"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests that the timed path finished in the window, drawn from the
seed with the longest of them in it, goes to the plain reference: each
prompt with its served tokens, teacher-forced, in float32. A served token
is judged by its gap: the reference's best logit at that position less the
reference's logit of the served token (0 where the served token is the
reference's best). The number compared is the widest gap over the sample
(``max_logit_gap``); the sample must hold the cell's ``min_tokens``.

The control (``control_gaps``) reads, at the same positions, the gap of
the token that the reference computed in float8 puts first.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from perfbench.reference import dense


def sample(finished: Sequence, seed: int, served_tokens: int,
           max_requests: int) -> List:
    """The longest finished request (prompt and served tokens), then
    others in an order drawn from the seed, until the sample holds
    ``served_tokens`` served tokens or ``max_requests`` requests."""
    if not finished:
        return []
    total = [r.prompt_len + len(r.tokens) for r in finished]
    first = int(np.argmax(total))
    rest = [i for i in range(len(finished)) if i != first]
    rng = np.random.default_rng([int(seed) & ((1 << 64) - 1), 7])
    order = [first] + [rest[i] for i in rng.permutation(len(rest))]
    out, n = [], 0
    for i in order:
        if n >= served_tokens or len(out) >= max_requests:
            break
        out.append(finished[i])
        n += len(finished[i].tokens)
    return out


def teacher_forced(requests: Sequence, device) -> tuple:
    """Each request's prompt with its served tokens but the last (int64 on
    ``device``), and the positions whose logits choose the served tokens."""
    seqs, positions = [], []
    for r in requests:
        toks = np.concatenate([r.prompt, np.asarray(r.tokens[:-1], np.int32)])
        seqs.append(torch.from_numpy(toks.astype(np.int64)).to(device))
        p = r.prompt_len
        positions.append(torch.arange(p - 1, p - 1 + len(r.tokens),
                                      device=device))
    return seqs, positions


def gaps(logits: Sequence[torch.Tensor], chosen: Sequence[torch.Tensor]
         ) -> torch.Tensor:
    """Best logit less the chosen token's, every position, concatenated."""
    out = []
    for lg, ch in zip(logits, chosen):
        best = lg.max(dim=-1).values
        out.append(best - lg.gather(1, ch[:, None].long())[:, 0])
    return torch.cat(out) if out else torch.zeros(0)


def run_reference(sizes: dict, weights: Callable, requests: Sequence,
                  device, precision: str = "float32") -> List[torch.Tensor]:
    """The reference's logits at the served positions of ``requests``.
    ``weights(prefix, layer)`` draws a subtree's tensors again from the
    seed ({"tok", ...} for "embed"; layer l of "blocks/pos0")."""
    seqs, positions = teacher_forced(requests, device)
    with torch.no_grad():
        return dense.logits_at(
            sizes, weights("embed", -1), weights("final_norm", -1),
            lambda li: weights("blocks/pos0", li), seqs, positions,
            precision=precision)


def served_gaps(ref_logits, requests, device) -> torch.Tensor:
    chosen = [torch.as_tensor(np.asarray(r.tokens, np.int64), device=device)
              for r in requests]
    return gaps(ref_logits, chosen)


def control_gaps(ref_logits, ctl_logits) -> torch.Tensor:
    """The reference's gap of the token the control puts first."""
    return gaps(ref_logits, [c.argmax(dim=-1) for c in ctl_logits])


def verdict(max_gap: Optional[float], n_tokens: int, limits: Dict[str, float]
            ) -> tuple:
    """(correct, the numbers compared with their limits)."""
    checks = {
        "max_logit_gap": {"value": max_gap, "rule": "<=",
                          "limit": limits["max_logit_gap"]},
        "tokens_compared": {"value": n_tokens, "rule": ">=",
                            "limit": limits["min_tokens"]},
    }
    ok = (max_gap is not None and n_tokens >= limits["min_tokens"]
          and max_gap <= limits["max_logit_gap"])
    return ok, checks
