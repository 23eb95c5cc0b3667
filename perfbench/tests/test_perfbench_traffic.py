"""The traffic is a function of the seed: the decks' lengths and gaps are
fixed by the mix, every seed sends the same lengths at the same mean rate
in another order, and the open loop against a fake engine sends the same
requests at the same times for the same seed."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import manifest  # noqa: E402
from perfbench.loop import OpenLoop  # noqa: E402

BDIR = ROOT / "perfbench"
MIXES = sorted(p.stem for p in (BDIR / "traffic").glob("*.json"))
SEED = 2 ** 31 + 12345


def _traffic(mix_name, seed, vocab=1000):
    mix = json.loads((BDIR / "traffic" / f"{mix_name}.json").read_text())
    gen = manifest.generator_module(BDIR, mix["generator"])
    return mix, gen.make(mix, seed, vocab, BDIR)


@pytest.mark.parametrize("mix_name", MIXES)
def test_every_seed_sends_the_decks(mix_name):
    mix, a = _traffic(mix_name, SEED)
    _, b = _traffic(mix_name, 7)
    for side in ("prompt", "output"):
        lo, hi = mix[side].get("clip", mix[side].get("uniform"))
        k = 0 if side == "prompt" else 1
        assert lo <= a.pairs[:, k].min() and a.pairs[:, k].max() <= hi
    n = len(a.pairs)
    assert sorted(a.lengths(i) for i in range(n)) == \
        sorted(b.lengths(i) for i in range(n)) == \
        sorted(map(tuple, a.pairs.tolist()))
    assert [a.lengths(i) for i in range(16)] != \
        [b.lengths(i) for i in range(16)]
    # each run of ``strata`` arrivals holds one request of each stratum
    per = n // a.strata
    rank = {tuple(p): i // per for i, p in enumerate(a.pairs.tolist())}
    assert sorted(rank[a.lengths(i)] for i in range(a.strata)) == \
        list(range(a.strata))
    # the same mean rate, whatever the order
    assert a.due(n) == pytest.approx(b.due(n))
    assert n / a.due(n) == pytest.approx(mix["rate"], rel=0.02)
    p1, o1 = a.request(37)
    p2, o2 = _traffic(mix_name, SEED)[1].request(37)
    assert o1 == o2 and np.array_equal(p1, p2) and p1.dtype == np.int32


class _Req:
    def __init__(self, rid, n):
        self.rid, self.left, self.done = rid, n, False


class FakeEngine:
    """Serves one token a step to every request, admits one request a
    step, each done after its budget."""

    def __init__(self):
        self.queue, self.live = [], {}
        self.scheduler = type("S", (), {"stats": {"steps": 0,
                                                  "decode_only": 0}})()
        self.prefill_stats = {"valid_tokens": 0, "token_slots": 0}
        self.step_idx, self._rid = 0, 0

    def add_request(self, prompt, max_new):
        self.queue.append(_Req(self._rid, max_new))
        self._rid += 1
        return self._rid - 1

    def step(self):
        if self.queue:
            r = self.queue.pop(0)
            self.live[r.rid] = r
        out = []
        for rid, r in list(self.live.items()):
            out.append((rid, rid % 7))
            r.left -= 1
            if r.left == 0:
                r.done = True
                del self.live[rid]
        self.scheduler.stats["steps"] += 1
        self.scheduler.stats["decode_only"] += 1
        self.step_idx += 1
        return out


def _run(seed):
    clock = iter(np.arange(0, 1e6, 0.01)).__next__
    loop = OpenLoop(FakeEngine(), _traffic("chat", seed)[1], clock=clock)
    loop.run_until(loop.start + 60.0)
    return [(r.i, r.prompt_len, r.max_new, round(r.due - loop.start, 6),
             len(r.tokens)) for r in loop.requests], loop


def test_open_loop_is_deterministic_for_a_seed():
    a, loop = _run(SEED)
    b, _ = _run(SEED)
    c, _ = _run(SEED + 1)
    assert a == b and a != c
    # every request due is sent, in order, no earlier than it was due
    assert [r.i for r in loop.requests] == list(range(len(loop.requests)))
    assert all(r.submit >= r.due for r in loop.requests)
    assert loop.unsent(loop.start + 1e3)[0].i == len(loop.requests)
    done = [r for r in loop.requests if r.done is not None]
    assert done and all(len(r.tokens) == r.max_new for r in done)
