"""Open-loop traffic: requests arrive on a schedule drawn from the seed,
whether or not earlier ones have finished.

A mix fixes two decks. The length deck holds ``deck`` (prompt, output)
pairs at the evenly spaced quantiles of the mix's length distributions
(an empirical histogram, read as ``trace/arrivals.py``'s
``LengthDistribution`` reads one, or a uniform range), clipped into the
mix's bounds, the output quantiles paired with the prompt ones by a fixed
shuffle. The gap deck holds as many gaps between arrivals at the evenly
spaced quantiles of an exponential of mean 1 / ``rate``: a Poisson
process's gaps, with their mean exactly the rate's. The length deck is
sorted by the mix's cost key and cut into ``strata`` strata; every run of
``strata`` arrivals takes one request of each, in an order drawn from the
seed, so any stretch of the schedule carries a near-even share of the
deck. The seed orders both decks and draws the token ids: every seed
sends the same lengths at the same mean rate, in another order.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

import numpy as np

_MASK64 = (1 << 64) - 1


def _histogram(path: Path, side: str):
    with open(path) as f:
        d = json.load(f)
    edges = np.asarray(d[side]["edges"], np.int64)
    counts = np.asarray(d[side]["counts"], np.float64)
    if len(edges) != len(counts) + 1 or not (np.diff(edges) > 0).all() \
            or counts.sum() <= 0 or (counts < 0).any():
        raise ValueError(f"{path}: a bad {side} histogram")
    return edges, counts


def quantile(spec: dict, u: np.ndarray, bench_dir: Path) -> np.ndarray:
    """Lengths at quantiles ``u`` in (0, 1) of a length spec, clipped.

    ``{"uniform": [lo, hi]}``: the integers lo..hi, evenly weighted.
    ``{"histogram": file, "side": "prompt"}``: a bin by weight, then the
    integers [edges[i], edges[i+1] - 1] evenly.
    ``"clip": [lo, hi]`` bounds either."""
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        out = lo + np.floor(u * (hi - lo + 1)).astype(np.int64)
    else:
        edges, counts = _histogram(Path(bench_dir) / spec["histogram"],
                                   spec["side"])
        cum = np.concatenate([[0.0], np.cumsum(counts / counts.sum())])
        i = np.clip(np.searchsorted(cum, u, side="right") - 1, 0,
                    len(counts) - 1)
        frac = (u - cum[i]) / (cum[i + 1] - cum[i])
        width = edges[i + 1] - edges[i]
        out = edges[i] + np.minimum(np.floor(frac * width).astype(np.int64),
                                    width - 1)
    if "clip" in spec:
        out = np.clip(out, spec["clip"][0], spec["clip"][1])
    return out.astype(np.int64)


def deck(mix: dict, bench_dir: Path) -> np.ndarray:
    """The mix's (prompt, output) pairs, (N, 2), sorted by its cost key
    (``strata_by``: "prompt" or "output"), ties by the other."""
    n = int(mix["deck"])
    u = (np.arange(n) + 0.5) / n
    prompt = quantile(mix["prompt"], u, bench_dir)
    pairing = np.random.default_rng(0).permutation(n)
    output = quantile(mix["output"], u[pairing], bench_dir)
    pairs = np.stack([prompt, output], axis=1)
    key = 0 if mix["strata_by"] == "prompt" else 1
    return pairs[np.lexsort((pairs[:, 1 - key], pairs[:, key]))]


class OpenLoopTraffic:
    """``due(i)``: the i-th arrival's time, seconds after the schedule's
    start; ``request(i)``: its (prompt tokens int32, max new tokens). The
    same for the same seed whatever the timing."""

    def __init__(self, mix: dict, seed: int, vocab: int, bench_dir: Path):
        self.vocab = int(vocab)
        self.seed = int(seed) & _MASK64
        self.pairs = deck(mix, bench_dir)
        n = len(self.pairs)
        self.strata = int(mix["strata"])
        if n % self.strata:
            raise ValueError(f"deck of {n} is not a multiple of "
                             f"{self.strata} strata")
        per = n // self.strata
        u = (np.arange(n) + 0.5) / n
        gaps = -np.log1p(-u) / float(mix["rate"])
        rng = np.random.default_rng([self.seed, 0])
        self.gaps = gaps[rng.permutation(n)]
        self.cycle = float(self.gaps.sum())
        self.offsets = np.concatenate([[0.0], np.cumsum(self.gaps)[:-1]])
        # block b of ``strata`` arrivals takes entry order[s, b] of each
        # stratum s, the strata in the order rank[b]
        self.rank = np.stack([rng.permutation(self.strata)
                              for _ in range(per)])
        self.order = np.stack([rng.permutation(per)
                               for _ in range(self.strata)])
        self.per = per

    def due(self, i: int) -> float:
        c, j = divmod(int(i), len(self.gaps))
        return c * self.cycle + float(self.offsets[j])

    def lengths(self, i: int) -> Tuple[int, int]:
        j = int(i) % len(self.pairs)
        b, k = divmod(j, self.strata)
        s = int(self.rank[b, k])
        p, o = self.pairs[s * self.per + int(self.order[s, b])]
        return int(p), int(o)

    def request(self, i: int) -> Tuple[np.ndarray, int]:
        plen, out = self.lengths(i)
        rng = np.random.default_rng([self.seed, 1, int(i)])
        return rng.integers(0, self.vocab, plen).astype(np.int32), out


def make(mix: dict, seed: int, vocab: int, bench_dir: Path
         ) -> OpenLoopTraffic:
    return OpenLoopTraffic(mix, seed, vocab, bench_dir)
