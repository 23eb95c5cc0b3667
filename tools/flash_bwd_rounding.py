#!/usr/bin/env python3
"""How much of the bf16 bound each rounding of the flash backward's
register operands takes, by the float32 emulation of its tensor-core
route (``tests/test_torch_flash_bwd_tiles.py``), on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/flash_bwd_rounding.py

At llama3.2-1b's training shape with a ragged S (B 4, H 32 / KH 8,
S 1000, D 64, causal) and whisper's encoder shape (B 2, H 16 / 16,
S 1500, non-causal), against the reference's ``_flash_bwd`` in JAX:
P and dS split in two bf16 halves (the route), one bf16 rounding of
both, of P alone and of dS alone. Prints one JSON line a shape: the
largest share of the bound (1e-2 + 2e-2 |want|) an element's error
takes. About two minutes.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), os.path.join(ROOT, "src")]

import torch  # noqa: E402

import test_torch_flash_bwd_tiles as T  # noqa: E402

SHAPES = ((4, 32, 8, 1000, 1000, 64, True), (2, 16, 16, 1500, 1500, 64, False))


def rounding(which: str):
    """``_times`` of the emulation with ``which`` operand rounded once:
    P is the operand without a negative element."""
    split = T._times

    def times(x, tile, _split):
        is_p = bool((x >= 0).all())
        once = which == "both" or (which == "P") == is_p
        return split(x, tile, not once)
    return times


def main() -> None:
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for shape in SHAPES:
        t0 = time.perf_counter()
        args, want = T.reference(*shape, seed=7)
        out = {"shape": shape, "split": T.share(T.emulate(*args, shape[-1]),
                                                want)}
        for which in ("both", "P", "dS"):
            T._times, keep = rounding(which), T._times
            try:
                out[f"one rounding of {which}"] = T.share(
                    T.emulate(*args, shape[-1]), want)
            finally:
                T._times = keep
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
