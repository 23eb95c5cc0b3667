#!/usr/bin/env python3
"""Time this tree's norm kernel against another checkout's, in one process.

    python3 tools/norm_ab.py OTHER_CHECKOUT

Needs a CUDA card and triton. At every shape the serving paths give the
norm (``chip_smoke.NORM_SHAPES``), in bf16, both kernels are held against
the plain version (``chip_smoke``'s bf16 tolerance) and timed by
``chip_smoke.time_ms`` in the order this, other, other, this, twice.
Prints one JSON line a shape (the four times of each kernel), then the
card's name and power limit. The other checkout's
``kernels/layernorm.py`` is loaded by its path and shares this tree's
helpers (``_checks``, ``ref``).
"""
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.layernorm import layernorm  # noqa: E402


def load_other(root: str):
    path = os.path.join(root, "src", "repro_torch", "kernels",
                        "layernorm.py")
    spec = importlib.util.spec_from_file_location("other_layernorm", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.layernorm


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    kernels = {"this": layernorm, "other": load_other(sys.argv[1])}
    g = torch.Generator(device="cuda").manual_seed(1)
    atol = chip_smoke.TOL["bfloat16"]
    for mode, rows, d in chip_smoke.NORM_SHAPES:
        x = (torch.randn((rows, d), generator=g, device="cuda") * 3
             ).to(torch.bfloat16)
        s = torch.randn((d,), generator=g, device="cuda").to(torch.bfloat16)
        b = s.flip(0) if mode == "layernorm" else None
        want = ref.norm_ref(x, s, b, mode=mode).float()
        times = {}
        for name in ("this", "other", "other", "this") * 2:
            def run(f=kernels[name]):
                return f(x, s, b, mode=mode)
            err = float((run().float() - want).abs().max())
            if err > atol:
                raise SystemExit(f"{name} {mode} rows{rows} d{d}: max |err| "
                                 f"{err:.3g} > {atol}")
            times.setdefault(name, []).append(chip_smoke.time_ms(torch, run))
        print(json.dumps({"shape": f"{mode} rows{rows} d{d}", "ms": times}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
