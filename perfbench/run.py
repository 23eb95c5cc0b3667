"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. It needs as many CUDA cards as the cell
asks for and exits with an error, printing no result, without them. The
last line of standard output is the result (``harness.run_cell``); the
last lines of standard error are the numbers compared with their limits.
Triton's cache lives in ``perfbench/.cache/triton`` of the checkout; the
kernels' libraries build into its ``build/kernels``.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "perfbench" / ".cache"
                                         / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    from perfbench import harness, manifest

    torch.set_num_threads(1)
    chips = manifest.load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
