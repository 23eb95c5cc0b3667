"""The readings a cell's correctness limit is set from.

    python perfbench/control.py --workload <cell> --seconds <s> \
        --seeds 1,2,... --control-seeds 1,2,3 [--out file.json]

For each seed, in one process: serve the cell for a short window at its
own load, sample its finished requests as a run does, and read the
widest gap of the served tokens against the float32 reference (the
program's readings: the largest over a dozen seeds is the limit's lower
end). For each control seed also read, at the same positions, the widest
gap of the tokens that the reference computed in float8 (e4m3, absmax
scales) puts first: the control, whose smallest reading is the upper end.
The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root, name: str, seeds, control_seeds, seconds: float,
             device: str = "cuda") -> list:
    from perfbench import check, harness

    rows = []
    for seed in seeds:
        sv = harness.serve(root, name, seed, seconds, False,
                           time.perf_counter(), device)
        sampled = harness.sample(sv)
        ref = harness.reference_logits(sv, sampled)
        g = check.served_gaps(ref, sampled, sv.dev)
        row = {"seed": seed, "requests": len(sampled),
               "tokens": int(g.numel()),
               "program_max_gap": float(g.max()) if g.numel() else None,
               "program_off_best": float((g > 0).float().mean())
               if g.numel() else None}
        if seed in control_seeds:
            ctl = harness.reference_logits(sv, sampled, "fp8")
            cg = check.control_gaps(ref, ctl)
            row["control_max_gap"] = float(cg.max())
            row["control_off_best"] = float((cg > 0).float().mean())
        harness.log(f"readings {json.dumps(row)}")
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import os
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "perfbench" / ".cache"
                                         / "triton")
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = readings(ROOT, args.workload, seeds, ctl, args.seconds)
    text = json.dumps({"workload": args.workload, "rows": rows}, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
