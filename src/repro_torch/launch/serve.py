"""Serving launcher of the port: batched request replay through its engine.

  python -m repro_torch.launch.serve --arch llama3.2-1b --requests 8
  python -m repro_torch.launch.serve --smoke --device cpu [--pack]
  python -m repro_torch.launch.serve --policy interleaved --pack --fuse \
      --superstep 4 [--prefill-jobs 2] [--decode-floor 2]
  python -m repro_torch.launch.serve --arch gpt2-xl --policy pim_aware
  python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --smoke --device cpu
  python -m repro_torch.launch.serve --arch rwkv6-7b [--smoke --device cpu]
  python -m repro_torch.launch.serve --arch jamba-v0.1-52b --smoke --device cpu

``--arch`` takes any name of ``repro_torch.configs.ARCHS``: the ``dense``
ones (llama3.2-1b, olmo-1b, granite-20b, phi3-medium-14b, and the paper's
gpt2-m/l/xl/2.5b, bert-b/l/1.3b/3.9b and gpt-6.7b/13b/30b), the ``moe``
ones (qwen3-moe-30b-a3b, kimi-k2-1t-a32b), rwkv6-7b and jamba-v0.1-52b.
An ``ssm`` or ``hybrid`` architecture prefills sequentially whatever
``--prefill-mode`` says, as the engine does; a ``moe`` one prefills in
chunks through its MoE layers. The launcher serves an architecture at its
full depth, as the reference's does: jamba-v0.1-52b's 103 GB and
kimi-k2-1t-a32b's 2 TB of bf16 weights do not fit one 80 GB card
(``chip_smoke.py`` serves jamba at depth 8 and runs kimi-k2's prefill step
at depth 1).

Runs on the card unless ``--device cpu`` is given (then through the
kernels' plain PyTorch versions). Weights are random, from ``--seed``.
On the card, one short request through a throwaway engine warms the
kernels up before the timed run. Prints tok/s, the PAS log summary,
dispatch counts (and with ``--superstep`` the supersteps), host syncs, the
policy's step kinds and the launch count of each kernel. ``--profile`` (card only) traces the run with
``torch.profiler`` and prints the device's busy share of the wall time and
the kernels that took the most device time.
"""
from __future__ import annotations

import argparse
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, resolve_device
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced (tiny) config")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="fixed prompt length (0 = random 2..9)")
    ap.add_argument("--prefill-mode", default="batched",
                    choices=["batched", "sequential"])
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--policy", default="serial",
                    choices=["serial", "interleaved", "pim_aware"],
                    help="step-composition policy (sched/policies.py)")
    ap.add_argument("--pack", action="store_true",
                    help="pack several prompts per prefill chunk row "
                         "(sched/packing.py)")
    ap.add_argument("--prefill-jobs", type=int, default=1,
                    help="concurrent prefill sub-batches (interleaving "
                         "policies)")
    ap.add_argument("--decode-floor", type=int, default=0,
                    help="defer decode below this ready-slot occupancy "
                         "when a prefill chunk fills the step")
    ap.add_argument("--fuse", action="store_true",
                    help="run an overlapped step (prefill chunk + the "
                         "ready slots' decode) as one dispatch")
    ap.add_argument("--superstep", type=int, default=1,
                    help="run up to K decode rounds per dispatch when no "
                         "prefill work is pending (1 = off)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the run with torch.profiler (card only)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.profile and dev.type != "cuda":
        ap.error("--profile measures the card: it needs --device cuda")
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = init_params(T.param_defs(cfg), device=dev, seed=args.seed)
    scfg = ServeConfig(max_slots=args.slots, max_len=args.max_len,
                       prefill_mode=args.prefill_mode,
                       prefill_chunk=args.prefill_chunk,
                       policy=args.policy, pack=args.pack,
                       max_prefill_jobs=args.prefill_jobs,
                       decode_floor=args.decode_floor, fuse=args.fuse,
                       superstep=args.superstep)
    if dev.type == "cuda":
        # one short request through a throwaway engine first, so that the
        # kernels' build, Triton's JIT and the libraries' set-up stay out
        # of the timed run
        warm = ServeEngine(cfg, params, scfg, device=dev)
        plen = min(args.prefill_chunk + 2, args.max_len - 1)
        warm.add_request(np.arange(plen) % cfg.vocab_size, max_new_tokens=2)
        warm.run_until_done()
        del warm
    eng = ServeEngine(cfg, params, scfg, device=dev)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = args.prompt_len or int(rng.integers(2, 10))
        eng.add_request(rng.integers(0, cfg.vocab_size, plen),
                        max_new_tokens=args.max_new)
    ops.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof = None
    if args.profile:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    t0 = time.perf_counter()
    results = eng.run_until_done()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
    tokens = sum(len(v) for v in results.values())
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[serve] {len(results)} requests, {tokens} tokens "
          f"in {dt:.2f}s ({tokens / dt:.1f} tok/s) on {where}")
    by_phase = {}
    for e in eng.pas_log:
        by_phase.setdefault(e["phase"], []).append(e)
    for phase, entries in by_phase.items():
        gemv = sum(1 for e in entries if e["gemv_path"])
        print(f"[serve] PAS {phase}: {len(entries)} steps, "
              f"{gemv} on the GEMV (PIM-analogue) path")
    print(f"[serve] dispatches: {eng.dispatch_counts['prefill']} prefill "
          f"({eng.effective_prefill_mode}"
          f"{', packed' if args.pack else ''}), "
          f"{eng.dispatch_counts['decode']} decode, "
          f"{eng.dispatch_counts['fused']} fused; "
          f"{eng.host_syncs} host syncs")
    if args.superstep > 1:
        print(f"[serve] supersteps (K={args.superstep}): "
              f"{eng.scheduler.stats['superstep']} dispatches covering "
              f"{eng.superstep_tokens} decode rounds")
    st = eng.prefill_stats
    if st["token_slots"]:
        print(f"[serve] prefill valid fraction "
              f"{st['valid_tokens'] / st['token_slots']:.3f} "
              f"({st['valid_tokens']} of {st['token_slots']} token slots"
              f"{', packed' if args.pack else ''})"
              + (f", decode deferrals: {eng.decode_deferrals}"
                 if eng.decode_deferrals else ""))
    stats = eng.scheduler.stats
    print(f"[serve] policy {eng.effective_policy}: "
          f"{stats['fused']} fused / {stats['overlapped']} overlapped / "
          f"{stats['serialized']} serialized / {stats['decode_only']} "
          f"decode-only steps")
    print(f"[serve] kernel launches: {ops.launch_counts()}")
    if prof is not None:
        print_device_time(prof, dt)
    return results


def device_time(prof, top: int = 15):
    """The device's busy seconds (the sum of kernel and copy times on the
    card; the runs use one stream) and the ``top`` device ops that took
    the most time: [(name, count, seconds)], slowest first."""
    by_name = defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += 1
            by_name[e.name][1] += e.time_range.elapsed_us() / 1e6
    busy_s = sum(s for _, s in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return busy_s, [(name, n, s) for name, (n, s) in ranked]


def print_device_time(prof, wall_s: float) -> None:
    """The device's busy share of the wall time and the device ops that
    took the most time, by name."""
    busy_s, ranked = device_time(prof)
    print(f"[serve] profile: device busy {busy_s:.4f}s of {wall_s:.4f}s "
          f"wall ({100 * busy_s / wall_s:.1f}%)")
    for name, n, s in ranked:
        print(f"[serve] profile: {s * 1e3:10.3f} ms {n:7d}x  {name[:90]}")


if __name__ == "__main__":
    main()
