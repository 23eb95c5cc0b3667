"""Training launcher: checkpoint/restart, a straggler watchdog, optional
gradient compression. The port's copy of ``repro/launch/train.py``.

  python -m repro_torch.launch.train --arch llama3.2-1b --smoke --steps 200
  python -m repro_torch.launch.train --arch llama3.2-1b --smoke --steps 60 \\
      --ckpt-dir /tmp/ck --ckpt-every 20 --fail-at-step 45   # exits 17
  # the same without --fail-at-step prints "resumed from step 40"

Runs on the card unless ``--device cpu`` is given (the plain versions of
the kernels). Weights come from ``init_params`` with seed 0, the data
from ``SyntheticLM`` or ``ByteCorpus`` over ``--corpus``; AdamW under a
20-step linear warmup and cosine decay.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import ByteCorpus, SyntheticLM
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params, param_count, resolve_device
from repro_torch.optim import adamw_init, linear_warmup_cosine
from repro_torch.train import TrainStepConfig, compression, make_train_step


class StragglerWatchdog:
    """Flags steps slower than ``factor`` x the running median (after 10
    steps); on one host it logs and counts."""

    def __init__(self, factor: float = 3.0, window: int = 50):
        self.factor = factor
        self.window = window
        self.times = []
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        slow = False
        if len(self.times) >= 10:
            med = statistics.median(self.times[-self.window:])
            if dt > self.factor * med:
                self.flagged += 1
                slow = True
        self.times.append(dt)
        return slow


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data", choices=["synthetic", "bytes"],
                    default="synthetic")
    ap.add_argument("--corpus", default="src")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=0,
                    help="inject a crash (fault-tolerance demo)")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.data == "bytes":
        cfg = dataclasses.replace(cfg, vocab_size=max(cfg.vocab_size, 256))
        data = ByteCorpus(args.corpus, args.seq, args.batch)
    else:
        data = SyntheticLM(cfg.vocab_size, args.seq, args.batch)

    params = init_params(T.param_defs(cfg), device=dev, seed=0)
    opt_state = adamw_init(params)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"[train] arch={cfg.name} params={param_count(T.param_defs(cfg)):,} "
          f"devices={n_dev}")

    tcfg = TrainStepConfig(
        microbatches=args.microbatches,
        learning_rate=linear_warmup_cosine(args.lr, 20, args.steps),
        compress_grads=args.compress_grads,
    )
    step_fn = make_train_step(cfg, tcfg, device=dev)

    start = 0
    mgr = None
    err_state = None
    if args.compress_grads:
        err_state = compression.init_error_state(params)
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        restored = mgr.restore_latest({"params": params, "opt": opt_state})
        if restored:
            params = restored["tree"]["params"]
            opt_state = restored["tree"]["opt"]
            start = restored["step"]
            print(f"[train] resumed from step {start} "
                  f"(elastic: {n_dev} devices now)")

    wd = StragglerWatchdog()
    losses = []
    for step in range(start, args.steps):
        if args.fail_at_step and step == args.fail_at_step:
            # quiesce the async checkpoint writer first: the injected crash
            # models "die after the last durable checkpoint", not "corrupt
            # the in-flight write" (atomicity has its own test)
            if mgr:
                mgr.wait()
            print(f"[train] INJECTED FAILURE at step {step}", flush=True)
            os._exit(17)
        batch = data.batch(step)
        t0 = time.time()
        if args.compress_grads:
            params, opt_state, err_state, metrics = step_fn(
                params, opt_state, batch, err_state)
        else:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))    # waits for the step
        dt = time.time() - t0
        if wd.observe(dt):
            print(f"[watchdog] step {step} straggling: {dt*1e3:.0f}ms")
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"({dt*1e3:.0f}ms/step)", flush=True)
        if mgr and step and step % args.ckpt_every == 0:
            mgr.save(step, {"params": params, "opt": opt_state},
                     {"loss": losses[-1]})
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt_state},
                 {"loss": losses[-1]})
        mgr.wait()
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(stragglers flagged: {wd.flagged})")
    return losses


if __name__ == "__main__":
    main()
