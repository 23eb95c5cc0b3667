"""One run of one cell: weights from the seed, the engine, the open loop
through its ramp and its measured window, the traced sub-window (``--trace
1``), the metrics, and the comparison with the plain reference.

Order of a run:
1. draw the weights (``weights.py``) and build ``ServeEngine`` with the
   cell's ``ServeConfig``;
2. serve one short request, whose first launches build the kernels'
   libraries and compile the norm, then run the open loop through the
   cell's ramp, which warms every shape the traffic uses and brings the
   engine to its steady state; both count in ``setup_s``;
3. measure ``seconds`` of the loop: the window;
4. with a trace, profile a further sub-window (``devtrace.py``);
5. read the metrics and the peak memory, free the program's state;
6. compare a sample of the window's finished requests with the reference
   (``check.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench import check, costs, devtrace, manifest, readings, weights
from perfbench.loop import OpenLoop

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
COUNTERS = ("token_slots", "valid_tokens")
WARM_PROMPT, WARM_NEW = 32, 8


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def model_config(config: dict):
    """The served ModelConfig: the port's architecture of the file's
    ``arch``, with the file's ``model`` sizes."""
    from repro_torch.configs import get_arch
    return dataclasses.replace(get_arch(config["arch"]), **config["model"])


def reference_sizes(cfg) -> dict:
    keys = ("num_layers", "d_model", "num_heads", "num_kv_heads",
            "head_dim", "d_ff", "vocab_size", "norm", "act",
            "tie_embeddings", "rope_theta")
    return {k: getattr(cfg, k) for k in keys}


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def device_info(dev: torch.device, chips: int, peak_bytes: int) -> dict:
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": chips,
            "memory_peak_bytes": int(peak_bytes)}


@dataclasses.dataclass
class Served:
    """What serving a cell leaves: the record the metrics read, the
    window's requests and finished requests, the peak memory, and what
    the reference needs to draw the weights again."""
    cell: manifest.Cell
    cfg: object
    defs: dict
    seed: int
    dev: torch.device
    rec: readings.Record
    window: list
    finished: list
    peak_bytes: int
    metrics: dict


def serve(root, name: str, seed: int, seconds: float, trace: bool,
          t0: float, device: str = "cuda") -> Served:
    """Steps 1-5 of a run (module docstring): serve cell ``name`` of the
    manifest at ``root`` through its ramp and window (and, with
    ``trace``, the traced sub-window), read the metrics the run reports,
    and free the program's state."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeConfig, ServeEngine

    clock = time.perf_counter
    cell = manifest.load_cell(root, name)
    bdir = cell.bench_dir()
    wl = cell.workload
    cfg = model_config(cell.config)
    dev = torch.device(device)
    if dev.type == "cuda":
        log(f"card: {_power_limit()}")
        torch.cuda.reset_peak_memory_stats()

    defs = T.param_defs(cfg)
    params = weights.draw_tree(defs, seed, dev)
    engine = ServeEngine(cfg, params, ServeConfig(**wl["serve"]), device=dev)
    _sync(dev)
    log(f"weights and engine {clock() - t0:.3f} s after start")
    # one short request before the schedule starts: the kernels' first
    # launch builds their libraries and compiles the norm, which must not
    # hold up requests that the schedule has already sent
    engine.add_request(np.arange(1, WARM_PROMPT + 1) % cfg.vocab_size,
                       WARM_NEW)
    while engine.queue or any(r is not None for r in engine.slot_req):
        engine.step()
    _sync(dev)
    log(f"kernels warm {clock() - t0:.3f} s after start")
    gen = manifest.generator_module(bdir, cell.traffic["generator"])
    loop = OpenLoop(engine, gen.make(cell.traffic, seed, cfg.vocab_size,
                                     bdir), clock=clock)
    loop.run_for(float(wl["ramp_s"]))
    _sync(dev)
    t_open = clock()
    setup_s = t_open - t0
    log(f"window opens at {setup_s:.3f} s")
    before = {k: engine.prefill_stats[k] for k in COUNTERS}
    loop.run_until(t_open + seconds)
    t_close = loop.steps[-1].end
    after = {k: engine.prefill_stats[k] for k in COUNTERS}

    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else None
    late = [r.submit - r.due for r in loop.requests
            if t_open <= r.due < t_close]
    if late:
        log(f"submits late by {1e3 * max(late):.3f} ms at most, "
            f"{1e3 * float(np.median(late)):.3f} ms median")
    rec = readings.Record(cfg=cfg, t_open=t_open, t_close=t_close,
                          requests=loop.requests + loop.unsent(t_close),
                          steps=loop.steps,
                          counters={"before": before, "after": after},
                          setup_s=setup_s, peak=costs.peaks(kind))
    metric_list = cell.per_layer if trace else cell.end_to_end
    readers = {m["name"]: manifest.metric_module(bdir, m["name"])
               for m in metric_list}
    if trace:
        op_names = sorted({op for r in readers.values()
                           for op in getattr(r, "OPS", ())})
        tw = wl["trace"]
        rec.trace = devtrace.capture(loop.run_for, float(tw["warm_s"]),
                                     float(tw["window_s"]), ops, op_names,
                                     engine, tempfile.gettempdir())
    _sync(dev)
    peak_bytes = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
        else 0
    metrics = {}
    for m in metric_list:
        v = readers[m["name"]].read(rec)
        if v is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    window = readings.window_requests(rec)
    for what, vals in (("ttft", readings.ttft_s(rec)),
                       ("tpot", readings.tpot_s(rec))):
        if vals:
            q = np.percentile(vals, [50, 75, 90]) * 1e3
            log(f"{what} ms p50 {q[0]:.3f} p75 {q[1]:.3f} p90 {q[2]:.3f} "
                f"over {len(vals)} requests")
    finished = [r for r in loop.requests
                if r.done is not None and t_open <= r.done <= t_close]
    log(f"window {rec.window_s:.3f} s: {len(window)} requests due, "
        f"{len(finished)} finished, {readings.tokens_in_window(rec)} tokens")

    # the program's state goes before the reference runs
    loop.engine = None
    del engine, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return Served(cell=cell, cfg=cfg, defs=defs, seed=seed, dev=dev,
                  rec=rec, window=window, finished=finished,
                  peak_bytes=peak_bytes, metrics=metrics)


def sample(sv: Served) -> list:
    ck = sv.cell.workload["check"]
    return check.sample(sv.finished, sv.seed, int(ck["served_tokens"]),
                        int(ck["max_requests"]))


def reference_logits(sv: Served, requests: list,
                     precision: str = "float32") -> list:
    """The reference's logits at the served positions of ``requests``,
    from the weights drawn again from the seed."""
    return check.run_reference(
        reference_sizes(sv.cfg),
        lambda prefix, layer: weights.draw_layer(sv.defs, sv.seed, sv.dev,
                                                 prefix, layer),
        requests, sv.dev, precision=precision)


def run_cell(root, name: str, seed: int, seconds: float, trace: bool,
             t0: float, device: str = "cuda") -> dict:
    """One run of cell ``name``; returns the result line's object
    (``checks`` last)."""
    sv = serve(root, name, seed, seconds, trace, t0, device)
    t_ref = time.perf_counter()
    sampled = sample(sv)
    g = check.served_gaps(reference_logits(sv, sampled), sampled, sv.dev)
    max_gap = float(g.max()) if g.numel() else None
    ok, checks = check.verdict(max_gap, int(g.numel()),
                               sv.cell.workload["check"])
    log(f"reference over {len(sampled)} requests, {g.numel()} tokens: "
        f"{time.perf_counter() - t_ref:.3f} s")

    dinfo = device_info(sv.dev, sv.cell.chips, sv.peak_bytes)
    out = {"correct": bool(ok), "attempted": len(sv.window), "failed": 0,
           "metrics": sv.metrics, "device": dinfo}
    tr = sv.rec.trace
    if tr is not None:
        dinfo["busy_s"] = tr["busy_s"]
        dinfo["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = checks
    return out


def print_result(out: dict, stream=None) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    import json
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']} {v['rule']} limit {v['limit']}", file=sys.stderr,
              flush=True)
    print(json.dumps(out), file=stream or sys.stdout, flush=True)

