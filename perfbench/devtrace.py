"""The traced sub-window: ``torch.profiler`` over a few seconds of the
steady loop, read back from its Chrome trace.

While it runs, the benchmark's own wrappers open a ``record_function``
range around each call of the dispatch-layer functions that the cell's
metrics name (``ops.fused_matvec``, ...) and
around the engine's phase methods, and keep each op call's shapes. Each
device kernel is given to the op call whose range holds its launch (the
runtime call with its correlation id), so a call's device time is that of
every kernel it launched. The device is busy where a kernel, copy or set
ran; the window is the ``pb.window`` range. The untraced run wraps
nothing.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import inspect
import json
import os
import tempfile
from typing import Dict, List

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ENGINE_METHODS = ("step", "admit_wave", "build_prefill_job",
                  "dispatch_prefill_chunk", "finish_prefill",
                  "dispatch_decode", "dispatch_fused_step",
                  "dispatch_decode_superstep", "resolve_decode",
                  "resolve_decode_superstep", "_fetch_np")
OP_PREFIX = "pb.op:"
WINDOW = "pb.window"


def _describe(bound: inspect.BoundArguments) -> dict:
    """What a call's cost needs: its operands' shapes and itemsize, and
    its scalar arguments."""
    out = {}
    for k, v in bound.arguments.items():
        if isinstance(v, torch.Tensor):
            out[k] = {"shape": tuple(v.shape), "itemsize": v.element_size()}
        elif isinstance(v, (int, float, str, bool)) or v is None:
            out[k] = v
    return out


class OpRecorder:
    """Wraps ``ops.<name>`` for each name, each call in a ``pb.op:<name>``
    range, and keeps the calls in order."""

    def __init__(self, ops_module, names):
        self.ops = ops_module
        self.names = tuple(names)
        self.calls: Dict[str, List[dict]] = {n: [] for n in self.names}
        self._saved = {}

    def _wrap(self, name, fn):
        sig = inspect.signature(fn)
        label = OP_PREFIX + name
        calls = self.calls[name]

        def call(*a, **k):
            with torch.profiler.record_function(label):
                out = fn(*a, **k)
            calls.append(_describe(sig.bind(*a, **k)))
            return out
        return call

    def __enter__(self):
        for n in self.names:
            self._saved[n] = getattr(self.ops, n)
            setattr(self.ops, n, self._wrap(n, self._saved[n]))
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self.ops, n, fn)


@contextlib.contextmanager
def engine_ranges(engine):
    """Each of the engine's phase methods in a ``pb.engine:<method>``
    range (set on the instance, removed after)."""
    def wrap(name, fn):
        label = "pb.engine:" + name

        def call(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return call
    names = [n for n in ENGINE_METHODS if hasattr(engine, n)]
    for n in names:
        setattr(engine, n, wrap(n, getattr(engine, n)))
    try:
        yield
    finally:
        for n in names:
            delattr(engine, n)


def capture(run_for, warm_s: float, window_s: float, ops_module, op_names,
            engine, tmpdir: str) -> dict:
    """Profile ``warm_s`` seconds of ``run_for`` unread, then ``window_s``
    seconds inside the ``pb.window`` range; read the trace. Returns the
    parsed trace with each recorded op call (``parse``)."""
    from torch.profiler import ProfilerActivity, profile
    rec = OpRecorder(ops_module, op_names)
    fd, path = tempfile.mkstemp(suffix=".json", dir=tmpdir)
    os.close(fd)
    try:
        with rec, engine_ranges(engine), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                ) as prof:
            run_for(warm_s)
            n_before = {n: len(c) for n, c in rec.calls.items()}
            with torch.profiler.record_function(WINDOW):
                run_for(window_s)
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
        events = events.get("traceEvents", events)
    finally:
        os.unlink(path)
    return parse(events, rec.calls, n_before)


def _union(intervals):
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def _gaps(intervals, lo, hi):
    """The idle stretches of [lo, hi] between sorted busy intervals."""
    out, t = [], lo
    for a, b in sorted(intervals):
        if a > t:
            out.append((t, min(a, hi)))
        t = max(t, b)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(a, b) for a, b in out if b > a]


def parse(events: list, calls: Dict[str, List[dict]],
          n_before: Dict[str, int]) -> dict:
    """The trace's window, device busy time, the device time of each op
    call in the window, the device ops that took most time and the idle
    stretches by what the host was doing (innermost ``pb.*`` range)."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError("the trace holds no pb.window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tid = win[0].get("tid")
    device = [e for e in events if e.get("cat") in DEVICE_CATS
              and "dur" in e]
    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = float(e["ts"])
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("tid") == tid
                    and str(e.get("name", "")).startswith("pb."))

    # op calls: the i-th pb.op:<name> range is the i-th recorded call
    op_ranges = {n: [r for r in ranges if r[2] == OP_PREFIX + n]
                 for n in calls}
    flat = sorted((a, b, n, i) for n, rs in op_ranges.items()
                  for i, (a, b, _) in enumerate(rs))
    starts = [r[0] for r in flat]
    dev_s = {n: [0.0] * len(rs) for n, rs in op_ranges.items()}
    busy, by_name = [], collections.Counter()
    for e in device:
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b > w0 and a < w1:
            busy.append((max(a, w0), min(b, w1)))
            by_name[e["name"]] += (min(b, w1) - max(a, w0)) / 1e6
        t = launches.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and flat[j][0] <= t <= flat[j][1]:
            dev_s[flat[j][2]][flat[j][3]] += (b - a) / 1e6
    out_calls = {}
    for n, rs in op_ranges.items():
        recs = calls[n]
        if len(rs) != len(recs):
            raise RuntimeError(f"{len(rs)} {n} ranges in the trace for "
                               f"{len(recs)} recorded calls")
        out_calls[n] = [dict(recs[i], device_s=dev_s[n][i])
                        for i, (a, b, _) in enumerate(rs)
                        if i >= n_before.get(n, 0) and a >= w0 and b <= w1]

    # idle stretches, each named by the innermost pb.* range open at its
    # start (the ranges of one thread nest: a sweep with a stack)
    nested = [r for r in ranges if r[2] != WINDOW]
    idle = collections.Counter()
    stack, ri = [], 0
    for a, b in _gaps(busy, w0, w1):
        while ri < len(nested) and nested[ri][0] <= a:
            r = nested[ri]
            ri += 1
            while stack and stack[-1][1] <= r[0]:
                stack.pop()
            stack.append(r)
        while stack and stack[-1][1] <= a:
            stack.pop()
        label = stack[-1][2] if stack else "outside the engine's calls"
        idle[label] += (b - a) / 1e6
    busy_s = _union(busy) / 1e6
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_s,
            "calls": out_calls,
            "device_ops": [[n, s] for n, s in by_name.most_common(10)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}
