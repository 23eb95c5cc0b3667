"""MetricsHub: request-lifecycle metrics over the serving event stream.

The port's own copy of ``repro/obs/metrics.py``: on the same trace it
gives the same summary, key for key.

The hub is a host-side registry of counters / gauges / histograms populated
from the SAME events a ``trace.TraceRecorder`` captures — it consumes event
dicts (schema.py), never engine or device state, so attaching metrics to a
serve adds exactly zero dispatches and zero host syncs (the zero-overhead
tests hold this for every policy x fuse x superstep combination).

Two ways to feed it, sharing one code path:

  live     — ``TraceRecorder(sinks=[hub])``: the recorder forwards every
             event (header included) to ``hub.observe`` as it is appended,
             so metrics are current while the engine serves.
  offline  — ``hub.ingest(trace)`` replays a loaded ``Trace``'s header +
             events + summary through the same ``observe``; a recorded
             JSONL file yields byte-identical metrics to the live serve
             that produced it (tested).

Per-request lifecycle (``RequestLifecycle``): arrival -> admit -> per-chunk
prefill -> first token -> per-token decode -> completion, all timestamped in
ENGINE-CLOCK TICKS (one scheduler step = one tick; a decode superstep's k
inner rounds advance the clock k ticks). Tick timestamps make every derived
metric deterministic for a seeded workload — which is what lets
``benchmarks/latency_guard.py`` hold p50/p99 latency baselines exactly.

Metric definitions (the glossary README "Observability" documents):

  TTFT        ticks from a request's TRUE arrival (the recorded injection
              step minus its ``arrival_offset`` — schema v5 records the
              offset so arrivals landing mid-superstep are not batched at
              the superstep boundary) to the decode step that carried its
              first generated token.
  TPOT        tick gap between a request's consecutive generated tokens
              (first token excluded; superstep inner rounds are 1 tick
              apart by construction).
  queue_wait  ticks from true arrival to admission.
  queue_depth / slots_busy   gauges stepped at every arrival / admit /
              completion; summarized time-weighted over the serve.
  valid-token fraction       valid prompt tokens over computed token slots
              across all prefill dispatches (the packing metric).
  dispatch mix               prefill / decode / fused dispatch counts plus
              superstep spans and the rounds they covered, derived from the
              event stream with the same closed-form rules the protocol
              lint checks against the engine's own counters.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

PERCENTILES = (50.0, 95.0, 99.0)


class Counter:
    """Monotonic count."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def merge(self, other: "Counter") -> "Counter":
        """Fleet aggregation: counts add."""
        self.value += other.value
        return self

    def to_dict(self) -> dict:
        return {"type": "counter", "value": self.value}

    def state_dict(self) -> dict:
        """Lossless export (``from_state`` round-trips exactly)."""
        return {"type": "counter", "name": self.name, "value": self.value}

    @classmethod
    def from_state(cls, d: dict) -> "Counter":
        c = cls(d["name"])
        c.value = d["value"]
        return c


class Gauge:
    """A stepped time series (tick, value): queue depth, slot occupancy.
    Summaries are time-weighted over [first tick, last tick] — each recorded
    value holds until the next change."""

    def __init__(self, name: str):
        self.name = name
        self.series: List[tuple] = []     # (tick, value), tick non-decreasing

    def set(self, tick: float, value: float) -> None:
        if self.series and self.series[-1][0] == tick:
            self.series[-1] = (tick, value)
        else:
            self.series.append((tick, value))

    @property
    def value(self) -> float:
        return self.series[-1][1] if self.series else 0.0

    def max(self) -> float:
        return max((v for _, v in self.series), default=0.0)

    def time_weighted_mean(self) -> float:
        if len(self.series) < 2:
            return self.value
        total, acc = 0.0, 0.0
        for (t0, v0), (t1, _v1) in zip(self.series, self.series[1:]):
            acc += v0 * (t1 - t0)
            total += t1 - t0
        return acc / total if total else self.value

    def merge(self, other: "Gauge") -> "Gauge":
        """Fleet aggregation by TICK INTERVAL: the merged series is the SUM
        of the two step functions over the union of their change ticks
        (each series reads 0 before its first sample). This is the correct
        semantics for per-replica queue depth / slot occupancy sharing one
        fleet clock — naive sample averaging would weight each replica's
        values by how often they *changed*, not how long they *held*."""
        if not other.series:
            return self
        if not self.series:
            self.series = [(t, v) for t, v in other.series]
            return self
        a, b = self.series, other.series
        ia = ib = 0
        va = vb = 0.0
        merged: List[tuple] = []
        for t in sorted({t for t, _ in a} | {t for t, _ in b}):
            while ia < len(a) and a[ia][0] <= t:
                va = a[ia][1]
                ia += 1
            while ib < len(b) and b[ib][0] <= t:
                vb = b[ib][1]
                ib += 1
            merged.append((t, va + vb))
        self.series = merged
        return self

    def to_dict(self) -> dict:
        return {"type": "gauge", "last": self.value, "max": self.max(),
                "mean": self.time_weighted_mean(),
                "samples": len(self.series)}

    def state_dict(self) -> dict:
        """Lossless export: the full stepped series, so a reloaded gauge
        merges and summarizes identically to the original."""
        return {"type": "gauge", "name": self.name,
                "series": [[t, v] for t, v in self.series]}

    @classmethod
    def from_state(cls, d: dict) -> "Gauge":
        g = cls(d["name"])
        g.series = [(t, v) for t, v in d["series"]]
        return g


class Histogram:
    """Exact sample store with numpy-matching percentile math (linear
    interpolation — ``np.percentile``'s default; the test pins equality)."""

    def __init__(self, name: str):
        self.name = name
        self.samples: List[float] = []

    def observe(self, value: float) -> None:
        self.samples.append(float(value))

    @property
    def count(self) -> int:
        return len(self.samples)

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return float(np.percentile(np.asarray(self.samples), q))

    def summary(self) -> dict:
        if not self.samples:
            return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    **{f"p{q:g}": 0.0 for q in PERCENTILES}}
        a = np.asarray(self.samples)
        out = {"count": int(a.size), "mean": float(a.mean()),
               "min": float(a.min()), "max": float(a.max())}
        for q in PERCENTILES:
            out[f"p{q:g}"] = float(np.percentile(a, q))
        return out

    def merge(self, other: "Histogram") -> "Histogram":
        """Fleet aggregation is LOSSLESS: samples concatenate, so percentiles
        of a merged histogram are exactly ``np.percentile`` over the
        concatenated raw samples (no bucketing error to compound)."""
        self.samples.extend(other.samples)
        return self

    def to_dict(self) -> dict:
        return {"type": "histogram", **self.summary()}

    def state_dict(self) -> dict:
        """Lossless export: raw samples, not a summary."""
        return {"type": "histogram", "name": self.name,
                "samples": list(self.samples)}

    @classmethod
    def from_state(cls, d: dict) -> "Histogram":
        h = cls(d["name"])
        h.samples = [float(s) for s in d["samples"]]
        return h


@dataclass
class RequestLifecycle:
    """One request's timeline, every field in engine-clock ticks."""
    rid: int
    arrival: int                  # true arrival tick (injection - offset)
    injected: int                 # tick the engine actually saw it
    prompt_len: int
    max_new: int
    gid: Optional[int] = None     # fleet-global id (schema v7); == rid solo
    admit: Optional[int] = None
    slot: Optional[int] = None
    prefill_steps: List[int] = field(default_factory=list)
    first_token: Optional[int] = None
    last_token: Optional[int] = None
    n_tokens: int = 0
    complete: Optional[int] = None
    reason: Optional[str] = None

    @property
    def ttft(self) -> Optional[int]:
        if self.first_token is None:
            return None
        return self.first_token - self.arrival

    def to_dict(self) -> dict:
        return {"rid": self.rid, "gid": self.gid, "arrival": self.arrival,
                "injected": self.injected, "prompt_len": self.prompt_len,
                "max_new": self.max_new, "admit": self.admit,
                "slot": self.slot, "prefill_steps": list(self.prefill_steps),
                "first_token": self.first_token,
                "last_token": self.last_token, "n_tokens": self.n_tokens,
                "complete": self.complete, "reason": self.reason,
                "ttft": self.ttft}


class MetricsHub:
    """Event-driven metrics registry + per-request lifecycle store."""

    def __init__(self):
        self.header: Optional[dict] = None
        self.engine_summary: Optional[dict] = None
        self.requests: Dict[int, RequestLifecycle] = {}
        self._metrics: Dict[str, object] = {}
        self._slot_rid: Dict[int, int] = {}
        self._queue_depth = 0
        self._slots_busy = 0
        self._superstep_ids: set = set()
        # terminal chaos outcomes land on ONE node's recorder (the lowest
        # alive id) but are fleet-scoped — keyed by gid for the rollup
        self.failed_gids: set = set()
        self.rejected_gids: set = set()

    # ---- registry ---------------------------------------------------------- #
    def _get(self, cls, name: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                            f"not {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(Counter, name)

    def merge(self, other: "MetricsHub") -> "MetricsHub":
        """Merge another hub's metric REGISTRY into this one: counters add,
        histograms concatenate samples (percentiles stay exact), gauges sum
        as step functions over the fleet clock. Request lifecycles, header
        and engine summary are NOT merged — rids are per-engine, so
        ``fleet.FleetMetrics`` keeps per-node hubs for request-level
        data and uses this only for the fleet-wide registry rollup."""
        for name, m in other._metrics.items():
            self._get(type(m), name).merge(m)
        return self

    def gauge(self, name: str) -> Gauge:
        return self._get(Gauge, name)

    def histogram(self, name: str) -> Histogram:
        return self._get(Histogram, name)

    # ---- event ingestion --------------------------------------------------- #
    def ingest(self, trace) -> "MetricsHub":
        """Replay a loaded ``trace.Trace`` through ``observe`` (header,
        events, summary) — the offline twin of the live sink path."""
        self.observe(trace.header)
        for ev in trace.events:
            self.observe(ev)
        if trace.summary is not None:
            self.observe(trace.summary)
        return self

    def observe(self, ev: dict) -> None:
        handler = getattr(self, f"_on_{ev['type']}", None)
        if handler is not None:
            handler(ev)

    def _on_header(self, ev: dict) -> None:
        self.header = ev

    def _on_request(self, ev: dict) -> None:
        step = int(ev["step"])
        arrival = step - int(ev.get("arrival_offset", 0))
        self.requests[ev["rid"]] = RequestLifecycle(
            rid=int(ev["rid"]), arrival=arrival, injected=step,
            prompt_len=int(ev["prompt_len"]), max_new=int(ev["max_new"]),
            gid=int(ev.get("gid", ev["rid"])))
        self.counter("requests_arrived").inc()
        self.histogram("prompt_len").observe(ev["prompt_len"])
        self._queue_depth += 1
        self.gauge("queue_depth").set(step, self._queue_depth)

    def _on_admit(self, ev: dict) -> None:
        step = int(ev["step"])
        for slot, rid, _plen in ev["wave"]:
            lc = self.requests.get(rid)
            if lc is not None:
                lc.admit = step
                lc.slot = int(slot)
                self.histogram("queue_wait_ticks").observe(step - lc.arrival)
            self._slot_rid[int(slot)] = int(rid)
            self._queue_depth -= 1
            self._slots_busy += 1
        self.counter("admission_waves").inc()
        self.gauge("queue_depth").set(step, self._queue_depth)
        self.gauge("slots_busy").set(step, self._slots_busy)

    def _on_prefill(self, ev: dict) -> None:
        step = int(ev["step"])
        chunk, valid = int(ev["chunk"]), int(ev["valid"])
        self.counter("prefill_valid_tokens").inc(valid)
        # computed token slots per dispatch: the packed grid shrinks to the
        # rows used; the unpacked grid is always max_slots rows; a
        # sequential (fallback) event stands for `valid` one-token
        # full-batch dispatches — the same rules engine.prefill_stats uses
        max_slots = int(self.header["serve"]["max_slots"]) if self.header \
            else len(ev["slots"])
        if ev.get("packed", False):
            self.counter("prefill_token_slots").inc(int(ev["rows"]) * chunk)
        elif self.header is not None and \
                self.header["serve"].get("prefill_mode") == "sequential":
            self.counter("prefill_token_slots").inc(max_slots * valid)
        else:
            self.counter("prefill_token_slots").inc(max_slots * chunk)
        if ev.get("fused", False):
            self.counter("fused_prefill_events").inc()
        else:
            self.counter("prefill_dispatches").inc()
        for slot in ev["slots"]:
            rid = self._slot_rid.get(int(slot))
            lc = self.requests.get(rid) if rid is not None else None
            if lc is not None:
                lc.prefill_steps.append(step)

    def _on_decode(self, ev: dict) -> None:
        step = int(ev["step"])
        sid = int(ev.get("superstep_id", -1))
        fused = bool(ev.get("fused", False))
        if fused:
            self.counter("fused_dispatches").inc()
        elif sid < 0:
            self.counter("decode_dispatches").inc()
        elif sid not in self._superstep_ids:
            self._superstep_ids.add(sid)
            self.counter("decode_dispatches").inc()
            self.counter("superstep_spans").inc()
        if sid >= 0:
            self.counter("superstep_rounds").inc()
        self.counter("tokens_generated").inc(len(ev["tokens"]))
        self.histogram("decode_occupancy").observe(ev["occupancy"])
        for rid, _tok in ev["tokens"]:
            lc = self.requests.get(rid)
            if lc is None:
                continue
            if lc.first_token is None:
                lc.first_token = step
                self.histogram("ttft_ticks").observe(step - lc.arrival)
            else:
                self.histogram("tpot_ticks").observe(step - lc.last_token)
            lc.last_token = step
            lc.n_tokens += 1

    def _on_complete(self, ev: dict) -> None:
        step = int(ev["step"])
        rid = int(ev["rid"])
        lc = self.requests.get(rid)
        if lc is not None:
            lc.complete = step
            lc.reason = ev["reason"]
            if lc.slot is not None and self._slot_rid.get(lc.slot) == rid:
                del self._slot_rid[lc.slot]
        self.counter("requests_completed").inc()
        self.counter(f"completed_{ev['reason']}").inc()
        self._slots_busy -= 1
        self.gauge("slots_busy").set(step, self._slots_busy)

    # ---- chaos events (schema v7, chaos) ----------------------------------- #
    def _on_fault(self, ev: dict) -> None:
        kind, phase, step = ev["kind"], ev["phase"], int(ev["step"])
        if phase == "begin":
            self.counter(f"faults_{kind}").inc()
            if kind == "node_crash":
                # the node is gone: its queued/resident load leaves the
                # fleet's merged gauges at the crash tick (the failover
                # re-arrivals re-enter on surviving nodes' hubs)
                self.counter("crash_inflight").inc(int(ev.get("inflight", 0)))
                self._queue_depth = 0
                self._slots_busy = 0
                self.gauge("queue_depth").set(step, 0)
                self.gauge("slots_busy").set(step, 0)
        elif phase == "end" and "since" in ev:
            self.histogram(f"fault_window_{kind}").observe(
                step - int(ev["since"]))

    def _on_recover(self, ev: dict) -> None:
        # fires on the DESTINATION node's hub: failover landed here
        self.counter("requests_recovered").inc()
        self.counter("recovery_reprefill_tokens").inc(
            int(ev["reprefill_tokens"]))
        # schema v8: tokens seeded from a KV snapshot instead of paid for
        # again — reprefill (paid) + restored (saved) = from-zero cost
        self.counter("recovery_restored_tokens").inc(
            int(ev.get("restored_tokens", 0)))
        # downtime = crash tick -> the re-prefill re-entering service; the
        # per-gid MTTR-to-next-token joins this with the new lifecycle
        self.histogram("recovery_downtime_ticks").observe(
            int(ev["step"]) - int(ev["crash_step"]))
        self.histogram("recovery_retries").observe(int(ev["retry"]))

    # ---- snapshot events (schema v8, chaos.snapshots) ---------------------- #
    def _on_snapshot(self, ev: dict) -> None:
        # fires on the EXPORTING node's hub: one KV delta left for the store
        self.counter("snapshot_events").inc()
        self.counter("snapshot_bytes").inc(int(ev["bytes"]))
        self.counter("snapshot_rows").inc(
            int(ev["prefix_len"]) - int(ev.get("base", 0)))

    def _on_restore(self, ev: dict) -> None:
        # fires on the DESTINATION node's hub: a snapshot seeded a slot here
        self.counter("requests_restored").inc()
        self.counter("restore_bytes").inc(int(ev["bytes"]))
        self.histogram("restore_prefix_len").observe(int(ev["prefix_len"]))

    def _on_failed(self, ev: dict) -> None:
        self.counter("requests_failed").inc()
        self.counter(f"failed_{ev['reason']}").inc()
        self.failed_gids.add(int(ev["gid"]))

    def _on_reject(self, ev: dict) -> None:
        self.counter("requests_rejected").inc()
        self.counter(f"rejected_{ev['reason']}").inc()
        self.rejected_gids.add(int(ev["gid"]))

    def _on_summary(self, ev: dict) -> None:
        self.engine_summary = ev

    # ---- derived SLO report ------------------------------------------------ #
    def dispatch_mix(self) -> dict:
        """Event-derived dispatch accounting — same closed forms the
        protocol lint holds the engine's own counters to, so live counters
        and this mix cannot silently diverge."""
        supersteps = self.counter("superstep_spans").value
        return {
            "prefill": self.counter("prefill_dispatches").value,
            "decode": self.counter("decode_dispatches").value,
            "fused": self.counter("fused_dispatches").value,
            "total": (self.counter("prefill_dispatches").value
                      + self.counter("decode_dispatches").value
                      + self.counter("fused_dispatches").value),
            "superstep_spans": supersteps,
            "superstep_rounds": self.counter("superstep_rounds").value,
            # one blocking fetch per plain/fused decode resolve, one per
            # superstep span — i.e. per decode-family dispatch
            "host_syncs": (self.counter("decode_dispatches").value
                           + self.counter("fused_dispatches").value),
        }

    def completed_gids(self) -> set:
        """Global ids of requests that COMPLETED on this node — the
        per-node input to the fleet's exactly-once / goodput rollup."""
        return {lc.gid for lc in self.requests.values()
                if lc.complete is not None and lc.gid is not None}

    def arrived_gids(self) -> set:
        return {lc.gid for lc in self.requests.values()
                if lc.gid is not None}

    def chaos_summary(self) -> Optional[dict]:
        """Per-node chaos report, or None for a fault-free serve."""
        names = [n for n in self._metrics
                 if n.startswith(("faults_", "failed_", "rejected_"))
                 or n in ("requests_recovered", "requests_failed",
                          "requests_rejected", "crash_inflight")]
        if not names:
            return None
        return {
            "faults": {n[len("faults_"):]: self._metrics[n].value
                       for n in names if n.startswith("faults_")},
            "fault_windows": {
                n[len("fault_window_"):]: self._metrics[n].summary()
                for n in self._metrics if n.startswith("fault_window_")},
            "recovered": self.counter("requests_recovered").value,
            "failed": self.counter("requests_failed").value,
            "rejected": self.counter("requests_rejected").value,
            "crash_inflight": self.counter("crash_inflight").value,
            "reprefill_tokens":
                self.counter("recovery_reprefill_tokens").value,
            "recovery_downtime_ticks":
                self.histogram("recovery_downtime_ticks").summary(),
            "snapshots": self.snapshot_summary(),
        }

    def snapshot_summary(self) -> dict:
        """KV-snapshot accounting (all-zero when snapshots are off):
        export volume, restore hit rate over recoveries, and the
        saved-vs-paid re-prefill split (saved = restored from snapshots,
        paid = actually re-prefilled; their sum is the from-zero cost)."""
        recovered = self.counter("requests_recovered").value
        restores = self.counter("requests_restored").value
        return {
            "events": self.counter("snapshot_events").value,
            "bytes": self.counter("snapshot_bytes").value,
            "rows": self.counter("snapshot_rows").value,
            "restores": restores,
            "restore_bytes": self.counter("restore_bytes").value,
            "restore_hit_rate": (restores / recovered if recovered
                                 else 0.0),
            "saved_tokens":
                self.counter("recovery_restored_tokens").value,
            "paid_tokens":
                self.counter("recovery_reprefill_tokens").value,
            "restore_prefix_len":
                self.histogram("restore_prefix_len").summary(),
        }

    def valid_token_fraction(self) -> float:
        slots = self.counter("prefill_token_slots").value
        if not slots:
            return 1.0
        return self.counter("prefill_valid_tokens").value / slots

    def summary(self) -> dict:
        """The JSON-serializable SLO report."""
        serve = dict(self.header.get("serve", {})) if self.header else {}
        return {
            "policy": serve.get("policy"),
            "serve": serve,
            "arch": self.header.get("arch") if self.header else None,
            "requests": {
                "arrived": self.counter("requests_arrived").value,
                "completed": self.counter("requests_completed").value,
                "tokens_generated": self.counter("tokens_generated").value,
                "reasons": {
                    r: self._metrics[f"completed_{r}"].value
                    for r in ("eos", "max_new", "cache_full")
                    if f"completed_{r}" in self._metrics},
            },
            "ttft_ticks": self.histogram("ttft_ticks").summary(),
            "tpot_ticks": self.histogram("tpot_ticks").summary(),
            "queue_wait_ticks": self.histogram("queue_wait_ticks").summary(),
            "queue_depth": self.gauge("queue_depth").to_dict(),
            "slots_busy": self.gauge("slots_busy").to_dict(),
            "decode_occupancy": self.histogram("decode_occupancy").summary(),
            "prompt_len": self.histogram("prompt_len").summary(),
            "valid_token_fraction": self.valid_token_fraction(),
            "dispatch_mix": self.dispatch_mix(),
            "chaos": self.chaos_summary(),
            # per-step-kind mix the scheduler ticked (serialized /
            # overlapped / fused / superstep / ...), when recorded
            "sched_stats": dict(self.engine_summary["sched_stats"])
            if self.engine_summary and "sched_stats" in self.engine_summary
            else None,
            # the engine's own counters, verbatim (cross-checkable against
            # dispatch_mix; the protocol lint enforces agreement)
            "engine": {
                k: self.engine_summary[k]
                for k in ("dispatch_counts", "host_syncs", "prefill_stats",
                          "decode_deferrals", "superstep_tokens")
                if k in self.engine_summary}
            if self.engine_summary else None,
        }

    def to_dict(self) -> dict:
        """Full export: the SLO summary, every registered metric, and every
        request lifecycle."""
        return {
            "summary": self.summary(),
            "metrics": {name: m.to_dict()
                        for name, m in sorted(self._metrics.items())},
            "requests": [self.requests[r].to_dict()
                         for r in sorted(self.requests)],
        }


__all__ = ["Counter", "Gauge", "Histogram", "MetricsHub",
           "RequestLifecycle", "PERCENTILES"]
