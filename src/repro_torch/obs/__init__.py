"""obs — serving observability of the port: metrics, SLO summaries,
timelines (the port's own copy of ``repro/obs``).

Host-side only, by construction: everything in this package consumes the
event dicts a ``trace.TraceRecorder`` emits (live, via ``sinks=``) or a
recorded ``trace.Trace`` (offline) — never engine or device state — so
metrics collection adds ZERO dispatches and ZERO host syncs to a serve.
Metrics on and metrics off issue the same dispatches and host syncs.

  metrics   ``MetricsHub``: counter/gauge/histogram registry, per-request
            lifecycle timelines (arrival -> admit -> prefill chunks ->
            first token -> per-token decode -> completion), and the derived
            SLO summary (p50/p95/p99 TTFT & TPOT in engine-clock ticks,
            queue depth, slot occupancy, valid-token fraction, dispatch
            mix) — JSON-serializable.
  timeline  Chrome/Perfetto trace-event export: dispatch spans (fused
            pairs as one slice, supersteps as nested round slices),
            async-fetch flows, per-slot request lanes, queue-depth
            counters, and simulator-replay NPU/PIM stream spans, into one
            ``trace.json``.

The launchers write both: ``launch.serve --metrics-out/--timeline-out``
for one engine, ``launch.fleet`` for a fleet.
"""
from repro_torch.obs.metrics import (PERCENTILES, Counter, Gauge,
                                     Histogram, MetricsHub,
                                     RequestLifecycle)
from repro_torch.obs.timeline import (NODE_PID_STRIDE, PID_ENGINE,
                                      PID_FLEET, PID_SIM, PID_SLOTS, TICK_US,
                                      dispatch_slices, engine_events,
                                      fleet_events, fleet_node_pids,
                                      sim_events, write_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsHub", "PERCENTILES",
    "RequestLifecycle",
    "NODE_PID_STRIDE", "PID_ENGINE", "PID_FLEET", "PID_SIM", "PID_SLOTS",
    "TICK_US", "dispatch_slices", "engine_events", "fleet_events",
    "fleet_node_pids", "sim_events", "write_chrome_trace",
]
