"""Workload-trace subsystem: capture -> lower -> replay.

  capture — ``TraceRecorder`` attached to a ServeEngine records every
            request / admission / prefill dispatch / decode step /
            completion, serializable to versioned JSONL (schema.py).
  lower   — ``trace_to_commands`` turns each recorded dispatch into the PAS
            command stream (Algorithm 1 + §5.3 MHA mapping) for that batch
            state.
  replay  — ``TraceReplayer`` drives ``sim.Simulator`` over the lowered
            stream: Fig. 10-style breakdowns + live-vs-offline routing
            divergence for a *served* workload. Overlapped steps (schema
            v2: an interleaved prefill chunk riding a decode dispatch)
            replay as ONE merged command DAG; ``cross_step=True`` chains
            the whole trace with next-step weight prefetch.

``arrivals`` provides Poisson/bursty open-loop load generators and the
``drive`` loop so traces with realistic queueing exist without real traffic.

The port's own copy of ``repro.trace``: a trace the port records on the
card lowers and replays here as the reference's would. A replay's times
are the simulated machine's (IANUS, NPU-MEM), never the card's.
"""
from repro_torch.trace.arrivals import (
    ArrivalEvent,
    LengthDistribution,
    bursty_arrivals,
    drive,
    lengths_from_file,
    poisson_arrivals,
)
from repro_torch.trace.lower import (
    LoweredStep,
    divergence_report,
    group_dispatch_spans,
    group_overlapped,
    trace_to_commands,
)
from repro_torch.trace.recorder import TraceRecorder
from repro_torch.trace.replay import ReplayResult, TraceReplayer, baseline_comparison
from repro_torch.trace.schema import (
    SCHEMA_VERSION,
    SUPPORTED_VERSIONS,
    Trace,
    TraceSchemaError,
    model_config_from_header,
    upgrade_event,
    validate_event,
)

__all__ = [
    "ArrivalEvent", "LengthDistribution", "bursty_arrivals", "drive",
    "lengths_from_file", "poisson_arrivals",
    "LoweredStep", "divergence_report", "group_dispatch_spans",
    "group_overlapped", "trace_to_commands",
    "TraceRecorder",
    "ReplayResult", "TraceReplayer", "baseline_comparison",
    "SCHEMA_VERSION", "SUPPORTED_VERSIONS", "Trace", "TraceSchemaError",
    "model_config_from_header", "upgrade_event", "validate_event",
]
