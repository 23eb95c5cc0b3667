"""Workload traces of the port: the open-loop arrival processes and their
driver, the versioned JSONL schema and the ``TraceRecorder`` that captures
a serve (the port's own copies of ``repro.trace``'s arrivals, schema and
recorder). Lowering to PAS commands and the simulator replay stay with the
reference for now."""
from repro_torch.trace.arrivals import (ArrivalEvent, LengthDistribution,
                                        bursty_arrivals, drive,
                                        lengths_from_file, poisson_arrivals)
from repro_torch.trace.recorder import TraceRecorder
from repro_torch.trace.schema import (SCHEMA_VERSION, SUPPORTED_VERSIONS,
                                      Trace, TraceSchemaError,
                                      model_config_from_header,
                                      upgrade_event, validate_event)

__all__ = ["ArrivalEvent", "LengthDistribution", "bursty_arrivals", "drive",
           "lengths_from_file", "poisson_arrivals", "TraceRecorder",
           "SCHEMA_VERSION", "SUPPORTED_VERSIONS", "Trace",
           "TraceSchemaError", "model_config_from_header", "upgrade_event",
           "validate_event"]
