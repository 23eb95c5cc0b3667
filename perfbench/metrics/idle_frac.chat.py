"""Share of the traced window in which no kernel, copy or set ran on the
device."""
from perfbench import readings

LAYER, UNIT, BETTER, SOURCE = "device", "%", "lower", "device_trace"
MOVES = "output_tok_s"


def read(rec):
    return readings.idle_pct(rec)
