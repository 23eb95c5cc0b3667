"""90th percentile, over every request of the window, of its mean gap
between consecutive tokens (``readings.tpot_s``)."""
from perfbench import readings

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(rec):
    v = readings.p90(readings.tpot_s(rec))
    return None if v is None else 1e3 * v
