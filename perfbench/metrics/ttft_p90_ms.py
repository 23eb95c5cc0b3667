"""90th percentile, over every request of the window, of its first token's
return less its submit (a request still waiting: the close less its
submit)."""
from perfbench import readings

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"


def read(rec):
    v = readings.p90(readings.ttft_s(rec))
    return None if v is None else 1e3 * v
