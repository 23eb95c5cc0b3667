"""Generated tokens delivered to the clients in the window, per second."""
from perfbench import readings

UNIT, BETTER, SOURCE = "tokens/s", "higher", "host_clock"


def read(rec):
    return readings.tokens_in_window(rec) / rec.window_s
