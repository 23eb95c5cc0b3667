"""Process start to the window's open: imports, the weights, the engine,
kernel builds and compiles, and the ramp of the open loop."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(rec):
    return rec.setup_s
