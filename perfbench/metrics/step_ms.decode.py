"""Host wall time of the window's pure-decode steps (decode-only steps and
supersteps) over the decode rounds they ran."""
from perfbench import readings

LAYER, UNIT, BETTER, SOURCE = "engine", "ms", "lower", "host_clock"
MOVES = "tpot_p90_ms"
KINDS = ("decode_only", "superstep")


def read(rec):
    steps = [s for s in readings.window_steps(rec) if s.kind in KINDS]
    rounds = sum(s.rounds for s in steps)
    if not rounds:
        return None
    return 1e3 * sum(s.end - s.start for s in steps) / rounds
