"""Host wall time of the window's steps that carried a prefill chunk, over
the thousands of prompt tokens those chunks carried."""
from perfbench import readings

LAYER, UNIT, BETTER, SOURCE = "engine", "ms/ktok", "lower", "host_clock"
MOVES = "ttft_p90_ms"


def read(rec):
    steps = [s for s in readings.window_steps(rec)
             if s.kind in readings.PREFILL_KINDS]
    tokens = sum(s.prefill_tokens for s in steps)
    if not tokens:
        return None
    return 1e3 * sum(s.end - s.start for s in steps) / (tokens / 1e3)
