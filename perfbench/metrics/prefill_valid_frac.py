"""Valid prompt tokens over the token slots the window's prefill
dispatches computed (the engine's ``prefill_stats``)."""

LAYER, UNIT, BETTER, SOURCE = "scheduler", "%", "higher", "program_counter"
MOVES = "ttft_p90_ms"


def read(rec):
    a, b = rec.counters["before"], rec.counters["after"]
    slots = b["token_slots"] - a["token_slots"]
    if not slots:
        return None
    return 100.0 * (b["valid_tokens"] - a["valid_tokens"]) / slots
