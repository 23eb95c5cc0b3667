"""The window's model flops (``readings.model_flops``: the frozen count
of each token decoded and each prompt prefilled in it, with the keys it
attended) over the window's seconds times the card's bf16 peak."""
from perfbench import readings

LAYER, UNIT, BETTER, SOURCE = "model step", "%", "higher", "host_clock"
MOVES = "output_tok_s"


def read(rec):
    return 100.0 * readings.model_flops(rec) / (
        rec.window_s * rec.peak["bf16_flops_s"])
