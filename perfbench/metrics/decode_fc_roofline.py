"""The decode FCs' share of their roofline: over the traced window's
``ops.fused_matvec`` calls, the sum of max(flops / bf16 peak, bytes / HBM
rate) (x, W and b read once, y written once: the weights once a call,
whatever the launches re-read) over the device time of the kernels each
call launched."""
from perfbench import costs, readings

LAYER, UNIT, BETTER, SOURCE = "kernels", "%", "higher", "device_trace"
MOVES = "output_tok_s"
OPS = ("fused_matvec",)


def cost(call):
    x, w = call["x"], call["w"]
    return costs.matvec_cost(x["shape"][0], x["shape"][1], w["shape"][1],
                             max(x["itemsize"], w["itemsize"]),
                             bias=call.get("bias") is not None)


def read(rec):
    return readings.roofline_pct(rec, "fused_matvec", cost)
