"""The whole count step's share of the card's bf16 dense peak, %: the
model FLOPs of the images counted in the traced window (flops.py, 2 x MACs
from the configuration's shapes) over the window, divided by the peak."""

from yogo_bench import flops, peaks


def read(ctx):
    c, out = ctx["counters"], ctx["out"]
    peak = peaks.rate(peaks.BF16_RATE, ctx["card"])
    if not c["images"] or peak is None:
        return None
    rate = flops.flops_per_image(ctx["cfg"]) * c["images"] / out["elapsed_s"]
    return 100.0 * rate / peak
