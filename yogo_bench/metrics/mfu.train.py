"""The whole training step's share of the card's bf16 dense peak, %:
3 x the forward's model FLOPs (forward, and the backward's two products)
a trained image, times the images stepped in the traced window over the
window, divided by the peak."""

from yogo_bench import flops, peaks


def read(ctx):
    c, out = ctx["counters"], ctx["out"]
    peak = peaks.rate(peaks.BF16_RATE, ctx["card"])
    if not c["images"] or peak is None:
        return None
    rate = 3 * flops.flops_per_image(ctx["cfg"]) * c["images"] / out["elapsed_s"]
    return 100.0 * rate / peak
