"""The stem kernel's share of its roofline, %: the least time its bytes
take at the card's memory rate (flops.stem_bytes: uint8 frames in, bf16
NHWC out; its FMAs take less) over its mean device time a launch. None
where the stem kernel did not run."""

from yogo_bench import flops, peaks
from yogo_bench.trace import kernel_seconds


def read(ctx):
    n = s = 0
    for k, t in kernel_seconds(ctx["trace"], "stem_kernel"):
        n, s = n + k, s + t
    mem = peaks.rate(peaks.MEM_RATE, ctx["card"])
    if not n or not s or mem is None:
        return None
    bound = flops.stem_bytes(ctx["cfg"], ctx["counters"]["batch"]) / mem
    return 100.0 * bound / (s / n)
