"""The window attention's share of its roofline, %: the least time a
batch's attention takes on the card (the larger of its bytes over the
memory rate and its FLOPs over the bf16 rate; families/swin.py
attn_bytes and attn_flops, counted from the shapes) over the stream time
a batch of the program's spans "swin/attn" (as win_attn_ms.count reads
it). None where no span was recorded."""

from yogo_bench import peaks
from yogo_bench.families.swin import attn_bytes, attn_flops
from yogo_bench.program import _tracing


def read(ctx):
    tracing, c = _tracing(), ctx["counters"]
    s = tracing.stats().get("swin/attn") if tracing else None
    mem, fl = peaks.rate(peaks.MEM_RATE, ctx["card"]), peaks.rate(peaks.BF16_RATE, ctx["card"])
    if not s or not s["stream_s"] or not c["batches"] or mem is None or fl is None:
        return None
    bound = max(attn_bytes(ctx["cfg"], c["batch"]) / mem, attn_flops(ctx["cfg"], c["batch"]) / fl)
    return 100.0 * bound / (s["stream_s"] / c["batches"])
