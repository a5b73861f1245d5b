"""The global blocks' attention's share of its roofline, %: the least time
a batch's global attention takes on the card (the larger of its bytes over
the memory rate and its FLOPs over the bf16 rate; families/vitdet.py
global_attn_bytes and global_attn_flops, counted from the shapes: the
published attention's own work, not the widened q and k) over the stream
time a batch of the program's spans "vit/global_attn" (as
vit_global_attn_ms.count reads it). None where no span was recorded."""

from yogo_bench import peaks
from yogo_bench.families.vitdet import global_attn_bytes, global_attn_flops
from yogo_bench.program import _tracing


def read(ctx):
    tracing, c = _tracing(), ctx["counters"]
    s = tracing.stats().get("vit/global_attn") if tracing else None
    mem, fl = peaks.rate(peaks.MEM_RATE, ctx["card"]), peaks.rate(peaks.BF16_RATE, ctx["card"])
    if not s or not s["stream_s"] or not c["batches"] or mem is None or fl is None:
        return None
    bound = max(global_attn_bytes(ctx["cfg"], c["batch"]) / mem, global_attn_flops(ctx["cfg"], c["batch"]) / fl)
    return 100.0 * bound / (s["stream_s"] / c["batches"])
