"""Stream time a batch of the program's spans "vit/global_attn"
(models/yogo.py ViTBlock: a global block's attention, q, k and v in and
the attended values out, the rel-pos products and the widened q and k
included; 4 spans a ViTDet-B forward), ms: each span from a CUDA event on
the block's stream at its entry to one at its exit, summed over the
window and divided by the window's batches. From the program's record
(yogo_bench/program.py); None where it has nothing for it."""

from yogo_bench.program import _tracing


def read(ctx):
    tracing, n = _tracing(), ctx["counters"]["batches"]
    s = tracing.stats().get("vit/global_attn") if tracing else None
    return 1e3 * s["stream_s"] / n if s and s["stream_s"] and n else None
