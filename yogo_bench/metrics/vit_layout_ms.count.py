"""Stream time a batch of the program's spans "vit/layout" (models/yogo.py
ViTBlock, in a window block: the attention LayerNorm storing into the
padded windows, and the merge of the projected windows into the residual
add; two spans a window block, 16 a ViTDet-B forward), ms: each span from
a CUDA event on the block's stream at its entry to one at its exit,
summed over the window and divided by the window's batches. From the
program's record (yogo_bench/program.py); None where it has nothing for
it."""

from yogo_bench.program import _tracing


def read(ctx):
    tracing, n = _tracing(), ctx["counters"]["batches"]
    s = tracing.stats().get("vit/layout") if tracing else None
    return 1e3 * s["stream_s"] / n if s and s["stream_s"] and n else None
