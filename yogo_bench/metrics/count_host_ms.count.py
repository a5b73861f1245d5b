"""Host time a batch in the program's span "count" (Predictor.count: the
mask's copy, top-K, decode, NMS and its host syncs, the histogram), ms;
the wait for the forward's work to drain shows here. From the program's
record (yogo_bench/program.py); None where it has nothing for it."""

from yogo_bench.program import span_ms


def read(ctx):
    return span_ms("count", "host_s")
