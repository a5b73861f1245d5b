"""Host time a step in the program's span "prefetch_wait" (the caller's
wait for data/prefetch.py's thread to hand over the next batch on the
device), ms. From the program's record (yogo_bench/program.py); None
where it has nothing for it."""

from yogo_bench.program import span_ms


def read(ctx):
    return span_ms("prefetch_wait", "host_s")
