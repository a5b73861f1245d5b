"""Stream time a batch of the program's span "count" (Predictor.count), ms:
from a CUDA event on the head's stream at its entry to one at its exit,
so the count's device work and the idle gaps its host syncs open. From
the program's record (yogo_bench/program.py); None where it has nothing
for it."""

from yogo_bench.program import span_ms


def read(ctx):
    return span_ms("count", "stream_s")
