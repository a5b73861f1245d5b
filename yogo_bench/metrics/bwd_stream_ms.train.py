"""Stream time a step of the program's span "step/backward" (the backward
pass), ms: from a CUDA event on the batch's stream at its entry to one
at its exit, so its device work and the idle gaps inside it. From the
program's record (yogo_bench/program.py); None where it has nothing for
it."""

from yogo_bench.program import span_ms


def read(ctx):
    return span_ms("step/backward", "stream_s")
