"""Host time a step in the program's span "step" (one make_train_step call:
dispatching the flips, forward, loss, backward, clamp and AdamW), ms.
From the program's record (yogo_bench/program.py); None where it has
nothing for it."""

from yogo_bench.program import span_ms


def read(ctx):
    return span_ms("step", "host_s")
