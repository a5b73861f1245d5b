"""Host time a batch in the program's span "to_device"
(Predictor.to_device: the frames' copy from pageable host memory, which
holds the calling thread until it is done), ms. From the program's
record (yogo_bench/program.py); None where it has nothing for it."""

from yogo_bench.program import span_ms


def read(ctx):
    return span_ms("to_device", "host_s")
