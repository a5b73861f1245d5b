"""Device-to-host syncs a call of the program's NMS fixed-point loop
(ops/nms.py: one a convergence test): the window's counters
nms_host_syncs over nms_calls. From the program's record
(yogo_bench/program.py); None where it has nothing for it."""

from yogo_bench.program import ratio


def read(ctx):
    return ratio("nms_host_syncs", "nms_calls")
