"""Device-to-host syncs a call of the program's NMS (ops/nms.py): the
window's counters nms_host_syncs over nms_calls. On the card the NMS is
one launch of csrc/nms.cu, which syncs nothing, so this reads 0; the
plain path's fixed-point loop syncs once a convergence test. From the
program's record (yogo_bench/program.py); None where it has nothing for
it."""

from yogo_bench.program import ratio


def read(ctx):
    return ratio("nms_host_syncs", "nms_calls")
