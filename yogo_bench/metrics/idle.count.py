"""Share of the traced window in which no operation ran on the device, %
(the union of the operations' intervals, not their sum)."""


def read(ctx):
    r = ctx["trace"]
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"]) if r["window_s"] else None
