"""Device time of the operations launched inside the benchmark's
"bench/count" span (Predictor.count: top-K, decode, NMS, histogram), a
batch, ms."""


def read(ctx):
    s = ctx["trace"]["spans"].get("bench/count")
    return 1e3 * s["device_s"] / s["count"] if s and s["count"] and s["device_s"] else None
