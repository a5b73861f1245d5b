"""Device time of host-to-device copies a batch, ms (the frames' upload in
Predictor.to_device; the count's small mask copy rides along)."""


def read(ctx):
    rec, n = ctx["trace"], ctx["counters"]["batches"]
    s = rec["memcpy"].get("HtoD")
    return 1e3 * s / n if s and n else None
