"""Device time of the operations launched inside the benchmark's
"bench/step" span (one make_train_step call: flips, forward, loss,
backward, clamp and AdamW), a step, ms."""


def read(ctx):
    s = ctx["trace"]["spans"].get("bench/step")
    return 1e3 * s["device_s"] / s["count"] if s and s["count"] and s["device_s"] else None
