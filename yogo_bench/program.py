"""The readers of the program's own record (yogo_tpu_torch.utils.tracing:
its spans and the counters added while a profiler runs), which covers the
traced window. Each returns None where the record has nothing for it, and
against a program without the module."""


def _tracing():
    try:
        from yogo_tpu_torch.utils import tracing
    except ImportError:  # a program without its own spans and counters
        return None
    return tracing


def span_ms(name, key):
    """Milliseconds of `key` ("host_s" or "stream_s") a span `name`."""
    tracing = _tracing()
    s = tracing.stats().get(name) if tracing else None
    return 1e3 * s[key] / s["count"] if s and s["count"] and s[key] is not None else None


def ratio(num, den):
    """The window's counter `num` over its counter `den`."""
    tracing = _tracing()
    c = tracing.counts() if tracing else {}
    return c.get(num, 0) / c[den] if c.get(den) else None
