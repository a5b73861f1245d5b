"""The port's own spans and counters.

`span(name, device=None)` marks a phase of the program (a `with` block).
With no profiler active, the normal case, it costs one check of
`torch.autograd._profiler_enabled()` and records nothing. Under
torch.profiler it opens `record_function("yogo/<name>")`, which puts the
span in the profiler's trace beside the device's activity, and adds the
span to an in-memory record: the number of spans of each name, their host
seconds and, for spans given a CUDA device, their stream seconds, the time
between CUDA events recorded on the device's current stream at entry and
at exit (the span's device work and the idle gaps inside it). The events
are resolved when the record is read (`stats()`). So the record covers
exactly the profiled stretches of the process since the last `reset()`;
it is shared by the process's threads. torch.profiler sees the thread
that started it and the threads that inherit its state (autograd's
backward): a span on another thread (a prefetcher's, a server's worker)
records nothing, as the profiler records nothing there.

`COUNTS` holds the program's counters, always on and cumulative; `add`
bumps them under a lock, and while a profiler is active also the
window's counters that `counts()` returns.

    <name>_kernel_launches  launches of csrc/<name>.cu (kernels.launch; 0 on the CPU):
        stem_nhwc, stem_nchw   the stem per layout (ops/stem.py): one an inference
                               forward of a conv stack on the card
        int8_conv              int8 convs (ops/int8_conv.py): 3 an int8 base_model
                               batch, 71 a ConvNeXt-Small one
        nms                    NMS resolves on the card (ops/nms.py): one a count
        layer_norm             inference LayerNorms on the card (ops/layer_norm.py):
                               40 a ConvNeXt-Small forward and 53 a Swin-S one
    <name>_kernel_builds    nvcc runs of csrc/<name>.cu or of a variant of it
                            (kernels.nvcc)
    nms_calls            NMS resolves (ops/nms.py), on either path
    nms_rounds           keep updates of the fixed-point loop (the plain version)
    nms_host_syncs       device-to-host syncs of that loop (one a convergence test)
    swin_windows         windows x heads attended by Swin blocks (models/yogo.py
                         SwinBlock), summed over a forward's blocks and images
    swin_pad_tokens      tokens a Swin block pads its map with to whole windows,
                         computes and then crops, over its blocks and images

The Swin trunk's spans, each with its device: "swin/attn" (the window
attention: q, k, v in, the attended values out; one a block) and
"swin/layout" (pad, roll and window partition before the qkv Dense;
window reverse, unroll and crop after the projection; two a block).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import Counter
from typing import Dict, List

import torch

COUNTS: Counter = Counter()

_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_record: Dict[str, list] = {}  # name -> [spans, host seconds, stream seconds or None]
_pending: List[tuple] = []  # (name, start event, end event), unresolved
_window: Counter = Counter()  # COUNTS' deltas while a profiler is active


def add(**deltas: int) -> None:
    """Add to `COUNTS`, and to the window's counters under a profiler (a
    read-modify-write, so under the lock)."""
    profiled = torch.autograd._profiler_enabled()
    with _lock:
        COUNTS.update(deltas)
        if profiled:
            _window.update(deltas)


class _Span:
    __slots__ = ("name", "stream", "rf", "t0", "start")

    def __init__(self, name: str, device):
        self.name = name
        self.stream = None
        if device is not None and torch.device(device).type == "cuda":
            self.stream = torch.cuda.current_stream(device)

    def __enter__(self) -> None:
        self.rf = torch.profiler.record_function(f"yogo/{self.name}")
        self.rf.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        host_s = time.perf_counter() - self.t0
        end = None
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
        self.rf.__exit__(*exc)
        with _lock:
            rec = _record.setdefault(self.name, [0, 0.0, None])
            rec[0] += 1
            rec[1] += host_s
            if end is not None:
                _pending.append((self.name, self.start, end))
        return False


def span(name: str, device=None):
    """A context manager: the span "yogo/<name>" while a profiler is
    active, else nothing. `device` (a CUDA device) adds the stream time of
    its current stream."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name, device)


def stats() -> Dict[str, dict]:
    """{name: {"count", "host_s", "stream_s"}} of the spans recorded since
    the last reset(); stream_s is None for a name whose spans had no CUDA
    device. Waits for the recorded events."""
    with _lock:
        for name, start, end in _pending:
            end.synchronize()
            rec = _record[name]
            rec[2] = (rec[2] or 0.0) + start.elapsed_time(end) / 1e3
        _pending.clear()
        return {k: {"count": n, "host_s": h, "stream_s": s} for k, (n, h, s) in _record.items()}


def counts() -> Dict[str, int]:
    """The counters added while a profiler was active, since the last
    reset()."""
    with _lock:
        return dict(_window)


def reset() -> None:
    """Forget the recorded spans and the window's counters (COUNTS stay)."""
    with _lock:
        _record.clear()
        _pending.clear()
        _window.clear()

