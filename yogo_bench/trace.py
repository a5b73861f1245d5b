"""The traced run: torch.profiler over the measured window, and the
reduction of its trace to what the per-layer readers read.

The benchmark's own spans are `record_function` ranges named "bench/...",
around its calls into the program; "bench/window" spans the whole window.
A device operation (kernel, copy or memset) belongs to the span that was
open on the host thread when the program launched it: the launch is the
runtime call that carries the operation's correlation id. An operation
launched by a thread with no spans of its own (autograd runs the backward
on a thread of its own) belongs to the span the main thread, the one that
opened "bench/window", had open at the launch; host-to-device copies that
such a thread starts (a prefetcher's) belong to none.

The record (`summarize`):
  window_s   length of "bench/window"
  busy_s     length of the union of device operations' intervals inside it
             (operations that overlap count once)
  kernels    {name: [launches, seconds]} in the window
  memcpy     {"HtoD" | "DtoH" | "DtoD" | ...: seconds}
  spans      {name: {"count": host spans, "device_s": device seconds launched in them}}
  breakdown  {"device_ops": 10 longest by total time, "idle_gaps": the idle
             time on the device summed by what the host was doing when each
             gap began, 10 largest} as [name, seconds]
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench/window"


def span(name: str, on: bool = True):
    """A "bench/<name>" span when tracing, else nothing."""
    return torch.profiler.record_function(f"bench/{name}") if on else contextlib.nullcontext()


class Tracer:
    """torch.profiler over CPU and CUDA activity, started and stopped
    around the window; `record()` reduces the trace."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                            record_shapes=False, with_stack=False)

    def __enter__(self) -> "Tracer":
        self.prof.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self.prof.__exit__(*exc)

    def record(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return summarize(events)


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


class _Stab:
    """The innermost interval containing a time, over intervals that nest
    (one host thread's spans and ops)."""

    def __init__(self, items: List[tuple]):
        self.items = sorted(items)  # (start, end, name)
        self.starts = [x[0] for x in self.items]

    def at(self, t: float, max_back: int = 4096) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(-1, i - max_back), -1):
            s, e, name = self.items[j]
            if e > t:
                return name
        return None


def summarize(events: List[dict]) -> dict:
    wins = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not wins:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    win = max(wins, key=lambda e: e["dur"])
    w0, w1 = win["ts"], win["ts"] + win["dur"]

    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e.get("dur", 0) > w0]
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launches[c] = (e["tid"], e["ts"])

    bench_spans = defaultdict(list)
    host = defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in HOST_CATS:
            continue
        item = (e["ts"], e["ts"] + e.get("dur", 0), e["name"])
        host[e["tid"]].append(item)
        if e["name"].startswith("bench/") and e["name"] != WINDOW:
            bench_spans[e["tid"]].append(item)
    span_stab = {tid: _Stab(v) for tid, v in bench_spans.items()}
    main_spans = span_stab.get(win["tid"])

    kernels: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    memcpy: Dict[str, float] = defaultdict(float)
    spans: Dict[str, dict] = {}
    for tid, items in bench_spans.items():
        for s, e, name in items:
            if w0 <= s < w1:
                spans.setdefault(name, {"count": 0, "device_s": 0.0})["count"] += 1
    intervals = []
    for e in dev:
        a, b = max(e["ts"], w0), min(e["ts"] + e.get("dur", 0), w1)
        sec = (b - a) * 1e-6
        intervals.append((a, b))
        name = e["name"]
        if e["cat"] == "gpu_memcpy":
            kind = name.split()[1] if name.startswith("Memcpy ") and len(name.split()) > 1 else name
            memcpy[kind] += sec
        kernels[name][0] += 1
        kernels[name][1] += sec
        launch = launches.get((e.get("args") or {}).get("correlation"))
        owner = None
        if launch is not None:
            tid, ts = launch
            if tid in span_stab:
                owner = span_stab[tid].at(ts)
            elif main_spans is not None and not name.startswith("Memcpy HtoD"):
                # launched by a thread without spans of its own (autograd's
                # backward thread): the span the main thread had open then
                owner = main_spans.at(ts)
        if owner is not None:
            spans.setdefault(owner, {"count": 0, "device_s": 0.0})["device_s"] += sec

    busy = _union(intervals)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))

    main = _Stab(host.get(win["tid"], []))
    others = _Stab([x for tid, items in host.items() if tid != win["tid"] for x in items])
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        op = main.at(a)
        where = main_spans.at(a) if main_spans else None
        if op is None or op == WINDOW:
            op = others.at(a) or "no host op"
        label = op if where is None or where == op else f"{where}:{op}"
        idle[label] += (b - a) * 1e-6

    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "kernels": {k: list(v) for k, v in kernels.items()},
        "memcpy": dict(memcpy),
        "spans": spans,
        "breakdown": {
            "device_ops": [[k, v[1]] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


def kernel_seconds(rec: dict, part: str) -> Iterator[tuple]:
    """(launches, seconds) of every kernel whose name contains `part`."""
    for name, (n, s) in rec["kernels"].items():
        if part in name:
            yield n, s
