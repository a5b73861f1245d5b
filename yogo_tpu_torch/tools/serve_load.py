"""Closed-loop load for `serve`: client threads in processes of their own
stream raw frames at a running server (one frame a request, or batch
requests of several), each thread with its own ServeClient, and check every
answer against the one expected for its frame.

The client processes import only the standard library, numpy and
serve_client.py, and do not share the server's interpreter lock: what is
measured is the server, loaded as camera machines would load it.
`measure(...)` streams the load and reads the server over one window of
it: the rates from the server's /metrics at the window's ends, the latency
percentiles from the requests that ended inside the same window, and a
caller's own actions (a hot reload half-way, a profiler window after it)
timed against the clients. chip_smoke.py and tools/serve_profile.py both
measure through it. `start(...)` alone starts the clients; they begin
streaming at `Load.t_start` (epoch seconds) and `Load.result()` waits for
them.

    python -m yogo_tpu_torch.tools.serve_load --port P --frames f.npy \\
        [--want w.json] --threads 16 --start-at T --seconds 10 [--frames-per-request 1]

runs one client process and prints {"requests": [[end (epoch s), latency
(s)], ...], "errors": [...]}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

PROCESSES = 4  # client processes a load is spread over
STARTUP_S = 5.0  # from start() to the first request: the processes start and connect
SETTLE_S = 0.5  # from the first request to a measured window, and from its end to the last


def run_clients(port: int, frames: Sequence[np.ndarray], want: Optional[Sequence[dict]],
                n_threads: int, start_at: float, seconds: float, first: int = 0,
                frames_per_request: int = 1):
    """n_threads clients from `start_at` (epoch seconds) for `seconds`, each
    request carrying `frames_per_request` frames; returns ([end (epoch
    seconds), latency (seconds)] of each request, errors)."""
    from yogo_tpu_torch.serve_client import ServeClient

    lat: List[List[float]] = []
    errors: List[str] = []
    lock = threading.Lock()

    def loop(t: int):
        try:
            with ServeClient("127.0.0.1", port, timeout=120) as c:
                time.sleep(max(0.0, start_at - time.time()))
                i = t
                while time.time() < start_at + seconds:
                    fs = [(i + j) % len(frames) for j in range(frames_per_request)]
                    t0 = time.perf_counter()
                    rs = c.predict_many(np.stack([frames[f] for f in fs]))
                    dt = time.perf_counter() - t0
                    with lock:
                        lat.append([time.time(), dt])
                        for f, r in zip(fs, rs):
                            if want is not None and r != want[f]:
                                errors.append(f"client {t}: frame {f} answered differently")
                    i += frames_per_request
        except Exception as e:  # every failure of a client counts
            with lock:
                errors.append(f"client {t}: {e!r}")

    threads = [threading.Thread(target=loop, args=(first + t,), daemon=True) for t in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=max(0.0, start_at - time.time()) + seconds + 150)
        if th.is_alive():
            errors.append("a client thread did not stop")
    return lat, errors


class Load:
    """Client processes streaming at a server; result() waits for them."""

    def __init__(self, procs, t_start: float, seconds: float, tmp):
        self.procs, self.t_start, self.seconds, self._tmp = procs, t_start, seconds, tmp

    def result(self) -> Dict[str, list]:
        """{"requests": [[end, latency], ...] in order of end, "errors"}."""
        lat, errors = [], []
        try:
            for p in self.procs:
                timeout = max(0.0, self.t_start - time.time()) + self.seconds + 200
                out, err = p.communicate(timeout=timeout)
                if p.returncode != 0:
                    errors.append(f"client process exited {p.returncode}: {err[-2000:]}")
                    continue
                part = json.loads(out.strip().splitlines()[-1])
                lat += part["requests"]
                errors += part["errors"]
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
            self._tmp.cleanup()
        return {"requests": sorted(lat), "errors": errors}


def start(port: int, frames: Sequence[np.ndarray], want: Optional[Sequence[dict]], *,
          threads: int, seconds: float, frames_per_request: int = 1) -> Load:
    """Start `threads` clients spread over PROCESSES processes; they stream
    from now + STARTUP_S for `seconds`. `want[i]` is the answer expected
    for frames[i] (None checks nothing)."""
    processes = max(1, min(PROCESSES, threads))
    tmp = tempfile.TemporaryDirectory()
    np.save(Path(tmp.name) / "frames.npy", np.stack(frames))
    argv = ["--port", str(port), "--frames", str(Path(tmp.name) / "frames.npy")]
    if want is not None:
        (Path(tmp.name) / "want.json").write_text(json.dumps(list(want)))
        argv += ["--want", str(Path(tmp.name) / "want.json")]
    t_start = time.time() + STARTUP_S
    argv += ["--start-at", repr(t_start), "--seconds", repr(seconds),
             "--frames-per-request", str(frames_per_request)]
    split = [threads // processes + (p < threads % processes) for p in range(processes)]
    root = Path(__file__).resolve().parents[2]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "yogo_tpu_torch.tools.serve_load", *argv,
             "--threads", str(n), "--first", str(sum(split[:i]))],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i, n in enumerate(split)
    ]
    return Load(procs, t_start, seconds, tmp)


def measure(port: int, frames: Sequence[np.ndarray], want: Optional[Sequence[dict]], *,
            threads: int, seconds: float, frames_per_request: int = 1,
            midway: Optional[Callable[[], Any]] = None, after: Optional[Callable[[], Any]] = None,
            after_s: float = 0.0) -> Dict[str, Any]:
    """Stream `threads` clients at the server on `port` and measure a
    window of `seconds` that starts SETTLE_S after their first request.
    `midway()` runs half-way through the window and `after()` just after
    it, while the clients stream on for `after_s` more; their return values
    come back under "midway" and "after". Requests/s, images/s, batches,
    occupancy, fallbacks and the server's mean timers are differences of
    /metrics over the window; the latency percentiles are those of the
    requests that ended in it. "errors" lists every failed or unexpected
    answer of the whole run (`want[i]` is frame i's answer; None checks
    nothing)."""
    from yogo_tpu_torch.serve_client import ServeClient

    load = start(port, frames, want, threads=threads, frames_per_request=frames_per_request,
                 seconds=seconds + after_s + 2 * SETTLE_S)
    out: Dict[str, Any] = {"client_threads": threads, "client_processes": len(load.procs),
                           "frames_per_request": frames_per_request}
    try:
        with ServeClient("127.0.0.1", port, timeout=120) as c:
            time.sleep(max(0.0, load.t_start + SETTLE_S - time.time()))
            m0, w0, t0 = c.metrics(), time.time(), time.perf_counter()
            if midway is not None:
                time.sleep(seconds / 2)
                out["midway"] = midway()
            time.sleep(max(0.0, seconds - (time.perf_counter() - t0)))
            m1, w1, window = c.metrics(), time.time(), time.perf_counter() - t0
            if after is not None:
                out["after"] = after()
    finally:
        res = load.result()
    ms = sorted(1e3 * dt for end, dt in res["requests"] if w0 <= end <= w1)
    d = {key: m1[key] - m0[key] for key in ("requests", "images", "batches", "full_fetch_fallbacks")}

    def window_mean(key, count):  # a mean timer of /metrics over the window alone
        n = m1[count] - m0[count]
        return (m1[key] * m1[count] - m0[key] * m0[count]) / n if n else None

    out.update({
        "window_s": window, "requests_all_run": len(res["requests"]), "errors": res["errors"],
        "requests_per_s": d["requests"] / window, "images_per_s": d["images"] / window,
        "requests_in_window": len(ms),
        "latency_ms_p50": ms[len(ms) // 2] if ms else None,
        "latency_ms_p99": ms[min(len(ms) - 1, int(0.99 * len(ms)))] if ms else None,
        "mean_batch_occupancy": d["images"] / max(d["batches"], 1), "batches": d["batches"],
        "fallbacks": d["full_fetch_fallbacks"],
        "mean_queue_wait_ms": window_mean("mean_queue_wait_ms", "images"),
        "mean_enqueue_ms": window_mean("mean_enqueue_ms", "batches"),
        "mean_dispatch_ms": window_mean("mean_dispatch_ms", "batches"),
        "mean_format_ms": window_mean("mean_format_ms", "images"),
        "mean_request_ms": window_mean("mean_request_ms", "requests"),
    })
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--frames", type=Path, required=True, help=".npy of (N, C, H, W) uint8 frames")
    p.add_argument("--want", type=Path, default=None, help="JSON list of the answer to each frame")
    p.add_argument("--threads", type=int, default=16)
    p.add_argument("--first", type=int, default=0, help="index of this process's first client")
    p.add_argument("--start-at", type=float, default=None, help="epoch seconds (default: now)")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--frames-per-request", type=int, default=1)
    a = p.parse_args(argv)
    frames = list(np.load(a.frames))
    want = json.loads(a.want.read_text()) if a.want else None
    lat, errors = run_clients(a.port, frames, want, a.threads,
                              a.start_at if a.start_at is not None else time.time(), a.seconds, a.first,
                              a.frames_per_request)
    print(json.dumps({"requests": lat, "errors": errors}))


if __name__ == "__main__":
    main()
