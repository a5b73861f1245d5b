"""The open-loop load generator of the serve cells.

A schedule (`schedule`) fixes, from the seed, when each request is due
and which frame it sends: n = rate x seconds requests at sorted uniform
times in [0, seconds) (a Poisson process of that rate, conditioned on its
count, so every seed offers the same number of requests), each a frame
drawn from the pool. Client processes (`client`, apart from the server's
interpreter lock) each take every k-th request and start a thread for
each when it is due, whether or not earlier ones have answered (no cap on
the requests in flight, so a stall of the server does not hold back the
sending), as raw uint8 octet-stream frames over HTTP. A request's latency runs from when it
was due to when its answer arrived, so a stall also delays the requests
queued behind it; how late the sender ran (sent - due) is recorded beside.

This module imports numpy and the standard library only: the clients do
not load torch.
"""

from __future__ import annotations

import http.client
import threading
import time
from typing import List, Tuple

import numpy as np

from yogo_bench import scene

# (request id, due offset s, pool frame index, whether its answer is kept for the check)
Item = Tuple[int, float, int, bool]
# (request id, due, sent, done offsets s, HTTP status; -1: no answer)
Record = Tuple[int, float, float, float, int]
NO_ANSWER = -1


def schedule(seed: int, rate: float, seconds: float, pool: int, keep: int) -> List[Item]:
    """The requests of a window: due times, frames and the ones kept."""
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 3])
    due = np.sort(rng.uniform(0.0, seconds, n))
    frames = rng.integers(0, pool, n)
    kept = set(rng.choice(n, size=min(keep, n), replace=False).tolist())
    return [(i, float(due[i]), int(frames[i]), i in kept) for i in range(n)]


def post(port: int, body: bytes, timeout: float) -> Tuple[int, bytes]:
    """One POST /predict of raw frames; (status, body), (NO_ANSWER, b"")
    when no answer came."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/predict", body, {"Content-Type": "application/octet-stream"})
        r = conn.getresponse()
        return r.status, r.read()
    except (OSError, http.client.HTTPException):
        return NO_ANSWER, b""
    finally:
        conn.close()


def client(conn, port: int, seed: int, hw, blobs, items: List[Item], warmup: int, timeout: float) -> None:
    """A client process: make its frames, send `warmup` requests one after
    another, say ("ready",), wait for ("go", t0) (t0 on the monotonic
    clock, which every process of the machine shares), send each of
    `items` on a thread of its own started when it is due, and answer
    ("done", records, kept bodies)."""
    frames = {f: scene.frame(seed, f, hw, blobs)[0].tobytes() for f in {it[2] for it in items}}
    any_frame = next(iter(frames.values())) if frames else scene.frame(seed, 0, hw, blobs)[0].tobytes()
    for _ in range(warmup):
        post(port, any_frame, timeout)
    conn.send(("ready",))
    _, t0 = conn.recv()
    lock = threading.Lock()
    records: List[Record] = []
    bodies = {}

    def send(rid, due, f, keep):
        sent = time.monotonic() - t0
        status, body = post(port, frames[f], timeout)
        done = time.monotonic() - t0
        with lock:
            records.append((rid, due, sent, done, status))
            if keep and status == 200:
                bodies[rid] = body.decode()

    senders = []
    for rid, due, f, keep in sorted(items, key=lambda it: it[1]):
        delay = t0 + due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        senders.append(threading.Thread(target=send, args=(rid, due, f, keep)))
        senders[-1].start()
    for t in senders:
        t.join()
    conn.send(("done", records, bodies))
    conn.close()


def p95(values: List[float]) -> float:
    """The 95th percentile, nearest rank."""
    v = sorted(values)
    return v[max(0, int(np.ceil(0.95 * len(v))) - 1)]
