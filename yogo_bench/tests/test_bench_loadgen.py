"""The open-loop schedule and the due-time arithmetic of loadgen.py."""

import json
import multiprocessing
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from yogo_bench import loadgen


@pytest.mark.parametrize("seed", [1, 2**31 + 5, 98765432101])
def test_schedule_is_fixed_by_the_seed_and_offers_the_same_count(seed):
    a = loadgen.schedule(seed, 80.0, 10.0, 256, 16)
    assert a == loadgen.schedule(seed, 80.0, 10.0, 256, 16)
    assert len(a) == 800
    due = [it[1] for it in a]
    assert due == sorted(due) and 0.0 <= due[0] and due[-1] < 10.0
    assert sum(it[3] for it in a) == 16
    assert all(0 <= it[2] < 256 for it in a)
    assert a != loadgen.schedule(seed + 1, 80.0, 10.0, 256, 16)
    gaps = np.diff(due)
    assert 0.6 / 80 < gaps.mean() < 1.4 / 80  # the rate asked for


def test_p95_is_the_nearest_rank():
    assert loadgen.p95(list(range(1, 101))) == 95
    assert loadgen.p95([3.0]) == 3.0
    assert loadgen.p95(list(range(1, 21))) == 19


class _Slow(BaseHTTPRequestHandler):
    delay = 0.2

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(self.delay)
        body = json.dumps({"detections": [], "counts": {}}).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def _drive(items, go_in):
    """Send `items` from a client on a thread to a server that takes 0.2 s
    a request, with the window starting `go_in` s from now; the records
    and kept bodies."""
    server = ThreadingHTTPServer(("127.0.0.1", 0), _Slow)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    try:
        parent, child = multiprocessing.Pipe()
        cl = threading.Thread(target=loadgen.client, daemon=True, args=(
            child, server.server_address[1], 7, (96, 128), (1, 2), items, 0, 10.0))
        cl.start()
        assert parent.poll(30) and parent.recv() == ("ready",)
        parent.send(("go", time.monotonic() + go_in))
        assert parent.poll(30)
        _, records, bodies = parent.recv()
        cl.join(10)
    finally:
        server.shutdown()
        server.server_close()
    assert not cl.is_alive()
    return records, bodies


def test_latency_runs_from_when_a_request_was_due():
    """Requests due 0.3 s before the client could send them (a client
    held up): each one's latency counts the wait from its due time, not
    only from when it was sent."""
    records, bodies = _drive([(0, 0.0, 0, True), (1, 0.0, 1, False), (2, 0.1, 2, False)], -0.3)
    assert [r[4] for r in records] == [200, 200, 200]
    for _, due, sent, done, _ in records:
        assert sent - due >= 0.2 and done - due >= (sent - due) + 0.2
    assert list(bodies) == [0]


def test_requests_are_sent_when_due_however_many_wait():
    """Eight requests due at once to a server that takes 0.2 s each: none
    waits for another's answer before it is sent."""
    records, _ = _drive([(i, 0.0, i, False) for i in range(8)], 0.05)
    assert sorted(r[0] for r in records) == list(range(8))
    assert max(sent - due for _, due, sent, _, _ in records) < 0.15
    assert all(done - due >= 0.2 for _, due, _, done, _ in records)


def test_an_unanswered_request_is_recorded_as_such():
    status, body = loadgen.post(1, b"x", 1.0)  # nothing listens on port 1
    assert status == loadgen.NO_ANSWER and body == b""
