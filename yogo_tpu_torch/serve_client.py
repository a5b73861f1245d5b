"""Python client for the `serve` HTTP protocol (copy of
yogo_tpu/serve_client.py; the wire protocol of yogo_tpu_torch/serve.py is
the JAX package's, so either client talks to either server).

The standard library and numpy only: this file goes onto scope machines
that have neither torch nor jax. What it adds over hand-rolled requests:

  - the raw octet-stream wire format (zero encode/decode) with automatic
    chunking of arbitrarily many frames into batch requests of at most
    `max_frames_per_request` (discovered from /healthz);
  - input validation against the server's advertised input_hw BEFORE
    paying the upload;
  - 503 load-shed handling: honors Retry-After with bounded retries, so a
    burst above --max-queue degrades to backoff instead of client errors;
  - one persistent keep-alive connection per client (reconnects on drop).

Usage:
    from yogo_tpu_torch.serve_client import ServeClient
    client = ServeClient("127.0.0.1", 8765)
    result = client.predict(frame)            # (C, H, W) uint8 -> dict
    results = client.predict_many(frames)     # N frames -> list of dicts
    client.close()

Thread safety: one ServeClient per thread (it holds one socket). The
server side coalesces across connections, so N threads with N clients
still share device batches.
"""

from __future__ import annotations

import gzip
import http.client
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["ServeClient", "ServerOverloaded"]


class ServerOverloaded(RuntimeError):
    """The server shed the request (503) and retries were exhausted."""


class ServeClient:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8765,
        *,
        timeout: float = 120.0,
        max_retries: int = 4,
    ):
        self.host, self.port = host, int(port)
        self.timeout = float(timeout)
        self.max_retries = int(max_retries)
        self._conn: Optional[http.client.HTTPConnection] = None
        self.info = self._get("/healthz")
        c, (h, w) = (
            (3 if self.info["rgb"] else 1),
            self.info["input_hw"],
        )
        self.img_chw = (c, int(h), int(w))
        self.max_frames = int(self.info["max_frames_per_request"])

    # ------------------------------------------------------------ transport
    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout
            )
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _request(self, method: str, path: str, body: Optional[bytes],
                 content_type: Optional[str]) -> tuple:
        """One HTTP round trip on the persistent connection; a dropped
        keep-alive socket (server restart, idle LB reset) gets ONE
        transparent reconnect."""
        headers = {"Accept-Encoding": "gzip"}
        if content_type:
            headers["Content-Type"] = content_type
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
                if resp.headers.get("Content-Encoding") == "gzip":
                    payload = gzip.decompress(payload)
                return resp.status, dict(resp.headers), payload
            except TimeoutError:
                # a timeout is NOT a dropped socket: re-sending would make
                # the server process the frames twice, amplifying load
                # exactly when it is saturated
                self.close()
                raise
            except (ConnectionError, http.client.RemoteDisconnected):
                # dropped keep-alive (server restart, idle LB reset):
                # one transparent reconnect
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _get(self, path: str) -> Dict[str, Any]:
        status, _, payload = self._request("GET", path, None, None)
        if status != 200:
            raise RuntimeError(f"GET {path} -> {status}: {payload[:200]!r}")
        return json.loads(payload)

    # ------------------------------------------------------------- protocol
    def metrics(self) -> Dict[str, Any]:
        """The server's /metrics counters (occupancy, queue depth, sheds)."""
        return self._get("/metrics")

    @staticmethod
    def _query(thresholds: Dict[str, float]) -> str:
        if not thresholds:
            return "/predict"
        q = "&".join(f"{k}={float(v)}" for k, v in sorted(thresholds.items()))
        return f"/predict?{q}"

    def _post_group(self, frames: np.ndarray, path: str) -> List[Dict]:
        """POST one batch request (N <= max_frames) with 503 backoff;
        returns the per-frame result dicts."""
        body = frames.tobytes()
        for retry in range(self.max_retries + 1):
            status, headers, payload = self._request(
                "POST", path, body, "application/octet-stream"
            )
            if status == 503 and retry < self.max_retries:
                # the server names its drain horizon; respect it (bounded).
                # Retry-After may be the RFC HTTP-date form behind a
                # proxy - fall back to 1 s rather than crash the backoff
                try:
                    delay = float(headers.get("Retry-After", 1) or 1)
                except (TypeError, ValueError):
                    delay = 1.0
                time.sleep(min(delay, 30.0) * (retry + 1))
                continue
            resp = json.loads(payload)
            if status == 503:
                raise ServerOverloaded(resp.get("error", "overloaded"))
            if status != 200:
                raise RuntimeError(
                    f"POST /predict -> {status}: {resp.get('error', resp)}"
                )
            return (
                resp["results"] if len(frames) > 1 else [resp]
            )
        raise AssertionError("unreachable")

    def _validate(self, frames: Sequence[np.ndarray]) -> np.ndarray:
        arr = np.ascontiguousarray(frames)
        if arr.dtype != np.uint8:
            # an unsafe cast would silently truncate float [0,1] frames
            # to all-black inputs; the server normalizes uint8 itself
            raise ValueError(
                f"frames must be uint8 (raw pixel bytes; the server "
                f"normalizes), got dtype {arr.dtype}"
            )
        if arr.ndim == 3:
            arr = arr[None]
        if arr.ndim != 4 or arr.shape[1:] != self.img_chw:
            raise ValueError(
                f"frames must be (N, {', '.join(map(str, self.img_chw))}) "
                f"uint8 CHW (server input_hw {self.info['input_hw']}), "
                f"got {arr.shape}"
            )
        return arr

    def predict(self, frame: np.ndarray, **thresholds: float) -> Dict:
        """One (C, H, W) uint8 frame -> {"detections": [...], "counts": ...}.
        Keyword thresholds (obj_thresh, iou_thresh,
        min_class_confidence_threshold) override the server defaults for
        this request only."""
        frame = np.asarray(frame)
        if frame.ndim != 3:
            # a 4-D array here would upload N frames and silently return
            # only frame 0's result - that's predict_many's job
            raise ValueError(
                f"predict() takes ONE (C, H, W) frame, got shape "
                f"{frame.shape}; use predict_many() for batches"
            )
        return self.predict_many(frame[None], **thresholds)[0]

    def predict_many(
        self, frames: Sequence[np.ndarray], **thresholds: float
    ) -> List[Dict]:
        """N frames -> N result dicts, in input order. Frames are chunked
        into batch requests of the server's max_frames_per_request: one
        HTTP round trip per chunk, each filling whole device batches."""
        arr = self._validate(frames)
        path = self._query(thresholds)
        out: List[Dict] = []
        for start in range(0, len(arr), self.max_frames):
            out.extend(self._post_group(arr[start:start + self.max_frames],
                                        path))
        return out
