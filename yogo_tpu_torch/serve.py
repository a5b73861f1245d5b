"""`python -m yogo_tpu_torch serve`: an HTTP inference server (port of
yogo_tpu/serve.py; the reference ships only batch CLI inference).

  - ONE loaded model, warmed up before the first request (cuDNN's
    algorithm choice, the kernels' build and load happen then, not under a
    request), on one device, or on a grid of devices (parallel/mesh.
    device_grid, as the JAX package's mesh): `--spatial-parallel N` splits
    each frame's rows over N devices (parallel/spatial.py), and
    `--data-parallel` serves one replica a group of N over every visible
    device, each micro-batch split over the replicas (the batch size
    rounded up to a multiple of the group count).
  - MICRO-BATCHING: concurrent requests are coalesced by a collector thread
    into one fixed-shape dispatch (pad + discard, the contract of infer.py);
    `linger_ms` bounds the added latency. A fetcher thread waits for each
    dispatch's results and answers its requests, so batch N+1 is assembled,
    uploaded and enqueued while batch N computes (`pipeline_depth`).
  - On the card each in-flight batch owns a slot of pinned host buffers: the
    frames are assembled into the slot's input buffer and uploaded from it,
    the top-K candidate rows come back into its output buffers, and the
    CUDA events recorded after that copy (one a data group, on its first
    device) are all the fetcher waits for - never a later batch's forward.
    A slot is reused only after its events.
  - stdlib only on the wire (http.server + threading).

Protocol (JSON over HTTP), the JAX package's:
  GET  /healthz  -> {"status": "ok", "model": ..., "classes": [...], ...}
  GET  /metrics  -> batcher counters (JSON; ?format=prometheus for the
                    exposition format)
  POST /predict  -> body = image bytes (PNG/JPEG/TIFF...; decoded by the
                    batch pipeline's read_image); optional query params
                    obj_thresh, iou_thresh, min_class_confidence_threshold.
                    Response: {"detections": [{"class_idx", "class",
                    "objectness", "class_confidence", "bbox_cxcywh",
                    "bbox_xyxy"}...], "counts": {name: n}}
  POST /predict with `Content-Type: application/octet-stream` -> the body
      is N raw uint8 (C, H, W) frames, C-order, at /healthz's input_hw,
      1 <= N <= max_frames_per_request; N frames enter the batcher
      atomically (all or none against --max-queue) and N > 1 answers
      {"results": [per-frame {detections, counts}...]} in input order.

Detections come from the host formatter (ops/postprocess.format_preds), over
the scattered top-K candidates of each image, or over its full decoded slice
when the request's obj_thresh undercuts the K-th candidate: a response equals
format_preds on the full decoded forward of the same pixels, bit for bit.

`--quantize` serves the int8 program (ops/quant.py), calibrated on up to
max(batch_size, 8) images of `--calibration-images`; the server keeps those
batches, and a hot reload recalibrates on them (once, on the first device,
copied to the others). A multi-process server raises: serve splits over
devices in one process.
"""

from __future__ import annotations

import gzip
import io
import json
import math
import queue
import sys
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from yogo_tpu_torch.infer import Predictor, load_model, needs_calibration, quantize_stack
from yogo_tpu_torch.ops.postprocess import _cxcywh_to_xyxy_np, format_preds, scatter_candidates
from yogo_tpu_torch.parallel.distributed import process_shard
from yogo_tpu_torch.parallel.mesh import device_grid, replicate
from yogo_tpu_torch.parallel.spatial import RowSplit
from yogo_tpu_torch.utils.checkpoint import load_any
from yogo_tpu_torch.utils.weights import state_dict_from_flax

# encoded-image uploads are buffered whole before decode; bound the
# allocation (a 772x1032 PNG is < 1 MB; 32 MiB covers any real frame)
_MAX_ENCODED_BODY = 32 * 1024 * 1024


class Overloaded(RuntimeError):
    """Raised by _Batcher.submit_many when the waiting queue is at
    --max-queue: the device is saturated and accepting the frames would
    only grow a backlog of H*W-byte buffers. HTTP maps it to 503 +
    Retry-After."""


class _Gauge:
    """Count of in-flight /predict requests, waitable at shutdown: handler
    threads are daemons (a hung keep-alive client must not block exit), so a
    graceful stop waits, bounded, for the gauge to reach zero."""

    def __init__(self):
        self._n = 0
        self._cond = threading.Condition()

    def __enter__(self):
        with self._cond:
            self._n += 1
        return self

    def __exit__(self, *exc):
        with self._cond:
            self._n -= 1
            if self._n == 0:
                self._cond.notify_all()
        return False

    def wait_zero(self, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._n > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True


class _Batcher:
    """Coalesce single-frame requests into fixed-shape dispatches,
    pipelined over two threads.

    Handler threads submit() frames and block on Futures. The collector
    drains the queue every `linger_s` (at once when a full batch waits) and
    calls `fwd_dispatch(frames)` with the 1..batch_size frames it took; that
    call pads them to the fixed batch, enqueues the device work and returns
    un-fetched handles. The fetcher calls `fwd_fetch(handles)` in FIFO
    order, which waits for that dispatch's results and returns (host
    candidate rows, host cell indices, full-prediction handle); each future
    resolves to (rows[i], idx[i], full, i). `pipeline_depth` bounds the
    dispatched-but-unfetched batches."""

    _SENTINEL = None  # enqueued by the collector on shutdown

    def __init__(self, fwd_dispatch: Callable, fwd_fetch: Callable, batch_size: int,
                 img_chw: Tuple[int, int, int], linger_s: float = 0.005,
                 pipeline_depth: int = 2, max_queue: int = 0):
        self._fwd_dispatch = fwd_dispatch
        self._fwd_fetch = fwd_fetch
        self.batch_size = int(batch_size)
        self.img_chw = tuple(img_chw)
        self.linger_s = float(linger_s)
        # load shedding: cap on frames WAITING for a dispatch (0 = none)
        self.max_queue = int(max_queue)
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        # (frame, future, submit time) of each waiting frame
        self._queue: List[Tuple[np.ndarray, Future, float]] = []
        self._stop = False
        self._inflight: "queue.Queue" = queue.Queue(maxsize=max(1, int(pipeline_depth)))
        self._n_images = 0
        self._n_batches = 0
        self._n_shed = 0
        self._dispatch_s = 0.0
        self._enqueue_s = 0.0
        self._wait_s = 0.0
        self._collector = threading.Thread(target=self._collect, daemon=True)
        self._fetcher = threading.Thread(target=self._fetch, daemon=True)
        self._collector.start()
        self._fetcher.start()

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n_img, n_b = self._n_images, self._n_batches
            disp, enq, wait = self._dispatch_s, self._enqueue_s, self._wait_s
            depth = len(self._queue)
        return {
            "images": n_img,
            "batches": n_b,
            # 1.0 = every dispatch rode alone, batch_size = fully coalesced
            "mean_batch_occupancy": (n_img / n_b) if n_b else 0.0,
            # dispatch to results ready, per batch; under pipelining this
            # includes time overlapped with the previous batch
            "mean_dispatch_ms": (1e3 * disp / n_b) if n_b else 0.0,
            # host time of fwd_dispatch per batch: assembly, upload and the
            # enqueue of forward + selection (the collector's own work)
            "mean_enqueue_ms": (1e3 * enq / n_b) if n_b else 0.0,
            # submit to taken by the collector, per frame
            "mean_queue_wait_ms": (1e3 * wait / n_img) if n_img else 0.0,
            "queue_depth": depth,
            "inflight_batches": self._inflight.qsize(),
            "shed_frames": self._n_shed,
        }

    def submit(self, img: np.ndarray) -> Future:
        return self.submit_many([img])[0]

    def submit_many(self, imgs: List[np.ndarray]) -> List[Future]:
        """Enqueue N frames atomically: all are accepted or the group is
        shed. Futures resolve independently, in input order, possibly
        across several dispatches."""
        for img in imgs:
            if img.shape != self.img_chw:
                raise ValueError(f"image shape {img.shape} != model input {self.img_chw}")
        futs: List[Future] = [Future() for _ in imgs]
        with self._nonempty:
            if self._stop:
                raise RuntimeError("batcher is shut down")
            if self.max_queue and len(self._queue) + len(imgs) > self.max_queue:
                self._n_shed += len(imgs)
                raise Overloaded(
                    f"{len(self._queue)} images already queued "
                    f"(--max-queue {self.max_queue}); retry later"
                )
            now = time.monotonic()
            self._queue.extend((img, fut, now) for img, fut in zip(imgs, futs))
            self._nonempty.notify()
        return futs

    def shutdown(self) -> None:
        with self._nonempty:
            self._stop = True
            self._nonempty.notify()
        self._collector.join(timeout=5)
        if self._collector.is_alive():
            # the collector enqueues the sentinel on its way out; if it hung
            # past the join, enqueue one so the fetcher still ends
            try:
                self._inflight.put_nowait(self._SENTINEL)
            except queue.Full:
                pass
        self._fetcher.join(timeout=5)

    def _collect(self) -> None:
        """Assemble batches and dispatch them; never waits for device
        results (backpressure is the bounded _inflight queue)."""
        while True:
            with self._nonempty:
                while not self._queue and not self._stop:
                    self._nonempty.wait()
                if self._stop and not self._queue:
                    self._inflight.put(self._SENTINEL)
                    return
                # linger on a deadline: every submit() notifies, and a
                # single wait() would dispatch 2-frame batches under load
                deadline = time.monotonic() + self.linger_s
                while len(self._queue) < self.batch_size and not self._stop:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._nonempty.wait(remaining)
                take = self._queue[: self.batch_size]
                del self._queue[: len(take)]
            t0 = time.monotonic()
            try:
                handles = self._fwd_dispatch([im for im, _, _ in take])
            except Exception as e:  # a failure while enqueueing
                for _, fut, _ in take:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            with self._lock:
                self._enqueue_s += time.monotonic() - t0
                self._wait_s += sum(t0 - t for _, _, t in take)
            self._inflight.put((handles, take, t0))  # blocks at pipeline_depth

    def _fetch(self) -> None:
        """Fetch each dispatch's results in FIFO order and resolve its
        futures."""
        while True:
            item = self._inflight.get()
            if item is self._SENTINEL:
                return
            handles, take, t0 = item
            try:
                rows, idx, full = self._fwd_fetch(handles)
                for i, (_, fut, _) in enumerate(take):
                    fut.set_result((rows[i], idx[i], full, i))
            except Exception as e:  # device errors reach every waiter
                for _, fut, _ in take:
                    if not fut.done():
                        fut.set_exception(e)
            with self._lock:
                self._n_images += len(take)
                self._n_batches += 1
                self._dispatch_s += time.monotonic() - t0


class _Slot:
    """Host buffers of one in-flight batch: the input frames and the
    candidate rows / cell indices that come back. Pinned on the card, so
    both copies are asynchronous; plain tensors on the CPU."""

    def __init__(self, batch_size: int, img_chw, k: int, pred_dim: int, pin: bool):
        self.inp = torch.empty((batch_size, *img_chw), dtype=torch.uint8, pin_memory=pin)
        self.rows = torch.empty((batch_size, k, pred_dim), dtype=torch.float32, pin_memory=pin)
        self.idx = torch.empty((batch_size, k), dtype=torch.int64, pin_memory=pin)
        self.inp_np = self.inp.numpy()


def build_server(
    ckpt_path,
    *,
    host: str = "127.0.0.1",
    port: int = 8765,
    batch_size: int = 8,
    obj_thresh: float = 0.5,
    iou_thresh: float = 0.5,
    min_class_confidence_threshold: float = 0.0,
    class_names: Optional[List[str]] = None,
    vertical_crop_height: Optional[float] = None,
    half: bool = False,
    quantize: bool = False,
    calibration_images: Optional[Path] = None,
    linger_ms: float = 5.0,
    data_parallel: bool = False,
    spatial_parallel: int = 1,
    fetch_top_k: int = 512,
    pipeline_depth: int = 2,
    max_queue: Optional[int] = None,
    max_frames_per_request: Optional[int] = None,
    device=None,
    devices: Optional[List] = None,
) -> ThreadingHTTPServer:
    """Load the model onto `device` (default CUDA), warm it up, and return
    a ready (not yet serving) ThreadingHTTPServer. Callers run
    serve_forever(); tests drive it from a thread and shut it down."""
    if (data_parallel or spatial_parallel > 1) and process_shard()[1] > 1:
        raise ValueError(
            "data_parallel/spatial_parallel serving is single-process only "
            "(same contract as yogo infer)"
        )
    # the JAX package's mesh selection (yogo_tpu/serve.py:451-478):
    # spatial-only takes exactly N devices, --data-parallel every visible
    # one as (n / N) groups of N; one Predictor replica a group
    grid = device_grid(spatial_parallel, data_parallel, devices=devices, device=device)
    device = grid[0][0]
    n_devices = sum(len(g) for g in grid)
    if batch_size % len(grid):
        batch_size = -(-batch_size // len(grid)) * len(grid)
    group_batch = batch_size // len(grid)
    model, stack, cfg = load_model(
        ckpt_path, half=half, device=device, vertical_crop_height=vertical_crop_height,
    )
    img_h, img_w = (int(d) for d in model.img_size)
    crop_hw = (img_h, img_w) if vertical_crop_height else None
    if spatial_parallel > 1:
        RowSplit(model, grid[0])  # refuse a height that does not split, at start-up

    num_classes = model.num_classes
    if class_names is None:
        names = cfg.get("class_names") or cfg.get("classes")
        if names is not None and len(names) == num_classes:
            class_names = list(names)
    if class_names is None:
        class_names = [str(i) for i in range(num_classes)]
    if len(class_names) != num_classes:
        raise ValueError(f"expected {num_classes} class names, got {len(class_names)}")
    if len(set(class_names)) != num_classes:
        # duplicates would merge per-class counts into one JSON key
        raise ValueError(f"class names must be unique, got {class_names}")

    rgb = bool(model.input_channels == 3)
    img_chw = (model.input_channels, img_h, img_w)
    # the batch pipeline normalizes in the dataset for normalize_images
    # checkpoints; requests arrive as uint8, so scale in the forward (same
    # f32 math; a float input takes the plain block 0, not the stem kernel)
    normalize = bool(model.normalize_images)
    sx, sy = model.grid
    n_cells = sy * sx
    pred_dim = 5 + num_classes
    k = max(1, min(int(fetch_top_k), n_cells))
    on_card = device.type == "cuda"

    calib: List[np.ndarray] = []
    if quantize and needs_calibration(model):
        # a server has no run of its own to calibrate on
        # (yogo_tpu/serve.py:371-398); a program with no int8 conv needs none
        if calibration_images is None:
            raise ValueError(
                "--quantize on a server needs --calibration-images DIR "
                "(representative images to calibrate activation scales "
                "on; the batch CLI calibrates on the run's own inputs)"
            )
        from yogo_tpu_torch.data.image_source import get_dataset

        ds = get_dataset(path_to_images=calibration_images, crop_hw=crop_hw, rgb=rgb,
                         normalize_images=normalize)
        n = min(len(ds), max(batch_size, 8))
        if n == 0:
            raise ValueError("--calibration-images directory is empty")
        calib = [np.stack([ds[i][0] for i in range(n)])]

    def predictors(stack_: torch.nn.Module) -> List[Predictor]:
        """One Predictor a data group, each over its row shards; the int8
        program is calibrated once, on the first device, and copied."""
        qp = quantize_stack(model, stack_, calib) if quantize else None
        out = []
        for group in grid:
            s_, q_ = replicate(stack_, qp, group[0])
            out.append(Predictor(model, s_, meta=cfg, qp=q_, devices=group))
        return out

    # the served Predictors (state["predictor"] is the first): a hot reload
    # builds new ones (stacks, int8 programs) off to the side and swaps this
    # reference; a dispatch reads it once, so in-flight batches finish on
    # the ones they started with
    served = predictors(stack)
    state = {"predictors": served, "predictor": served[0]}
    # pipeline_depth queued + one being fetched + one the collector holds
    slots: "queue.Queue[_Slot]" = queue.Queue()
    for _ in range(max(1, int(pipeline_depth)) + 2):
        slots.put(_Slot(batch_size, img_chw, k, pred_dim, pin=on_card))

    def fwd_dispatch(frames: List[np.ndarray]):
        """Assemble the frames into a free slot, then for each data group
        upload its rows of the batch and enqueue forward, top-K selection
        and the copy of the candidates back into the slot; returns (slot,
        each group's raw head, each group's event recorded after that
        copy) without waiting for a device."""
        slot = slots.get()
        try:
            for i, frame in enumerate(frames):
                slot.inp_np[i] = frame
            slot.inp_np[len(frames):] = 0
            raws, dones = [], []
            with torch.inference_mode():
                for g, pred in enumerate(state["predictors"]):
                    rows_g = slice(g * group_batch, (g + 1) * group_batch)
                    x = pred.to_device(slot.inp[rows_g])
                    if normalize:
                        x = x.float() / 255.0
                    raw = pred.forward_raw(x)
                    rows, idx = pred.candidates(raw, k)
                    slot.rows[rows_g].copy_(rows, non_blocking=True)
                    slot.idx[rows_g].copy_(idx, non_blocking=True)
                    done = None
                    if on_card:
                        done = torch.cuda.Event()
                        done.record(torch.cuda.current_stream(pred.device))
                    raws.append(raw)
                    dones.append(done)
            return slot, raws, dones
        except BaseException:
            slots.put(slot)
            raise

    def fwd_fetch(handles):
        """Wait for one dispatch's events alone, copy its candidates out of
        the slot and free the slot; the raw heads stay on the devices."""
        slot, raws, dones = handles
        try:
            for done in dones:
                if done is not None:
                    done.synchronize()
            rows, idx = slot.rows.numpy().copy(), slot.idx.numpy().copy()
        finally:
            slots.put(slot)
        return rows, idx, (raws, dones)

    # a side stream a data group's first device, for the fallback slices
    fallback_streams = [torch.cuda.Stream(g[0]) for g in grid] if on_card else None
    stream_lock = threading.Lock()  # one fallback at a time on those streams
    counters_lock = threading.Lock()
    fallback_count = [0]  # full-slice fetches (candidate set insufficient)
    # POSTs answered and their server-side wall time (body read to response
    # written); frames formatted and the host time of their scatter or
    # fallback fetch + formatter
    timers = {"requests": 0, "request_s": 0.0, "frames": 0, "format_s": 0.0}

    def _slice_full(full, i: int) -> np.ndarray:
        """Image i's decoded (5+C, Sy, Sx) grid from a dispatch's raw head of
        its data group. On the card it runs on a side stream that waits for
        that group's event of that dispatch only, so a fallback never waits
        for later batches."""
        raws, dones = full
        g, i = divmod(i, group_batch)
        raw, done = raws[g], dones[g]
        decode = state["predictors"][g].decode_slice  # the decode needs no weights
        with torch.inference_mode():
            if fallback_streams is None:
                return decode(raw, i).numpy()
            fallback_stream = fallback_streams[g]
            with stream_lock, torch.cuda.stream(fallback_stream):
                fallback_stream.wait_event(done)
                # raw was made on the default stream: keep its memory from
                # being reused there while this stream still reads it
                raw.record_stream(fallback_stream)
                return decode(raw, i).cpu().numpy()  # synchronizes this stream only

    # warm up now (the selection path and the fallback slice): the first
    # request must not pay cuDNN's algorithm search or the kernel build
    with torch.inference_mode():
        _, _, full_w = fwd_fetch(fwd_dispatch([np.zeros(img_chw, np.uint8)]))
        for g in range(len(grid)):
            _slice_full(full_w, g * group_batch)
        del full_w

    # default shed point: pipeline_depth batches in flight plus this many
    # waiting is already seconds of backlog
    if max_queue is None:
        max_queue = 8 * batch_size
    if max_frames_per_request is None:
        # a derived default respects a user-set --max-queue (a batch
        # request sheds whole)
        max_frames_per_request = min(4 * batch_size, max_queue or 10**9)
    max_frames_per_request = max(1, int(max_frames_per_request))
    if max_queue and max_frames_per_request > max_queue:
        raise ValueError(
            f"--max-frames-per-request {max_frames_per_request} exceeds "
            f"--max-queue {max_queue}: a full-size batch request would "
            "always be shed; raise --max-queue or lower the frame cap"
        )
    batcher = _Batcher(fwd_dispatch, fwd_fetch, batch_size, img_chw,
                       linger_s=linger_ms / 1e3, pipeline_depth=pipeline_depth,
                       max_queue=max_queue)
    inflight = _Gauge()

    def _pred_for(cand_rows, cand_idx, full, slot, obj_t: float) -> np.ndarray:
        """The (D, Sy, Sx) grid a request's thresholds are served from: the
        K candidates scattered into a zero grid when they hold every cell
        above obj_t (the K-th candidate's objectness <= obj_t), else the
        image's full decoded slice."""
        if k < n_cells and float(cand_rows[-1, 4]) > obj_t:
            with counters_lock:
                fallback_count[0] += 1
            return _slice_full(full, slot)
        return scatter_candidates(cand_rows, cand_idx, pred_dim, sy, sx)

    defaults = {
        "obj_thresh": obj_thresh,
        "iou_thresh": iou_thresh,
        "min_class_confidence_threshold": min_class_confidence_threshold,
    }
    info = {
        "status": "ok",
        "model": model.defn.name,
        "classes": class_names,
        "input_hw": [img_h, img_w],
        "rgb": rgb,
        "normalize_images": normalize,
        "batch_size": batch_size,
        "quantize": bool(quantize),
        "fetch_top_k": k,
        "pipeline_depth": max(1, int(pipeline_depth)),
        "max_queue": int(max_queue),
        "max_frames_per_request": int(max_frames_per_request),
        "data_parallel_devices": n_devices if data_parallel and n_devices > 1 else 1,
        "spatial_parallel": int(spatial_parallel),
        "device": str(device),
        "compute_dtype": str(model.compute_dtype).replace("torch.", ""),
        "defaults": defaults,
        "reloads": 0,
    }

    reload_lock = threading.Lock()

    def reload_checkpoint(path=None) -> Dict[str, Any]:
        """Swap the served weights for those of `path` (default: the
        startup checkpoint, re-read from disk). The new stack is built and
        loaded on the device off to the side (a quantized server
        recalibrates its int8 program on the kept calibration batches), then
        one reference is swapped: no kernel is rebuilt or reloaded, no
        served parameter is written in place, and in-flight batches finish
        on the old stack. On any failure the old weights keep serving and
        {"ok": False, "error": ...} comes back. SIGHUP triggers it under
        `serve`."""
        src = path if path is not None else ckpt_path
        with reload_lock:
            try:
                model2, variables2, _ = load_any(src)
                for what, got, want in (
                    ("model", model2.defn.name, model.defn.name),
                    ("num_classes", model2.num_classes, num_classes),
                    ("input_channels", model2.input_channels, model.input_channels),
                    ("normalize_images", bool(model2.normalize_images), normalize),
                ):
                    if got != want:
                        raise ValueError(f"incompatible reload: {what} {got!r} != serving {want!r}")
                new_stack = model.module(device)
                try:
                    new_stack.load_state_dict(state_dict_from_flax(variables2), strict=True)
                except RuntimeError as e:
                    raise ValueError(f"incompatible reload: weight shapes differ ({e})") from e
                new_preds = predictors(new_stack)
                if on_card:
                    for p_ in new_preds:  # uploads off the hot path
                        for d in set(p_.devices):
                            torch.cuda.current_stream(d).synchronize()
                state.update(predictors=new_preds, predictor=new_preds[0])
                info["reloads"] += 1
                return {"ok": True, "reloads": info["reloads"], "path": str(src)}
            except Exception as e:
                return {"ok": False, "error": repr(e), "path": str(src)}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # noqa: N802 (stdlib name)
            pass  # no per-request stderr lines

        def _drain(self, length: int) -> None:
            """Discard a rejected request's body in chunks before answering
            (answering while the client still writes makes it see EPIPE);
            past twice the encoded cap, close the connection instead."""
            if length > 2 * _MAX_ENCODED_BODY:
                self.close_connection = True
                length = 0
            while length > 0:
                chunk = self.rfile.read(min(length, 1 << 20))
                if not chunk:
                    self.close_connection = True
                    return
                length -= len(chunk)

        def _json(self, code: int, payload: Dict[str, Any],
                  extra_headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            encoding = None
            # a batch response is megabytes of JSON; gzip it for clients
            # that ask, when it is worth the CPU
            if len(body) >= 1024 and "gzip" in self.headers.get("Accept-Encoding", "").lower():
                body = gzip.compress(body, compresslevel=1)
                encoding = "gzip"
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if encoding:
                self.send_header("Content-Encoding", encoding)
            for key, v in (extra_headers or {}).items():
                self.send_header(key, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib name)
            url = urlparse(self.path)
            if url.path in ("/", "/healthz"):
                self._json(200, info)
            elif url.path == "/metrics":
                stats = batcher.stats()
                with counters_lock:
                    stats["full_fetch_fallbacks"] = fallback_count[0]
                    t = dict(timers)
                stats["requests"] = t["requests"]
                stats["mean_request_ms"] = 1e3 * t["request_s"] / t["requests"] if t["requests"] else 0.0
                stats["mean_format_ms"] = 1e3 * t["format_s"] / t["frames"] if t["frames"] else 0.0
                q = {key: v[-1] for key, v in parse_qs(url.query).items()}
                if q.get("format") == "prometheus":
                    lines = []
                    for key, v in sorted(stats.items()):
                        kind = ("gauge" if key.startswith("mean_") or key in (
                            "queue_depth", "inflight_batches") else "counter")
                        lines.append(f"# TYPE yogo_{key} {kind}")
                        lines.append(f"yogo_{key} {float(v)!r}")
                    body = ("\n".join(lines) + "\n").encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain; version=0.0.4")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self._json(200, stats)
            else:
                self._json(404, {"error": f"unknown path {url.path}"})

        def do_POST(self):  # noqa: N802 (stdlib name)
            t0 = time.perf_counter()
            with inflight:
                self._predict()
            with counters_lock:
                timers["requests"] += 1
                timers["request_s"] += time.perf_counter() - t0

        def _predict(self):
            url = urlparse(self.path)
            if url.path != "/predict":
                self._json(404, {"error": f"unknown path {url.path}"})
                return
            cl = self.headers.get("Content-Length")
            if cl is None:
                # http.server does not decode chunked bodies: say so
                self._json(411, {"error": "Content-Length required (chunked "
                                          "transfer-encoding is not supported)"})
                return
            try:
                length = int(cl)
            except ValueError:
                self._json(400, {"error": f"bad Content-Length: {cl!r}"})
                return
            if length <= 0:
                self._json(400, {"error": "empty body; POST image bytes"})
                return
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if ctype.strip().lower() == "application/octet-stream":
                # raw uint8 frames: the body IS the (N, C, H, W) pixel buffer
                expected = int(np.prod(img_chw))
                n_frames, rem = divmod(length, expected)
                if rem or not (1 <= n_frames <= max_frames_per_request):
                    self._drain(length)
                    self._json(400, {"error": (
                        f"raw body must be N x {expected} bytes (uint8, C-order "
                        f"{list(img_chw)} CHW frames, 1 <= N <= "
                        f"{max_frames_per_request}), got {length}"
                    )})
                    return
                buf = self.rfile.read(length)
                if len(buf) != length:  # client hung up mid-body
                    self._json(400, {"error": f"short body: {len(buf)}/{length} bytes"})
                    return
                imgs = list(np.frombuffer(buf, np.uint8).reshape(-1, *img_chw))
            else:
                if length > _MAX_ENCODED_BODY:
                    self._drain(length)
                    self._json(413, {"error": (
                        f"body of {length} bytes exceeds the {_MAX_ENCODED_BODY}-byte "
                        "limit for encoded images; send raw octet-stream frames instead"
                    )})
                    return
                try:
                    imgs = [_decode_image_bytes(self.rfile.read(length), rgb=rgb, crop_hw=crop_hw)]
                except Exception as e:
                    self._json(400, {"error": f"could not decode image: {e}"})
                    return
            for img in imgs:
                if img.shape != img_chw:
                    self._json(400, {"error": (
                        f"image shape {list(img.shape)} != model input {list(img_chw)} "
                        "(CHW); resize/crop client-side or start the server with --crop-height"
                    )})
                    return

            q = {key: v[-1] for key, v in parse_qs(url.query).items()}
            unknown = sorted(set(q) - set(defaults))
            if unknown:
                # a typo'd override silently serving the default is a trap
                self._json(400, {"error": (
                    f"unknown query parameter(s) {unknown}; supported: {sorted(defaults)}"
                )})
                return
            try:
                thr = {key: float(q.get(key, defaults[key])) for key in defaults}
                # a negative or NaN obj_thresh would feed every cell to the
                # O(N^2) host NMS
                for key, v in thr.items():
                    if not math.isfinite(v) or not (0.0 <= v <= 1.0):
                        raise ValueError(f"{key}={v} outside [0, 1]")
            except ValueError as e:
                self._json(400, {"error": f"bad query parameter: {e}"})
                return

            try:
                futs = batcher.submit_many(imgs)
                # one deadline for the group: a hung device must not cost
                # 120 s per frame of a batch request
                deadline = time.monotonic() + 120.0
                results = []
                for i in range(len(futs)):
                    # drop each result (and its raw-head handle) once it is
                    # formatted, so a batch request pins no more device
                    # memory than pipeline_depth allows
                    fut, futs[i] = futs[i], None
                    cand_rows, cand_idx, full, slot = fut.result(
                        timeout=max(0.0, deadline - time.monotonic())
                    )
                    del fut
                    t1 = time.perf_counter()
                    pred = _pred_for(cand_rows, cand_idx, full, slot, thr["obj_thresh"])
                    del cand_rows, cand_idx, full
                    results.append(format_detections(pred, class_names, **thr))
                    with counters_lock:
                        timers["frames"] += 1
                        timers["format_s"] += time.perf_counter() - t1
            except Overloaded as e:
                self._json(503, {"error": f"overloaded: {e}"}, extra_headers={"Retry-After": "1"})
                return
            except FuturesTimeoutError:
                self._json(503, {"error": "inference timed out (120 s group deadline); "
                                          "device hung or severely backlogged"},
                           extra_headers={"Retry-After": "30"})
                return
            except Exception as e:
                self._json(503, {"error": f"inference failed: {e!r}"})
                return
            self._json(200, results[0] if len(results) == 1 else {"results": results})

    class _Server(ThreadingHTTPServer):
        # the default accept backlog of 5 overflows under a burst of
        # concurrent clients (connection refused / reset)
        request_queue_size = 128

        def handle_error(self, request, client_address):
            # a client that disconnects mid-response is not worth a
            # traceback; anything else still gets reported
            if isinstance(sys.exc_info()[1], (ConnectionError, TimeoutError)):
                return
            super().handle_error(request, client_address)

    server = _Server((host, port), Handler)
    server.yogo_batcher = batcher
    server.yogo_inflight = inflight
    server.yogo_info = info
    server.yogo_state = state  # the served Predictors, swapped by a reload
    server.reload_checkpoint = reload_checkpoint
    return server


def format_detections(pred: np.ndarray, class_names: List[str], **thresholds) -> Dict[str, Any]:
    """One decoded (5+C, Sy, Sx) grid -> the response of one frame: the
    host formatter's detections (format_preds, `thresholds` its keyword
    arguments) and per-class counts."""
    rows = format_preds(pred, box_format="cxcywh", **thresholds)
    # xyxy from the same pass: a second format_preds would redo the NMS
    xyxy = _cxcywh_to_xyxy_np(rows[:, :4]) if len(rows) else np.zeros((0, 4), np.float32)
    dets = []
    counts = {name: 0 for name in class_names}
    for r, bx in zip(rows, xyxy):
        ci = int(np.argmax(r[5:]))
        counts[class_names[ci]] += 1
        dets.append({
            "class_idx": ci,
            "class": class_names[ci],
            "objectness": float(r[4]),
            "class_confidence": float(r[5 + ci]),
            "bbox_cxcywh": [float(v) for v in r[:4]],
            "bbox_xyxy": [float(v) for v in bx],
        })
    return {"detections": dets, "counts": counts}


def _decode_image_bytes(
    raw: bytes, *, rgb: bool, crop_hw: Optional[Tuple[int, int]]
) -> np.ndarray:
    """Bytes -> (C, H, W) uint8 through the batch pipeline's own decoder
    (read_image opens any PIL-readable source) and crop."""
    from yogo_tpu_torch.data.image_source import center_crop
    from yogo_tpu_torch.data.utils import read_image

    return center_crop(read_image(io.BytesIO(raw), rgb=rgb), crop_hw)


def do_serve(args) -> None:
    server = build_server(
        args.ckpt_path,
        host=args.host,
        port=args.port,
        batch_size=args.batch_size,
        obj_thresh=args.obj_thresh,
        iou_thresh=args.iou_thresh,
        min_class_confidence_threshold=args.min_class_confidence_threshold,
        class_names=args.class_names,
        vertical_crop_height=args.crop_height,
        half=args.half,
        quantize=args.quantize,
        calibration_images=args.calibration_images,
        linger_ms=args.linger_ms,
        data_parallel=args.data_parallel,
        spatial_parallel=args.spatial_parallel,
        fetch_top_k=args.fetch_top_k,
        pipeline_depth=args.pipeline_depth,
        max_queue=args.max_queue,
        max_frames_per_request=args.max_frames_per_request,
        device=args.device,
    )
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} (POST /predict, GET /healthz; "
          "ctrl-c or SIGTERM to stop)", flush=True)

    # SIGTERM: stop accepting, finish in-flight requests, exit 0.
    # shutdown() must run off the serve_forever thread (calling it from the
    # signal frame, which IS that thread, deadlocks), so a one-shot thread
    # does it. SIGHUP reloads the checkpoint, off the signal frame too.
    import signal as _signal

    def _term(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    def _hup(signum, frame):
        def run():
            print(f"SIGHUP reload: {server.reload_checkpoint()}", file=sys.stderr)

        threading.Thread(target=run, daemon=True).start()

    not_installed = object()  # a None previous disposition is legitimate
    prev = prev_hup = not_installed
    try:
        prev = _signal.signal(_signal.SIGTERM, _term)
        prev_hup = _signal.signal(_signal.SIGHUP, _hup)
    except ValueError:  # not the main thread (embedded use)
        pass
    try:
        server.serve_forever()
        # stopped by SIGTERM: accepted requests finish (the gauge covers
        # decode -> batcher -> response), bounded against hung clients
        drained = server.yogo_inflight.wait_zero(timeout=30.0)
        print("SIGTERM: " + ("drained in-flight requests, " if drained
                             else "drain timed out (hung client?), ") + "shutting down",
              file=sys.stderr)
    except KeyboardInterrupt:
        pass
    finally:
        # signal.signal rejects None though it returns None for a handler
        # installed from C; restore the default then
        if prev is not not_installed:
            _signal.signal(_signal.SIGTERM, _signal.SIG_DFL if prev is None else prev)
        if prev_hup is not not_installed:
            _signal.signal(_signal.SIGHUP, _signal.SIG_DFL if prev_hup is None else prev_hup)
        server.yogo_batcher.shutdown()
        server.server_close()
