"""The port's HTTP server (yogo_tpu_torch/serve.py) on the CPU: the cases of
tests/test_serve.py that need no data / spatial parallelism or int8, on
tests/goldens/trained_half_filters.ckpt (96x128, float32).

Tolerances: a served response is BIT-equal (JSON-level) to the port's host
formatter over Predictor.forward of the same pixels in a batch of the
server's shape, whichever path (top-K candidates or full-slice fallback)
served it (the CPU's convs round a batch of one differently from a batch
of two or more, by an ulp); against JAX's format_preds
over JAX's forward, classes and counts are exact and boxes within 1e-6
(XLA's and torch's f32 convs differ in the last bits). Every HTTP call has
a socket timeout, every Future.result() a timeout, and every server is shut
down by its fixture or a finally.
"""

import io
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_golden_detections import gen_test_images
from yogo_tpu_torch.infer import Predictor
from yogo_tpu_torch.ops.postprocess import _cxcywh_to_xyxy_np, format_preds
from yogo_tpu_torch.serve import Overloaded, _Batcher, build_server

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "tests" / "goldens" / "trained_half_filters.ckpt"
CLASSES = ["cell", "parasite"]
TIMEOUT = 60


def png_bytes(img_hw_u8: np.ndarray) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img_hw_u8).save(buf, format="PNG")
    return buf.getvalue()


def post(port: int, body: bytes, path="/predict", content_type=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=body, method="POST",
        headers={"Content-Type": content_type} if content_type else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
        return json.loads(r.read())


def start(request, ckpt=CKPT, **kw):
    """A built server serving from a thread, shut down at the test's end."""
    srv = build_server(ckpt, port=0, device="cpu", **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()

    def stop():
        srv.shutdown()
        srv.yogo_batcher.shutdown()
        srv.server_close()
        t.join(timeout=10)

    request.addfinalizer(stop)
    return srv


def expected(pred: np.ndarray, **thr):
    """What the server must answer for one decoded grid: the host
    formatter's rows, as the handler turns them into JSON."""
    rows = format_preds(pred, box_format="cxcywh", **thr)
    xyxy = _cxcywh_to_xyxy_np(rows[:, :4]) if len(rows) else np.zeros((0, 4), np.float32)
    dets, counts = [], {c: 0 for c in CLASSES}
    for r, bx in zip(rows, xyxy):
        ci = int(np.argmax(r[5:]))
        counts[CLASSES[ci]] += 1
        dets.append({"class_idx": ci, "class": CLASSES[ci], "objectness": float(r[4]),
                     "class_confidence": float(r[5 + ci]),
                     "bbox_cxcywh": [float(v) for v in r[:4]],
                     "bbox_xyxy": [float(v) for v in bx]})
    return {"detections": dets, "counts": counts}


def in_batch(frame: np.ndarray, batch_size: int) -> np.ndarray:
    """One (C, H, W) frame in a batch of the server's shape, padded with
    zero frames as the server pads it."""
    x = np.zeros((batch_size, *frame.shape), frame.dtype)
    x[0] = frame
    return x


@pytest.fixture(scope="module")
def imgs(tmp_path_factory):
    return gen_test_images(tmp_path_factory.mktemp("serve_goldens"), n=4, seed=5)


@pytest.fixture(scope="module")
def server(request):
    return start(request, batch_size=4, linger_ms=20.0)


@pytest.fixture(scope="module")
def decoded(imgs):
    """The port's full decoded forward of each frame, (4, 7, Sy, Sx)."""
    pred = Predictor.from_checkpoint(CKPT, device="cpu")
    return pred.forward(np.stack(imgs)[:, None]).numpy()


def test_healthz_reports_model(server):
    info = get(server.server_address[1], "/healthz")
    assert info["status"] == "ok" and info["classes"] == CLASSES
    assert info["input_hw"] == [96, 128] and info["model"] == "half_filters"
    assert info["device"] == "cpu" and info["quantize"] is False


def test_served_detections_match_host_formatter(server, imgs, decoded):
    """The end gate: a served response == the port's format_preds over its
    own full decoded forward, bit for bit, and == JAX's format_preds over
    JAX's forward within the stated tolerance."""
    import jax.numpy as jnp

    from yogo_tpu.ops.postprocess import format_preds as jax_format_preds
    from yogo_tpu.utils.checkpoint import load_any as jax_load_any

    jmodel, jvars, _ = jax_load_any(CKPT)
    jpred = np.asarray(jmodel.apply(jvars, jnp.asarray(np.stack(imgs)[:, None]), inference=True))
    port = server.server_address[1]
    total = 0
    for img, mine, theirs in zip(imgs, decoded, jpred):
        status, resp = post(port, png_bytes(img))
        assert status == 200, resp
        assert resp == expected(mine, obj_thresh=0.5, iou_thresh=0.5,
                                min_class_confidence_threshold=0.0)
        want = jax_format_preds(theirs, obj_thresh=0.5, iou_thresh=0.5)
        dets = resp["detections"]
        assert sorted(d["class_idx"] for d in dets) == sorted(int(np.argmax(r[5:])) for r in want)
        by_obj = sorted(dets, key=lambda d: -d["objectness"])
        want = want[np.argsort(-want[:, 4], kind="stable")]
        for d, r in zip(by_obj, want):
            np.testing.assert_allclose(d["bbox_cxcywh"], r[:4], rtol=0, atol=1e-6)
        total += len(dets)
    assert total >= 5  # the golden generator gives real detections


def test_concurrent_requests_share_dispatches(server, imgs):
    port = server.server_address[1]
    before = get(port, "/metrics")
    bodies = [png_bytes(im) for im in imgs] * 3  # 12 requests, batch cap 4
    with ThreadPoolExecutor(max_workers=12) as pool:
        results = list(pool.map(lambda b: post(port, b), bodies))
    assert all(status == 200 for status, _ in results)
    # whichever slot of whichever batch a frame rode in, the same answer
    for i in range(4):
        assert results[i][1] == results[i + 4][1] == results[i + 8][1]
    stats = get(port, "/metrics")
    images = stats["images"] - before["images"]
    batches = stats["batches"] - before["batches"]
    assert images == 12 and 1 <= batches < images
    assert stats["mean_batch_occupancy"] > 1.0


def test_threshold_query_overrides(server, imgs, decoded):
    port = server.server_address[1]
    _, strict = post(port, png_bytes(imgs[0]), path="/predict?obj_thresh=0.99")
    _, loose = post(port, png_bytes(imgs[0]), path="/predict?obj_thresh=0.1&iou_thresh=0.3")
    assert len(strict["detections"]) <= len(loose["detections"])
    assert loose == expected(decoded[0], obj_thresh=0.1, iou_thresh=0.3,
                             min_class_confidence_threshold=0.0)
    for bad_q in ("obj_thresh=nope", "obj_thresh=-1", "obj_thresh=nan", "iou_thresh=2"):
        status, bad = post(port, png_bytes(imgs[0]), path=f"/predict?{bad_q}")
        assert status == 400 and "error" in bad, bad_q


def test_error_paths(server):
    port = server.server_address[1]
    status, resp = post(port, b"not an image")
    assert status == 400 and "decode" in resp["error"]
    wrong = np.zeros((8, 8), np.uint8)
    status, resp = post(port, png_bytes(wrong))
    assert status == 400 and "shape" in resp["error"]
    status, resp = post(port, png_bytes(wrong), path="/nonsense")
    assert status == 404
    status, resp = post(port, b"")
    assert status == 400


def test_missing_content_length_is_411(server):
    with socket.create_connection(("127.0.0.1", server.server_address[1]), timeout=TIMEOUT) as s:
        s.sendall(b"POST /predict HTTP/1.1\r\nHost: t\r\n"
                  b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n")
        head = s.recv(65536).split(b"\r\n", 1)[0]
    assert b"411" in head


def test_raw_frame_path_matches_png_path(server, imgs):
    port = server.server_address[1]
    _, png_resp = post(port, png_bytes(imgs[0]))
    status, raw_resp = post(port, imgs[0][None].tobytes(), content_type="application/octet-stream")
    assert status == 200 and raw_resp == png_resp and len(raw_resp["detections"]) >= 1
    status, resp = post(port, imgs[0][None].tobytes()[:-7], content_type="application/octet-stream")
    assert status == 400 and "bytes" in resp["error"]
    status, resp = post(port, imgs[0][None].tobytes(), content_type="application/octet-stream; x=y")
    assert status == 200 and resp == png_resp


def test_raw_batch_request_matches_singles(server, imgs):
    port = server.server_address[1]
    singles = [post(port, im[None].tobytes(), content_type="application/octet-stream")[1]
               for im in imgs[:3]]
    body = b"".join(im[None].tobytes() for im in imgs[:3])
    status, resp = post(port, body, content_type="application/octet-stream")
    assert status == 200 and set(resp) == {"results"} and resp["results"] == singles
    status, strict = post(port, body, path="/predict?obj_thresh=0.99",
                          content_type="application/octet-stream")
    assert status == 200
    assert all(len(s["detections"]) <= len(r["detections"])
               for s, r in zip(strict["results"], resp["results"]))
    info = get(port, "/healthz")
    cap = info["max_frames_per_request"]
    assert cap == 4 * info["batch_size"]  # the documented default
    status, resp = post(port, imgs[0][None].tobytes() * (cap + 1),
                        content_type="application/octet-stream")
    assert status == 400 and str(cap) in resp["error"]


def test_encoded_body_size_cap(server):
    status, resp = post(server.server_address[1], b"\0" * (32 * 1024 * 1024 + 1))
    assert status == 413 and "limit" in resp["error"]


def _rows_of(frames):
    b = len(frames)
    return (np.stack(frames)[:, 0, :1, :1].astype(np.float32).reshape(b, 1, 1),
            np.zeros((b, 1), np.int64))


def test_batcher_submit_many_is_atomic_under_shedding():
    """A group that would overflow max_queue is shed whole; a group that
    fits is accepted whole and resolves in input order."""
    gate = threading.Event()

    def fetch(frames):
        gate.wait(timeout=30)
        return (*_rows_of(frames), "full")

    batcher = _Batcher(list, fetch, batch_size=1, img_chw=(1, 1, 1), linger_s=0.0,
                       pipeline_depth=1, max_queue=4)
    try:
        # saturate: batch 1 in the gated fetch, batch 2 queued, batch 3
        # held by the collector, the waiting queue empty
        first = [batcher.submit(np.zeros((1, 1, 1), np.uint8)) for _ in range(3)]
        deadline = time.monotonic() + 30
        while batcher.stats()["queue_depth"] > 0:
            assert time.monotonic() < deadline, "pipeline never saturated"
            time.sleep(0.001)
        group = batcher.submit_many([np.full((1, 1, 1), v, np.uint8) for v in (1, 2, 3)])
        with pytest.raises(Overloaded):
            batcher.submit_many([np.zeros((1, 1, 1), np.uint8) for _ in range(2)])
        stats = batcher.stats()
        assert stats["shed_frames"] == 2 and stats["queue_depth"] == 3
        gate.set()
        assert [int(f.result(timeout=30)[0][0, 0]) for f in group] == [1, 2, 3]
        for f in first:
            f.result(timeout=30)
    finally:
        gate.set()
        batcher.shutdown()


def test_batcher_pipelines_dispatch_ahead_of_fetch():
    """Batch N+1 is dispatched while batch N's fetch is blocked, up to
    pipeline_depth, and every future gets its own slot's result, FIFO."""
    dispatched = []
    gate = threading.Event()
    seen = threading.Condition()

    def dispatch(frames):
        with seen:
            dispatched.append(list(frames))
            seen.notify_all()
        return len(dispatched) - 1

    def fetch(handle):
        gate.wait(timeout=30)
        return (*_rows_of(dispatched[handle]), f"full-{handle}")

    batcher = _Batcher(dispatch, fetch, batch_size=2, img_chw=(1, 1, 1), linger_s=0.0,
                       pipeline_depth=2)
    try:
        futs = [batcher.submit(np.full((1, 1, 1), v, np.uint8)) for v in (10, 11, 20, 21, 30, 31)]
        with seen:
            deadline = time.monotonic() + 30
            while len(dispatched) < 3 and seen.wait(max(0.0, deadline - time.monotonic())):
                pass
        assert len(dispatched) == 3, f"pipelining stalled: {len(dispatched)}"
        assert not any(f.done() for f in futs)
        gate.set()
        results = [f.result(timeout=30) for f in futs]
        assert [int(r[0][0, 0]) for r in results] == [10, 11, 20, 21, 30, 31]
        assert [r[2] for r in results] == ["full-0", "full-0", "full-1", "full-1", "full-2", "full-2"]
        assert [r[3] for r in results] == [0, 1, 0, 1, 0, 1]
    finally:
        gate.set()
        batcher.shutdown()


def test_batcher_fetch_error_reaches_all_waiters():
    fail = [True]

    def fetch(frames):
        if fail[0]:
            fail[0] = False
            raise RuntimeError("device fault")
        return (*_rows_of(frames), "full")

    batcher = _Batcher(list, fetch, batch_size=2, img_chw=(1, 1, 1), linger_s=0.02,
                       pipeline_depth=2)
    try:
        futs = batcher.submit_many([np.zeros((1, 1, 1), np.uint8)] * 2)
        errs = 0
        for f in futs:
            with pytest.raises(RuntimeError, match="device fault"):
                f.result(timeout=30)
            errs += 1
        assert errs == 2  # both frames rode the failing dispatch
        rows, _, _, _ = batcher.submit(np.full((1, 1, 1), 7, np.uint8)).result(timeout=30)
        assert int(rows[0, 0]) == 7  # the batcher survives
    finally:
        batcher.shutdown()


def test_batcher_sheds_load_at_max_queue():
    gate = threading.Event()

    def fetch(frames):
        gate.wait(timeout=30)
        return (*_rows_of(frames), "full")

    batcher = _Batcher(list, fetch, batch_size=2, img_chw=(1, 1, 1), linger_s=0.0,
                       pipeline_depth=1, max_queue=3)
    try:
        futs, shed = [], 0
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                futs.append(batcher.submit(np.zeros((1, 1, 1), np.uint8)))
            except Overloaded:
                shed += 1
                break
        assert shed == 1, "never shed despite a gated fetch + max_queue=3"
        stats = batcher.stats()
        assert stats["shed_frames"] == 1 and stats["queue_depth"] <= 3
        gate.set()
        for f in futs:
            f.result(timeout=30)
        rows, _, _, _ = batcher.submit(np.full((1, 1, 1), 9, np.uint8)).result(timeout=30)
        assert int(rows[0, 0]) == 9
    finally:
        gate.set()
        batcher.shutdown()


def test_serve_overload_returns_503_with_retry_after(server):
    port = server.server_address[1]
    info = get(port, "/healthz")
    assert info["max_queue"] == 8 * info["batch_size"]  # the default shed point
    body = np.zeros((1, *info["input_hw"]), np.uint8).tobytes()
    orig = server.yogo_batcher.submit_many
    server.yogo_batcher.submit_many = lambda imgs: (_ for _ in ()).throw(
        Overloaded("8 images already queued"))
    try:
        req = urllib.request.Request(f"http://127.0.0.1:{port}/predict", data=body, method="POST",
                                     headers={"Content-Type": "application/octet-stream"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=TIMEOUT)
        assert ei.value.code == 503 and ei.value.headers["Retry-After"] == "1"
        assert "overloaded" in json.loads(ei.value.read())["error"]
    finally:
        server.yogo_batcher.submit_many = orig
    assert post(port, body, content_type="application/octet-stream")[0] == 200


def test_metrics_prometheus_format(server):
    port = server.server_address[1]
    stats = get(port, "/metrics")
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics?format=prometheus",
                                timeout=TIMEOUT) as resp:
        assert resp.headers["Content-Type"].startswith("text/plain")
        text = resp.read().decode()
    samples = {}
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            name, val = line.split()
            samples[name] = float(val)
    assert set(samples) == {f"yogo_{k}" for k in stats}
    for k, v in stats.items():
        if k not in ("mean_dispatch_ms", "images", "batches", "mean_batch_occupancy"):
            assert samples[f"yogo_{k}"] == pytest.approx(float(v))
    assert "# TYPE yogo_queue_depth gauge" in text and "# TYPE yogo_images counter" in text


def test_unknown_query_param_is_400(server, imgs):
    status, resp = post(server.server_address[1], png_bytes(imgs[0]), path="/predict?obj_tresh=0.9")
    assert status == 400 and "obj_tresh" in resp["error"] and "obj_thresh" in resp["error"]


def test_fetch_topk_fallback_is_exact(request, imgs):
    """K=4 on a 192-cell grid: a request whose obj_thresh undercuts the
    4th candidate is served from the image's full slice (counted in
    /metrics), and every answer equals the full-tensor formatter's."""
    srv = start(request, batch_size=2, linger_ms=5.0, fetch_top_k=4)
    port = srv.server_address[1]
    assert srv.yogo_info["fetch_top_k"] == 4
    full = Predictor.from_checkpoint(CKPT, device="cpu").forward(in_batch(imgs[0][None], 2))[0]
    for thresh in (0.01, 0.5, 0.99):
        status, resp = post(port, png_bytes(imgs[0]), path=f"/predict?obj_thresh={thresh}")
        assert status == 200
        assert resp == expected(full.numpy(), obj_thresh=thresh, iou_thresh=0.5,
                                min_class_confidence_threshold=0.0)
    assert int((full[4] > 0.01).sum()) > 4  # the premise
    assert get(port, "/metrics")["full_fetch_fallbacks"] >= 1


def test_frame_cap_over_queue_cap_is_a_build_error(request):
    with pytest.raises(ValueError, match="max-queue"):
        build_server(CKPT, port=0, batch_size=2, max_queue=4, max_frames_per_request=8,
                     device="cpu")
    srv = start(request, batch_size=8, max_queue=16)
    assert srv.yogo_info["max_frames_per_request"] == 16


def test_serve_rejects_duplicate_class_names():
    with pytest.raises(ValueError, match="unique"):
        build_server(CKPT, port=0, class_names=["cell", "cell"], device="cpu")


def test_unported_options_raise_naming_their_roadmap_items():
    for kw, item in (({"data_parallel": True}, "item 15"), ({"spatial_parallel": 4}, "item 15")):
        with pytest.raises(NotImplementedError, match=item):
            build_server(CKPT, port=0, device="cpu", **kw)


def test_serve_normalized_checkpoint_parity(request, tmp_path):
    """A normalize_images checkpoint is served with the /255 scaling the
    batch pipeline applies in its dataset (raw uint8 would give garbage
    with HTTP 200): equal to the port's forward on img / 255, and to JAX's."""
    import jax.numpy as jnp

    from yogo_tpu.ops.postprocess import format_preds as jax_format_preds
    from yogo_tpu.utils.checkpoint import load_any as jax_load_any
    from yogo_tpu_torch.models.yogo import YOGO
    from yogo_tpu_torch.utils.checkpoint import save_checkpoint
    from yogo_tpu_torch.utils.weights import flax_from_state_dict

    model = YOGO.create((48, 64), 0.08, 0.1, 2, model_version="quarter_filters",
                        normalize_images=True)
    stack = model.init(torch.Generator().manual_seed(4), device="cpu")
    ck = tmp_path / "norm.ckpt"
    save_checkpoint(ck, model, flax_from_state_dict(stack.state_dict()), classes=CLASSES)
    img = np.random.default_rng(9).integers(0, 256, (48, 64)).astype(np.uint8)
    x = img[None, None].astype(np.float32) / 255.0
    mine = model.apply(stack, torch.from_numpy(in_batch(x[0], 2)), inference=True)[0].numpy()
    jmodel, jvars, _ = jax_load_any(ck)
    theirs = np.asarray(jmodel.apply(jvars, jnp.asarray(x), inference=True))[0]

    srv = start(request, ckpt=ck, batch_size=2, linger_ms=1.0)
    assert srv.yogo_info["normalize_images"] is True
    status, resp = post(srv.server_address[1], png_bytes(img), path="/predict?obj_thresh=0.4")
    assert status == 200
    assert resp == expected(mine, obj_thresh=0.4, iou_thresh=0.5, min_class_confidence_threshold=0.0)
    want = jax_format_preds(theirs, obj_thresh=0.4, iou_thresh=0.5)
    assert sorted((d["class_idx"], round(d["objectness"], 5)) for d in resp["detections"]) == \
        sorted((int(np.argmax(r[5:])), round(float(r[4]), 5)) for r in want)


def test_bf16_crop_to_an_odd_height_takes_the_plain_block_0(request, imgs):
    """--crop-height can make H odd, which the stem kernel refuses: the
    served forward then runs block 0 as a plain conv, as JAX does, and
    still equals the formatter over the same cropped forward."""
    from yogo_tpu_torch.data.image_source import center_crop

    srv = start(request, batch_size=2, linger_ms=1.0, half=True, vertical_crop_height=0.49)
    h = srv.yogo_info["input_hw"][0]
    assert h == 47 and srv.yogo_info["compute_dtype"] == "bfloat16"
    pred = Predictor.from_checkpoint(CKPT, half=True, device="cpu", vertical_crop_height=0.49)
    x = torch.from_numpy(center_crop(imgs[1][None], (h, 128))[None].copy())
    assert not pred.model.stem_kernel_eligible(pred.stack, x)
    status, resp = post(srv.server_address[1], png_bytes(imgs[1]))
    assert status == 200
    assert resp == expected(pred.forward(in_batch(x[0].numpy(), 2))[0].numpy(),
                            obj_thresh=0.5, iou_thresh=0.5,
                            min_class_confidence_threshold=0.0)


def test_serve_sigterm_graceful_shutdown():
    """`serve` + SIGHUP reloads the checkpoint in place; SIGTERM stops
    accepting, answers the in-flight request, prints the drain line and
    exits 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "yogo_tpu_torch", "serve", str(CKPT), "--device", "cpu",
         "--port", str(port), "--batch-size", "2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}"),
    )
    try:
        deadline = time.monotonic() + 120
        while True:
            try:
                get(port, "/healthz")
                break
            except (OSError, urllib.error.URLError):
                if time.monotonic() > deadline or proc.poll() is not None:
                    pytest.fail("server never came up")
                time.sleep(0.2)
        proc.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 60
        while get(port, "/healthz")["reloads"] != 1:
            assert time.monotonic() < deadline, "SIGHUP did not reload"
            time.sleep(0.1)
        result = {}
        th = threading.Thread(target=lambda: result.update(resp=post(
            port, np.full((1, 96, 128), 127, np.uint8).tobytes(),
            content_type="application/octet-stream")))
        th.start()
        time.sleep(0.05)  # the request is likely in flight when the signal lands
        proc.send_signal(signal.SIGTERM)
        th.join(timeout=60)
        assert not th.is_alive()
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err[-2000:]
    assert "SIGTERM" in err and "shutting down" in err, err[-2000:]
    assert "SIGHUP reload: {'ok': True" in err, err[-2000:]
    assert result["resp"][0] == 200


BASE_CKPT = REPO / "tests" / "goldens" / "trained_base_model_fullres.ckpt"


def test_quantized_server_answers_equal_its_int8_predictor_and_reloads(request, tmp_path):
    """`serve --quantize --calibration-images` on the trained base_model
    (int8 blocks 4-6), 193-row crops of its golden frames, micro-batch 2:
    calibrated on max(2, 8) -> both images of the directory; each answer
    is bit-equal to the host formatter over the server's int8
    Predictor.forward of a batch of the server's shape; a reload
    recalibrates (a new program, the same answers) and builds no kernel."""
    from tests.test_golden_fullres import gen_test_images as gen_fullres
    from yogo_tpu_torch import kernels
    from yogo_tpu_torch.data.image_source import get_dataset

    gen_fullres(tmp_path / "calib", n=2)
    with pytest.raises(ValueError, match="calibration-images"):
        build_server(BASE_CKPT, port=0, device="cpu", quantize=True, vertical_crop_height=0.25)
    srv = start(request, ckpt=BASE_CKPT, batch_size=2, quantize=True, calibration_images=tmp_path / "calib",
                vertical_crop_height=0.25, linger_ms=1.0)
    port = srv.server_address[1]
    info = get(port, "/healthz")
    assert info["quantize"] is True and info["input_hw"] == [193, 1032]
    frames = [im for im, _ in get_dataset(path_to_images=tmp_path / "calib", crop_hw=(193, 1032))][:2]
    pred = srv.yogo_state["predictor"]
    assert pred.qp is not None and sum("w8" in b for b in pred.qp["blocks"]) == 3

    def answers():
        return [post(port, f.tobytes(), content_type="application/octet-stream")[1] for f in frames]

    want = [expected(pred.forward(in_batch(f, 2)).numpy()[0], obj_thresh=0.5, iou_thresh=0.5,
                     min_class_confidence_threshold=0.0) for f in frames]
    before = answers()
    assert before == want and sum(a["counts"]["cell"] + a["counts"]["parasite"] for a in before) > 0
    builds = dict(kernels.BUILDS)
    assert srv.reload_checkpoint()["ok"] is True
    assert srv.yogo_state["predictor"] is not pred and srv.yogo_state["predictor"].qp is not pred.qp
    assert answers() == before and dict(kernels.BUILDS) == builds
    assert get(port, "/healthz")["reloads"] == 1


def test_quantized_server_without_int8_blocks_needs_no_calibration(request):
    """half_filters has no block wide enough for int8: `--quantize` serves
    the folded bf16 program, with no calibration images."""
    with pytest.warns(UserWarning, match="every block is skipped"):
        srv = start(request, batch_size=2, quantize=True)
    assert get(srv.server_address[1], "/healthz")["quantize"] is True
    assert not any("w8" in b for b in srv.yogo_state["predictor"].qp["blocks"])
