"""The port's ServeClient (yogo_tpu_torch/serve_client.py) against the
port's live server on the CPU: the cases of tests/test_serve_client.py
(chunking to max_frames_per_request, input order, threshold overrides,
local validation, 503 backoff, reconnects, gzip, .pth serving, hot
reload), and the JAX package's own ServeClient against the port's server:
the wire protocol is the same. Responses compare JSON-level (exact)."""

import ast
import json
import socket
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_golden_detections import gen_test_images
from tests.test_torch_serve import CKPT, CLASSES, TIMEOUT, post, start
from yogo_tpu_torch import kernels
from yogo_tpu_torch.serve_client import ServeClient, ServerOverloaded

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def server(request):
    return start(request, batch_size=4, linger_ms=20.0, max_frames_per_request=16)


@pytest.fixture(scope="module")
def client(server):
    c = ServeClient("127.0.0.1", server.server_address[1], timeout=TIMEOUT)
    yield c
    c.close()


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return [im[None] for im in gen_test_images(tmp_path_factory.mktemp("client"), n=4, seed=5)]


def test_client_imports_only_the_standard_library_and_numpy():
    tree = ast.parse((REPO / "yogo_tpu_torch" / "serve_client.py").read_text())
    mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert mods == {"__future__", "gzip", "http", "json", "time", "typing", "numpy"}


def test_discovery_and_single_predict_parity(server, client, frames):
    assert client.img_chw == (1, *server.yogo_info["input_hw"]) and client.max_frames == 16
    port = server.server_address[1]
    for f in frames:
        _, want = post(port, f.tobytes(), content_type="application/octet-stream")
        assert client.predict(f) == want


def test_predict_many_chunks_and_preserves_order(client, frames):
    singles = [client.predict(f) for f in frames]
    results = client.predict_many(np.stack([frames[i % 4] for i in range(35)]))  # 16 + 16 + 3
    assert len(results) == 35
    for i, r in enumerate(results):
        assert r == singles[i % 4]


def test_threshold_kwargs(client, frames):
    loose = client.predict(frames[0], obj_thresh=0.1)
    strict = client.predict(frames[0], obj_thresh=0.99)
    assert len(strict["detections"]) <= len(loose["detections"])
    with pytest.raises(RuntimeError, match="unknown query"):
        client.predict(frames[0], obj_tresh=0.5)


def test_input_validation_is_local(client):
    with pytest.raises(ValueError, match="frames must be"):
        client.predict(np.zeros((1, 8, 8), np.uint8))
    with pytest.raises(ValueError, match="frames must be"):
        client.predict_many(np.zeros((2, 3, 4), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        client.predict_many(np.zeros((1, *client.img_chw), np.float32))
    with pytest.raises(ValueError, match="predict_many"):
        client.predict(np.zeros((2, *client.img_chw), np.uint8))


def test_retry_after_http_date_and_503_backoff(client, frames, monkeypatch):
    """A Retry-After in HTTP-date form falls back to the default delay; a
    shed is retried with the server's hint; a persistent shed surfaces as
    ServerOverloaded after max_retries."""
    real = ServeClient._request
    sheds = {"n": 0}
    monkeypatch.setattr("time.sleep", lambda s: None)

    def flaky(self, method, path, body, ctype, limit=2, hint="0"):
        if method == "POST" and sheds["n"] < limit:
            sheds["n"] += 1
            return 503, {"Retry-After": hint}, json.dumps({"error": "overloaded: test"}).encode()
        return real(self, method, path, body, ctype)

    want = client.predict(frames[0])
    monkeypatch.setattr(ServeClient, "_request",
                        lambda *a: flaky(*a, limit=1, hint="Wed, 21 Oct 2026 07:28:00 GMT"))
    assert client.predict(frames[0]) == want and sheds["n"] == 1
    sheds["n"] = 0
    monkeypatch.setattr(ServeClient, "_request", flaky)
    assert client.predict(frames[0]) == want and sheds["n"] == 2
    monkeypatch.setattr(ServeClient, "_request",
                        lambda *a: (503, {"Retry-After": "0"}, b'{"error": "overloaded: always"}'))
    with pytest.raises(ServerOverloaded, match="always"):
        client.predict(frames[0])


def test_reconnects_after_server_side_close(client, frames):
    client._connection().connect()
    client._conn.sock.shutdown(socket.SHUT_RDWR)  # a dropped keep-alive
    assert client.predict(frames[0]) == client.predict(frames[0])


def test_gzip_negotiation(server, client, frames):
    import gzip
    import http.client

    body = np.concatenate([frames[0]] * 8).tobytes()

    def raw_post(hdrs):
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=TIMEOUT)
        try:
            conn.request("POST", "/predict?obj_thresh=0.1", body=body,
                         headers={"Content-Type": "application/octet-stream", **hdrs})
            r = conn.getresponse()
            return r.read(), r.headers.get("Content-Encoding")
        finally:
            conn.close()

    plain, enc0 = raw_post({})
    zipped, enc1 = raw_post({"Accept-Encoding": "gzip"})
    assert enc0 is None and enc1 == "gzip" and len(zipped) < len(plain)
    assert gzip.decompress(zipped) == plain
    got = client.predict_many(np.stack([frames[0]] * 8), obj_thresh=0.1)
    assert json.dumps({"results": got}).encode() == plain


def test_serve_from_pth_checkpoint(request, tmp_path, client, frames):
    from yogo_tpu_torch.utils.checkpoint import load_checkpoint
    from yogo_tpu_torch.utils.torch_bridge import save_pth

    model, variables, _ = load_checkpoint(CKPT)
    save_pth(tmp_path / "m.pth", model, variables, classes=CLASSES)
    srv = start(request, ckpt=tmp_path / "m.pth", batch_size=4, linger_ms=20.0)
    with ServeClient("127.0.0.1", srv.server_address[1], timeout=TIMEOUT) as c:
        assert c.info["classes"] == CLASSES
        got = c.predict(frames[0])
    # the .pth holds anchors as float32: counts and classes as the .ckpt's
    want = client.predict(frames[0])
    assert got["counts"] == want["counts"]
    assert [d["class_idx"] for d in got["detections"]] == [d["class_idx"] for d in want["detections"]]
    for a, b in zip(got["detections"], want["detections"]):
        np.testing.assert_allclose(a["bbox_cxcywh"], b["bbox_cxcywh"], rtol=1e-6)


def test_hot_reload_swaps_weights_without_a_rebuild(request, tmp_path, frames):
    """reload_checkpoint: new weights serve on the next dispatch from a
    stack built off to the side (the old one is not written in place), no
    kernel library is built or loaded again, and an incompatible checkpoint
    is refused while the old weights keep serving."""
    from yogo_tpu_torch.models.yogo import YOGO
    from yogo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    model, variables, _ = load_checkpoint(CKPT)
    ckpt = tmp_path / "serving.ckpt"
    save_checkpoint(ckpt, model, variables, classes=CLASSES)
    srv = start(request, ckpt=ckpt, batch_size=2, linger_ms=1.0)
    with ServeClient("127.0.0.1", srv.server_address[1], timeout=TIMEOUT) as c:
        before = c.predict(frames[0])
        old = srv.yogo_state["predictor"].stack
        old_weights = {k: v.clone() for k, v in old.state_dict().items()}
        builds, loaded = dict(kernels.BUILDS), dict(kernels._loaded)

        bumped = {g: {n: {leaf: np.asarray(a) * 1.1 for leaf, a in leaves.items()}
                      for n, leaves in tree.items()} for g, tree in variables.items()}
        save_checkpoint(ckpt, model, bumped, classes=CLASSES)
        out = srv.reload_checkpoint()
        assert out["ok"], out
        after = c.predict(frames[0])
        assert after != before
        assert srv.yogo_state["predictor"].stack is not old
        for k, v in old.state_dict().items():
            assert torch.equal(v, old_weights[k]), k  # never written in place
        assert dict(kernels.BUILDS) == builds and dict(kernels._loaded) == loaded

        other = YOGO.create(model.img_size, 0.04, 0.05, num_classes=5)
        stack = other.init(torch.Generator().manual_seed(0), device="cpu")
        from yogo_tpu_torch.utils.weights import flax_from_state_dict

        save_checkpoint(ckpt, other, flax_from_state_dict(stack.state_dict()),
                        classes=[f"c{i}" for i in range(5)])
        out = srv.reload_checkpoint()
        assert not out["ok"] and "incompatible" in out["error"]
        assert c.predict(frames[0]) == after
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.server_address[1]}/healthz",
                                    timeout=TIMEOUT) as r:
            assert json.loads(r.read())["reloads"] == 1


def test_metrics_passthrough(server, client):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.server_address[1]}/metrics",
                                timeout=TIMEOUT) as r:
        want = json.loads(r.read())
    assert set(client.metrics()) == set(want)


def test_jax_client_talks_to_the_port_s_server(server, client, frames):
    """The JAX package's ServeClient against the port's server: the same
    discovery, the same answers, chunking and all."""
    from yogo_tpu.serve_client import ServeClient as JaxServeClient

    with JaxServeClient("127.0.0.1", server.server_address[1], timeout=TIMEOUT) as jc:
        assert jc.img_chw == client.img_chw and jc.max_frames == client.max_frames
        assert jc.predict_many(np.stack(frames * 5)) == client.predict_many(np.stack(frames * 5))
        assert jc.predict(frames[1], obj_thresh=0.2) == client.predict(frames[1], obj_thresh=0.2)
