"""Row-split inference (`--spatial-parallel N`, yogo_tpu_torch/parallel/
spatial.py and parallel/mesh.device_grid) on the CPU, N handles to "cpu".

  - the row arithmetic: every layer's output rows are owned once, and each
    shard's window holds exactly the input rows its kept outputs read,
    at 772 and 96 rows over N = 2, 3, 4;
  - the stem's plain version on each shard's window equals the unsplit
    stem's rows bit for bit (both layouts);
  - the f32 row-split head of the trained base_model checkpoint at
    772x1032 against the unsplit port forward at rtol = atol = 1e-5, and
    the golden per-image counts exact; bf16 (the stem per shard) within 1
    bf16 ulp;
  - predict(spatial_parallel=4, return_full_predictions=True) against the
    JAX package's predict(spatial_parallel=4) on the 8 forced CPU devices,
    at tests/test_parallel.py's rtol 1e-3 / atol 1e-5;
  - int8: the row-split program with the unsplit program's weights and
    scales: the head within 1e-4 of the unsplit one, the codes entering
    each int8 block equal in >= 99.9% of places and off by <= 1 elsewhere;
    predict(quantize=True, spatial_parallel=N) at 772x1032 holds the int8
    golden gates of tests/test_golden_fullres_int8.py;
  - device_grid's choices and refusals.

JAX is imported inside the test that compares with it; the `cuda` test
maps the shards onto one card (python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_spatial.py -m cuda).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_golden_fullres import gen_test_images as gen_fullres
from yogo_tpu_torch.infer import Predictor, predict, quantize_stack
from yogo_tpu_torch.models.defns import get_model_defn
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.ops import quant
from yogo_tpu_torch.ops.postprocess import format_preds
from yogo_tpu_torch.ops.stem import fused_stem_reference
from yogo_tpu_torch.parallel import mesh, spatial
from yogo_tpu_torch.tools.golden_scene import int8_gates
from yogo_tpu_torch.utils.checkpoint import load_any
from yogo_tpu_torch.utils.weights import state_dict_from_flax

REPO = Path(__file__).resolve().parent.parent
GOLDENS = REPO / "tests" / "goldens"
BASE_CKPT = GOLDENS / "trained_base_model_fullres.ckpt"
HALF_CKPT = GOLDENS / "trained_half_filters.ckpt"


@pytest.fixture(scope="module")
def fullres(tmp_path_factory):
    """The 4 golden frames at 772x1032 (their directory and the batch) and
    the committed golden detections."""
    d = tmp_path_factory.mktemp("spatial") / "imgs"
    gen_fullres(d, n=4)
    from PIL import Image

    x = np.stack([np.asarray(Image.open(p)) for p in sorted(d.glob("*.png"))])[:, None]
    g = np.load(GOLDENS / "detections_fullres_base.npz")
    return d, x, {k: g[k] for k in g.files}


@pytest.fixture(scope="module")
def f32_unsplit(fullres):
    """The unsplit f32 port: its Predictor and raw head of the 4 frames."""
    pred = Predictor.from_checkpoint(BASE_CKPT, device="cpu")
    return pred, pred.forward_raw(fullres[1])


def _crop(x, rows=(200, 328), cols=(300, 492)):
    """The golden frames cut to 128x192: the trained checkpoint's
    activations at a size the CPU runs in a second."""
    return np.ascontiguousarray(x[:, :, rows[0]:rows[1], cols[0]:cols[1]])


def _stack(model, variables):
    s = model.module("cpu")
    s.load_state_dict(state_dict_from_flax(variables))
    return s


# ------------------------------------------------------- the row arithmetic
def _walk(blocks, h, n):
    """(h_in, h_out, owned input rows, owned output rows, windows) of each
    layer, from row_split and conv_window alone (no divisibility check)."""
    own = spatial.row_split(h, n)
    for spec in blocks:
        h_out = spatial.out_height(h, spec)
        out = spatial.row_split(h_out, n)
        wins = [spatial.conv_window(lo, hi, h, spec.kernel, spec.stride, spec.padding) for lo, hi in out]
        yield spec, h, h_out, own, out, wins
        h, own = h_out, out


@pytest.mark.parametrize("model_version", ["base_model", "depth_ver_0", "depth_ver_3"])
@pytest.mark.parametrize("h", [772, 96])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_every_output_row_owned_once_and_each_window_is_what_the_conv_reads(h, n, model_version):
    blocks = get_model_defn(model_version)(2).blocks
    plan = spatial.plan_rows(blocks, h, n) if h % n == 0 else None
    for i, (spec, h_in, h_out, own, out, wins) in enumerate(_walk(blocks, h, n)):
        k, s, p = spec.kernel, spec.stride, spec.padding
        # ownership: consecutive, covering [0, h_out) once, sizes within one
        assert out[0][0] == 0 and out[-1][1] == h_out
        assert all(a[1] == b[0] for a, b in zip(out, out[1:]))
        assert max(hi - lo for lo, hi in out) - min(hi - lo for lo, hi in out) <= 1
        for (lo, hi), (a, b, t) in zip(out, wins):
            assert 0 <= a < b <= h_in
            # the op over [a, b) with its own padding reaches the last kept row
            assert (b - a + 2 * p - k) // s + 1 >= t + hi - lo
            reads = set()
            for y in range(lo, hi):
                j = t + y - lo  # the row of the op's output that is global row y
                for r in range(k):
                    local = j * s - p + r  # the slice row that tap reads
                    g = y * s - p + r  # the global row it must be
                    if 0 <= g < h_in:
                        assert a + local == g and 0 <= local < b - a, (i, y, r)
                        reads.add(g)
                    else:  # the image's own zero padding, also in the slice
                        assert local < 0 or local >= b - a, (i, y, r)
            # the window is the rows the kept outputs read, its top moved up
            # to a whole stride (read by a dropped output row)
            assert max(reads) == b - 1 and a <= min(reads) < a + s and a % s == 0, (i, lo, hi)
            if i == 0 and h % 2 == 0:
                assert (b - a) % 2 == 0  # the stem kernel takes even heights
        if h % n == 0:
            lr = plan[i]
            assert (lr.h_in, lr.h_out, lr.own_in, lr.own_out, lr.windows) == (
                h_in, h_out, tuple(own), tuple(out), tuple(wins))


def test_plan_at_772_and_what_it_refuses():
    blocks = get_model_defn("base_model")(2).blocks
    plan = spatial.plan_rows(blocks, 772, 4)
    assert plan[0].own_in == ((0, 193), (193, 386), (386, 579), (579, 772))
    assert plan[0].own_out == ((0, 97), (97, 194), (194, 290), (290, 386))
    # the stem's slices: [0, 2hi) on top, [2lo - 2, 2hi) below
    assert plan[0].windows == ((0, 194, 0), (192, 388, 1), (386, 580, 1), (578, 772, 1))
    assert [lr.h_out for lr in plan] == [386, 386, 193, 193, 97, 97, 97, 97]
    with pytest.raises(ValueError, match="divisible"):
        spatial.plan_rows(blocks, 772, 3)
    with pytest.raises(ValueError, match="fewer than"):
        spatial.plan_rows(blocks, 16, 4)  # the head grid has 2 rows
    # ConvNeXt-Small plans (its heights at 772: 193 -> 96 -> 48 -> 24, the
    # head 96) and runs: the f32 head of a small split at 1e-5
    cnx = YOGO.create((64, 96), 0.1, 0.1, 2, model_version="convnext_small")
    heights = [lr.h_out for lr in spatial.plan_rows(spatial.convnext_layers(), 772, 4)]
    assert [heights[i] for i in (0, 4, 8, 36, 40, 41)] == [193, 96, 48, 24, 24, 96]
    torch.manual_seed(0)
    net = cnx.module("cpu")
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 1, 64, 96), np.uint8))
    raw = Predictor(cnx, net, devices=["cpu"] * 2).forward_raw(x)
    torch.testing.assert_close(raw, Predictor(cnx, net).forward_raw(x), rtol=1e-5, atol=1e-6)


def test_windows_keep_their_owners_memory_order():
    """A shard's window is made dense in its owners' memory order, so its
    ops see the layout the unsplit forward's see (cuDNN picks algorithms,
    and so roundings, by layout); an axis of size 1 keeps its place,
    whatever stride it carries (a frame's channel axis may carry 0)."""
    for like, want in (
        (torch.zeros(4, 1, 10, 12).as_strided((4, 1, 10, 12), (120, 0, 12, 1)), (60, 60, 12, 1)),
        (torch.zeros(4, 1, 10, 12), (60, 60, 12, 1)),
        (torch.zeros(4, 8, 10, 12).contiguous(memory_format=torch.channels_last), (480, 1, 96, 8)),
        (torch.zeros(4, 8, 10, 12).permute(0, 2, 3, 1), (480, 12, 1, 60)),  # NHWC view of NCHW
        (torch.zeros(4, 10, 12, 32, dtype=torch.int8), (1920, 384, 32, 1)),  # NHWC codes
    ):
        rows = 2 if like.shape[1] in (1, 8) else 1
        win = spatial._dense_like(like.narrow(rows, 2, 5), like)
        assert win.stride() == want and torch.equal(win, like.narrow(rows, 2, 5))


# ----------------------------------------------------------- stem per shard
@pytest.mark.parametrize("n", [2, 4])
def test_stem_plain_version_per_shard_is_the_unsplit_rows(fullres, f32_unsplit, n):
    x = torch.from_numpy(fullres[1][:2, 0].copy())
    w9, b9 = (t.detach() for t in f32_unsplit[0].stack.folded_stem())
    lr = spatial.plan_rows(get_model_defn("base_model")(2).blocks, 772, n)[0]
    for layout in ("nhwc", "nchw"):
        whole = fused_stem_reference(x, w9, b9, layout)
        for (lo, hi), (a, b, t) in zip(lr.own_out, lr.windows):
            part = fused_stem_reference(x[:, a:b].contiguous(), w9, b9, layout)
            assert torch.equal(part[:, :, t:t + hi - lo], whole[:, :, lo:hi])


# -------------------------------------------------------- float, 772x1032
@pytest.mark.parametrize("n", [2, 4])
def test_f32_row_split_head_equals_unsplit_and_counts_are_golden(fullres, f32_unsplit, n):
    pred1, raw1 = f32_unsplit
    pred = Predictor(pred1.model, pred1.stack, devices=["cpu"] * n)
    raw = pred.forward_raw(fullres[1])
    assert raw.shape == raw1.shape == (4, 97, 129, 7) and raw.dtype == torch.float32
    torch.testing.assert_close(raw, raw1, rtol=1e-5, atol=1e-5)
    assert pred.rows.halo_bytes > 0
    golden = fullres[2]
    for i in range(4):
        mask = torch.arange(4) == i
        assert int(pred.count(raw, mask).sum()) == len(golden[f"dets_{i}"])


@pytest.mark.parametrize("n", [2, 4])
def test_bf16_row_split_runs_the_stem_per_shard(fullres, monkeypatch, n):
    model, v, _ = load_any(BASE_CKPT)
    model = model.resize(128, 192).with_compute_dtype(torch.bfloat16)
    stack = _stack(model, v)
    x = _crop(fullres[1])
    calls = []
    stem = spatial.fused_stem_nchw
    monkeypatch.setattr(spatial, "fused_stem_nchw", lambda im, *a, **k: calls.append(im.shape) or stem(im, *a, **k))
    raw1 = Predictor(model, stack).forward_raw(x)
    raw = Predictor(model, stack, devices=["cpu"] * n).forward_raw(x)
    # one stem a shard, on its window of the uint8 rows
    wins = spatial.plan_rows(model.defn.blocks, 128, n)[0].windows
    assert calls == [(len(x), b - a, 192) for a, b, _ in wins]
    assert raw.dtype == torch.bfloat16
    # 1 bf16 ulp at the head's range (the same ops on the same rows)
    torch.testing.assert_close(raw.float(), raw1.float(), rtol=8e-3, atol=1e-2)


def test_predict_spatial_parallel_matches_jax_and_the_unsplit_port(tmp_path):
    """tests/test_parallel.py:335's case, on the port: full decoded
    predictions with each image's rows over 4 devices."""
    from tests.test_golden_detections import gen_test_images
    from yogo_tpu.infer import predict as jax_predict

    img_dir = tmp_path / "imgs"
    gen_test_images(img_dir, n=5, seed=4)
    kw = dict(path_to_images=img_dir, return_full_predictions=True, batch_size=3, use_tqdm=False)
    theirs = np.asarray(jax_predict(HALF_CKPT, spatial_parallel=4, **kw), np.float32)
    single = predict(HALF_CKPT, device="cpu", **kw)
    mine = predict(HALF_CKPT, spatial_parallel=4, device="cpu", **kw)
    assert mine.shape == theirs.shape == (5, 7, 12, 16)
    np.testing.assert_allclose(mine, theirs, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(mine, single, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------- int8
@pytest.mark.parametrize("n", [2, 4])
def test_int8_row_split_equals_the_unsplit_program(fullres, n):
    model, v, _ = load_any(BASE_CKPT)
    model = model.resize(128, 192)
    stack = _stack(model, v)
    x = _crop(fullres[1])
    qp = quantize_stack(model, stack, [x])
    assert [j + 1 for j, b in enumerate(qp["blocks"]) if "w8" in b] == [4, 5, 6]
    rec1, rec = [], []
    raw1 = quant.quantized_forward(model, qp, torch.from_numpy(x), decode=False, record=rec1)
    pred = Predictor(model, stack, qp=qp, devices=["cpu"] * n)
    raw = pred.rows.forward_raw(pred.shard_weights, torch.from_numpy(x), record=rec)
    assert raw.shape == raw1.shape and raw.dtype == torch.float32
    torch.testing.assert_close(raw, raw1, rtol=0, atol=1e-4)
    assert len(rec) == len(rec1) == 3
    for got, want in zip(rec, rec1):
        d = (got.int() - want.int()).abs()
        assert got.shape == want.shape and int(d.max()) <= 1 and float((d == 0).float().mean()) >= 0.999
    # the predictor's own forward is that head
    torch.testing.assert_close(pred.forward_raw(x), raw, rtol=0, atol=0)


@pytest.mark.parametrize("n", [2, 4])
def test_predict_quantize_spatial_parallel_holds_the_int8_golden_gates(fullres, n):
    img_dir, _, golden = fullres
    preds = predict(BASE_CKPT, path_to_images=img_dir, return_full_predictions=True, batch_size=4,
                    quantize=True, spatial_parallel=n, device="cpu")
    dets = [format_preds(p, obj_thresh=0.5, iou_thresh=0.5) for p in preds]
    gates = int8_gates(dets, golden)
    assert not gates["failures"], gates


# ----------------------------------------------------------- device_grid
def test_device_grid_choices_and_refusals(monkeypatch):
    cpu = torch.device("cpu")
    assert mesh.device_grid(4, device="cpu") == [[cpu] * 4]
    assert mesh.device_grid(2, True, device="cpu") == [[cpu] * 2]
    assert mesh.device_grid(1, devices=["cpu", "cpu"]) == [[cpu]]
    assert mesh.device_grid(2, devices=["cpu"] * 3) == [[cpu] * 2]
    assert mesh.device_grid(1, True, devices=["cpu"] * 2) == [[cpu], [cpu]]
    assert mesh.device_grid(2, True, devices=["cpu"] * 4) == [[cpu] * 2] * 2
    with pytest.raises(ValueError, match="must divide the device count 3"):
        mesh.device_grid(2, True, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="needs 4 devices, got 2"):
        mesh.device_grid(4, devices=["cpu"] * 2)
    # the cards, counted without touching one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert mesh.device_grid(2) == [cards[:2]]
    assert mesh.device_grid(2, device="cuda:2") == [cards[2:]]
    assert mesh.device_grid(2, True) == [cards[:2], cards[2:]]
    assert mesh.device_grid(1, True) == [[c] for c in cards]
    with pytest.raises(ValueError, match="3 cards; 4 are visible|5 cards; 4 are visible"):
        mesh.device_grid(3, device="cuda:2")
    with pytest.raises(ValueError, match="must divide the device count 4"):
        mesh.device_grid(3, True)
    # under a process group a rank takes its own N cards
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert mesh.device_grid(2, True) == [cards[2:]]
    assert mesh.device_grid(2) == [cards[2:]]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(ValueError, match="need 4 cards; 3 are visible"):
        mesh.device_grid(2, True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.device_grid(2)


def test_replicas_share_weights_on_one_device_and_copy_to_another():
    model = YOGO.create((32, 48), 0.1, 0.1, 2, model_version="quarter_filters")
    stack = model.init(torch.Generator().manual_seed(0), device="cpu")
    qp = {"a": torch.ones(2), "blocks": [{"w": torch.zeros(1)}], "n": 3}
    assert mesh.replicate(stack, qp, torch.device("cpu")) == (stack, qp)
    pred = Predictor(model, stack, qp=None, devices=["cpu"] * 2)
    assert all(s is stack and q is None for s, q in pred.shard_weights)
    with pytest.raises(ValueError, match="first row shard"):
        Predictor(model, stack, devices=["meta", "cpu"])


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_cuda_shards_on_one_card_launch_the_stem_once_each(cuda, fullres, n):
    from yogo_tpu_torch.utils import tracing

    x = fullres[1]
    pred1 = Predictor.from_checkpoint(BASE_CKPT, half=True, device="cuda:0")
    pred = Predictor.from_checkpoint(BASE_CKPT, half=True, devices=["cuda:0"] * n)
    before = tracing.COUNTS["stem_nhwc_kernel_launches"]
    raw = pred.forward_raw(x)
    torch.cuda.synchronize()
    assert tracing.COUNTS["stem_nhwc_kernel_launches"] - before == n
    raw1 = pred1.forward_raw(x)
    for i in range(4):
        m = torch.arange(4) == i
        assert abs(int(pred.count(raw, m).sum()) - int(pred1.count(raw1, m).sum())) <= 2
