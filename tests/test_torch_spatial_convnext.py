"""ConvNeXt-Small's row split (yogo_tpu_torch/parallel/spatial.py,
RowSplit.convnext) on the CPU, N handles to "cpu", at full width and
depth on seeded perturbed weights (torch's default init, then every gamma
from N(0.5, 0.2) and every bias from N(0, 0.1): at init each block is the
identity):

  - the row plan of ConvNeXt's layers at 772 rows for N = 2 and 4: every
    output row owned once, each window the rows the layer reads (the
    transpose upsample maps each shard's rows to 4x as many);
  - the f32 split head against the unsplit head, rtol 1e-5 / atol 1e-6,
    at 128x128 over 4 shards and 64x64 over 2 (the rest at 64x64 over 2);
  - predict(spatial_parallel=2) against the JAX package's
    predict(spatial_parallel=2) on a checkpoint of those weights, at
    tests/test_torch_spatial.py's rtol 1e-3 / atol 1e-5;
  - int8: the split program with the unsplit program's weights and scales
    requantizes each shard's own rows: the codes entering all 71 sites and
    the head equal the unsplit program's bit for bit (every shard's ops
    see the unsplit forward's memory layout);
  - one split train step (f32, flips on, remat "blocks") against the
    unsplit step:
    the loss at rtol 1e-5, every parameter's gradient at rtol 1e-4 of its
    largest element;
  - 64x64 over 4 shards is refused: its last stage has 2 rows (JAX's
    GSPMD pads it instead; ROADMAP.md Queue 3);
  - each shard's int8 conv rows equal one conv over the shards' codes put
    together, at all 71 sites (the plain version here);
  - `cuda` tests: the int8 conv kernel launched per shard (71 N a batch),
    each launch's rows bit-equal to the unsplit launch's on the same
    codes. They skip here (python -m pytest --noconftest -p
    no:cacheprovider tests/test_torch_spatial_convnext.py -m cuda).
"""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from yogo_tpu_torch.infer import Predictor, predict, quantize_stack
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.ops import quant_convnext as qc
from yogo_tpu_torch.parallel import spatial
from yogo_tpu_torch.train import TrainState, make_optimizer, make_train_step
from yogo_tpu_torch.utils import tracing
from yogo_tpu_torch.utils.checkpoint import save_checkpoint
from yogo_tpu_torch.utils.weights import flax_from_state_dict

CLASSES = ["healthy", "ring"]
CPU = torch.device("cpu")
LOSS_KW = dict(no_obj_weight=0.5, iou_weight=5.0, classify_weight=1.0, label_smoothing=0.01)


def perturbed(model, device="cpu", seed=0):
    """ConvNeXt-Small with torch's default init (seeded), gammas and biases
    redrawn."""
    torch.manual_seed(seed)
    net = model.module("cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("gamma"):
                p.copy_(0.5 + 0.2 * torch.randn(p.shape, generator=gen))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return net.to(device)


def frames(b, hw, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (b, 1, *hw), np.uint8))


@pytest.fixture(scope="module")
def nets():
    """The model at 128x128 (N = 4) and 64x64 (N = 2), with one set of
    weights (they do not depend on the image size)."""
    models = {n: YOGO.create(hw, 0.1, 0.12, len(CLASSES), model_version="convnext_small")
              for hw, n in (((128, 128), 4), ((64, 64), 2))}
    net = perturbed(models[2])
    return {n: (m, net) for n, m in models.items()}


# ------------------------------------------------------------ the plan
@pytest.mark.parametrize("n", [2, 4])
def test_plan_owns_every_row_once_and_each_window_is_what_the_layer_reads(n):
    layers = spatial.convnext_layers()
    plan = spatial.plan_rows(layers, 772, n)
    assert len(plan) == 1 + 3 + 36 + 2 == len(layers)
    assert [plan[i].h_out for i in (0, 4, 8, 36, 40, 41)] == [193, 96, 48, 24, 24, 96]
    for i, (spec, lr) in enumerate(zip(layers, plan)):
        k, s, p = spec.kernel, spec.stride, spec.padding
        assert lr.own_out[0][0] == 0 and lr.own_out[-1][1] == lr.h_out
        assert all(a[1] == b[0] for a, b in zip(lr.own_out, lr.own_out[1:]))
        if i + 1 < len(plan):
            assert plan[i + 1].own_in == lr.own_out and plan[i + 1].h_in == lr.h_out
        for (lo, hi), (a, b, t), own in zip(lr.own_out, lr.windows, lr.own_in):
            assert 0 <= a < b <= lr.h_in
            if spec.transpose:  # each input row gives `stride` output rows
                assert (a, b) == own and t == 0 and (lo, hi) == (s * own[0], s * own[1])
                continue
            assert (b - a + 2 * p - k) // s + 1 >= t + hi - lo
            reads = set()
            for y in range(lo, hi):
                j = t + y - lo  # the row of the op's output that is global row y
                for r in range(k):
                    local, g = j * s - p + r, y * s - p + r
                    if 0 <= g < lr.h_in:
                        assert a + local == g and 0 <= local < b - a, (i, y, r)
                        reads.add(g)
                    else:  # the image's own padding, also the slice's
                        assert local < 0 or local >= b - a, (i, y, r)
            assert max(reads) == b - 1 and a <= min(reads), (i, lo, hi)
    # the downsample of 193 rows drops the last: the last window ends at 2 hi
    assert plan[4].windows[-1][1] == 2 * plan[4].own_out[-1][1] == 192


def test_64_rows_over_4_shards_are_refused_and_a_transpose_that_overlaps_too():
    model = YOGO.create((64, 64), 0.1, 0.12, len(CLASSES), model_version="convnext_small")
    with pytest.raises(ValueError, match="gives 2 rows, fewer than the 4 row shards"):
        spatial.RowSplit(model, [CPU] * 4)
    overlapping = spatial.ConvSpec(0, kernel=4, stride=2, padding=1, transpose=True)
    with pytest.raises(NotImplementedError, match="kernel \\(4\\) is not its stride \\(2\\)"):
        spatial.plan_rows((overlapping,), 8, 2)


# ------------------------------------------------------------ float
@pytest.mark.parametrize("n", [4, 2])
def test_f32_split_head_equals_the_unsplit_head(nets, n):
    model, net = nets[n]
    x = frames(2, model.img_size)
    pn = Predictor(model, net, devices=["cpu"] * n)
    raw = pn.forward_raw(x)
    raw1 = Predictor(model, net).forward_raw(x)
    assert raw.shape == raw1.shape == (2, *model.grid[::-1], 7) and raw.dtype == torch.float32
    torch.testing.assert_close(raw, raw1, rtol=1e-5, atol=1e-6)
    assert pn.rows.halo_bytes > 0


def test_predict_spatial_parallel_matches_jax(nets, tmp_path):
    from PIL import Image

    from yogo_tpu.infer import predict as jax_predict

    model, net = nets[2]
    ckpt = tmp_path / "cnx.ckpt"
    save_checkpoint(ckpt, model, flax_from_state_dict(net.state_dict()), classes=CLASSES)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, im in enumerate(frames(3, model.img_size, seed=2).numpy()):
        Image.fromarray(im[0]).save(img_dir / f"f{i}.png")
    kw = dict(path_to_images=img_dir, return_full_predictions=True, batch_size=3, use_tqdm=False)
    theirs = np.asarray(jax_predict(ckpt, spatial_parallel=2, **kw), np.float32)
    mine = predict(ckpt, spatial_parallel=2, device="cpu", **kw)
    assert mine.shape == theirs.shape == (3, 7, *model.grid[::-1])
    np.testing.assert_allclose(mine, theirs, rtol=1e-3, atol=1e-5)


# ------------------------------------------------------------- int8
def shard_site_outputs(monkeypatch):
    """Spy on the int8 program's sites: {site key: [each call's f32 output]}."""
    seen = {}
    site_conv = qc.QuantLayers.site_conv

    def spy(self, key, h, stride):
        y = site_conv(self, key, h, stride)
        if key in self.int8:
            seen.setdefault(key, []).append(y)
        return y

    monkeypatch.setattr(qc.QuantLayers, "site_conv", spy)
    return seen


@pytest.fixture(scope="module")
def int8_run(nets):
    """64x64 over 2 shards: the program calibrated on the batch with the
    unsplit forward; the unsplit and the split heads and codes, and the
    split's int8 conv outputs by site."""
    model, net = nets[2]
    x = frames(2, model.img_size, seed=1)
    qp = quantize_stack(model, net, [x])
    rec1, rec = [], []
    raw1 = qc.quantized_convnext_forward(model, qp, x, decode=False, record=rec1)
    pred = Predictor(model, net, qp=qp, devices=["cpu"] * 2)
    with pytest.MonkeyPatch.context() as mp:
        seen = shard_site_outputs(mp)
        raw = pred.rows.forward_raw(pred.shard_weights, x, record=rec)
    return dict(x=x, qp=qp, pred=pred, raw1=raw1, rec1=rec1, raw=raw, rec=rec, seen=seen)


def test_int8_split_codes_at_every_site_and_head_equal_the_unsplit_program(int8_run):
    r = int8_run
    assert len(r["rec"]) == len(r["rec1"]) == len(qc.quant_sites()) == 71
    for (key, _), got, want in zip(qc.quant_sites(), r["rec"], r["rec1"]):
        assert got.dtype == torch.int8 and torch.equal(got, want), key
    assert torch.equal(r["raw"], r["raw1"])
    torch.testing.assert_close(r["pred"].forward_raw(r["x"]), r["raw"], rtol=0, atol=0)


def test_each_shard_s_int8_conv_rows_equal_the_unsplit_conv_on_the_same_codes(int8_run):
    """What the card checks per launch, on the plain version here: at every
    site, the shards' outputs in row order equal one conv over the codes
    the shards requantized, put together."""
    qp, seen = int8_run["qp"], int8_run["seen"]
    keys = [k for k, _ in qc.quant_sites()]
    assert list(seen) == keys and all(len(v) == 2 for v in seen.values())
    for key, codes in zip(keys, int8_run["rec"]):
        blk = qp["int8"][key]
        stride = 2 if key.startswith("down") else 1
        whole = qc.int8_conv(codes, blk["w8"], blk["deq"], blk["b"], cin=codes.shape[-1], stride=stride,
                             padding=0, act=None)
        assert torch.equal(torch.cat(seen[key], 1), whole), key


# ------------------------------------------------------------ training
def test_split_train_step_equals_the_unsplit_step(nets):
    model, net = nets[2]
    sx, sy = model.grid
    x = frames(2, model.img_size, seed=3)
    labels = torch.zeros(2, 6, sy, sx)
    labels[:, :, 2, 3] = torch.tensor([1, 0.4, 0.4, 0.6, 0.6, 1])
    out = {}
    for n in (1, 2):
        stack = copy.deepcopy(net)
        opt, sched, _ = make_optimizer(stack.parameters(), 1e-3, 5e-2, 10.0, 20)
        rows = spatial.RowSplit(model, [CPU] * n) if n > 1 else None
        step = make_train_step(model, LOSS_KW, remat="blocks" if n > 1 else "none", rows=rows)
        _, loss, _ = step(TrainState(stack, opt, sched), x, labels, torch.ones(2),
                          torch.Generator().manual_seed(3))
        out[n] = (float(loss), {k: p.grad for k, p in stack.named_parameters()})
    np.testing.assert_allclose(out[2][0], out[1][0], rtol=1e-5)
    for k, g in out[1][1].items():
        torch.testing.assert_close(out[2][1][k], g, rtol=1e-4, atol=1e-4 * float(g.abs().max()), msg=k)


# -------------------------------------------------------------- card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_cuda_int8_conv_per_shard_launches_71_n_and_each_equals_the_unsplit_launch(cuda, n, monkeypatch):
    from yogo_tpu_torch.ops import int8_conv as ic

    model = YOGO.create((128, 128), 0.1, 0.12, len(CLASSES), model_version="convnext_small")
    dev = torch.device("cuda", 0)
    net = perturbed(model, dev)
    x = frames(4, model.img_size, seed=1).to(dev)
    qp = quantize_stack(model, net, [x])
    seen = shard_site_outputs(monkeypatch)
    pred = Predictor(model, net, qp=qp, devices=[dev] * n)
    rec = []
    before = tracing.COUNTS["int8_conv_kernel_launches"]
    pred.rows.forward_raw(pred.shard_weights, x, record=rec)
    torch.cuda.synchronize()
    assert tracing.COUNTS["int8_conv_kernel_launches"] - before == 71 * n
    for (key, _), codes in zip(qc.quant_sites(), rec):
        blk = qp["int8"][key]
        stride = 2 if key.startswith("down") else 1
        whole = ic.int8_conv(codes.contiguous(), blk["w8"], blk["deq"], blk["b"], cin=codes.shape[-1],
                             stride=stride, padding=0, act=None)
        assert len(seen[key]) == n and torch.equal(torch.cat(seen[key], 1), whole), key
