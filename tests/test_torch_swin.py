"""The port's Swin-S trunk (models/yogo.py SwinSmall, family "swin", which
only the port has) against the benchmark's plain float32 reference
(yogo_bench/families/swin.py, written from the published detection
backbone), on the CPU at a small size: 100x132 frames, so that the maps
are 25x33 -> 13x17 -> 7x9 -> 4x5 and every stage pads its windows and
every merge pads an odd side; widths 32/64/128/256, heads 1/2/4/8 (the
published head size 32), depths 2/2/2/2. Also: the layout pieces against
the published constructions, the spans and counters, a native checkpoint
that counts through Predictor and `infer --count`, and the paths that
refuse the family."""

import contextlib
import json

import pytest
import torch

from yogo_bench import manifest, reference, scene, weights
from yogo_bench.families import swin as ref_swin
from yogo_tpu_torch.infer import Predictor, predict
from yogo_tpu_torch.models import yogo as Y
from yogo_tpu_torch.models.defns import get_model_defn
from yogo_tpu_torch.ops.grid import grid_size
from yogo_tpu_torch.utils import tracing
from yogo_tpu_torch.utils.checkpoint import save_checkpoint
from yogo_tpu_torch.utils.weights import flax_from_state_dict

HW = (100, 132)
SMALL = {"dims": [32, 64, 128, 256], "heads": [1, 2, 4, 8], "depths": [2, 2, 2, 2]}
MAPS = [(25, 33, 28, 35), (13, 17, 14, 21), (7, 9, 7, 14), (4, 5, 7, 7)]  # (h, w, hp, wp) a stage
B = 2


def config(**over) -> dict:
    with open(manifest.ROOT / "yogo_bench/configs/swin_small.json") as f:
        cfg = json.load(f)
    return {**cfg, "img_size": list(HW), **over}


def small_net(cfg: dict) -> Y.SwinSmall:
    return Y.SwinSmall(5 + cfg["num_classes"], 1, depths=tuple(cfg["depths"]), dims=tuple(cfg["dims"]),
                       heads=tuple(cfg["heads"])).eval()


@pytest.fixture(scope="module")
def seeded():
    """(config, seeded weights, frames, the reference's float32 head)."""
    cfg = config(**SMALL)
    w = weights.production_density(weights.make(ref_swin.spec(cfg), 7, "cpu"), cfg)
    frames, _ = scene.pool(11, range(B), hw=HW, blobs=(2, 5))
    return cfg, w, frames, reference.head(w, frames, cfg)


def port_head(cfg, w, frames, dtype):
    net = small_net(cfg)
    net.load_state_dict(w, strict=True)
    model = Y.YOGO.create(HW, cfg["anchor_w"], cfg["anchor_h"], cfg["num_classes"], model_version="swin_small",
                          compute_dtype=dtype)
    return model.apply(net, torch.from_numpy(frames), decode=False)


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    d = a.double() - b.double()
    return float(d.norm() / b.double().norm())


def test_the_small_size_pads_every_stage(seeded):
    cfg = seeded[0]
    assert ref_swin.stage_maps(cfg) == MAPS
    assert seeded[3].shape == (B, 16, 20, 7)


def test_float32_head_matches_the_reference(seeded):
    """float32 on both sides: only the order of float32 roundings differs
    (the port's LayerNorm takes the variance as E[x^2] - E[x]^2, its
    attention is scaled_dot_product_attention's softmax), ~1e-6 of the
    head over 8 blocks; 1e-5 leaves room and no part of the mathematics."""
    cfg, w, frames, ref = seeded
    out = port_head(cfg, w, frames, torch.float32)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel_rms(out, ref) < 1e-5
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_bfloat16_head_matches_the_reference_and_fp8_does_not(seeded):
    """bf16 operands in every conv and Dense (and the bias in bf16) round
    each by up to 2^-9, over 8 blocks: the head reads ~0.005-0.01 of its
    norm from the float32 reference; 0.02 leaves room. The reference
    computed in float8 e4m3, the precision below, reads above it."""
    cfg, w, frames, ref = seeded
    out = port_head(cfg, w, frames, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert rel_rms(out, ref) < 0.02
    assert rel_rms(reference.head(w, frames, cfg, cast=reference.fp8), ref) > 0.02


# ---------------------------------------------------------------- pieces


def published_partition(x, win):
    b, h, w, c = x.shape
    x = x.view(b, h // win, win, w // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, win, win, c)


def published_mask(hp, wp, win, shift):
    """BasicLayer.forward of the detection backbone."""
    img_mask = torch.zeros((1, hp, wp, 1))
    h_slices = (slice(0, -win), slice(-win, -shift), slice(-shift, None))
    w_slices = (slice(0, -win), slice(-win, -shift), slice(-shift, None))
    cnt = 0
    for h in h_slices:
        for w in w_slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    mask_windows = published_partition(img_mask, win).view(-1, win * win)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0, float(0.0))


def published_index(win):
    """WindowAttention.__init__'s relative_position_index."""
    coords_h = torch.arange(win)
    coords_w = torch.arange(win)
    coords = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += win - 1
    relative_coords[:, :, 1] += win - 1
    relative_coords[:, :, 0] *= 2 * win - 1
    return relative_coords.sum(-1)


@pytest.mark.parametrize("hp,wp", [(28, 35), (14, 21), (7, 14), (7, 7), (196, 259)])
def test_partition_and_reverse_are_inverses_in_the_published_window_order(hp, wp):
    x = torch.randn(2, hp, wp, 5)
    win = Y.window_partition(x, 7)
    assert win.shape == (2, 49, hp * wp // 49, 5)
    assert torch.equal(Y.window_reverse(win, 7, hp, wp), x)
    # token t of window n is the published partition's window (image, n), token t
    pub = published_partition(x, 7).view(2, -1, 49, 5)
    assert torch.equal(win.transpose(1, 2), pub)


@pytest.mark.parametrize("hp,wp", [(28, 35), (14, 21), (7, 14), (7, 7), (196, 259)])
def test_shift_mask_equals_the_published_slices(hp, wp):
    want = published_mask(hp, wp, 7, 3)
    assert torch.equal(Y.swin_shift_mask(hp, wp, 7, 3, "cpu"), want)
    assert torch.equal(ref_swin.shift_mask(hp, wp, 7, 3, "cpu"), want)


@pytest.mark.parametrize("win", [7, 3])
def test_relative_index_equals_the_published_one(win):
    want = published_index(win)
    assert torch.equal(Y.swin_relative_index(win, torch.device("cpu")), want)
    assert torch.equal(ref_swin.relative_index(win), want)
    table = torch.randn((2 * win - 1) ** 2, 3)
    bias = Y.swin_relative_bias(table, win)
    assert torch.equal(bias, table[want.view(-1)].view(win * win, win * win, -1).permute(2, 0, 1))


def test_grid_at_full_size_is_132_by_100():
    """The padded merges give ceil(h / 2): 193x258 -> 97x129 -> 49x65 ->
    25x33, so (Sx, Sy) = (132, 100), not ConvNeXt's floor (128, 96)."""
    defn = get_model_defn("swin_small")(2)
    assert (defn.name, defn.family) == ("swin_small", "swin")
    assert grid_size(defn.blocks, 772, 1032) == (132, 100)
    assert Y.YOGO.create((772, 1032), 0.04, 0.05, 2, model_version="swin_small").grid == (132, 100)
    assert ref_swin.grid(config(img_size=[772, 1032])) == (132, 100)
    assert grid_size(defn.blocks, *HW) == (20, 16) == ref_swin.grid(config())


def test_the_bias_is_made_once_and_again_when_the_table_changes(seeded):
    cfg, w, _, _ = seeded
    net = small_net(cfg)
    net.load_state_dict(w)
    blk = net.stage0_block1
    dev = torch.device("cpu")
    with torch.inference_mode():
        a = blk.attn_bias(28, 35, torch.float32, dev)
        assert blk.attn_bias(28, 35, torch.float32, dev) is a
    assert a.shape == (1, 20 * 1, 49, 49) and a.stride(-2) % 8 == 0
    want = Y.swin_relative_bias(blk.rel_bias.detach(), 7)[None] + published_mask(28, 35, 7, 3)[:, None]
    assert torch.equal(a, want.reshape(1, -1, 49, 49))
    net.load_state_dict({k: v * 2 if k.endswith("rel_bias") else v for k, v in w.items()})
    with torch.inference_mode():
        b = blk.attn_bias(28, 35, torch.float32, dev)
    assert b is not a and not torch.equal(a, b)


# ------------------------------------------------------ spans and counters


def expected_counts(batch: int) -> dict:
    windows = sum(2 * batch * (hp // 7) * (wp // 7) * heads for (_, _, hp, wp), heads in zip(MAPS, SMALL["heads"]))
    pads = sum(2 * batch * (hp * wp - h * w) for h, w, hp, wp in MAPS)
    return {"swin_windows": windows, "swin_pad_tokens": pads}


def test_spans_and_counters_follow_from_the_shapes(seeded):
    cfg, w, frames, _ = seeded
    want = expected_counts(B)
    assert want == {"swin_windows": 192, "swin_pad_tokens": 1168}
    before = dict(tracing.COUNTS)
    port_head(cfg, w, frames, torch.float32)
    assert {k: tracing.COUNTS[k] - before.get(k, 0) for k in want} == want
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        port_head(cfg, w, frames, torch.float32)
    stats, counts = tracing.stats(), tracing.counts()
    tracing.reset()
    assert stats["swin/attn"]["count"] == 8 and stats["swin/layout"]["count"] == 16
    assert stats["swin/attn"]["stream_s"] is None  # no CUDA device
    assert {k: counts[k] for k in want} == want


# ------------------------------------------- checkpoint, Predictor, infer


def test_a_native_checkpoint_counts_through_predictor_and_infer(tmp_path, capsys):
    """Swin-S at its published widths, 100x132: seeded weights saved as a
    native checkpoint, read by Predictor.from_checkpoint and by `predict`
    (`infer --count`), count as the module they came from. (The
    objectness bias is raised: the cell's is set for 772x1032.)"""
    from PIL import Image

    cfg = config(production_density={"obj_kernel_scale": 1.0, "obj_bias": 1.0})
    w = weights.production_density(weights.make(ref_swin.spec(cfg), 3, "cpu"), cfg)
    model = Y.YOGO.create(HW, cfg["anchor_w"], cfg["anchor_h"], 2, model_version="swin_small")
    stack = model.module("cpu")
    stack.load_state_dict(w, strict=True)
    ckpt = tmp_path / "swin.ckpt"
    save_checkpoint(ckpt, model, flax_from_state_dict(stack.state_dict()), classes=["cell", "parasite"])
    frames, _ = scene.pool(5, range(3), hw=HW, blobs=(2, 5))
    here = Predictor(model, stack)
    want = here.count(here.forward_raw(frames))
    assert int(want.sum()) > 0

    pred = Predictor.from_checkpoint(ckpt, device="cpu")
    assert isinstance(pred.stack, Y.SwinSmall)
    assert torch.equal(pred.count(pred.forward_raw(frames)), want)

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f[0]).save(img_dir / f"{i}.png")
    predict(ckpt, path_to_images=img_dir, count_predictions=True, batch_size=2, device="cpu")
    assert str([("cell", int(want[0])), ("parasite", int(want[1]))]) in capsys.readouterr().out


# ----------------------------------------------------- refused, clearly


@pytest.fixture(scope="module")
def full_variables():
    model = Y.YOGO.create(HW, 0.04, 0.05, 2, model_version="swin_small")
    return model, flax_from_state_dict(model.module("cpu").state_dict())


def test_int8_refuses_the_family(full_variables):
    from yogo_tpu_torch.ops.quant import family_quant_plan

    model, variables = full_variables
    with pytest.raises(ValueError, match="swin"):
        family_quant_plan(model, variables)


def test_onnx_export_refuses_the_family(full_variables):
    from yogo_tpu_torch.utils.export_model import build_onnx

    model, variables = full_variables
    with pytest.raises(NotImplementedError, match="swin"):
        build_onnx(model, variables)


def test_pth_interop_refuses_the_family(full_variables, tmp_path):
    from yogo_tpu_torch.utils.torch_bridge import save_pth

    model, variables = full_variables
    with pytest.raises(NotImplementedError, match="swin"):
        save_pth(tmp_path / "x.pth", model, variables)


def test_the_row_split_refuses_the_family(full_variables):
    from yogo_tpu_torch.parallel.spatial import RowSplit

    model, _ = full_variables
    with pytest.raises(NotImplementedError, match="swin"):
        RowSplit(model, ["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="swin"):
        model.apply(model.module("cpu"), torch.zeros(1, 1, *HW), split=object())


def test_a_forward_needs_the_whole_input_at_once():
    net = Y.SwinSmall(7, **{k: tuple(v) for k, v in SMALL.items()})
    with pytest.raises(ValueError):
        net(torch.zeros(1, 1, *HW), start_block=1)
    with pytest.raises(ValueError):
        net(torch.zeros(1, 1, *HW), remat="some")


def test_sdpa_on_the_card_is_held_to_the_fused_backends(monkeypatch):
    """fused_attention leaves the CPU to torch's choice and, on CUDA,
    allows the memory-efficient and cuDNN backends only, so that a call
    neither takes raises instead of writing the logits."""
    import torch.nn.attention as attention

    asked = []
    monkeypatch.setattr(attention, "sdpa_kernel", lambda backends: asked.append(backends) or contextlib.nullcontext())
    with Y.fused_attention(torch.device("cpu")):
        pass
    assert asked == []
    with Y.fused_attention(torch.device("cuda")):
        pass
    assert asked == [[attention.SDPBackend.EFFICIENT_ATTENTION, attention.SDPBackend.CUDNN_ATTENTION]]
