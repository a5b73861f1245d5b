"""The port's Swin-S trunk (models/yogo.py SwinSmall, family "swin", which
only the port has) against the benchmark's plain float32 reference
(yogo_bench/families/swin.py, written from the published detection
backbone), on the CPU at a small size: 100x132 frames, so that the maps
are 25x33 -> 13x17 -> 7x9 -> 4x5 and every stage pads its windows and
every merge pads an odd side; widths 32/64/128/256, heads 1/2/4/8 (the
published head size 32), depths 2/2/2/2. Also: the layout pieces against
the published constructions, the index maps by which the card's kernels
carry the layout (csrc/windows.cuh) against the pad, roll and partition
they replace, the spans and counters, a native checkpoint that counts
through Predictor and `infer --count`, and the paths that refuse the
family. The `cuda` tests (the window merge kernel, a head on the card
against the plain layout's) need a GPU:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_swin.py -m cuda"""

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
from yogo_tpu_torch.ops.layer_norm import Windows, layer_norm_cuda
from yogo_tpu_torch.ops.window_merge import window_merge_cuda
from yogo_tpu_torch.utils import tracing
from yogo_tpu_torch.utils.checkpoint import save_checkpoint
from yogo_tpu_torch.utils.weights import flax_from_state_dict

HW = (100, 132)
SMALL = {"dims": [32, 64, 128, 256], "heads": [1, 2, 4, 8], "depths": [2, 2, 2, 2]}
MAPS = [(25, 33, 28, 35), (13, 17, 14, 21), (7, 9, 7, 14), (4, 5, 7, 7)]  # (h, w, hp, wp) a stage
# the four stage maps at 772x1032 (H, W, C)
FULL_STAGES = [(193, 258, 96), (97, 129, 192), (49, 65, 384), (25, 33, 768)]
B = 2
KERNELS = ("layer_norm", "layer_norm_windows", "window_merge")


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


# ------------------------------------- the layout as the kernels index it


def slot_sources(b, h, w, windows: Windows) -> torch.Tensor:
    """csrc/windows.cuh window_source over every window slot of B maps:
    (B * Hp * Wp,) the map row (b * H + i) * W + j that each slot of the
    (B, w*w, nW) windows holds, -1 where it holds a padded zero."""
    hp, wp, win, shift = windows
    nwx = wp // win
    nw = (hp // win) * nwx
    slot = torch.arange(b * hp * wp)
    img, r = slot // (hp * wp), slot % (hp * wp)
    t, n = r // nw, r % nw
    i = ((n // nwx) * win + t // win + shift) % hp
    j = ((n % nwx) * win + t % win + shift) % wp
    return torch.where((i < h) & (j < w), (img * h + i) * w + j, -1)


def token_slots(b, h, w, windows: Windows) -> torch.Tensor:
    """csrc/windows.cuh window_slot over every row of B maps: (B * H * W,)
    the window slot that map row (b * H + i) * W + j was laid out in."""
    hp, wp, win, shift = windows
    nwx = wp // win
    nw = (hp // win) * nwx
    row = torch.arange(b * h * w)
    img, i, j = row // (h * w), row // w % h, row % w
    ri, rj = (i - shift) % hp, (j - shift) % wp
    return (img * win * win + (ri % win) * win + rj % win) * nw + (ri // win) * nwx + rj // win


LAYOUT_MAPS = sorted({(h, w) for h, w, _ in FULL_STAGES} | {(h, w) for h, w, _, _ in MAPS})


def _windows(h, w, shift) -> Windows:
    return Windows(-(-h // 7) * 7, -(-w // 7) * 7, 7, shift)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("h,w", LAYOUT_MAPS)
def test_slot_sources_are_pad_roll_partition(h, w, shift):
    """Each window slot holds the map row slot_sources names, or a zero
    where it names none: swin_window_layout (F.pad, torch.roll by -shift,
    window_partition) as an index map. Rows hold their index + 1, so that
    no row reads as a padded zero."""
    windows = _windows(h, w, shift)
    rows = torch.arange(1, B * h * w + 1, dtype=torch.float32)
    x = rows.view(B, h, w, 1).expand(B, h, w, 2)
    laid = Y.swin_window_layout(x, windows)
    assert laid.shape == (B, 49, windows.hp * windows.wp // 49, 2)
    src = slot_sources(B, h, w, windows)
    want = torch.where(src >= 0, rows[src.clamp(min=0)], 0.0)
    assert torch.equal(laid.reshape(-1, 2), want[:, None].expand(-1, 2))
    assert int((src < 0).sum()) == B * (windows.hp * windows.wp - h * w)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("h,w", LAYOUT_MAPS)
def test_token_slots_are_reverse_roll_crop(h, w, shift):
    """Each map token's merge-add reads the window slot token_slots names:
    swin_merge_windows (window_reverse, torch.roll by +shift, the crop, the
    add) as an index map, and the inverse of slot_sources on the map's
    rows."""
    windows = _windows(h, w, shift)
    g = torch.Generator().manual_seed(h * w + shift)
    x = torch.randn(B, h, w, 8, generator=g)
    t = torch.randn(B, 49, windows.hp * windows.wp // 49, 8, generator=g).to(torch.bfloat16)
    slots = token_slots(B, h, w, windows)
    want = x.reshape(-1, 8) + t.reshape(-1, 8)[slots].float()
    assert torch.equal(Y.swin_merge_windows(x, t, windows).reshape(-1, 8), want)
    assert torch.equal(slot_sources(B, h, w, windows)[slots], torch.arange(B * h * w))


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


MERGE_WRONG = {
    "x_bf16": ({"x": _meta((2, 9, 10, 96), torch.bfloat16)}, "x must be an f32"),
    "x_3d": ({"x": _meta((9, 10, 96))}, "x must be an f32"),
    "t_f16": ({"t": _meta((2, 49, 4, 96), torch.float16)}, "t must be bfloat16 or float32"),
    "c_not_multiple_of_8": ({"x": _meta((2, 9, 10, 100)), "t": _meta((2, 49, 4, 100))}, "C must be"),
    "windows_not_whole": ({"windows": Windows(14, 15, 7, 3)}, "do not lay out a 9x10 map"),
    "shift_a_window": ({"windows": Windows(14, 14, 7, 7)}, "do not lay out a 9x10 map"),
    "t_not_the_windows": ({"t": _meta((2, 49, 9, 96))}, "t must be the map's windows"),
    "t_strided": ({"t": _meta((2, 4, 49, 96)).transpose(1, 2)}, "x and t must be contiguous"),
    "t_on_cpu": ({"t": torch.zeros(2, 49, 4, 96)}, "one device"),
    "meta": ({}, "no window merge kernel for device meta"),
    "cpu": ({"x": torch.zeros(2, 9, 10, 96), "t": torch.zeros(2, 49, 4, 96)},
            "no window merge kernel for device cpu"),
}


@pytest.mark.parametrize("case", sorted(MERGE_WRONG))
def test_merge_wrapper_refuses_what_the_kernel_does_not_take(case):
    over, match = MERGE_WRONG[case]
    a = {"x": _meta((2, 9, 10, 96)), "t": _meta((2, 49, 4, 96), torch.bfloat16),
         "windows": Windows(14, 14, 7, 3), **over}
    before = tracing.COUNTS["window_merge_kernel_launches"]
    with pytest.raises(ValueError, match=match):
        window_merge_cuda(a["x"], a["t"], a["windows"])
    assert tracing.COUNTS["window_merge_kernel_launches"] == before


def kernel_launches() -> tuple:
    return tuple(tracing.COUNTS[f"{name}_kernel_launches"] for name in KERNELS)


def test_the_cpu_and_autograd_launch_no_kernel(seeded):
    """On the CPU, in inference and in a training forward and backward, the
    block runs the plain layout and its gradient reaches every parameter."""
    cfg, w, frames, _ = seeded
    before = kernel_launches()
    port_head(cfg, w, frames, torch.float32)
    net = small_net(cfg)
    net.load_state_dict(w, strict=True)
    model = Y.YOGO.create(HW, cfg["anchor_w"], cfg["anchor_h"], cfg["num_classes"], model_version="swin_small")
    model.apply(net, torch.from_numpy(frames), train=True, decode=False).float().square().mean().backward()
    assert kernel_launches() == before
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in net.parameters())


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


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA GPU (decided when the test
    runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("t_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("h,w,c", FULL_STAGES)
def test_merge_kernel_is_reverse_roll_crop_then_add(cuda, h, w, c, shift, t_dtype):
    """The window merge kernel at each Swin stage's map (B=2): bit for bit
    x + crop(roll(window_reverse(t), +shift)), one launch."""
    windows = _windows(h, w, shift)
    g = torch.Generator().manual_seed(c + shift)
    x = torch.randn(B, h, w, c, generator=g).cuda()
    t = torch.randn(B, 49, windows.hp * windows.wp // 49, c, generator=g).to(t_dtype).cuda()
    before = tracing.COUNTS["window_merge_kernel_launches"]
    got = window_merge_cuda(x, t, windows)
    assert tracing.COUNTS["window_merge_kernel_launches"] - before == 1
    want = Y.swin_merge_windows(x, t, windows)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_merge_kernel_refuses_misaligned_rows(cuda):
    windows = _windows(9, 10, 3)
    flat = torch.zeros(4 + 2 * 9 * 10 * 96, device="cuda")
    t = torch.zeros(2, 49, 4, 96, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        window_merge_cuda(flat[1:1 + 2 * 9 * 10 * 96].view(2, 9, 10, 96), t, windows)


def _plain_layout_ln(x, w, b, eps, dtype, windows=None):
    """layer_norm_cuda's row store, then the plain layout."""
    y = layer_norm_cuda(x, w, b, eps, dtype)
    return y if windows is None else Y.swin_window_layout(y, windows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_head_on_the_card_equals_the_plain_layout_bit_for_bit(cuda, monkeypatch, seeded, dtype):
    """SwinSmall on the card with the layout in its kernels (at the small
    size's 8 blocks: 13 row-store LayerNorms, 8 windowed, 8 merges a
    forward) gives the head of the same forward with the row-store kernel
    followed by the plain pad, roll and partition, and the plain reverse,
    roll, crop and add, bit for bit: the kernels move the same values and
    add them as torch does."""
    cfg, w, frames, _ = seeded
    net = small_net(cfg)
    net.load_state_dict(w, strict=True)
    net = net.cuda()
    model = Y.YOGO.create(HW, cfg["anchor_w"], cfg["anchor_h"], cfg["num_classes"], model_version="swin_small",
                          compute_dtype=dtype)
    x = torch.from_numpy(frames).cuda()
    before = kernel_launches()
    got = model.apply(net, x, decode=False)
    blocks = sum(cfg["depths"])
    assert tuple(n - b for n, b in zip(kernel_launches(), before)) == (blocks + 5, blocks, blocks)
    with monkeypatch.context() as m:
        m.setattr(Y, "layer_norm_cuda", _plain_layout_ln)
        m.setattr(Y, "window_merge_cuda", Y.swin_merge_windows)
        plain = model.apply(net, x, decode=False)
    assert got.dtype == dtype
    assert torch.equal(got, plain)


@pytest.mark.cuda
def test_under_autograd_on_the_card_the_layout_is_plain(cuda, seeded):
    """A training forward on the card records gradients: no kernel runs,
    and the gradient reaches every parameter."""
    cfg, w, frames, _ = seeded
    net = small_net(cfg)
    net.load_state_dict(w, strict=True)
    net = net.cuda()
    model = Y.YOGO.create(HW, cfg["anchor_w"], cfg["anchor_h"], cfg["num_classes"], model_version="swin_small",
                          compute_dtype=torch.bfloat16)
    before = kernel_launches()
    out = model.apply(net, torch.from_numpy(frames).cuda(), train=True, decode=False)
    out.float().square().mean().backward()
    assert kernel_launches() == before
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in net.parameters())
