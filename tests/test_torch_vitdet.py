"""The port's ViTDet-B trunk (models/yogo.py ViTDetBase, family "vitdet",
which only the port has) against the benchmark's plain float32 reference
(yogo_bench/families/vitdet.py, written from detectron2's vit.py), on the
CPU at a small size: width 64, 2 heads of 32, 3 blocks (the middle one
global), windows of 4, 72x104 frames, so that the frame pads to 80x112,
the map is 5x7 and the window blocks pad it to 8x8 on both sides; the
global block's tables resample (15 rows to 9 and 13), the window blocks'
do not, and the position embedding resamples from 4x4. Also: the pieces
against the published formulas, the widened attention against the dense
bias, the caches, the spans and counters, a native checkpoint that counts
through Predictor and `infer --count` at the published widths, and the
paths that refuse the family. The `cuda` tests need a GPU:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vitdet.py -m cuda"""

import json
import math

import pytest
import torch
import torch.nn.functional as F

from yogo_bench import manifest, reference, scene, weights
from yogo_bench.families import vitdet as ref_vit
from yogo_tpu_torch.infer import Predictor, predict
from yogo_tpu_torch.models import yogo as Y
from yogo_tpu_torch.models.defns import get_model_defn
from yogo_tpu_torch.ops.grid import grid_size
from yogo_tpu_torch.ops.layer_norm import layer_norm_cuda
from yogo_tpu_torch.utils import tracing
from yogo_tpu_torch.utils.checkpoint import save_checkpoint
from yogo_tpu_torch.utils.weights import flax_from_state_dict, state_dict_from_flax

HW = (72, 104)
SMALL = {"img_size": list(HW), "embed_dim": 64, "heads": 2, "head_dim": 32, "depth": 3, "window": 4,
         "window_block_indexes": [0, 2], "vit_img_size": 128, "pretrain_img_size": 64, "neck_channels": 32}
MAP = (5, 7)
B = 2
KERNELS = ("layer_norm", "layer_norm_windows", "window_merge")


def config(**over) -> dict:
    with open(manifest.ROOT / "yogo_bench/configs/vitdet_base.json") as f:
        cfg = json.load(f)
    return {**cfg, **over}


def small_net(cfg: dict) -> Y.ViTDetBase:
    p = cfg["patch"]
    glob = tuple(i for i in range(cfg["depth"]) if i not in cfg["window_block_indexes"])
    return Y.ViTDetBase(5 + cfg["num_classes"], 1, dim=cfg["embed_dim"], depth=cfg["depth"], heads=cfg["heads"],
                        window=cfg["window"], global_blocks=glob, global_size=cfg["vit_img_size"] // p,
                        pos_size=cfg["pretrain_img_size"] // p, neck=cfg["neck_channels"]).eval()


@pytest.fixture(scope="module")
def seeded():
    """(config, seeded weights, frames, the reference's float32 head)."""
    cfg = config(**SMALL)
    w = weights.make(ref_vit.spec(cfg), 7, "cpu")
    frames, _ = scene.pool(11, range(B), hw=HW, blobs=(2, 5))
    return cfg, w, frames, reference.head(w, frames, cfg)


def model(dtype=torch.float32, hw=HW) -> Y.YOGO:
    return Y.YOGO.create(hw, 0.042501, 0.0555177, 2, model_version="vitdet_base", compute_dtype=dtype)


def port_head(cfg, w, frames, dtype, net=None):
    if net is None:
        net = small_net(cfg)
        net.load_state_dict(w, strict=True)
    return model(dtype).apply(net, torch.from_numpy(frames), decode=False)


def rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    d = a.double() - b.double()
    return float(d.norm() / b.double().norm())


def test_the_small_size_pads_and_resamples(seeded):
    cfg = seeded[0]
    assert ref_vit.token_map(cfg) == MAP and ref_vit.grid(cfg) == (14, 10)
    assert seeded[3].shape == (B, 10, 14, 7)
    assert [ref_vit.rel_size(cfg, i) for i in range(3)] == [4, 8, 4]


def test_float32_head_matches_the_reference(seeded):
    """float32 on both sides: only the order of float32 roundings differs
    (the LayerNorm's E[x^2] - E[x]^2, the bias summed inside the widened
    dot product, scaled_dot_product_attention's softmax), ~3e-7 of the
    head over 3 blocks; 1e-5 leaves room and no part of the mathematics."""
    cfg, w, frames, ref = seeded
    out = port_head(cfg, w, frames, torch.float32)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel_rms(out, ref) < 1e-5
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_bfloat16_head_matches_the_reference_and_fp8_does_not(seeded):
    """bf16 operands in every conv and Dense, and the rel-pos bias rounded
    to bf16 inside the widened q, round each by up to 2^-9: the head reads
    ~0.004 of its norm from the float32 reference; 0.015 leaves room. The
    reference computed in float8 e4m3, the precision below, reads ~0.035,
    above it."""
    cfg, w, frames, ref = seeded
    out = port_head(cfg, w, frames, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    assert rel_rms(out, ref) < 0.015
    assert rel_rms(reference.head(w, frames, cfg, cast=reference.fp8), ref) > 0.015


# ---------------------------------------------------------------- pieces


def published_rel_pos(q_size, k_size, rel_pos):
    """detectron2 vit.py get_rel_pos, as published."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos_resized = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                        size=max_rel_dist, mode="linear")
        rel_pos_resized = rel_pos_resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        rel_pos_resized = rel_pos
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative_coords = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos_resized[relative_coords.long()]


@pytest.mark.parametrize("rows,size", [(27, 14), (7, 4), (127, 49), (127, 65), (15, 5), (15, 7), (127, 64)])
def test_rel_pos_tables_equal_the_published_formula(rows, size):
    """At the window's own size the table is read as it is (27 rows, 14;
    127, 64); at the maps of a global block it is resampled linearly (127
    rows to 97 and 129 at 772x1032, 15 to 9 and 13 at the small size)."""
    g = torch.Generator().manual_seed(rows * 100 + size)
    table = torch.randn(rows, 8, generator=g)
    want = published_rel_pos(size, size, table)
    assert torch.equal(Y.vit_rel_pos(table, size), want)
    assert torch.equal(ref_vit.get_rel_pos(size, size, table), want)
    if rows == 2 * size - 1:  # read as it is: row i - j + size - 1
        i = torch.arange(size)
        assert torch.equal(want, table[i[:, None] - i[None, :] + size - 1])


@pytest.mark.parametrize("hw", [(49, 65), (5, 7), (14, 14)])
def test_position_embedding_is_the_published_bicubic_resampling(hw):
    g = torch.Generator().manual_seed(hw[0])
    pos = torch.randn(1, 1 + 14 * 14, 16, generator=g)
    got = Y.vit_abs_pos(pos, *hw)
    assert torch.equal(got, ref_vit.get_abs_pos(pos, True, hw))
    grid = pos[:, 1:].reshape(1, 14, 14, 16).permute(0, 3, 1, 2)
    want = grid if hw == (14, 14) else F.interpolate(grid, size=hw, mode="bicubic", align_corners=False)
    assert got.shape == (1, *hw, 16) and torch.equal(got, want.permute(0, 2, 3, 1))


def dense_rel_pos_attention(q, k, v, rel_h, rel_w, scale):
    """The published Attention: the (B * heads, L, L) logits, the dense
    bias of add_decomposed_rel_pos, softmax, the values."""
    b, s, n, d = q.shape
    sh, sw = rel_h.shape[0], rel_w.shape[0]
    q, k, v = (t.reshape(b * s, n, d) for t in (q, k, v))
    r = q.reshape(b * s, sh, sw, d)
    bias_h = torch.einsum("bhwc,hkc->bhwk", r, rel_h)
    bias_w = torch.einsum("bhwc,wkc->bhwk", r, rel_w)
    attn = ((q * scale) @ k.transpose(-2, -1)).view(b * s, sh, sw, sh, sw)
    attn = (attn + bias_h[..., None] + bias_w[..., None, :]).view(b * s, n, n)
    return (attn.softmax(-1) @ v).view(b, s, n, d)


@pytest.mark.parametrize("sh,sw,d", [(4, 4, 32), (5, 7, 32), (14, 14, 64), (3, 9, 16)])
def test_widened_attention_equals_the_dense_bias(sh, sw, d):
    """rel_pos_attention (q and k widened by the rel-pos products and the
    one-hot key columns, d + sh + sw padded to a multiple of 8) gives the
    dense-bias attention: the same logits summed in another order."""
    g = torch.Generator().manual_seed(sh * sw + d)
    q, k, v = (torch.randn(2, 3, sh * sw, d, generator=g) for _ in range(3))
    rel_h, rel_w = torch.randn(sh, sh, d, generator=g) * 0.3, torch.randn(sw, sw, d, generator=g) * 0.3
    got = Y.rel_pos_attention(q, k, v, rel_h, rel_w, d ** -0.5)
    want = dense_rel_pos_attention(q, k, v, rel_h, rel_w, d ** -0.5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    keys = Y.vit_key_columns(sh, sw, d, torch.float32, torch.device("cpu"))
    assert (d + keys.shape[1]) % 8 == 0 and d + keys.shape[1] - (d + sh + sw) < 8
    assert torch.equal(keys.sum(1), torch.full((sh * sw,), 2.0))


def test_widened_attention_attends_to_the_pad_slots_as_published(seeded):
    """A window block on a map that pads its windows (5x7 -> 8x8, 29 of
    64 slots pad): the pad slots hold the LayerNorm's zeros, whose keys
    and values are the qkv biases, and are attended to without a mask, as
    the published window_partition after norm1 leaves them: the block
    equals the reference's block, pad keys and all."""
    cfg, w, _, _ = seeded
    net = small_net(cfg)
    net.load_state_dict(w, strict=True)
    x = torch.randn(B, *MAP, 64, generator=torch.Generator().manual_seed(3))
    with torch.inference_mode():
        got = net.block0(x, torch.float32)
    want = ref_vit.block(x, w, "block0", 2, 4, cfg["ln_eps"], reference.f32)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_grid_at_full_size_is_130_by_98():
    """The frame pads to 784x1040: a 49x65 map of 3,185 tokens, doubled
    by the pyramid's transpose to (Sx, Sy) = (130, 98)."""
    defn = get_model_defn("vitdet_base")(2)
    assert (defn.name, defn.family) == ("vitdet_base", "vitdet")
    assert grid_size(defn.blocks, 772, 1032) == (130, 98)
    assert model(hw=(772, 1032)).grid == (130, 98)
    assert ref_vit.grid(config()) == (130, 98) and ref_vit.token_map(config()) == (49, 65)
    assert grid_size(defn.blocks, *HW) == (14, 10) == ref_vit.grid(config(**SMALL))
    for h in range(1, 70):  # ceil(h / 16) at every size, as the pad gives
        assert grid_size(defn.blocks, h, h)[1] == 2 * -(-h // 16)


def test_tables_and_position_embedding_are_made_once_and_again_when_changed(seeded):
    cfg, w, _, _ = seeded
    net = small_net(cfg)
    net.load_state_dict(w)
    blk, dev = net.block1, torch.device("cpu")
    with torch.inference_mode():
        a = blk.rel_pos(*MAP, torch.float32, dev)
        assert blk.rel_pos(*MAP, torch.float32, dev) is a
        p = net.abs_pos(*MAP, dev)
        assert net.abs_pos(*MAP, dev) is p
    assert torch.equal(a[0], published_rel_pos(5, 5, w["block1.rel_pos_h"]))
    assert torch.equal(a[1], published_rel_pos(7, 7, w["block1.rel_pos_w"]))
    assert torch.equal(p, ref_vit.get_abs_pos(w["pos_embed"], True, MAP))
    net.load_state_dict({k: v * 2 if k.endswith(("rel_pos_h", "rel_pos_w", "pos_embed")) else v
                         for k, v in w.items()})
    with torch.inference_mode():
        b = blk.rel_pos(*MAP, torch.float32, dev)
        q = net.abs_pos(*MAP, dev)
    assert b is not a and torch.equal(b[0], 2 * a[0])
    assert q is not p and torch.equal(q, 2 * p)


def kernel_launches() -> tuple:
    return tuple(tracing.COUNTS[f"{name}_kernel_launches"] for name in KERNELS)


def test_the_cpu_and_autograd_launch_no_kernel(seeded):
    """On the CPU, in inference and in a training forward and backward, the
    blocks run the plain layout and the gradient reaches every parameter,
    the tables and the position embedding through their resampling."""
    cfg, w, frames, _ = seeded
    before = kernel_launches()
    port_head(cfg, w, frames, torch.float32)
    net = small_net(cfg)
    net.load_state_dict(w, strict=True)
    model().apply(net, torch.from_numpy(frames), train=True, decode=False).float().square().mean().backward()
    assert kernel_launches() == before
    assert all(p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0
               for p in net.parameters())


def test_init_follows_detectron2(seeded):
    net = model().init(torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(net, Y.ViTDetBase) and sum(p.numel() for p in net.parameters()) == 87_366_791
    assert abs(float(net.pos_embed.detach().std()) - 0.02) < 0.002
    assert all(float(getattr(net, f"block{i}").rel_pos_h.detach().abs().max()) == 0 for i in range(12))
    assert net.block2.rel_pos_h.shape == (127, 64) and net.block0.rel_pos_h.shape == (27, 64)
    assert net.lateral_conv.bias is None and net.output_conv.bias is None


def test_a_native_checkpoint_round_trips_the_flax_layout(seeded):
    cfg, w, _, _ = seeded
    back = state_dict_from_flax(flax_from_state_dict(w))
    assert sorted(back) == sorted(w) and all(torch.equal(back[k], w[k]) for k in w)


# ------------------------------------------------------ spans and counters


def test_spans_and_counters_follow_from_the_shapes(seeded):
    """Two window blocks of one 8x8-padded window each and one global
    block over 35 tokens, per image: 4 windows, 58 pad tokens and 70
    global tokens for B=2; spans 1 global, 2 windowed, 4 layout."""
    cfg, w, frames, _ = seeded
    want = {"vit_windows": 2 * B * 4, "vit_pad_tokens": 2 * B * (64 - 35), "vit_global_tokens": B * 35}
    assert want == {"vit_windows": 16, "vit_pad_tokens": 116, "vit_global_tokens": 70}
    before = dict(tracing.COUNTS)
    port_head(cfg, w, frames, torch.float32)
    assert {k: tracing.COUNTS[k] - before.get(k, 0) for k in want} == want
    tracing.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        port_head(cfg, w, frames, torch.float32)
    stats, counts = tracing.stats(), tracing.counts()
    tracing.reset()
    assert {k: stats[k]["count"] for k in ("vit/global_attn", "vit/win_attn", "vit/layout")} == {
        "vit/global_attn": 1, "vit/win_attn": 2, "vit/layout": 4}
    assert stats["vit/global_attn"]["stream_s"] is None  # no CUDA device
    assert {k: counts[k] for k in want} == want


def test_full_size_counts_follow_from_the_shapes():
    """At 772x1032: 20 windows of 196 tokens a window block, 735 of the
    56x70 padded map's 3,920 tokens pad (18.75%), 3,185 global tokens."""
    cfg = config()
    h, w = ref_vit.token_map(cfg)
    hp, wp = -(-h // 14) * 14, -(-w // 14) * 14
    assert (h * w, hp, wp, hp * wp // 196, hp * wp - h * w) == (3185, 56, 70, 20, 735)
    assert (hp * wp - h * w) / (hp * wp) == 0.1875


# ------------------------------------------- checkpoint, Predictor, infer


def test_a_native_checkpoint_counts_through_predictor_and_infer(tmp_path, capsys):
    """ViTDet-B at its published widths, 72x104: seeded weights saved as a
    native checkpoint, read by Predictor.from_checkpoint and by `predict`
    (`infer --count`), count as the module they came from. (The head's
    bias is raised: the cell's is set for 772x1032.)"""
    from PIL import Image

    cfg = config(img_size=list(HW), init={**config()["init"], "head_bias": 0.5})
    w = weights.make(ref_vit.spec(cfg), 3, "cpu")
    m = model()
    stack = m.module("cpu")
    stack.load_state_dict(w, strict=True)
    ckpt = tmp_path / "vitdet.ckpt"
    save_checkpoint(ckpt, m, flax_from_state_dict(stack.state_dict()), classes=["cell", "parasite"])
    frames, _ = scene.pool(5, range(3), hw=HW, blobs=(2, 5))
    here = Predictor(m, stack)
    want = here.count(here.forward_raw(frames))
    assert int(want.sum()) > 0

    pred = Predictor.from_checkpoint(ckpt, device="cpu")
    assert isinstance(pred.stack, Y.ViTDetBase)
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
    m = model()
    return m, flax_from_state_dict(m.module("cpu").state_dict())


def test_int8_refuses_the_family(full_variables):
    from yogo_tpu_torch.ops.quant import family_quant_plan

    m, variables = full_variables
    with pytest.raises(ValueError, match="vitdet"):
        family_quant_plan(m, variables)


def test_onnx_export_refuses_the_family(full_variables):
    from yogo_tpu_torch.utils.export_model import build_onnx

    m, variables = full_variables
    with pytest.raises(NotImplementedError, match="vitdet"):
        build_onnx(m, variables)


def test_pth_interop_refuses_the_family(full_variables, tmp_path):
    from yogo_tpu_torch.utils.torch_bridge import save_pth

    m, variables = full_variables
    with pytest.raises(NotImplementedError, match="vitdet"):
        save_pth(tmp_path / "x.pth", m, variables)


def test_the_row_split_refuses_the_family(full_variables):
    from yogo_tpu_torch.parallel.spatial import RowSplit

    m, _ = full_variables
    with pytest.raises(NotImplementedError, match="vitdet"):
        RowSplit(m, ["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="vitdet"):
        m.apply(m.module("cpu"), torch.zeros(1, 1, *HW), split=object())


def test_a_forward_needs_the_whole_input_at_once(seeded):
    net = small_net(seeded[0])
    with pytest.raises(ValueError, match="vitdet family has no fused stem"):
        net(torch.zeros(1, 1, *HW), start_block=1)
    with pytest.raises(ValueError):
        net(torch.zeros(1, 1, *HW), remat="some")


# ------------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA GPU (decided when the test
    runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


def _plain_layout_ln(x, w, b, eps, dtype, windows=None):
    """layer_norm_cuda's row store, then the plain layout."""
    y = layer_norm_cuda(x, w, b, eps, dtype)
    return y if windows is None else Y.swin_window_layout(y, windows)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_a_head_on_the_card_equals_the_plain_layout_bit_for_bit(cuda, monkeypatch, seeded, dtype):
    """ViTDetBase on the card with the window layout in its kernels (the
    small size: 1 global block's norm, 3 MLP norms and 2 neck norms store
    rows, 2 attention norms store into windows, 2 merges) gives the head
    of the same forward with the row-store kernel followed by the plain
    pad and partition, and the plain reverse, crop and add, bit for bit."""
    cfg, w, frames, _ = seeded
    net = small_net(cfg)
    net.load_state_dict(w, strict=True)
    net = net.cuda()
    m = model(dtype)
    x = torch.from_numpy(frames).cuda()
    before = kernel_launches()
    got = m.apply(net, x, decode=False)
    assert tuple(n - b for n, b in zip(kernel_launches(), before)) == (6, 2, 2)
    with monkeypatch.context() as mp:
        mp.setattr(Y, "layer_norm_cuda", _plain_layout_ln)
        mp.setattr(Y, "window_merge_cuda", Y.swin_merge_windows)
        plain = m.apply(net, x, decode=False)
    assert got.dtype == dtype
    assert torch.equal(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("sh,sw", [(49, 65), (14, 14)])
def test_sdpa_on_the_card_takes_the_widened_call_in_a_fused_backend(cuda, monkeypatch, sh, sw):
    """Under fused_attention (memory-efficient and cuDNN only) the widened
    q and k of a global block (d 64 + 49 + 65 -> 184) and of a window
    (64 + 28 -> 96) are taken by a fused backend, in bf16, and give the
    dense-bias attention within bf16's rounding."""
    import torch.nn.attention as attention

    asked = []
    sdpa = attention.sdpa_kernel
    monkeypatch.setattr(attention, "sdpa_kernel", lambda backends: asked.append(backends) or sdpa(backends))
    g = torch.Generator().manual_seed(sh)
    q, k, v = (torch.randn(1, 12, sh * sw, 64, generator=g).cuda().to(torch.bfloat16) for _ in range(3))
    rel_h = (torch.randn(sh, sh, 64, generator=g) * 0.1).cuda().to(torch.bfloat16)
    rel_w = (torch.randn(sw, sw, 64, generator=g) * 0.1).cuda().to(torch.bfloat16)
    with Y.fused_attention(torch.device("cuda")):
        got = Y.rel_pos_attention(q, k, v, rel_h, rel_w, 0.125)
    assert asked == [[attention.SDPBackend.EFFICIENT_ATTENTION, attention.SDPBackend.CUDNN_ATTENTION]]
    want = dense_rel_pos_attention(*(t.float() for t in (q, k, v, rel_h, rel_w)), 0.125)
    assert rel_rms(got, want) < 0.01


@pytest.mark.cuda
def test_a_global_block_at_full_width_holds_no_logits(cuda):
    """One full-width global block (768 wide, 12 heads, a 49x65 map) at
    B=8 in bf16 raises the card's peak memory by less than one (8, 12,
    3185, 3185) bf16 tensor of logits (1.95 GB): the bias is never dense.
    The block runs under fused_attention, as ViTDetBase runs it."""
    blk = Y.ViTBlock(768, 12, 0, 64).cuda().eval()
    x = torch.randn(8, 49, 65, 768, device="cuda")
    with torch.inference_mode(), Y.fused_attention(torch.device("cuda")):
        blk(x, torch.bfloat16)  # tables, key columns, the kernels' builds
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = blk(x, torch.bfloat16)
        torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    logits = 8 * 12 * 3185 * 3185 * 2
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert rise < logits, (rise, logits)
    assert math.isclose(logits / 2 ** 30, 1.81, abs_tol=0.01)
