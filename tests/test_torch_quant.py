"""The port's int8 PTQ (yogo_tpu_torch/ops/quant.py) against the JAX
package's (yogo_tpu/ops/quant.py) on the CPU, with the same weights and
seeded inputs. Tolerances, by what is compared:
  - the fold, quantize_weights, default_skip_blocks, equalization_layout
    and the program built from a given calibration payload: exactly equal
    (the same numpy);
  - calibrate_act_scales / equalization_vectors: rtol 3e-5 (the f32
    forward of torch's and XLA's CPU convs sums in another order; both
    percentiles interpolate the same subsample the same way);
  - the int8 codes entering each quantized block, the JAX program carried
    over by quant_params_from_jax: equal in >= 99.9% of places, off by at
    most 1 elsewhere (a code flips where f32 summation-order noise straddles
    a rounding boundary); the raw head within atol 0.05 on the trained
    base_model checkpoint (its logits reach ~191 on the crop used);
  - the end gates, on the committed goldens: those of
    tests/test_golden_fullres_int8.py (predict at 772x1032) and of
    tests/test_quant.py's trained half_filters stress gate.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_golden_fullres import gen_test_images as gen_fullres
from tests.test_golden_fullres_int8 import (
    CKPT_PATH as BASE_CKPT,
    GOLDEN_PATH,
    greedy_iou_match,
)
from yogo_tpu.models.yogo import YOGO as JYOGO
from yogo_tpu.ops import quant as jq
from yogo_tpu_torch.infer import Predictor, predict
from yogo_tpu_torch.models.defns import MODELS
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.ops import quant as tq
from yogo_tpu_torch.ops.postprocess import format_preds
from yogo_tpu_torch.tools.golden_scene import int8_gates
from yogo_tpu_torch.utils.checkpoint import load_any
from yogo_tpu_torch.utils.weights import flax_from_state_dict, quant_params_from_jax, state_dict_from_flax

ARCHS = [n for n in MODELS if n != "convnext_small"]
HW = (48, 64)
CALIB_RTOL = 3e-5


def _variables(arch: str, hw=HW, seed: int = 0):
    """flax-layout variables of a seeded init (the port's, which is the JAX
    package's scheme and cheaper here), with non-trivial BN statistics."""
    jm = JYOGO.create(hw, 0.08, 0.1, 2, model_version=arch)
    stack = _port_model(arch, hw).init(torch.Generator().manual_seed(seed), device="cpu")
    v = flax_from_state_dict(stack.state_dict())
    rng = np.random.default_rng(seed + 1)
    for name, stats in v["batch_stats"].items():
        n = stats["mean"].shape[0]
        stats["mean"] = (0.1 * rng.standard_normal(n)).astype(np.float32)
        stats["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return jm, v


def _port_model(arch: str, hw=HW):
    return YOGO.create(hw, 0.08, 0.1, 2, model_version=arch)


def _batches(n=2, b=4, hw=HW, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (b, 1, *hw)).astype(np.uint8) for _ in range(n)]


def _nhwc(batches):
    return [jq.to_nhwc_f32(b) for b in batches]


def _jax_numpy(qp):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16 else np.asarray(a), qp)


@pytest.mark.parametrize("arch", ARCHS)
def test_fold_skip_rule_and_equalization_layout_equal_jax(arch):
    jm, v = _variables(arch)
    tm = _port_model(arch)
    stack = tm.module("cpu")
    stack.load_state_dict(state_dict_from_flax(v), strict=True)
    want = jq.fold_conv_stack(jm.defn, v)
    for got in (tq.fold_conv_stack(tm.defn, v), tq.fold_conv_stack(tm.defn, stack)):
        assert [s for s, _, _ in got] == list(tm.defn.blocks)
        for (_, gw, gb), (_, ww, wb) in zip(got, want):
            np.testing.assert_array_equal(gw, ww)
            np.testing.assert_array_equal(gb, wb)
    skip = tq.default_skip_blocks(tm.defn, 1)
    assert skip == jq.default_skip_blocks(jm.defn, 1)
    last = len(tm.defn.blocks) - 1
    for s in (skip, (), (last,), tuple(range(1, last + 1))):
        assert tq.equalization_layout(tm.defn, 1, s) == jq.equalization_layout(jm.defn, 1, s)
    _, _, n_scales, all_skip = tq.family_quant_plan(tm, v, device="cpu")
    _, _, j_scales, j_all_skip = jq.family_quant_plan(jm, v)
    assert (n_scales, all_skip) == (j_scales, j_all_skip)


def test_quantize_weights_equal_jax_and_zero_channel():
    rng = np.random.default_rng(1)
    w = rng.normal(0, 0.1, (3, 3, 40, 7)).astype(np.float32)
    w[..., 2] = 0.0
    w[0, 0, 0, 3] = 0.5 * 127 * (w[..., 3].max() / 127)  # a tie on the grid
    got, want = tq.quantize_weights(w), jq.quantize_weights(w)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    q, sw = got
    assert q.dtype == np.int8 and sw[2] == 1.0 and not q[..., 2].any()
    assert np.abs(q).max() == 127


@pytest.mark.parametrize("arch", ["base_model", "silu_model"])
def test_calibration_equals_jax(arch):
    jm, v = _variables(arch)
    batches = _batches()
    folded_j = jq.fold_conv_stack(jm.defn, v)
    folded_t = tq.fold_conv_stack(jm.defn, v)
    for cq in (None, 100.0, 99.0):
        got = tq.calibrate_act_scales(folded_t, batches, clip_quantile=cq, device="cpu")
        want = jq.calibrate_act_scales(folded_j, _nhwc(batches), clip_quantile=cq)
        assert got.dtype == np.float32 and got.shape == (len(jm.defn.blocks) - 1,)
        np.testing.assert_allclose(got, want, rtol=CALIB_RTOL)
    skip = (len(jm.defn.blocks) - 1,)
    got = tq.equalization_vectors(folded_t, batches, skip, device="cpu")
    want = jq.equalization_vectors(folded_j, _nhwc(batches), skip)
    assert sorted(got) == sorted(want)
    for i in want:
        np.testing.assert_allclose(got[i], want[i], rtol=CALIB_RTOL)
    with pytest.raises(ValueError, match="at least one"):
        tq.calibrate_act_scales(folded_t, [], device="cpu")
    # the folded f32 forward the scales describe, whole and up to block 4
    x = batches[0]
    for upto in (None, 4):
        got = tq.folded_float_forward(folded_t, x, upto=upto, device="cpu").permute(0, 2, 3, 1)
        want = np.asarray(jq.folded_float_forward(folded_j, jq.to_nhwc_f32(x), upto=upto))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_percentile_is_jax_linear_interpolation():
    rng = np.random.default_rng(2)
    v = rng.standard_normal((1001, 5)).astype(np.float32)
    for pct in (99.5, 99.9, 50.0, 100.0, 0.0):
        np.testing.assert_array_equal(
            tq._percentile(torch.from_numpy(v), pct, dim=0).numpy(),
            np.asarray(jnp.percentile(jnp.asarray(v), pct, axis=0)),
        )
        np.testing.assert_array_equal(
            tq._percentile(torch.from_numpy(v[:, 0]), pct).numpy(),
            np.asarray(jnp.percentile(jnp.asarray(v[:, 0]), pct)),
        )


def test_program_from_a_payload_equals_jax_bitwise():
    """Given JAX's calibration payload, the port builds JAX's program bit
    for bit (the equalization fold and quantize_weights are the same
    numpy; bf16 rounds to nearest even in both)."""
    jm, v = _variables("base_model")
    tm = _port_model("base_model")
    skip = tq.default_skip_blocks(tm.defn, 1)
    qj = jq.quantize_conv_stack(jm, v, _batches(), skip_blocks=skip)
    qt = tq.quantize_conv_stack(tm, v, [], skip_blocks=skip, act_scales=np.asarray(qj["scales"]),
                                device="cpu")
    want = quant_params_from_jax(_jax_numpy(qj))
    for key in ("stem_w", "stem_b", "scales"):
        assert torch.equal(qt[key], want[key]), key
    assert qt["stem_w"].dtype == torch.bfloat16 and qt["stem_w"].shape == (16, 1, 3, 3)
    assert [sorted(b) for b in qt["blocks"]] == [sorted(b) for b in want["blocks"]]
    for g, w in zip(qt["blocks"], want["blocks"]):
        for key in g:
            assert g[key].dtype == w[key].dtype and torch.equal(g[key], w[key]), key
    assert [("w8" in b) for b in qt["blocks"]] == [False, False, False, True, True, True, False]


def test_calibration_payload_roundtrip_bitwise():
    """A program assembled from the calibrating run's payload is bitwise the
    calibrating run's (the payload carries the equalization vectors), and
    the legacy per-tensor payload still builds a program."""
    tm = _port_model("base_model")
    _, v = _variables("base_model", seed=5)
    skip = tq.default_skip_blocks(tm.defn, 1)
    qp0 = tq.quantize_conv_stack(tm, v, _batches(), skip_blocks=skip, device="cpu")
    layout = tq.equalization_layout(tm.defn, 1, skip)
    assert layout and qp0["scales"].shape == (7 + sum(c for _, c in layout),)
    qp1 = tq.quantize_conv_stack(tm, v, [], skip_blocks=skip, act_scales=qp0["scales"].numpy(),
                                 device="cpu")
    flat0, flat1 = jax.tree.leaves(qp0), jax.tree.leaves(qp1)
    assert len(flat0) == len(flat1) and all(torch.equal(a, b) for a, b in zip(flat0, flat1))
    legacy = tq.quantize_conv_stack(tm, v, [], skip_blocks=skip, act_scales=qp0["scales"][:7].numpy(),
                                    device="cpu")
    assert torch.equal(legacy["scales"], qp0["scales"][:7])
    with pytest.raises(ValueError, match="calibration payload"):
        tq.quantize_conv_stack(tm, v, [], skip_blocks=skip, act_scales=np.ones(5), device="cpu")
    with pytest.raises(ValueError, match="zero scale"):
        tq.quantize_conv_stack(tm, v, [], skip_blocks=skip, act_scales=np.zeros(7), device="cpu")


def test_quantize_conv_stack_argument_checks_and_every_block_skipped():
    tm = _port_model("half_filters")
    _, v = _variables("half_filters")
    with pytest.raises(ValueError, match="block 0"):
        tq.quantize_conv_stack(tm, v, _batches(), skip_blocks=[0], device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        tq.quantize_conv_stack(tm, v, _batches(), skip_blocks=[9], device="cpu")

    def never():
        raise AssertionError("a program with no int8 conv must not calibrate")
        yield

    skip = tq.default_skip_blocks(tm.defn, 1)
    with pytest.warns(UserWarning, match="every block is skipped"):
        qp = tq.quantize_conv_stack(tm, v, never(), skip_blocks=skip, device="cpu")
    assert not any("w8" in b for b in qp["blocks"]) and not qp["scales"].any()
    assert tq.family_quant_plan(tm, v, device="cpu")[3] is True
    # ConvNeXt is no conv stack: its plan is ops/quant_convnext.py's
    # (tests/test_torch_quant_convnext.py), and the conv-stack fold refuses it
    from yogo_tpu_torch.ops import quant_convnext

    cn = YOGO.create(HW, 0.08, 0.1, 2, model_version="convnext_small")
    assert tq.family_quant_forward(cn) is quant_convnext.quantized_convnext_forward
    assert tq.family_quant_plan(cn, {}, device="cpu")[2:] == (71, False)
    with pytest.raises(NotImplementedError, match="quant_convnext"):
        tq.fold_conv_stack(cn.defn, {})


# ------------------------------------------- the forward, JAX's program in
def _crop_frames(n=2, rows=(200, 328), cols=(300, 492)):
    """n golden fullres frames cut to 128x192: the trained checkpoint's
    activations at a size the CPU runs in a second."""
    import tempfile
    from pathlib import Path

    from PIL import Image

    d = Path(tempfile.mkdtemp())
    gen_fullres(d, n=n)
    frames = [np.asarray(Image.open(p)) for p in sorted(d.glob("*.png"))]
    return np.stack([f[rows[0]:rows[1], cols[0]:cols[1]] for f in frames])[:, None]


@pytest.fixture(scope="module")
def trained_crop():
    model, v, _ = load_any(BASE_CKPT)
    x = _crop_frames()
    jm = JYOGO.create(x.shape[2:], model.anchor_w, model.anchor_h, 2, model_version="base_model")
    tm = model.resize(*x.shape[2:])
    return jm, tm, jax.tree.map(np.asarray, v), x


def _jax_codes(jm, qp, x):
    """The int8 codes entering each quantized block of JAX's program, by
    the lines of yogo_tpu/ops/quant.py:587-614, and its raw head."""
    specs = jm.defn.blocks
    h = jq._conv(jnp.asarray(jq.to_nhwc_f32(x)).astype(jnp.bfloat16), qp["stem_w"], specs[0],
                 jnp.float32) + qp["stem_b"]
    h = jq._act_fn(specs[0].act)(h)
    codes = []
    for j, blk in enumerate(qp["blocks"]):
        spec = specs[1 + j]
        if "w8" not in blk:
            h = jq._conv(h.astype(jnp.bfloat16), blk["w"], spec, jnp.float32) + blk["b"]
            h = jq._act_fn(spec.act)(h)
            continue
        q = jnp.clip(jnp.round(h / qp["scales"][j]), -127, 127).astype(jnp.int8)
        codes.append(np.asarray(q))
        acc = jq._conv(q, blk["w8"], spec, jnp.int32)
        h = jq._act_fn(spec.act)(acc.astype(jnp.float32) * blk["deq"] + blk["b"])
    return codes, np.asarray(h)


@pytest.mark.parametrize("skip", ["default", "head_only"])
def test_quantized_forward_codes_and_head_match_jax(trained_crop, skip, monkeypatch):
    """JAX's program through both forwards. skip "default" (blocks 4-6 int8)
    runs block 0 as the fused stem (its plain version here) with the
    bf16-rounded weights; "head_only" (blocks 1-6 int8) runs block 0 as
    the f32 conv, whose output feeds the entry requant."""
    jm, tm, v, x = trained_crop
    skip_blocks = tq.default_skip_blocks(tm.defn, 1) if skip == "default" else (7,)
    qj = jq.quantize_conv_stack(jm, v, [x], skip_blocks=skip_blocks)
    qp = quant_params_from_jax(_jax_numpy(qj))
    calls = []
    stem_fn = tq.fused_stem_nchw
    monkeypatch.setattr(tq, "fused_stem_nchw", lambda *a, **k: calls.append(1) or stem_fn(*a, **k))
    rec = []
    raw = tq.quantized_forward(tm, qp, torch.from_numpy(x), decode=False, record=rec).numpy()
    assert len(calls) == (skip == "default")
    want_codes, want_raw = _jax_codes(jm, qj, x)
    assert len(rec) == len(want_codes) == (3 if skip == "default" else 6)
    for got, want in zip(rec, want_codes):
        d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
        assert got.shape == want.shape and d.max() <= 1 and (d == 0).mean() >= 0.999
    assert raw.shape == want_raw.shape and raw.dtype == np.float32
    np.testing.assert_allclose(raw, want_raw, rtol=0, atol=0.05)
    # a float input never takes the stem kernel
    calls.clear()
    tq.quantized_forward(tm, qp, torch.from_numpy(x).float(), decode=False)
    assert not calls


def test_calibration_on_a_tiled_batch_equals_jax(trained_crop):
    """The calibration batch of `predict` at batch size 64 from repeated
    frames: the crop tiled to 16 images puts the entry of block 4 past
    1M elements, so the stride subsample skips elements (step 3) and walks
    other ones than on the crop alone. The port's payload still equals
    JAX's, and differs from the untiled one (how much the gates move with
    it at full resolution: tests/int8_calibration_witness.py)."""
    jm, tm, v, x = trained_crop
    skip = tq.default_skip_blocks(tm.defn, 1)
    tiled = np.concatenate([x] * 8)
    assert 128 * (x.shape[2] // 4) * (x.shape[3] // 4) * len(tiled) // 1_000_000 == 3
    got = tq.quantize_conv_stack(tm, v, [tiled], skip_blocks=skip, device="cpu")["scales"].numpy()
    want = np.asarray(jq.quantize_conv_stack(jm, v, [tiled], skip_blocks=skip)["scales"])
    np.testing.assert_allclose(got, want, rtol=CALIB_RTOL)
    untiled = tq.quantize_conv_stack(tm, v, [x], skip_blocks=skip, device="cpu")["scales"].numpy()
    assert not np.array_equal(got[:7], untiled[:7])


def test_trained_half_filters_stress_gate(tmp_path):
    """tests/test_quant.py's stress gate on the port: every BACKBONE block
    of the trained half_filters quantized (the head stays bf16), calibrated
    on the first half of 16 golden frames, against the port's float
    forward: same counts and classes, matched IoU > 0.9, objectness within
    0.1."""
    from tests.test_golden_detections import gen_test_images

    model, variables, _ = load_any(BASE_CKPT.parent / "trained_half_filters.ckpt")
    x = np.stack(gen_test_images(tmp_path / "g", n=16, seed=2))[:, None]
    qp = tq.quantize_conv_stack(model, variables, [x[:8]], skip_blocks=(len(model.defn.blocks) - 1,),
                                device="cpu")
    out_q = tq.quantized_forward(model, qp, torch.from_numpy(x)).numpy()
    out_f = Predictor(model, _stack(model, variables)).forward(x).numpy()
    n_match = n_total = 0
    for qi, fi in zip(out_q, out_f):
        dq = format_preds(qi, obj_thresh=0.5, iou_thresh=0.5)
        df = format_preds(fi, obj_thresh=0.5, iou_thresh=0.5)
        assert len(dq) == len(df)
        pairs = greedy_iou_match(dq, df, thresh=0.0)
        assert len(pairs) == len(df)
        for i, j, iou in pairs:
            assert iou > 0.9 and dq[i, 5:].argmax() == df[j, 5:].argmax()
            assert abs(dq[i, 4] - df[j, 4]) < 0.1
        n_match += len(pairs)
        n_total += len(df)
    assert n_total >= 20 and n_match == n_total


def _stack(model, variables):
    stack = model.module("cpu")
    stack.load_state_dict(state_dict_from_flax(variables), strict=True)
    return stack


def test_predict_quantize_fullres_golden_gates(tmp_path):
    """`predict(quantize=True, device="cpu")` at 772x1032 on the trained
    base_model: calibrated on the run's 4 images, real int8 blocks 4-6,
    the gates of tests/test_golden_fullres_int8.py against the committed
    bf16 detections (golden_scene.int8_gates, which chip_smoke.py holds the
    card to)."""
    golden = np.load(GOLDEN_PATH)
    gen_fullres(tmp_path / "imgs", n=4)
    preds = predict(BASE_CKPT, path_to_images=tmp_path / "imgs", return_full_predictions=True,
                    batch_size=4, quantize=True, device="cpu")
    gates = int8_gates([format_preds(p, obj_thresh=0.5, iou_thresh=0.5) for p in preds], golden)
    assert gates["failures"] == [] and gates["golden"] > 0


def test_predictor_from_checkpoint_quantize_and_calibration_errors(trained_crop):
    _, tm, _, x = trained_crop
    with pytest.raises(ValueError, match="at least one image"):
        Predictor.from_checkpoint(BASE_CKPT, device="cpu", quantize=True, calib=[])
    p = Predictor.from_checkpoint(BASE_CKPT, device="cpu", quantize=True, calib=[x[:, :, :96]],
                                  vertical_crop_height=96 / 772)
    raw = p.forward_raw(x[:, :, :96])
    assert p.qp is not None and raw.dtype == torch.float32 and raw.shape == (2, 12, 24, 7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # half_filters: every block skipped
        q = Predictor.from_checkpoint(BASE_CKPT.parent / "trained_half_filters.ckpt", device="cpu",
                                      quantize=True)
    assert not any("w8" in b for b in q.qp["blocks"])


def test_golden_scene_int8_gates_are_the_jax_test_s():
    """The int8 gates (yogo_tpu_torch/tools/golden_scene.py): the matcher
    is tests/test_golden_fullres_int8.py's, and the gates pass the committed
    detections against themselves and fail a dropped image's."""
    from yogo_tpu_torch.tools.golden_scene import greedy_iou_match as port_match

    golden = np.load(GOLDEN_PATH)
    dets = [golden[f"dets_{i}"] for i in range(4)]
    rng = np.random.default_rng(0)
    for d in dets:
        moved = d.copy()
        moved[:, :2] += rng.normal(0, 2e-3, (len(d), 2)).astype(np.float32)
        assert port_match(moved, d) == greedy_iou_match(moved, d)
    ok = int8_gates(dets, golden)
    assert ok["failures"] == [] and ok["matched"] == ok["golden"] == sum(len(d) for d in dets)
    bad = int8_gates([dets[0], dets[1][:-5], dets[2], dets[3]], golden)
    assert bad["failures"] and "image 1" in bad["failures"][0]
