"""The port's candidate paths (ops/postprocess.py: select_top_candidates
{,_raw}, decode_raw_slice, scatter_candidates, format_to_numpy,
count_cells_for_formatted_preds) against the JAX package's on seeded heads.

Tolerances: the selected SET of cells is equal; candidate rows, the K-th
objectness and decoded slices agree within rtol 2e-6 / atol 1e-7 against
JAX (XLA's and torch's f32 logistic / exp / softmax differ in the last
bits); the host-side functions (scatter, numpy export, counts) are
bit-equal. Inside the port the candidate rows and the fallback slice are
bit-equal to the full decode of the same head, which is what makes a served
response equal the full-tensor formatter's. Tie ORDER among equal keys may
differ between the two top-Ks and is not compared: the fuzz uses continuous
logits for the set and quantized ones (ties) for the scatter."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yogo_tpu.ops import postprocess as jpost
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.ops import postprocess as tpost

ANCHORS = dict(anchor_w=0.1, anchor_h=0.12, width_multiplier=1.0, height_multiplier=1.3)
RTOL, ATOL = 2e-6, 1e-7


def _raw(seed, b=3, sy=12, sx=16, c=2, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sy, sx, 5 + c)) * 2).astype(dtype)


def _by_cell(rows, idx):
    order = np.argsort(idx)
    return rows[order], idx[order]


@pytest.mark.parametrize("seed,k", [(0, 8), (1, 64), (2, 191), (3, 1)])
def test_select_top_candidates_raw_equals_jax(seed, k):
    raw = _raw(seed)
    jr, ji = jpost.select_top_candidates_raw(jnp.asarray(raw), k, **{
        "anchor_w": ANCHORS["anchor_w"], "anchor_h": ANCHORS["anchor_h"],
        "width_multiplier": 1.0, "height_multiplier": 1.3})
    tr, ti = tpost.select_top_candidates_raw(torch.from_numpy(raw), k, **ANCHORS)
    jr, ji, tr, ti = np.asarray(jr), np.asarray(ji), tr.numpy(), ti.numpy()
    assert tr.shape == (3, k, 7) and ti.shape == (3, k) and tr.dtype == np.float32
    for b in range(3):
        assert set(ti[b]) == set(ji[b])
        got, gi = _by_cell(tr[b], ti[b])
        want, wi = _by_cell(jr[b], ji[b])
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        # sorted descending: the K-th (completeness proof) is the last
        assert np.all(np.diff(tr[b, :, 4]) <= 0)
        np.testing.assert_allclose(tr[b, -1, 4], jr[b, -1, 4], rtol=RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_candidates_and_slices_are_the_full_decode_bit_for_bit(dtype):
    """Rows and fallback slices come out of the same decode as
    YOGO.apply(..., inference=True), with the same offset tables: equal
    bits, bf16 head or f32."""
    model = YOGO.create((96, 128), 0.1, 0.12, 2, model_version="half_filters",
                        height_multiplier=1.3)
    sx, sy = model.grid
    raw = torch.from_numpy(_raw(4, b=2, sy=sy, sx=sx)).to(dtype)
    full = model._decode_raw(raw, inference=True)  # (B, D, Sy, Sx)
    flat = full.reshape(2, 7, -1)
    rows, idx = tpost.select_top_candidates_raw(raw, 50, **ANCHORS)
    for b in range(2):
        assert torch.equal(rows[b], flat[b, :, idx[b]].T)
        assert torch.equal(tpost.decode_raw_slice(raw, torch.tensor(b), **ANCHORS), full[b])


def test_decode_raw_slice_equals_jax():
    raw = _raw(5)
    for slot in range(3):
        want = np.asarray(jpost.decode_raw_slice(jnp.asarray(raw), jnp.int32(slot), 0.1, 0.12, 1.0, 1.3))
        got = tpost.decode_raw_slice(torch.from_numpy(raw), slot, **ANCHORS).numpy()
        assert got.shape == want.shape == (7, 12, 16)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_select_top_candidates_decoded_equals_jax():
    rng = np.random.default_rng(6)
    out = rng.random((2, 7, 12, 16), dtype=np.float32)
    jr, ji = jpost.select_top_candidates(jnp.asarray(out), 20)
    tr, ti = tpost.select_top_candidates(torch.from_numpy(out), 20)
    for b in range(2):
        got, gi = _by_cell(tr[b].numpy(), ti[b].numpy())
        want, wi = _by_cell(np.asarray(jr[b]), np.asarray(ji[b]))
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(got, want)  # a gather: exact


def test_scatter_format_and_count_equal_jax():
    rng = np.random.default_rng(7)
    pred = rng.random((7, 12, 16), dtype=np.float32)
    pred[2:4] *= 0.3
    flat = pred.reshape(7, -1).T
    idx = np.argsort(-flat[:, 4], kind="stable")[:40]
    np.testing.assert_array_equal(
        tpost.scatter_candidates(flat[idx], idx, 7, 12, 16),
        jpost.scatter_candidates(flat[idx], idx, 7, 12, 16),
    )
    for img_id in (0, 5):
        got = tpost.format_to_numpy(img_id, pred, 96, 128)
        want = jpost.format_to_numpy(img_id, pred, 96, 128)
        assert got.dtype == want.dtype and got.shape == want.shape and got.shape[0] == 10
        assert got.tobytes() == want.tobytes()
    rows = tpost.format_preds(pred)[:, 5:]
    for thresh in (None, 0.0, 0.55, 1.0):
        np.testing.assert_array_equal(
            tpost.count_cells_for_formatted_preds(rows, thresh),
            jpost.count_cells_for_formatted_preds(rows, thresh),
        )
    np.testing.assert_array_equal(tpost.count_cells_for_formatted_preds(np.zeros((0, 2))), [0, 0])
    for bad in (np.zeros(3), ):
        with pytest.raises(ValueError, match="expected"):
            tpost.count_cells_for_formatted_preds(bad)
    with pytest.raises(ValueError, match="between 0 and 1"):
        tpost.count_cells_for_formatted_preds(rows, 1.5)


def test_scatter_candidates_exactness_fuzz():
    """Port of tests/test_serve.py's fuzz: for random grids, random K and
    any threshold t >= the K-th candidate's objectness, format_preds on
    the scattered candidates is BIT-identical to format_preds on the full
    grid, NMS tie-breaks and duplicate objectness values included."""
    d, sy, sx = 9, 7, 11  # 4 classes
    s = sy * sx
    for seed in range(40):
        rng = np.random.default_rng(seed)
        pred = rng.random((d, sy, sx), dtype=np.float32)
        # clustered boxes + quantized objectness: suppression and ties occur
        pred[2:4] *= 0.4
        pred[4] = np.round(pred[4] * 8) / 8
        k = int(rng.integers(1, s + 1))
        flat = pred.reshape(d, s).T
        # the port's own top-K, in its device order (descending objectness)
        rows, idx = tpost.select_top_candidates(torch.from_numpy(pred)[None], k)
        rows, idx = rows[0].numpy(), idx[0].numpy()
        np.testing.assert_array_equal(rows, flat[idx])
        vk = rows[-1, 4]
        for t in (vk, min(vk + 0.1, 1.0), 0.6, 0.9):
            if vk > t:
                continue  # the server would take the full-fetch path
            rec = tpost.scatter_candidates(rows, idx, d, sy, sx)
            got = tpost.format_preds(rec, obj_thresh=float(t), iou_thresh=0.5)
            want = tpost.format_preds(pred, obj_thresh=float(t), iou_thresh=0.5)
            np.testing.assert_array_equal(got, want, err_msg=f"{seed}/{t}")
