"""`predict(data_parallel=True)` at world 2 (two gloo ranks on the CPU,
tests/torch_parallel_worker.py), the port's counterpart of the JAX
package's multihost_infer_worker case: 5 images at batch 2 a rank, so rank
0 runs [0, 2) + [2, 3) and rank 1 runs [3, 5) plus one fully masked round.
The counts equal one process of the port and JAX's predict, and rank 1
prints none; the artifacts are the single-process ones, each written by
the rank that owns the image. Under --quantize rank 0 calibrates on its
leading images and every rank runs its program: the scales are equal on
the ranks bit for bit, and each count is within 1 of one process (JAX's
gate, tests/test_multihost.py:432). What a multi-process run refuses
(spatial-only, return_full_predictions, serve) raises. With
--spatial-parallel 2 each rank splits its images' rows over its own two
devices, and the counts are one process's."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

from tests.torch_parallel_worker import load_rank, run_workers
from yogo_tpu.infer import predict as jax_predict
from yogo_tpu.models.yogo import YOGO as JYOGO
from yogo_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from yogo_tpu_torch.infer import predict
from yogo_tpu_torch.tools.golden_scene import gen_golden_images

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "tests" / "goldens" / "trained_half_filters.ckpt"
HW = (96, 128)
THRESH = 0.5


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The trained half_filters checkpoint on 5 frames of the golden
    scene's generator; a seeded base_model at the same size for int8."""
    d = tmp_path_factory.mktemp("infer_dp")
    # base_model's blocks of >= 128 input channels quantize, so the int8
    # leg really broadcasts a calibration payload
    model_q = JYOGO.create(HW, 0.15, 0.2, 2, model_version="base_model")
    jax_save_checkpoint(d / "model_q.ckpt", model_q, model_q.init(jax.random.key(1)),
                        classes=["cell", "parasite"], model_name="mq")
    img_dir = d / "imgs"
    img_dir.mkdir()
    imgs, _ = gen_golden_images(5, hw=HW)
    for i, im in enumerate(imgs):
        Image.fromarray(im[0]).save(img_dir / f"im{i}.png")
    (d / "mh").mkdir()
    spec = {"img_dir": str(img_dir), "ckpt": str(CKPT),
            "ckpt_q": str(d / "model_q.ckpt"), "out_dir": str(d / "mh")}
    (d / "infer.json").write_text(json.dumps(spec))
    outs = run_workers("infer", d, d / "out", timeout=240)
    run_workers("raises", d, d / "out", timeout=120)
    return d, spec, outs


def count_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("[(")]


def one_process(spec, capsys, **kw):
    predict(spec["ckpt"], path_to_images=spec["img_dir"], count_predictions=True, batch_size=2,
            obj_thresh=THRESH, device="cpu", **kw)
    return capsys.readouterr().out.strip().splitlines()[-1]


def test_counts_equal_one_process_and_jax_and_rank_one_prints_none(scene, capsys):
    d, spec, outs = scene
    want = one_process(spec, capsys)
    jax_predict(spec["ckpt"], path_to_images=spec["img_dir"], count_predictions=True,
                batch_size=2, obj_thresh=THRESH, use_tqdm=False)
    assert capsys.readouterr().out.strip().splitlines()[-1] == want
    got = count_lines(outs[0])
    assert got[:2] == [want, want], outs[0]  # the fused count path, the host path
    assert sum(n for _, n in ast.literal_eval(want)) > 0
    assert count_lines(outs[1]) == []


def test_spatial_parallel_under_two_ranks_counts_as_one_process(scene, capsys):
    """`infer --data-parallel --spatial-parallel 2` at world 2: each rank
    splits its own images' rows over its 2 devices; rank 0 prints one
    process's counts."""
    d, spec, outs = scene
    want = one_process(spec, capsys)
    assert count_lines(outs[0])[3] == want, outs[0]
    assert count_lines(outs[1]) == []


def test_artifacts_are_the_single_process_ones_written_by_their_owners(scene, capsys, tmp_path):
    d, spec, _ = scene
    single = tmp_path / "single"
    one_process(spec, capsys, output_dir=str(single), save_preds=True, save_npy=True)
    mh = d / "mh"
    txt = sorted(p.name for p in single.glob("*.txt"))
    assert sorted(p.name for p in mh.glob("*.txt")) == txt and len(txt) == 5
    for name in txt:
        assert (mh / name).read_text() == (single / name).read_text(), name
    # one .npy a rank, named after the images' parent directory, image ids global
    npys = sorted(p.name for p in mh.glob("*.npy"))
    assert npys == [f"{d.name}.p0.npy", f"{d.name}.p1.npy"], npys
    merged = np.hstack([np.load(mh / n) for n in npys])
    np.testing.assert_array_equal(merged, np.load(single / f"{d.name}.npy"))


def test_int8_scales_are_rank_zero_s_on_every_rank_and_counts_within_one(scene, capsys):
    d, spec, outs = scene
    ranks = [load_rank(d / "out", "infer", r) for r in range(2)]
    for r in ranks:
        assert len(r["scales"]) == 1
    np.testing.assert_array_equal(ranks[0]["scales"][0], ranks[1]["scales"][0])
    assert (ranks[0]["scales"][0] > 0).any()
    predict(spec["ckpt_q"], path_to_images=spec["img_dir"], count_predictions=True, quantize=True,
            batch_size=2, obj_thresh=THRESH, device="cpu")
    want = dict(ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1]))
    got = dict(ast.literal_eval(count_lines(outs[0])[2]))
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1, (k, got[k], want[k])


@pytest.mark.parametrize("what, kind", [("spatial_only", "ValueError: spatial_parallel-only"),
                                        ("full_predictions", "ValueError: return_full_predictions"),
                                        ("serve", "ValueError: data_parallel/spatial_parallel")])
def test_a_multi_process_run_refuses(scene, what, kind):
    d, _, _ = scene
    for r in range(2):
        caught = load_rank(d / "out", "raises", r)[what]
        assert caught is not None and caught.startswith(kind), caught
