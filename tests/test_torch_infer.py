"""The port's slice as a whole, on the CPU: `predict` and the CLI on the
trained base_model checkpoint at 772x1032 reproduce the JAX package's
committed golden detections (tests/goldens/detections_fullres_base.npz,
from tests/test_golden_fullres_int8.py).

  - float32 full predictions + format_preds: equal per-image counts, boxes
    at the golden's own gate (rtol 2e-3, atol 2e-4);
  - the `--count` path (selection-first, on the device) totals the golden's
    per-class counts, with a ragged last batch;
  - bf16 (`half`, the plain stem on the CPU): per-image counts within +-2,
    the gate of tests/test_golden_fullres_int8.py.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_golden_fullres import gen_test_images
from yogo_tpu_torch.data.image_source import ImagePathDataset
from yogo_tpu_torch.infer import Predictor, predict
from yogo_tpu_torch.ops.postprocess import format_preds

REPO = Path(__file__).resolve().parent.parent
GOLDENS = REPO / "tests" / "goldens"
CKPT = GOLDENS / "trained_base_model_fullres.ckpt"
N_IMAGES = 4
CLASSES = ["cell", "parasite"]


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDENS / "detections_fullres_base.npz")
    dets = [g[f"dets_{i}"] for i in range(N_IMAGES)]
    counts = np.zeros(len(CLASSES), np.int64)
    for d in dets:
        np.add.at(counts, d[:, 5:].argmax(axis=1), 1)
    return dets, counts


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fullres") / "imgs"
    gen_test_images(d, n=N_IMAGES)
    return d


def _counts_line(counts) -> str:
    return str(list(zip(CLASSES, (int(c) for c in counts))))


def test_f32_full_predictions_match_golden(img_dir, golden, capsys):
    dets_want, counts_want = golden
    preds = predict(CKPT, path_to_images=img_dir, return_full_predictions=True,
                    count_predictions=True, batch_size=4, device="cpu")
    assert preds.shape == (N_IMAGES, 7, 97, 129) and preds.dtype == np.float32
    for i, p in enumerate(preds):
        d = format_preds(p, obj_thresh=0.5, iou_thresh=0.5)
        assert d.shape == dets_want[i].shape, f"detection count changed for image {i}"
        np.testing.assert_allclose(d, dets_want[i], rtol=2e-3, atol=2e-4)
    assert _counts_line(counts_want) in capsys.readouterr().out


@pytest.mark.parametrize("batch_size", [4, 3])
def test_f32_count_path_totals_golden(img_dir, golden, capsys, batch_size):
    predict(CKPT, path_to_images=img_dir, count_predictions=True,
            batch_size=batch_size, device="cpu")
    assert _counts_line(golden[1]) in capsys.readouterr().out


def test_bf16_with_stem_within_two_per_image(img_dir, golden):
    dets_want, _ = golden
    pred = Predictor.from_checkpoint(CKPT, half=True, device="cpu")
    ds = ImagePathDataset(img_dir)
    imgs = np.stack([ds[i][0] for i in range(len(ds))])
    x = pred.to_device(imgs)
    assert pred.model.stem_kernel_eligible(pred.stack, x)
    full = pred.forward(imgs).numpy()
    raw = pred.forward_raw(imgs)
    for i in range(N_IMAGES):
        n_full = len(format_preds(full[i]))
        n_dev = int(pred.count(raw, torch.arange(N_IMAGES) == i).sum())
        assert abs(n_full - len(dets_want[i])) <= 2, (i, n_full)
        assert abs(n_dev - len(dets_want[i])) <= 2, (i, n_dev)


def test_cli_count_prints_golden_totals(img_dir, golden):
    r = subprocess.run(
        [sys.executable, "-m", "yogo_tpu_torch", "infer", str(CKPT),
         "--path-to-images", str(img_dir), "--count", "--batch-size", "3",
         "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert _counts_line(golden[1]) in r.stdout


def test_cli_requires_count(img_dir, tmp_path):
    """`infer` asks for no --count any more: the artifact paths run too
    (tests/test_torch_infer_artifacts.py holds them against JAX); here the
    golden scene's --save-preds files hold the golden detection counts."""
    r = subprocess.run(
        [sys.executable, "-m", "yogo_tpu_torch", "infer", str(CKPT),
         "--path-to-images", str(img_dir), "--save-preds", "--output-dir", str(tmp_path / "o"),
         "--batch-size", "3", "--device", "cpu", "--no-use-tqdm"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    g = np.load(GOLDENS / "detections_fullres_base.npz")
    for i, txt in enumerate(sorted((tmp_path / "o").iterdir())):
        assert len(txt.read_text().splitlines()) == len(g[f"dets_{i}"]), txt.name
