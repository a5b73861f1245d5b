"""The port's `infer` artifacts on the CPU against yogo_tpu.infer.predict on
the same images and checkpoint (tests/goldens/trained_half_filters.ckpt,
96x128, float32):

  - `--save-preds` .txt files: same lines, class exact, boxes within 1e-6
    (the tolerance of test_torch_postprocess.py::test_format_and_count_equal_jax:
    XLA's and torch's f32 convs differ in the last bits);
  - `--save-npy` .npy: same shape, image ids and labels exact, the rest
    within 1e-6 (pixels: 1e-6 relative); its .json sidecar equal except
    write_date;
  - `--count` alongside artifacts: the host counts, equal;
  - `--crop-height`: all of the above on the cropped frames;
  - `--fetch-top-k` K (candidates, with and without full-slice fallbacks)
    and 0 (full tensors): BYTE-equal files;
  - `--draw-boxes`: one image per frame; a malformed image skips its batch.
"""

import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_golden_detections import gen_test_images
from yogo_tpu.infer import predict as jax_predict
from yogo_tpu_torch.infer import predict

REPO = Path(__file__).resolve().parent.parent
CKPT = REPO / "tests" / "goldens" / "trained_half_filters.ckpt"
N_IMAGES = 6


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("artifacts") / "scope_run" / "images"
    gen_test_images(d, n=N_IMAGES, seed=5)
    return d


def _run(fn, img_dir, out, capsys, **kw):
    out.mkdir(parents=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fn(CKPT, path_to_images=img_dir, output_dir=str(out), save_preds=True, save_npy=True,
           count_predictions=True, batch_size=4, **kw)
    return capsys.readouterr().out.strip().splitlines()[-1]


@pytest.fixture(scope="module", params=[None, 0.5], ids=["full", "crop0.5"])
def both(request, img_dir, tmp_path_factory):
    """(port dir, JAX dir, port counts line, JAX counts line)."""
    import io
    from contextlib import redirect_stdout

    root = tmp_path_factory.mktemp("both")
    lines = []
    for name, fn, kw in (("port", predict, {"device": "cpu", "fetch_top_k": 64}),
                         ("jax", jax_predict, {})):
        buf = io.StringIO()
        (root / name).mkdir()
        with redirect_stdout(buf), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fn(CKPT, path_to_images=img_dir, output_dir=str(root / name), save_preds=True,
               save_npy=True, count_predictions=True, batch_size=4,
               vertical_crop_height=request.param, **kw)
        lines.append(buf.getvalue().strip().splitlines()[-1])
    return root / "port", root / "jax", lines[0], lines[1]


def test_save_preds_txt_equal_jax(both):
    port, jax_dir, _, _ = both
    names = sorted(p.name for p in jax_dir.glob("*.txt"))
    assert names == sorted(p.name for p in port.glob("*.txt")) and len(names) == N_IMAGES
    n_rows = 0
    for name in names:
        got = [ln.split() for ln in (port / name).read_text().splitlines()]
        want = [ln.split() for ln in (jax_dir / name).read_text().splitlines()]
        assert [g[0] for g in got] == [w[0] for w in want], name
        np.testing.assert_allclose(np.array([g[1:] for g in got], float).reshape(-1, 4),
                                   np.array([w[1:] for w in want], float).reshape(-1, 4),
                                   rtol=0, atol=1e-6)
        n_rows += len(got)
    assert n_rows >= N_IMAGES  # the trained model finds the generator's blobs


def test_save_npy_and_sidecar_equal_jax(both):
    port, jax_dir, _, _ = both
    # named after the images directory's parent, as on the scope
    got, want = np.load(port / "scope_run.npy"), np.load(jax_dir / "scope_run.npy")
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    assert got.shape[0] == 10 and got.shape[1] > 0
    np.testing.assert_array_equal(got[[0, 6]], want[[0, 6]])  # image ids, labels
    np.testing.assert_allclose(got[1:5], want[1:5], rtol=1e-6, atol=1e-4)  # pixels
    np.testing.assert_allclose(got[5:], want[5:], rtol=0, atol=1e-6)
    meta_got = json.loads((port / "scope_run.json").read_text())
    meta_want = json.loads((jax_dir / "scope_run.json").read_text())
    assert meta_got.pop("write_date") and meta_want.pop("write_date")
    assert meta_got == meta_want


def test_count_alongside_artifacts_equal_jax(both):
    _, _, port_line, jax_line = both
    assert port_line == jax_line and port_line.startswith("[('cell',")


@pytest.mark.parametrize("k,fallback", [(2, True), (64, False)])
def test_fetch_top_k_files_byte_equal_to_full_tensors(img_dir, tmp_path, capsys, k, fallback):
    full = _run(predict, img_dir, tmp_path / "k0", capsys, device="cpu", fetch_top_k=0)
    tmp = tmp_path / f"k{k}"
    tmp.mkdir()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        predict(CKPT, path_to_images=img_dir, output_dir=str(tmp), save_preds=True,
                save_npy=True, count_predictions=True, batch_size=4, device="cpu", fetch_top_k=k)
    cand = capsys.readouterr().out.strip().splitlines()[-1]
    # K=2 is below the passing cells of most frames: their full slices come
    # back instead (the run warns when more than a tenth do)
    assert any("fell back" in str(w.message) for w in caught) == fallback
    assert cand == full
    names = sorted(p.name for p in (tmp_path / "k0").iterdir())
    assert names == sorted(p.name for p in tmp.iterdir()) and len(names) == N_IMAGES + 2
    for name in names:
        if name.endswith(".json"):
            continue  # write_date
        assert (tmp / name).read_bytes() == (tmp_path / "k0" / name).read_bytes(), name


def test_draw_boxes_and_a_malformed_image(img_dir, tmp_path):
    from PIL import Image

    predict(CKPT, path_to_images=img_dir, output_dir=str(tmp_path / "drawn"), draw_boxes=True,
            batch_size=4, device="cpu", output_img_ftype=".tif")
    drawn = sorted((tmp_path / "drawn").iterdir())
    assert [p.name for p in drawn] == [f"i{i:03d}.tif" for i in range(N_IMAGES)]
    with Image.open(drawn[0]) as im:
        assert im.mode == "RGBA" and im.size == (128, 96)
    # a broken frame skips its batch with a warning, the others are written
    bad = tmp_path / "bad"
    bad.mkdir()
    for p in sorted(img_dir.iterdir())[:3]:
        (bad / p.name).write_bytes(p.read_bytes())
    (bad / "i000.png").write_bytes(b"not a png")
    with pytest.warns(UserWarning, match="got error"):
        predict(CKPT, path_to_images=bad, output_dir=str(tmp_path / "o"), save_preds=True,
                batch_size=2, device="cpu")
    assert sorted(p.name for p in (tmp_path / "o").iterdir()) == ["i002.txt"]


def test_unported_options_raise_naming_their_roadmap_items(img_dir, tmp_path, capsys):
    # --spatial-parallel splits each image's rows over N devices (N handles
    # to the CPU here), and --data-parallel in one process that sees one
    # device is the single-device path (the JAX package with one device
    # builds no mesh): the counts are the single-device ones
    counts = []
    for kw in ({}, {"data_parallel": True}, {"spatial_parallel": 2},
               {"spatial_parallel": 4, "data_parallel": True}):
        predict(CKPT, path_to_images=img_dir, count_predictions=True, device="cpu", batch_size=4,
                **kw)
        counts.append(capsys.readouterr().out.strip())
    assert counts == [counts[0]] * 4 and counts[0].startswith("[('cell',")
    with pytest.raises(ValueError, match="divisible"):
        predict(CKPT, path_to_images=img_dir, count_predictions=True, device="cpu",
                spatial_parallel=5)
    with pytest.raises(ValueError, match="at the same time"):
        predict(CKPT, path_to_images=img_dir, save_preds=True, draw_boxes=True,
                output_dir=str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="output_dir"):
        predict(CKPT, path_to_images=img_dir, save_preds=True, device="cpu")


def test_data_parallel_in_one_process_that_sees_several_cards_raises_naming_torchrun(
        img_dir, monkeypatch, capsys):
    """One process a card: --data-parallel without a process group where
    several cards are visible would run on one of them, so it raises (the
    JAX package meshes them); with one card, or on the CPU, it runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for device in (None, "cuda", "cuda:1"):
        with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
            predict(CKPT, path_to_images=img_dir, count_predictions=True, data_parallel=True,
                    device=device)
    predict(CKPT, path_to_images=img_dir, count_predictions=True, data_parallel=True, batch_size=4,
            device="cpu")
    assert capsys.readouterr().out.strip().startswith("[('cell',")


def test_cli_save_npy_on_the_cpu(img_dir, tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "yogo_tpu_torch", "infer", str(CKPT), "--path-to-images",
         str(img_dir), "--save-npy", "--count", "--output-dir", str(tmp_path / "o"),
         "--device", "cpu", "--no-use-tqdm", "--fetch-top-k", "16"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().startswith("[('cell',")
    assert sorted(p.name for p in (tmp_path / "o").iterdir()) == ["scope_run.json", "scope_run.npy"]
