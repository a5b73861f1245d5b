"""The port's command line on the CPU: the parsers against the JAX
package's (same flags, defaults and validators), `train` / `test` / `infer`
through `yogo_tpu_torch.__main__.main(argv)`, the stand-alone test entry
(the behaviours of tests/test_test_model_entry.py), and `test` on the
trained golden checkpoint against the JAX package's `yogo test`."""

import argparse
import json
import pickle
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from tests.data_fixtures import CLASSES, make_pair_dirs, write_defn
from yogo_tpu.utils import argparsers as jargs
from yogo_tpu.utils.test_model import test_model as jax_test_model
from yogo_tpu_torch.__main__ import main
from yogo_tpu_torch.infer import get_prediction_class_counts
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.utils import argparsers as targs
from yogo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from yogo_tpu_torch.utils.test_model import test_model as run_test_model
from yogo_tpu_torch.utils.weights import flax_from_state_dict

GOLDEN_CKPT = "tests/goldens/trained_half_filters.ckpt"


# -------------------------------------------------------------------- parsers
@pytest.mark.parametrize("make,argv", [
    ("train_parser", ["d.yml"]),
    ("train_parser", ["d.yml", "--epochs", "3", "-bs", "8", "--half", "--no-wandb", "--resume",
                      "--from-pretrained", "x.ckpt", "--packed-cache", "--remat", "blocks",
                      "--dataset-split-override", "0.5", "0.25", "0.25", "--image-hw", "96", "128",
                      "--checkpoint-interval", "2", "--accumulate-grad-batches", "3", "--no-fast-eval",
                      "--fast-eval-max-detections", "64", "--tags", "a", "b", "--lr", "0.01"]),
    ("test_parser", ["m.ckpt", "d.yml"]),
    ("test_parser", ["m.ckpt", "d.yml", "--include-mAP", "--include-background", "--dump-to-disk",
                     "--no-fast-eval", "--packed-cache", "dir", "--fast-eval-max-labels", "9"]),
    ("infer_parser", ["m.ckpt", "--path-to-images", "d"]),
    ("infer_parser", ["m.pth", "--path-to-zarr", "z", "--draw-boxes", "--save-npy", "--count",
                      "--output-dir", "o", "--class-names", "a", "b", "--batch-size", "3", "--half",
                      "--crop-height", "0.25", "--output-img-filetype", ".tif", "--obj-thresh", "0.3",
                      "--iou-thresh", "0.4", "--min-class-confidence-threshold", "0.2",
                      "--max-detections", "99", "--fetch-top-k", "0", "--no-use-tqdm"]),
    ("export_parser", ["m.ckpt"]),
    ("export_parser", ["m.pth", "--crop-height", "0.25", "--output-filename", "o", "--no-simplify",
                       "--format", "pth"]),
    ("serve_parser", ["m.ckpt"]),
    ("serve_parser", ["m.ckpt", "--host", "0.0.0.0", "--port", "0", "--batch-size", "64",
                      "--linger-ms", "2", "--fetch-top-k", "128", "--pipeline-depth", "3",
                      "--max-queue", "512", "--max-frames-per-request", "64", "--half",
                      "--crop-height", "0.5", "--class-names", "a", "b", "--obj-thresh", "0.6"]),
])
def test_parsers_give_the_jax_package_s_namespace(make, argv):
    """Same flag names, types and defaults; only --device differs in
    meaning (a torch device, default the card)."""
    got = vars(getattr(targs, make)().parse_args(argv))
    want = vars(getattr(jargs, make)().parse_args(argv))
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "dataset_split_override" and want[key] is not None:
            assert got[key].to_dict() == want[key].to_dict()
        else:
            assert got[key] == want[key], key
    assert got["device"] is None


@pytest.mark.parametrize("name,values", [
    ("uint", ["0", "3", "-1", "x"]), ("positive_int", ["0", "1", "x"]),
    ("unitary_float", ["0", "1", "0.5", "1.5", "x"]), ("super_unitary_float", ["1", "0.5", "x"]),
    ("unsigned_float", ["0", "-0.5", "2", "x"]),
])
def test_validators_accept_and_reject_like_the_jax_package_s(name, values):
    def outcome(fn, v):
        try:
            return fn(v)
        except argparse.ArgumentTypeError as e:
            return str(e)

    for v in values:
        assert outcome(getattr(targs, name), v) == outcome(getattr(jargs, name), v)


def test_global_parser_dispatches_three_subcommands_and_infer_keeps_its_flags(capsys, monkeypatch):
    p = targs.global_parser()
    assert p.parse_args(["train", "d.yml"]).task == "train"
    assert p.parse_args(["test", "m.ckpt", "d.yml"]).task == "test"
    a = p.parse_args(["infer", "m.ckpt", "--path-to-images", "imgs", "--count", "--half"])
    assert (a.task, a.count, a.half, a.batch_size, a.device) == ("infer", True, True, 64, None)
    assert str(p.parse_args(["infer", "m.ckpt", "--path-to-image", "i.png"]).path_to_images) == "i.png"
    a = p.parse_args(["serve", "m.ckpt", "--half", "--device", "cpu"])
    assert (a.task, a.half, a.batch_size, a.port, a.device) == ("serve", True, 8, 8765, "cpu")
    a = p.parse_args(["export", "m.ckpt"])
    assert (a.task, a.input, a.format, a.simplify, a.crop_height, a.device) == (
        "export", "m.ckpt", "onnx", True, None, None)
    for bad in (["export", "m.ckpt", "--format", "tflite"], ["infer", "m.ckpt"],
                ["infer", "m.ckpt", "--path-to-images", "d", "--batch-size", "0"], ["train", "d", "--epo", "1"],
                ["infer", "m.ckpt", "--path-to-images", "d", "--path-to-zarr", "z"],
                ["serve", "m.ckpt", "--batch-size", "0"]):
        with pytest.raises(SystemExit):
            p.parse_args(bad)
    # serve --spatial-parallel runs through main: each frame's rows split
    # over 2 devices (handles to the CPU), its /healthz says so
    import threading
    import urllib.request

    import yogo_tpu_torch.serve as serve_mod

    built = []
    build = serve_mod.build_server
    monkeypatch.setattr(serve_mod, "build_server", lambda *a, **k: built.append(build(*a, **k)) or built[-1])
    t = threading.Thread(target=main, args=(["serve", GOLDEN_CKPT, "--spatial-parallel", "2",
                                             "--data-parallel", "--port", "0", "--device", "cpu"],))
    t.start()
    try:
        deadline = time.monotonic() + 120
        while not built and t.is_alive():
            assert time.monotonic() < deadline, "the server was never built"
            time.sleep(0.05)
        assert built, "serve exited before building its server"
        port = built[0].server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            info = json.loads(r.read())
        # one data group of two row shards: two devices in all
        assert (info["spatial_parallel"], info["data_parallel_devices"]) == (2, 2)
    finally:
        if built:
            built[0].shutdown()
        t.join(timeout=60)
    assert not t.is_alive()
    # the parallel flags that are ported parse
    assert p.parse_args(["train", "d", "--fsdp"]).fsdp
    assert p.parse_args(["infer", "m.ckpt", "--path-to-images", "d", "--data-parallel"]).data_parallel


# ------------------------------------------------------------ train and test
@pytest.fixture()
def fixture_tree(tmp_path):
    pairs = [make_pair_dirs(tmp_path, str(i), n_images=6, seed=i) for i in range(2)]
    tpairs = [make_pair_dirs(tmp_path, "te", n_images=3, seed=5)]
    return write_defn(tmp_path / "d.yml", dataset_pairs=pairs, test_pairs=tpairs,
                      split={"train": 0.75, "val": 0.25})


def test_train_resume_test_and_infer_through_main(tmp_path, fixture_tree, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    common = [str(fixture_tree), "--device", "cpu", "--batch-size", "4", "--image-hw", "40", "56",
              "--no-wandb"]
    main(["train", *common, "--epochs", "2", "--model", "quarter_filters", "--name", "cli",
          "--packed-cache", str(tmp_path / "cache")])
    run = tmp_path / "trained_models" / "cli"
    assert sorted(p.name for p in run.iterdir()) == ["best.ckpt", "config.json", "latest.ckpt",
                                                     "metrics.jsonl", "validation_bbs.png"]
    assert "packed-cache: decoded" in capsys.readouterr().err
    _, _, meta = load_checkpoint(run / "latest.ckpt")
    assert meta["next_epoch"] == 2 and meta["classes"] == CLASSES and meta["model_name"] == "cli"
    # --resume with no --name continues in the run's own directory
    main(["train", *common, "--epochs", "3", "--resume", "--from-pretrained", str(run / "latest.ckpt")])
    _, _, meta2 = load_checkpoint(run / "latest.ckpt")
    assert meta2["next_epoch"] == 3 and meta2["step"] == meta["step"] // 2 * 3
    lines = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    assert [ln["epoch"] for ln in lines if "train loss" in ln][-1] == 2
    capsys.readouterr()
    for flags in (["--fast-eval"], ["--no-fast-eval", "--include-mAP", "--include-background"]):
        main(["test", str(run / "best.ckpt"), str(fixture_tree), "--device", "cpu", *flags])
        out = capsys.readouterr().out
        for text in ("test loss:", "confusion matrix:", "calibration error", "missed by class:"):
            assert text in out
        assert ("test mAP:" in out) == ("--include-mAP" in flags)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    Image.fromarray(np.full((40, 56), 200, np.uint8)).save(img_dir / "a.png")
    main(["infer", str(run / "best.ckpt"), "--path-to-images", str(img_dir), "--count", "--device", "cpu"])
    assert capsys.readouterr().out.strip().startswith("[('healthy',")


def test_without_a_card_and_without_device_cpu_every_subcommand_raises(tmp_path, fixture_tree):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is valid here")
    model = YOGO.create((40, 56), 0.15, 0.2, len(CLASSES), model_version="quarter_filters")
    stack = model.init(torch.Generator().manual_seed(0), device="cpu")
    save_checkpoint(tmp_path / "m.ckpt", model, flax_from_state_dict(stack.state_dict()), classes=CLASSES)
    for argv in (["train", str(fixture_tree), "--epochs", "1", "--no-wandb"],
                 ["test", str(tmp_path / "m.ckpt"), str(fixture_tree)],
                 ["infer", str(tmp_path / "m.ckpt"), "--path-to-images", str(tmp_path), "--count"],
                 ["infer", str(tmp_path / "m.ckpt"), "--path-to-images", str(tmp_path), "--save-npy",
                  "--output-dir", str(tmp_path / "o")],
                 ["serve", str(tmp_path / "m.ckpt"), "--port", "0"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert not (tmp_path / "trained_models").exists()


# ----------------------------------------------- the stand-alone test entry
def entry_args(ckpt, defn, **over):
    base = dict(ckpt_path=ckpt, dataset_defn_path=defn, wandb=False, wandb_entity=None,
                wandb_project=None, wandb_resume_id=None, dump_to_disk=False, include_mAP=True,
                include_background=True, note=None, tags=None, device="cpu")
    base.update(over)
    return SimpleNamespace(**base)


@pytest.fixture()
def fresh_ckpt(tmp_path):
    model = YOGO.create((40, 56), 0.15, 0.2, len(CLASSES), model_version="quarter_filters")
    stack = model.init(torch.Generator().manual_seed(0), device="cpu")
    save_checkpoint(tmp_path / "m.ckpt", model, flax_from_state_dict(stack.state_dict()), classes=CLASSES)
    return tmp_path / "m.ckpt"


def test_test_model_end_to_end(tmp_path, fresh_ckpt, fixture_tree, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    metrics = run_test_model(entry_args(fresh_ckpt, fixture_tree, dump_to_disk=True))
    out = capsys.readouterr().out
    for text in ("test loss:", "test mAP:", "confusion matrix:", "calibration error"):
        assert text in out
    with open(tmp_path / "test_metrics.pkl", "rb") as f:
        dumped = pickle.load(f)
    assert dumped[0] == metrics[0] and dumped[11] == CLASSES
    assert metrics[2].shape == (len(CLASSES) + 1,) * 2  # background included


def test_test_model_requires_test_split(tmp_path, fresh_ckpt):
    pairs = [make_pair_dirs(tmp_path, "only", n_images=3)]
    defn = write_defn(tmp_path / "train_only.yml", dataset_pairs=pairs)
    with pytest.raises(ValueError, match="no test split"):
        run_test_model(entry_args(fresh_ckpt, defn))


def test_test_model_class_mismatch_and_quantize_fail_fast(tmp_path, fresh_ckpt, fixture_tree):
    pairs = [make_pair_dirs(tmp_path, "tr", n_images=4)]
    defn = write_defn(tmp_path / "more.yml", dataset_pairs=pairs, classes=CLASSES + ["extra"],
                      split={"train": 0.5, "val": 0.25, "test": 0.25})
    with pytest.raises(ValueError, match="classes"):
        run_test_model(entry_args(fresh_ckpt, defn))
    # the mismatch is refused before a batch is taken to calibrate on
    with pytest.raises(ValueError, match="classes"):
        run_test_model(entry_args(fresh_ckpt, defn, quantize=True))
    # quarter_filters has no block wide enough for int8: the program is the
    # folded bf16 stack, said so, and scored
    with pytest.warns(UserWarning, match="every block is skipped"):
        metrics = run_test_model(entry_args(fresh_ckpt, fixture_tree, quantize=True))
    assert np.isfinite(metrics[0])


def test_quantize_through_main_runs_the_int8_program(tmp_path, fixture_tree, monkeypatch, capsys):
    """`test --quantize` on a base_model checkpoint (int8 blocks 4-6,
    calibrated on the first test batch) and `infer --quantize --count` on
    the trained golden base_model over 193-row crops of two golden frames:
    the counts printed are those of predict(quantize=True)."""
    from tests.test_golden_fullres import gen_test_images
    from yogo_tpu_torch.infer import predict

    monkeypatch.chdir(tmp_path)
    model = YOGO.create((40, 56), 0.15, 0.2, len(CLASSES), model_version="base_model")
    stack = model.init(torch.Generator().manual_seed(0), device="cpu")
    save_checkpoint(tmp_path / "b.ckpt", model, flax_from_state_dict(stack.state_dict()), classes=CLASSES)
    main(["test", str(tmp_path / "b.ckpt"), str(fixture_tree), "--device", "cpu", "--quantize"])
    out = capsys.readouterr().out
    assert "test loss:" in out and "nan" not in out.split("test loss:")[1].split()[0]

    ckpt = "tests/goldens/trained_base_model_fullres.ckpt"
    monkeypatch.chdir(Path(__file__).parent.parent)
    gen_test_images(tmp_path / "imgs", n=2)
    argv = ["infer", ckpt, "--path-to-images", str(tmp_path / "imgs"), "--count", "--device", "cpu",
            "--crop-height", "0.25", "--batch-size", "2"]
    main([*argv, "--quantize"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    kw = dict(path_to_images=tmp_path / "imgs", vertical_crop_height=0.25, return_full_predictions=True,
              batch_size=2, device="cpu")
    counts = get_prediction_class_counts(predict(ckpt, quantize=True, **kw))
    assert counts.sum() > 0 and printed == str([("cell", int(counts[0])), ("parasite", int(counts[1]))])


# ----------------------------- the golden checkpoint against `yogo test` (JAX)
def golden_fixture(root, n=16, seed=2):
    """The learning-validation generator of tests/test_golden_detections.py
    (frozen copy), with each blob's YOLO label row beside its frame."""
    img_dir, lbl_dir = root / "images", root / "labels"
    img_dir.mkdir()
    lbl_dir.mkdir()
    r = np.random.default_rng(seed)
    for i in range(n):
        arr = np.full((96, 128), 225, np.uint8)
        rows = []
        for _ in range(int(r.integers(2, 5))):
            cls = int(r.integers(0, 2))
            h, w = (12, 12) if cls == 0 else (8, 16)
            y, x = int(r.integers(2, 94 - h)), int(r.integers(2, 126 - w))
            arr[y : y + h, x : x + w] = 60 if cls == 0 else 130
            rows.append(f"{cls} {(x + w / 2) / 128} {(y + h / 2) / 96} {w / 128} {h / 96}")
        arr += r.integers(0, 12, arr.shape).astype(np.uint8)
        Image.fromarray(arr).save(img_dir / f"i{i:03d}.png")
        (lbl_dir / f"i{i:03d}.txt").write_text("\n".join(rows))
    return write_defn(root / "golden.yml", test_pairs=[(img_dir, lbl_dir)], classes=["cell", "parasite"])


@pytest.mark.parametrize("fast_eval", [True, False])
def test_golden_checkpoint_scores_as_the_jax_package_s_test(tmp_path, monkeypatch, fast_eval):
    """`test` on tests/goldens/trained_half_filters.ckpt over 16 frames of
    its own generator, both packages in bf16 on the CPU: the same confusion
    matrix, missed / extra counts and matched total. The two frameworks
    round bf16 convs differently, so box corners differ in the third digit:
    mAP is held at atol 5e-3 and the test loss at rtol 1e-2."""
    from pathlib import Path

    ckpt = Path(__file__).parent.parent / GOLDEN_CKPT
    root = tmp_path / "g"
    root.mkdir()
    defn = golden_fixture(root)
    results = {}
    for name, fn in (("jax", jax_test_model), ("port", run_test_model)):
        out = tmp_path / name
        out.mkdir()
        monkeypatch.chdir(out)
        fn(entry_args(ckpt, defn, include_background=False, dump_to_disk=True, fast_eval=fast_eval))
        with open(out / "test_metrics.pkl", "rb") as f:
            results[name] = pickle.load(f)
    got, want = results["port"], results["jax"]
    assert int(want[10][0]) > 30  # a trained model: most blobs are matched
    np.testing.assert_array_equal(got[2], want[2])  # confusion
    np.testing.assert_array_equal(got[8], want[8])  # missed by class
    np.testing.assert_array_equal(got[9], want[9])  # extra by class
    np.testing.assert_array_equal(got[10], want[10])  # matched total
    np.testing.assert_allclose(got[0], want[0], rtol=1e-2)
    np.testing.assert_allclose(got[1]["map"], want[1]["map"], atol=5e-3)
    assert got[11] == want[11] == ["cell", "parasite"]
