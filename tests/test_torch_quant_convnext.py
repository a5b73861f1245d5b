"""The port's int8 program of ConvNeXt-Small (yogo_tpu_torch/ops/
quant_convnext.py) against the JAX package's (yogo_tpu/ops/
quant_convnext.py) on the CPU, 64x96, B=2, on the JAX package's init with
every gamma, bias and norm scale perturbed (tests/test_torch_convnext.py).

  - the site list: the JAX package's 71 of 75;
  - calibration: the per-site scales at rtol 1e-5 (the f32 functional
    forwards sum in other orders);
  - the functional f32 twin against JAX's and against the port's module at
    rtol = atol = 1e-4;
  - with JAX's scales the weights and dequant factors are JAX's, bit for
    bit; the codes entering each site equal JAX's program's in at least
    99.9% of places and differ by at most 1 elsewhere, each site held from
    the same site outputs as JAX's program (the port's stream continues
    from JAX's site outputs). Run free, two int8 programs of 71 sites drift
    apart: a float difference of d at a site's input flips a fraction ~d/s
    of its codes (s the site's scale), and the flips move the next site's
    input by ~sqrt(d s), so after a few blocks the programs differ by about
    one code step whatever float order they use. Free-running, the port's
    raw int8 head is held within twice the JAX program's own int8 error
    (its distance to JAX's f32 head);
  - the decoded output on the JAX package's init (gamma 1e-6), the fixture
    of tests/test_quant_convnext.py, within that file's bounds of JAX's f32
    output (objectness and class probabilities 0.01, centres 0.005);
  - the entry points on ConvNeXt: `train --model convnext_small` one epoch
    at 64x96, then `test` and `infer --count --quantize` on its best.ckpt
    through the CLI (and `test --quantize`), `serve`, and `serve
    --quantize` with a reload.
On the CPU the int8 conv is its plain version (exact integers).
"""

import functools
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.data_fixtures import CLASSES, make_pair_dirs, write_defn
from tests.test_torch_convnext import HW, NUM_CLASSES, images, perturb
from yogo_tpu.models.yogo import YOGO as JYOGO
from yogo_tpu.ops import quant_convnext as jqc
from yogo_tpu_torch.infer import Predictor, needs_calibration, quantize_stack
from yogo_tpu_torch.models.yogo import ConvNeXtSmall, YOGO
from yogo_tpu_torch.ops import int8_conv as ic
from yogo_tpu_torch.ops import quant as tq
from yogo_tpu_torch.ops import quant_convnext as qc
from yogo_tpu_torch.utils import checkpoint as tckpt
from yogo_tpu_torch.utils.weights import state_dict_from_flax


@pytest.fixture(scope="module")
def setup():
    jm = JYOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="convnext_small")
    v = {"params": perturb(jax.tree.map(np.asarray, jm.init(jax.random.key(3)))["params"],
                           np.random.default_rng(3))}
    m = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="convnext_small")
    net = m.module("cpu")
    net.load_state_dict(state_dict_from_flax(v), strict=True)
    x = images(11)
    jqp = jqc.quantize_convnext(jm, v, [x])
    return jm, v, m, net, x, jqp


def jax_sites(jm, jqp, x):
    """JAX's int8 program on x, recording at each int8 site the codes that
    enter it and its f32 output (quantized_convnext_forward's site)."""
    int8, scales = jqp["int8"], jqp["scales"]
    keys = [k for k, _ in jqc.quant_sites(min_cin=0) if k in int8]
    bf16_site = jqc._float_site(jnp.bfloat16)
    codes, outs = [], []

    def site(key, h, kernel, bias, stride):
        if key not in int8:
            return bf16_site(key, h, kernel, bias, stride)
        blk = int8[key]
        q = jnp.clip(jnp.round(h.astype(jnp.float32) / scales[keys.index(key)]), -127, 127).astype(jnp.int8)
        if stride is None:
            acc = jax.lax.dot_general(q, blk["w8"], (((q.ndim - 1,), (0,)), ((), ())),
                                      preferred_element_type=jnp.int32)
        else:
            acc = jax.lax.conv_general_dilated(q, blk["w8"], (stride, stride), [(0, 0), (0, 0)],
                                               dimension_numbers=jqc._DN, preferred_element_type=jnp.int32)
        out = acc.astype(jnp.float32) * blk["deq"] + blk["b"]
        codes.append(np.asarray(q))
        outs.append(np.asarray(out))
        return out

    class Placeholders(dict):
        def __missing__(self, k):
            return {"kernel": None, "bias": None}

    def tree(node):
        out = Placeholders()
        for k, leaf in node.items():
            out[k] = tree(leaf) if isinstance(leaf, dict) else leaf
        return out

    xn = jnp.transpose(jnp.asarray(x, jnp.float32), (0, 2, 3, 1))
    jqc._forward(tree(jqp["float"]), xn, site, compute_dtype=jnp.bfloat16, res_dtype=jnp.float32)
    return codes, outs


def test_site_list_is_the_jax_package_s():
    assert qc.quant_sites() == jqc.quant_sites()
    assert len(qc.quant_sites()) == 71 and len(qc.quant_sites(min_cin=0)) == 75
    assert qc.quant_sites()[0] == ("stage0_block0/pwconv2", 384)


def test_calibration_scales_match_jax(setup):
    jm, v, m, net, x, jqp = setup
    got = qc.calibrate_act_scales(net, [x], device="cpu")
    np.testing.assert_allclose(got, np.asarray(jqp["scales"]), rtol=1e-5)
    # the flax-layout tree and the module give the same scales (the CPU's
    # convs may sum in another order for another allocation: ulps)
    np.testing.assert_allclose(qc.calibrate_act_scales(v, [x], device="cpu"), got, rtol=2e-6)


def test_float_twin_matches_jax_s_and_the_module(setup):
    jm, v, m, net, x, _ = setup
    xf = x.astype(np.float32)
    want = np.asarray(jqc.float_forward(v["params"], jnp.transpose(jnp.asarray(xf), (0, 2, 3, 1))))
    got = qc.float_forward(net, x, device="cpu").numpy()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, m.apply(net, torch.from_numpy(x), decode=False).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_with_jax_s_scales_weights_and_codes_are_jax_s(setup):
    jm, v, m, net, x, jqp = setup
    qp = qc.quantize_convnext(m, net, [], act_scales=np.asarray(jqp["scales"]), device="cpu")
    assert sorted(qp["int8"]) == sorted(jqp["int8"])
    for key, blk in jqp["int8"].items():
        np.testing.assert_array_equal(qp["int8"][key]["w8"].numpy(), ic.pack_weights(np.asarray(blk["w8"]).reshape(
            (1, 1) + blk["w8"].shape if blk["w8"].ndim == 2 else blk["w8"].shape)).numpy())
        np.testing.assert_array_equal(qp["int8"][key]["deq"].numpy(), np.asarray(blk["deq"]))
        np.testing.assert_array_equal(qp["int8"][key]["b"].numpy(), np.asarray(blk["b"]))
    want_codes, want_outs = jax_sites(jm, jqp, x)
    assert len(want_codes) == 71
    # each site from JAX's site outputs: the port's int8 site computes its
    # own codes and output, then hands JAX's output on
    index = {k: i for i, (k, _) in enumerate(qc.quant_sites())}
    got_codes, got_outs, forced = [], [], iter(want_outs)
    flt, bf16_site = qp["float"], qc._float_site(qp["float"], torch.bfloat16)

    def site(key, h, stride):
        if key not in qp["int8"]:
            return bf16_site(key, h, stride)
        blk = qp["int8"][key]
        q = tq.requant_nhwc(h, qp["scales"][index[key]])
        got_codes.append(q)
        got_outs.append(ic.int8_conv(q, blk["w8"], blk["deq"], blk["b"], cin=q.shape[-1], stride=stride or 1,
                                     padding=0, act=None))
        return torch.from_numpy(next(forced))

    with torch.inference_mode():
        qc._forward(flt, torch.from_numpy(x).float(), site, torch.bfloat16)
    for i, (got, exp, out, jout) in enumerate(zip(got_codes, want_codes, got_outs, want_outs)):
        diff = np.abs(got.numpy().astype(np.int32) - exp.astype(np.int32))
        assert got.shape == exp.shape, i
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (i, diff.max(), (diff == 0).mean())
        # where a pixel's codes are all equal, so is the int8 conv's output
        # (the epilogue's two roundings; XLA may fuse them: 1 ulp)
        same = (diff == 0).all(axis=-1)
        if qc.quant_sites()[i][0].startswith("down"):
            continue  # a 2x2 output pixel reads 4 input pixels
        np.testing.assert_allclose(out.numpy()[same], jout[same], rtol=2e-7, atol=1e-7, err_msg=str(i))


def test_free_running_int8_head_stays_within_int8_noise_of_jax_s(setup):
    """Both programs run free from the same calibration: the port's raw
    head within twice JAX's own int8 error (see the module docstring)."""
    jm, v, m, net, x, jqp = setup
    want = np.asarray(jax.jit(functools.partial(jqc.quantized_convnext_forward, jm, decode=False))(
        jqp, jnp.asarray(x)))
    ref = np.asarray(jqc.float_forward(v["params"], jnp.transpose(jnp.asarray(x, jnp.float32), (0, 2, 3, 1))))
    qp = qc.quantize_convnext(m, net, [x], device="cpu")
    raw = qc.quantized_convnext_forward(m, qp, torch.from_numpy(x), decode=False)
    assert raw.dtype == torch.float32 and raw.shape == (2, 8, 12, 9)
    noise = np.abs(want - ref).max()
    assert 0 < noise < 0.1 * np.abs(ref).max()
    assert np.abs(raw.numpy() - want).max() <= 2 * noise


def test_decoded_output_within_the_jax_gates_on_jax_s_init():
    """tests/test_quant_convnext.py's fixture (JAX's init, 64x96, 4
    classes, seed 7) and bounds, against JAX's f32 output, and the port's
    program deterministic."""
    jm = JYOGO.create(HW, 0.0425, 0.0555, 4, model_version="convnext_small")
    v = jax.tree.map(np.asarray, jm.init(jax.random.key(7)))
    x = np.random.default_rng(7).integers(0, 256, (2, 1, *HW)).astype(np.uint8)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), inference=True))
    m = YOGO.create(HW, 0.0425, 0.0555, 4, model_version="convnext_small")
    qp = qc.quantize_convnext(m, v, [x], device="cpu")
    out = qc.quantized_convnext_forward(m, qp, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, qc.quantized_convnext_forward(m, qp, torch.from_numpy(x)).numpy())
    assert out.shape == ref.shape == (2, 9, 8, 12)
    assert np.max(np.abs(ref[:, 4] - out[:, 4])) < 0.01  # objectness
    assert np.max(np.abs(ref[:, 5:] - out[:, 5:])) < 0.01  # class probabilities
    assert np.max(np.abs(ref[:, :2] - out[:, :2])) < 0.005  # centres
    assert (out[:, 2] > 0).all() and (out[:, 3] > 0).all()
    np.testing.assert_allclose(out[:, 5:].sum(axis=1), 1.0, rtol=1e-4)


def test_program_layout_and_argument_checks(setup):
    jm, v, m, net, x, jqp = setup
    scales = np.asarray(jqp["scales"])
    qp = qc.quantize_convnext(m, v, [], act_scales=scales, device="cpu")
    assert len(qp["int8"]) == 71 and qp["scales"].dtype == torch.float32
    assert qp["int8"]["down2_conv"]["w8"].shape == (384, 2, 2, 192)
    assert qp["int8"]["stage2_block0/pwconv1"]["w8"].shape == (1536, 1, 1, 384)
    assert qp["int8"]["down2_conv"]["deq"].shape == (384,)
    flt = qp["float"]
    assert "stage3_block0.pwconv1.weight" not in flt and "down2_conv.weight" not in flt
    assert flt["stage0_block0.pwconv1.weight"].dtype == torch.bfloat16
    assert flt["down1_conv.weight"].dtype == torch.bfloat16
    assert flt["stage0_block0.norm.weight"].dtype == torch.float32
    assert flt["stage0_block0.gamma"].dtype == torch.float32
    with pytest.raises(ValueError, match="one entry per quantized site"):
        qc.quantize_convnext(m, v, [], act_scales=scales[:-1], device="cpu")
    bad = scales.copy()
    bad[3] = 0.0
    with pytest.raises(ValueError, match="zero scale"):
        qc.quantize_convnext(m, v, [], act_scales=bad, device="cpu")
    with pytest.raises(ValueError, match="at least one batch"):
        qc.quantize_convnext(m, v, [], device="cpu")
    base = YOGO.create(HW, 0.08, 0.1, NUM_CLASSES, model_version="base_model")
    with pytest.raises(NotImplementedError, match="convnext family only"):
        qc.quantize_convnext(base, {"params": {}}, [], device="cpu")
    with pytest.raises(NotImplementedError, match="quant_convnext"):
        tq.fold_conv_stack(m.defn, v)


def test_family_dispatch_and_the_predictor(setup):
    """family_quant_plan routes convnext to this program (71 scales, never
    all skipped), and Predictor's int8 forwards run it."""
    jm, v, m, net, x, jqp = setup
    build_qp, fwd, n_scales, all_skip = tq.family_quant_plan(m, net, device="cpu")
    assert fwd is qc.quantized_convnext_forward is tq.family_quant_forward(m)
    assert n_scales == 71 and all_skip is False and needs_calibration(m)
    qp = build_qp([], act_scales=np.asarray(jqp["scales"]))
    with pytest.raises(ValueError, match="calibrate"):
        quantize_stack(m, net, [])
    pred = Predictor(m, net, qp=qp)
    raw = pred.forward_raw(x)
    assert torch.equal(raw, qc.quantized_convnext_forward(m, qp, torch.from_numpy(x), decode=False))
    assert torch.equal(pred.forward(x), qc.quantized_convnext_forward(m, qp, torch.from_numpy(x)))


# ------------------------------------------------------------ entry points
@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """`train --model convnext_small` for one epoch at 64x96 through the
    CLI, in its own directory."""
    import os

    from yogo_tpu_torch.__main__ import main

    root = tmp_path_factory.mktemp("convnext_cli")
    pairs = [make_pair_dirs(root, "tr", n_images=6, seed=1)]
    tpairs = [make_pair_dirs(root, "te", n_images=3, seed=5)]
    defn = write_defn(root / "d.yml", dataset_pairs=pairs, test_pairs=tpairs,
                      split={"train": 0.75, "val": 0.25})
    cwd = os.getcwd()
    os.chdir(root)
    try:
        main(["train", str(defn), "--device", "cpu", "--batch-size", "4", "--image-hw", *map(str, HW),
              "--model", "convnext_small", "--epochs", "1", "--no-wandb", "--name", "cnx"])
    finally:
        os.chdir(cwd)
    return root, defn, root / "trained_models" / "cnx"


def test_cli_train_test_and_int8_infer(trained_run, capsys, monkeypatch):
    from PIL import Image

    from yogo_tpu_torch.__main__ import main
    from yogo_tpu_torch.infer import predict

    root, defn, run = trained_run
    monkeypatch.chdir(root)
    model, v, meta = tckpt.load_checkpoint(run / "best.ckpt")
    assert model.model_version == "convnext_small" and meta["classes"] == CLASSES
    assert v["batch_stats"] == {} and "stage2_block26" in v["params"]
    lines = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(ln["train loss"]) for ln in lines if "train loss" in ln)
    capsys.readouterr()
    for extra in ([], ["--quantize"]):
        main(["test", str(run / "best.ckpt"), str(defn), "--device", "cpu", *extra])
        out = capsys.readouterr().out
        assert "test loss:" in out and "nan" not in out.split("test loss:")[1].split()[0], extra
    img_dir = root / "imgs"
    img_dir.mkdir()
    for i in range(2):
        Image.fromarray(images(20 + i, n=1)[0, 0]).save(img_dir / f"{i}.png")
    main(["infer", str(run / "best.ckpt"), "--path-to-images", str(img_dir), "--count", "--quantize",
          "--device", "cpu", "--batch-size", "2"])
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    preds = predict(run / "best.ckpt", path_to_images=img_dir, quantize=True, batch_size=2,
                    return_full_predictions=True, device="cpu")
    from yogo_tpu_torch.infer import get_prediction_class_counts

    counts = get_prediction_class_counts(preds)
    assert printed == str([(c, int(n)) for c, n in zip(CLASSES, counts)])


def test_serve_answers_equal_the_formatter(trained_run):
    """`serve` on the trained ConvNeXt at micro-batch 2: an answer equals
    the host formatter over Predictor.forward of a batch of the server's
    shape."""
    from yogo_tpu_torch.serve import build_server, format_detections

    _, _, run = trained_run
    srv = build_server(run / "best.ckpt", port=0, device="cpu", batch_size=2, linger_ms=1.0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        pred = srv.yogo_state["predictor"]
        assert isinstance(pred.stack, ConvNeXtSmall)
        frame = images(30, n=1)[0]
        req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/predict",
                                     data=frame.tobytes(), method="POST",
                                     headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = json.loads(r.read())
        batch = np.zeros((2, *frame.shape), np.uint8)
        batch[0] = frame
        want = format_detections(pred.forward(batch).numpy()[0], CLASSES, obj_thresh=0.5,
                                 iou_thresh=0.5, min_class_confidence_threshold=0.0)
        assert got == want
    finally:
        srv.shutdown()
        srv.yogo_batcher.shutdown()
        srv.server_close()
        t.join(timeout=10)


def test_quantized_serve_answers_equal_its_int8_predictor_and_reloads(trained_run, tmp_path):
    """`serve --quantize --calibration-images` on the trained ConvNeXt at
    micro-batch 2, calibrated on the directory's 3 frames: an answer equals
    the host formatter over the server's int8 Predictor.forward of a batch
    of the server's shape; a reload recalibrates (a new program, the same
    answers)."""
    from PIL import Image

    from yogo_tpu_torch.serve import build_server, format_detections

    _, _, run = trained_run
    frames = images(40, n=3)
    (tmp_path / "calib").mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f[0]).save(tmp_path / "calib" / f"{i}.png")
    with pytest.raises(ValueError, match="calibration-images"):
        build_server(run / "best.ckpt", port=0, device="cpu", quantize=True)
    srv = build_server(run / "best.ckpt", port=0, device="cpu", batch_size=2, linger_ms=1.0, quantize=True,
                       calibration_images=tmp_path / "calib")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        pred = srv.yogo_state["predictor"]
        assert len(pred.qp["int8"]) == 71
        qp = quantize_stack(pred.model, pred.stack, [frames])
        np.testing.assert_array_equal(pred.qp["scales"].numpy(), qp["scales"].numpy())

        def answer(frame):
            req = urllib.request.Request(f"http://127.0.0.1:{srv.server_address[1]}/predict",
                                         data=frame.tobytes(), method="POST",
                                         headers={"Content-Type": "application/octet-stream"})
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        batch = np.zeros((2, *frames[0].shape), np.uint8)
        batch[0] = frames[0]
        want = format_detections(pred.forward(batch).numpy()[0], CLASSES, obj_thresh=0.5,
                                 iou_thresh=0.5, min_class_confidence_threshold=0.0)
        assert answer(frames[0]) == want
        assert srv.reload_checkpoint()["ok"] is True
        assert srv.yogo_state["predictor"] is not pred and srv.yogo_state["predictor"].qp is not pred.qp
        assert answer(frames[0]) == want
    finally:
        srv.shutdown()
        srv.yogo_batcher.shutdown()
        srv.server_close()
        t.join(timeout=10)


def test_trainer_checkpoint_crosses_to_the_jax_package(trained_run, tmp_path):
    """The port Trainer's best.ckpt of the ConvNeXt run: the JAX package
    loads it and restores its AdamW state; written back by the JAX package
    from what it read, the file is byte-equal; the port restores the
    optimizer state of that file."""
    from yogo_tpu.train import make_optimizer as jax_make_optimizer
    from yogo_tpu.utils import checkpoint as jckpt
    from yogo_tpu_torch.train import make_optimizer

    _, _, run = trained_run
    path = run / "best.ckpt"
    jm, jv, meta = jckpt.load_checkpoint(path)
    assert jm.model_version == "convnext_small" and jv["batch_stats"] == {}
    tx, _ = jax_make_optimizer(3e-4, 5e-2, 10.0, 100)
    opt_state = jckpt.restore_opt_state(meta, tx.init(jv["params"]))
    assert int(opt_state[1][0].count) == meta["step"] > 0
    extra = {k: v for k, v in meta.items() if k not in (
        "format", "epoch", "step", "normalize_images", "classes", "model_name", "model_version",
        "model_config", "_opt_state_bytes")}
    jckpt.save_checkpoint(tmp_path / "j.ckpt", jm, jv, opt_state=opt_state, epoch=meta["epoch"],
                          step=meta["step"], classes=meta["classes"], model_name=meta["model_name"], **extra)
    assert (tmp_path / "j.ckpt").read_bytes() == path.read_bytes()
    model, v, tmeta = tckpt.load_checkpoint(tmp_path / "j.ckpt")
    net = model.module("cpu")
    net.load_state_dict(state_dict_from_flax(v), strict=True)
    optimizer, scheduler, _ = make_optimizer(net.parameters(), 3e-4, 5e-2, 10.0, 100)
    assert tckpt.restore_opt_state(tmeta, net, optimizer, scheduler)
    assert scheduler.last_epoch == meta["step"]
    st = optimizer.state[net.stage2_block26.gamma]
    np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                  np.asarray(opt_state[1][0].mu["stage2_block26"]["gamma"]))
