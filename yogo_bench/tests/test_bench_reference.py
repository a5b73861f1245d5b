"""The plain reference agrees with the port on the CPU at small sizes,
in float32: the forwards, the count, the loss and the first steps of
training. (The port is checked against the JAX package by tests/; here
the yardstick is checked against the port.)"""

import time

import numpy as np
import pytest
import torch

from yogo_bench import ckpt, manifest, reference, scene, weights
from yogo_bench.families import convnext
from yogo_bench.tests import small

from yogo_tpu_torch.losses import yogo_loss
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.ops.postprocess import count_class_predictions_raw

MAN = manifest.load()


def port_model(cfg, dtype=torch.float32):
    return YOGO.create(tuple(cfg["img_size"]), cfg["anchor_w"], cfg["anchor_h"], cfg["num_classes"],
                       model_version=cfg["architecture"], compute_dtype=dtype)


def test_conv_stack_forward_matches_the_port():
    cfg = {**manifest.config(MAN, "base_model"), **small.base_model()}
    _, variables = ckpt.read(cfg["checkpoint"])
    w = {k: torch.from_numpy(v) for k, v in ckpt.torch_weights(variables).items()}
    model = port_model(cfg)
    stack = model.module("cpu")
    stack.load_state_dict({**w, **{f"bn{i}.num_batches_tracked": torch.tensor(0) for i in (0, 4, 5)}})
    frames, _ = scene.pool(3, range(3), hw=cfg["img_size"], blobs=(2, 5))
    ref = reference.head(w, frames, cfg)
    out = model.apply(stack, torch.from_numpy(frames), decode=False)
    assert ref.shape == out.shape
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_convnext_forward_matches_the_port():
    cfg = {**manifest.config(MAN, "convnext_small"), "img_size": [96, 128]}
    w = weights.production_density(weights.make(convnext.spec(cfg), 0, "cpu"), cfg)
    model = port_model(cfg)
    stack = model.module("cpu")
    stack.load_state_dict(w)
    frames, _ = scene.pool(4, range(2), hw=cfg["img_size"], blobs=(2, 5))
    ref = reference.head(w, frames, cfg)
    out = model.apply(stack, torch.from_numpy(frames), decode=False)
    assert ref.shape == out.shape == (2, *reference.grid(cfg)[::-1], 7)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_count_matches_the_port_on_the_same_head(seed):
    cfg = {**manifest.config(MAN, "base_model"), "img_size": [96, 128]}
    sx, sy = reference.grid(cfg)
    g = torch.Generator().manual_seed(seed)
    raw = torch.randn((3, sy, sx, 7), generator=g) * 2
    raw[..., 4] -= 4.0  # a few percent of the cells pass 0.5
    raw = raw.to(torch.bfloat16)  # ties in objectness, as a bf16 head has
    port = count_class_predictions_raw(raw, cfg["anchor_w"], cfg["anchor_h"], max_detections=256,
                                       image_mask=torch.tensor([True, False, True]))
    ref = reference.counts(raw, cfg, image_mask=[True, False, True], max_detections=256)
    assert ref.sum() > 0
    np.testing.assert_array_equal(port.numpy(), ref)


def test_loss_matches_the_port():
    cfg = {**manifest.config(MAN, "base_model"), "img_size": [96, 128]}
    job = manifest.traffic("train")
    sx, sy = reference.grid(cfg)
    frames, labels = scene.pool(5, range(3), hw=cfg["img_size"], blobs=(2, 5))
    grids = torch.from_numpy(np.stack([scene.label_grid(lb, sx, sy) for lb in labels]))
    raw = torch.randn((3, sy, sx, 7), generator=torch.Generator().manual_seed(0), requires_grad=True)
    model = port_model(cfg)
    decoded = model._decode_raw(raw, inference=False)
    port, _ = yogo_loss(decoded, grids, **{k: job[k] for k in ("no_obj_weight", "iou_weight",
                                                              "classify_weight", "label_smoothing")})
    ref = reference.loss(raw, grids, cfg, job)
    torch.testing.assert_close(ref, port, rtol=1e-5, atol=1e-6)
    gp, = torch.autograd.grad(port, raw)
    gr, = torch.autograd.grad(ref, raw)
    torch.testing.assert_close(gr, gp, rtol=1e-4, atol=1e-7)


def test_first_training_steps_match_the_port_in_float32():
    from yogo_bench.drivers.train import Session

    cfg = {**manifest.config(MAN, "base_model"), "img_size": [96, 128], "compute_dtype": "float32"}
    mix = {**manifest.traffic("train"), "batch": 4, "pool": 12, "blobs": [2, 5], "check_within": 4}
    sess = Session(cfg, mix, small.SEED, "cpu", {})
    sess.window(0.0, False, time.perf_counter)
    sess.release()
    gaps = sess.check()
    for pre in ("", "win_"):
        assert gaps[pre + "loss_gap"] < 1e-4 and gaps[pre + "grad_gap"] < 1e-3 and gaps[pre + "change_gap"] < 5e-3, gaps
