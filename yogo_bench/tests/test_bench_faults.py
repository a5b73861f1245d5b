"""A run whose timed path is broken underneath reads `correct` false:
the harness drives the rest of a run (on the CPU, past its look for a
card) at a small size, float32 so that a sound run reads near zero, with
each fault a cell can have planted in the program. The controls (the
precision below the configuration's) fail too, at the cell's limits."""

import time

import pytest
import torch

from yogo_bench import manifest, reference, run
from yogo_bench.tests import small

import yogo_tpu_torch.infer as port_infer
from yogo_tpu_torch.train import ClampedAdamW

MAN = manifest.load()


def _run(workload, f32=True, seconds=1.0, **extra):
    rs = small.resize(workload)
    if f32:
        rs["config"] = {**rs["config"], "compute_dtype": "float32"}
    rs["config"].update(extra)
    return run.run_cell(MAN, workload, small.SEED, seconds, False, "cpu", start=time.perf_counter(), resize=rs)


@pytest.mark.parametrize("workload", ["base_model.count", "convnext_small.count", "base_model.train"])
def test_a_sound_run_is_correct(workload):
    r = _run(workload)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("workload", ["base_model.count", "convnext_small.count"])
def test_an_altered_count_is_caught(workload, monkeypatch):
    count = port_infer.Predictor.count
    monkeypatch.setattr(port_infer.Predictor, "count", lambda self, raw, mask=None: count(self, raw, mask) + 1)
    r = _run(workload)
    assert not r["correct"] and r["checks"]["count_gap"][0] > 0


@pytest.mark.parametrize("workload", ["base_model.count", "convnext_small.count"])
def test_half_the_batch_left_out_is_caught(workload, monkeypatch):
    fwd = port_infer.Predictor.forward_raw

    def half(self, imgs):
        raw = fwd(self, imgs)
        n = raw.shape[0] // 2
        return torch.cat([raw[:n], raw[:n].mean(0, keepdim=True).expand(raw.shape[0] - n, *raw.shape[1:])])

    monkeypatch.setattr(port_infer.Predictor, "forward_raw", half)
    r = _run(workload)
    assert not r["correct"] and r["checks"]["head_rel_rms"][0] > r["checks"]["head_rel_rms"][1]


def test_a_step_that_leaves_the_state_unchanged_is_caught(monkeypatch):
    monkeypatch.setattr(ClampedAdamW, "step", lambda self, closure=None: None)
    r = _run("base_model.train")
    assert not r["correct"] and r["checks"]["change_gap"][0] > 0.99


def test_a_step_that_goes_wrong_only_in_the_window_is_caught(monkeypatch):
    """Sound steps in set-up, then steps that leave the state unchanged
    once the window runs (as a step captured or compiled after set-up's
    steps could): the window's own steps are compared."""
    import yogo_bench.drivers.train as drv

    window = drv.Session.window

    def broken(self, *a, **k):
        monkeypatch.setattr(self.state.optimizer, "step", lambda closure=None: None)
        return window(self, *a, **k)

    monkeypatch.setattr(drv.Session, "window", broken)
    r = _run("base_model.train")
    checks = r["checks"]
    assert not r["correct"] and checks["change_gap"][0] <= checks["change_gap"][1], checks
    assert checks["win_change_gap"][0] > 0.99, checks


def test_a_step_over_half_the_batch_is_caught(monkeypatch):
    import yogo_bench.drivers.train as drv

    make = drv.make_train_step

    def halved(*a, **k):
        step = make(*a, **k)

        def run_half(state, imgs, labels, mask, gen=None):
            n = imgs.shape[0] // 2
            return step(state, imgs[:n], labels[:n], mask[:n], gen)
        return run_half

    monkeypatch.setattr(drv, "make_train_step", halved)
    r = _run("base_model.train")
    assert not r["correct"] and r["checks"]["loss_gap"][0] > r["checks"]["loss_gap"][1]


@pytest.mark.parametrize("config", ["base_model", "convnext_small"])
def test_the_fp8_control_of_the_count_fails(config):
    """The reference computed in float8 in the program's place reads above
    the cell's limit (the int8 program's reading beside it, for the
    record); base_model at its own size and weights (at 96x128 its
    half-width stand-in reads under the limit), ConvNeXt at 96x128."""
    from yogo_bench import controls

    cfg = manifest.config(MAN, config)
    if config == "convnext_small":
        cfg["img_size"] = [96, 128]
    mix = {**manifest.traffic("count"), "batch": 2, "blobs": [2, 5]}
    rows = {r["control"]: r["head_rel_rms"] for r in controls.count_control(cfg, mix, small.SEED, "cpu")}
    assert rows["reference in fp8"] > manifest.limits(f"{config}.count")["checks"]["head_rel_rms"], rows


def test_the_fp8_control_of_training_fails():
    from yogo_bench.drivers.train import Session, compare

    cfg = {**manifest.config(MAN, "base_model"), "img_size": [96, 128]}
    mix = {**manifest.traffic("train"), "batch": 4, "pool": 12, "blobs": [2, 5], "check_within": 4}
    sess = Session(cfg, mix, small.SEED, "cpu", {})
    sess.window(0.0, False, time.perf_counter)
    sess.release()
    first = compare(sess.reference_steps(cast=reference.fp8), sess.reference_steps(), sess.theta0)
    win = compare(sess.reference_window(cast=reference.fp8), sess.reference_window(), sess.win["theta"])
    gaps = {**first, **{f"win_{k}": v for k, v in win.items()}}
    limits = manifest.limits("base_model.train")["checks"]
    assert any(gaps[k] > limits[k] for k in limits), gaps
