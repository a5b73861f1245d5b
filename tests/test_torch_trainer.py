"""The port's Trainer on the CPU: the behaviours tests/test_train.py pins
for the JAX Trainer (end to end, accumulation, fine-tune wiring, buffered
logs, resume, SIGTERM, checkpoint cadence), the whole slice against the JAX
Trainer on one fixture, and checkpoints crossing between the packages.
Tolerances are stated at each comparison."""

import json
import os
import signal
import warnings
from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import yogo_tpu.train as jtrain
import yogo_tpu_torch.train as ttrain
from tests.data_fixtures import CLASSES, make_pair_dirs, write_defn
from tests.test_torch_train import nodrop_models
from yogo_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from yogo_tpu_torch.models.yogo import YOGO
from yogo_tpu_torch.train import Trainer, step_seed
from yogo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from yogo_tpu_torch.utils.logging import RunLogger
from yogo_tpu_torch.utils.msgpack_lite import unpackb
from yogo_tpu_torch.utils.weights import (
    flax_from_state_dict,
    optax_state_from_torch,
    state_dict_from_flax,
)


def base_config(tmp_path, pairs=None, **over):
    """The configuration of tests/test_train.py::_resume_base_config."""
    if pairs is None:
        pairs = [make_pair_dirs(tmp_path, str(i), n_images=6, seed=i) for i in range(2)]
    defn = write_defn(tmp_path / "d.yml", dataset_pairs=pairs, split={"train": 0.75, "val": 0.25})
    cfg = {
        "learning_rate": 1e-3, "decay_factor": 10.0, "weight_decay": 5e-2,
        "label_smoothing": 0.01, "iou_weight": 5.0, "no_obj_weight": 0.5,
        "classify_weight": 1.0, "epochs": 4, "batch_size": 4,
        "anchor_w": 0.1, "anchor_h": 0.15, "model": "quarter_filters",
        "half": False, "rgb": False, "image_hw": (40, 56),
        "pretrained_path": None, "normalize_images": False,
        "dataset_split_override": None,
        "dataset_descriptor_file": str(defn),
        "name": "resume", "note": None, "tags": None,
        "wandb_entity": None, "wandb_project": None, "use_wandb": False,
        "model_save_dir": str(tmp_path / "run_full"),
    }
    cfg.update(over)
    return cfg


def cpu_trainer(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "no test dataset found" on test-less fixtures
        t = Trainer(cfg, device="cpu")
        t.init()
    return t


def records(run_dir):
    return [json.loads(ln) for ln in (Path(run_dir) / "metrics.jsonl").read_text().splitlines()]


def tiny_checkpoint(path, hw=(48, 64), with_opt=False, **meta):
    model = YOGO.create(hw, 0.08, 0.1, len(CLASSES), model_version="quarter_filters")
    stack = model.init(torch.Generator().manual_seed(0), device="cpu")
    opt_state = None
    if with_opt:
        optimizer, scheduler, _ = ttrain.make_optimizer(stack.parameters(), 1e-3, 5e-2, 10.0, 50)
        state = ttrain.TrainState(stack, optimizer, scheduler)
        step = ttrain.make_train_step(model, dict(no_obj_weight=0.5, iou_weight=5.0,
                                                  classify_weight=1.0, label_smoothing=0.01))
        sx, sy = model.grid
        labels = torch.zeros(2, 6, sy, sx)
        labels[:, :, 1, 1] = torch.tensor([1, 0.2, 0.2, 0.4, 0.4, 1])
        step(state, torch.randint(0, 255, (2, 1, *hw), dtype=torch.uint8), labels, torch.ones(2),
             torch.Generator().manual_seed(0))
        opt_state = optax_state_from_torch(stack, optimizer, scheduler)
    save_checkpoint(path, model, flax_from_state_dict(stack.state_dict()), opt_state=opt_state,
                    classes=CLASSES, **meta)
    return model, stack


# ---------------------------------------------------------------- end to end
def test_trainer_end_to_end_tiny(tmp_path):
    """2-epoch run on generated data: one record a step, checkpoints
    written, test metrics produced, config.json names torch and the
    device."""
    pairs = [make_pair_dirs(tmp_path, str(i), n_images=6, seed=i) for i in range(2)]
    test_pair = [make_pair_dirs(tmp_path, "t", n_images=4, seed=9)]
    defn = write_defn(tmp_path / "e.yml", dataset_pairs=pairs, test_pairs=test_pair,
                      split={"train": 0.75, "val": 0.25})
    cfg = base_config(tmp_path, pairs=pairs, epochs=2, dataset_descriptor_file=str(defn),
                      model_save_dir=str(tmp_path / "run"), name="tiny")
    trainer = cpu_trainer(cfg)
    result = trainer.train()
    run = tmp_path / "run"
    assert sorted(p.name for p in run.iterdir()) == ["best.ckpt", "config.json", "latest.ckpt",
                                                     "metrics.jsonl", "validation_bbs.png"]
    # the last validation batch's first image with its boxes, as JAX draws it
    from PIL import Image

    with Image.open(run / "validation_bbs.png") as im:
        assert im.mode == "RGBA" and im.size == tuple(cfg["image_hw"][::-1])
    lines = records(run)
    steps = [ln["step"] for ln in lines if "train loss" in ln]
    assert steps == list(range(1, 2 * len(trainer.train_dataloader) + 1))
    assert sum("val loss" in ln for ln in lines) == 1  # epoch 0 validates, epoch 1 does not
    assert [ln["_summary"]["eval engine"] for ln in lines if "_summary" in ln] == ["device-fast-eval"]
    mean_loss, mAP, confusion, *_ = result
    assert np.isfinite(mean_loss) and confusion.shape[0] >= len(CLASSES)
    config = json.loads((run / "config.json").read_text())
    assert config["device"] == "cpu" and "jax-version" not in config
    # fine-tune from best.ckpt: the global step is restored
    t2 = cpu_trainer(dict(cfg, pretrained_path=str(run / "best.ckpt"), epochs=1,
                          model_save_dir=str(tmp_path / "run2")))
    assert t2.state.step > 0 and t2.tuning is True


def test_do_training_records_the_torch_version_and_runs_the_host_engine(tmp_path):
    from yogo_tpu_torch.utils.argparsers import train_parser

    pairs = [make_pair_dirs(tmp_path, "a", n_images=8, seed=0)]
    defn = write_defn(tmp_path / "d.yml", dataset_pairs=pairs,
                      split={"train": 0.5, "val": 0.25, "test": 0.25})
    args = train_parser().parse_args(
        [str(defn), "--device", "cpu", "--epochs", "1", "--batch-size", "4", "--image-hw", "40", "56",
         "--model", "quarter_filters", "--no-wandb", "--no-fast-eval", "--name", "do"])
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        result = ttrain.do_training(args)
    finally:
        os.chdir(cwd)
    run = tmp_path / "trained_models" / "do"
    config = json.loads((run / "config.json").read_text())
    assert config["torch-version"] == torch.__version__ and config["device"] == "cpu"
    assert result is not None and np.isfinite(result[0])
    assert [ln["_summary"]["eval engine"] for ln in records(run) if "_summary" in ln] == ["host-hungarian"]


def test_trainer_end_to_end_accumulate(tmp_path):
    """3 train batches at accumulate=2 -> 2 optimizer steps an epoch (the
    short final group pads with a zero-weight micro-batch); validation
    keeps plain batches."""
    pairs = [make_pair_dirs(tmp_path, "a", n_images=8, seed=0)]
    cfg = base_config(tmp_path, pairs=pairs, epochs=1, batch_size=2, accumulate_grad_batches=2,
                      model_save_dir=str(tmp_path / "run"))
    trainer = cpu_trainer(cfg)
    trainer.train()
    assert trainer.global_step == 2 and trainer.state.scheduler.last_epoch == 2
    lines = records(tmp_path / "run")
    assert any("val loss" in ln for ln in lines) and any("train loss" in ln for ln in lines)


def test_unported_options_raise_and_the_default_device_is_the_card(tmp_path):
    cfg = base_config(tmp_path)
    # --spatial-parallel runs: two row shards on the CPU, one optimizer
    # step of the split, and a height that does not divide is refused
    t = cpu_trainer(dict(cfg, spatial_parallel=2, epochs=1, model_save_dir=str(tmp_path / "sp")))
    assert t.devices == [torch.device("cpu")] * 2 and t.rows is not None
    t.train()
    assert t.global_step == len(t.train_dataloader) > 0 and (tmp_path / "sp" / "latest.ckpt").exists()
    with pytest.raises(ValueError, match="divisible"):
        Trainer(dict(cfg, spatial_parallel=3), device="cpu")
    # --fsdp runs; in one process there is nothing to shard
    t = cpu_trainer(dict(cfg, fsdp=True))
    assert t._fsdp is False and t.world == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(dict(cfg))
    # test --quantize runs: quarter_filters has no block wide enough for
    # int8, so its program is the folded bf16 stack, said so, and scored
    m = YOGO.create((40, 56), 0.1, 0.1, 3, model_version="quarter_filters")
    sx, sy = m.grid
    batch = (np.zeros((1, 1, 40, 56), np.uint8), np.zeros((1, 6, sy, sx), np.float32),
             np.ones(1, np.float32))
    with pytest.warns(UserWarning, match="every block is skipped"):
        out = Trainer.test([batch], dict(class_names=CLASSES, iou_weight=1, no_obj_weight=0.5,
                                         label_smoothing=0.0, half=False),
                           m, m.module("cpu"), quantize=True)
    assert np.isfinite(out[0])
    with pytest.raises(ValueError, match="is required in config"):
        Trainer.test([], {"class_names": CLASSES}, None, None)
    with pytest.raises(RuntimeError, match="not initialized"):
        Trainer(dict(cfg), device="cpu").train()


def test_one_process_that_sees_several_cards_says_which_one_it_trains_on(tmp_path, monkeypatch,
                                                                          capsys):
    """The port trains one process a card: a process that sees several
    prints one line naming its card and torchrun (the JAX package's
    Trainer would mesh them all); one card, or the CPU, prints nothing."""
    cfg = base_config(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ttrain, "local_device", lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(ttrain, "device_name", lambda device: "a card")
    for n in (1, 3):
        monkeypatch.setattr(torch.cuda, "device_count", lambda n=n: n)
        t = Trainer(dict(cfg))
        assert t.device == torch.device("cuda", 0)
        lines = capsys.readouterr().out.strip().splitlines()
        if n == 1:
            assert lines == []
        else:
            assert len(lines) == 1 and "cuda:0" in lines[0] and "torchrun --nproc-per-node 3" in lines[0]
    monkeypatch.setattr(ttrain, "local_device", lambda device=None: torch.device("cpu"))
    Trainer(dict(cfg), device="cpu")
    assert capsys.readouterr().out == ""


def test_trainer_rejects_mismatched_pretrained_size(tmp_path):
    tiny_checkpoint(tmp_path / "ck.ckpt")
    cfg = base_config(tmp_path, pretrained_path=str(tmp_path / "ck.ckpt"), model=None,
                      image_hw=(40, 56))  # != (48, 64) in the checkpoint
    with pytest.raises(RuntimeError, match="mismatch in pretrained"):
        Trainer(cfg, device="cpu").init()


def test_trainer_sets_tuning_from_pretrained_and_load_any_loads_pth(tmp_path):
    tiny_checkpoint(tmp_path / "ck.ckpt", step=10)
    cfg = base_config(tmp_path, image_hw=(48, 64), anchor_w=0.08, anchor_h=0.1)
    t = cpu_trainer(dict(cfg, pretrained_path=str(tmp_path / "ck.ckpt"),
                         model_save_dir=str(tmp_path / "r1")))
    assert t.tuning is True and t.global_step == 10 and t._lr_step_offset == 10
    assert t.state.scheduler.last_epoch == 0  # this run's own clock
    t2 = cpu_trainer(dict(cfg, model_save_dir=str(tmp_path / "r2")))
    assert t2.tuning is False
    # a reference .pth fine-tunes like the .ckpt it was written from (by
    # suffix, or sniffed by its zip magic); a broken one is refused
    from yogo_tpu_torch.utils.checkpoint import load_checkpoint
    from yogo_tpu_torch.utils.torch_bridge import save_pth

    model, variables, _ = load_checkpoint(tmp_path / "ck.ckpt")
    save_pth(tmp_path / "ref.pth", model, variables, classes=CLASSES, step=10)
    (tmp_path / "sniffed").write_bytes((tmp_path / "ref.pth").read_bytes())
    for name in ("ref.pth", "sniffed"):
        t3 = cpu_trainer(dict(cfg, pretrained_path=str(tmp_path / name),
                              model_save_dir=str(tmp_path / f"r_{name}")))
        assert t3.tuning is True and t3.global_step == 10
        for k, v in t.state.stack.state_dict().items():
            assert torch.equal(t3.state.stack.state_dict()[k], v), k
    (tmp_path / "broken.pth").write_bytes(b"PK\x03\x04rest")
    with pytest.raises(RuntimeError):
        cpu_trainer(dict(cfg, pretrained_path=str(tmp_path / "broken.pth")))


def test_flush_train_logs_buffers_and_emits_per_step(tmp_path):
    """Losses are buffered as tensors and fetched once a commit window; the
    logger still receives one correct record a step."""
    t = Trainer.__new__(Trainer)
    t.logger = RunLogger(log_dir=tmp_path, use_wandb=False)
    t.lr_schedule = lambda step: 0.1 * step
    pending = [
        (i, torch.tensor(float(i)), {"iou_loss": torch.tensor(10.0 * i),
                                     "objectness_loss": torch.tensor(1.0),
                                     "classification_loss": torch.tensor(2.0)})
        for i in range(1, 4)
    ]
    t._flush_train_logs(pending, epoch=0, window_imgs=12, window_start=0.0)
    assert pending == []
    t.logger.finish()
    committed = [ln for ln in records(tmp_path) if "train loss" in ln]
    assert [(ln["step"], ln["train loss"], ln["iou_loss"]) for ln in committed] == [
        (1, 1.0, 10.0), (2, 2.0, 20.0), (3, 3.0, 30.0)]
    assert np.isclose(committed[-1]["LR"], 0.3) and committed[-1]["images/sec"] > 0
    assert committed[0]["classification_loss"] == 2.0


def test_trainer_resume_optimizer_wiring(tmp_path):
    """--resume-optimizer restores the saved AdamW moments and both counts;
    without the flag AdamW starts fresh; a checkpoint without optimizer
    state warns and the LR log runs on this run's clock."""
    _, stack = tiny_checkpoint(tmp_path / "ck.ckpt", with_opt=True, step=1)
    tiny_checkpoint(tmp_path / "noopt.ckpt", step=1)
    _, _, meta = load_checkpoint(tmp_path / "ck.ckpt")
    saved = unpackb(meta["_opt_state_bytes"])
    cfg = base_config(tmp_path, image_hw=(48, 64), anchor_w=0.08, anchor_h=0.1,
                      pretrained_path=str(tmp_path / "ck.ckpt"))
    t = cpu_trainer(dict(cfg, resume_optimizer=True, model_save_dir=str(tmp_path / "r1")))
    got = optax_state_from_torch(t.state.stack, t.state.optimizer, t.state.scheduler)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(saved)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert t._lr_step_offset == 0 and t.state.scheduler.last_epoch == 1
    t2 = cpu_trainer(dict(cfg, model_save_dir=str(tmp_path / "r2")))
    assert len(t2.state.optimizer.state) == 0 and t2._lr_step_offset == 1
    with pytest.warns(UserWarning, match="no saved optimizer state"):
        t3 = Trainer(dict(cfg, resume_optimizer=True, pretrained_path=str(tmp_path / "noopt.ckpt"),
                          model_save_dir=str(tmp_path / "r3")), device="cpu")
        t3.init()
    assert t3._lr_step_offset == t3.global_step == 1


# ------------------------------------------------------- preemption / resume
def test_resume_requires_pretrained(tmp_path):
    with pytest.raises(ValueError, match="--resume .* --from-pretrained"):
        Trainer(base_config(tmp_path, resume=True), device="cpu").init()


def test_resume_without_name_continues_in_place(tmp_path):
    base = base_config(tmp_path)
    cpu_trainer(dict(base, epochs=1)).train()
    run_dir = Path(base["model_save_dir"])
    latest = run_dir / "latest.ckpt"
    assert latest.exists()
    tR = cpu_trainer(dict(base, epochs=2, pretrained_path=str(latest), resume=True,
                          model_save_dir=None, name=None))
    assert Path(tR.model_save_dir).resolve() == run_dir.resolve()
    tE = cpu_trainer(dict(base, epochs=2, pretrained_path=str(latest), resume=True,
                          model_save_dir=str(tmp_path / "elsewhere")))
    assert Path(tE.model_save_dir).resolve() == (tmp_path / "elsewhere").resolve()


def test_resume_exact_continuation(tmp_path):
    """An epoch-boundary stop + --resume replays the uninterrupted run bit
    for bit on the CPU (dropout and flips on): parameters, BN statistics,
    AdamW moments and counts, the watermark and the epoch counter."""
    base = base_config(tmp_path)
    cpu_trainer(dict(base)).train()
    bytes_a = (Path(base["model_save_dir"]) / "latest.ckpt").read_bytes()
    _, vars_a, meta_a = load_checkpoint(Path(base["model_save_dir"]) / "latest.ckpt")
    assert meta_a["next_epoch"] == 4

    cfg_b = dict(base, model_save_dir=str(tmp_path / "run_int"))
    tB = cpu_trainer(cfg_b)
    orig_ckpt = tB.checkpoint

    def ckpt_hook(path, model_name, **kw):
        orig_ckpt(path, model_name, **kw)
        if Path(path).name == "latest.ckpt" and tB.epoch == 1:
            tB._stop_requested = True

    tB.checkpoint = ckpt_hook
    assert tB.train() is None  # interrupted: no test pass
    int_latest = Path(cfg_b["model_save_dir"]) / "latest.ckpt"
    _, _, meta_b = load_checkpoint(int_latest)
    assert meta_b["next_epoch"] == 2 and meta_b["min_val_loss"] is not None

    cfg_r = dict(base, model_save_dir=str(tmp_path / "run_resumed"),
                 pretrained_path=str(int_latest), resume=True)
    tR = cpu_trainer(cfg_r)
    assert tR._start_epoch == 2 and tR.tuning is False
    assert tR.min_val_loss == pytest.approx(meta_b["min_val_loss"])
    tR.train()
    _, vars_r, meta_r = load_checkpoint(Path(cfg_r["model_save_dir"]) / "latest.ckpt")
    assert meta_r["next_epoch"] == 4 and meta_r["step"] == meta_a["step"]
    for a, r in zip(jax.tree.leaves(vars_a), jax.tree.leaves(vars_r)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r))
    for a, r in zip(jax.tree.leaves(unpackb(meta_a["_opt_state_bytes"])),
                    jax.tree.leaves(unpackb(meta_r["_opt_state_bytes"]))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r))
    # only the run's name in the meta may differ between the two files
    assert len(bytes_a) == len((Path(cfg_r["model_save_dir"]) / "latest.ckpt").read_bytes())


def test_step_seed_depends_on_seed_and_step_only():
    assert step_seed(0, 5) == step_seed(0, 5) != step_seed(0, 6)
    assert step_seed(1, 5) != step_seed(0, 5)
    assert 0 <= step_seed(3, 10**6) < 2**63
    torch.Generator().manual_seed(step_seed(3, 10**6))


def test_sigterm_mid_epoch_checkpoint(tmp_path):
    base = base_config(tmp_path, model_save_dir=str(tmp_path / "run_mid"))
    t = cpu_trainer(base)
    orig_step = t._train_step

    def step_hook(state, imgs, labels, mask, gen):
        t._stop_requested = True  # the signal lands while step 1 is in flight
        return orig_step(state, imgs, labels, mask, gen)

    t._train_step = step_hook
    assert t.train() is None
    p = tmp_path / "run_mid" / "latest.ckpt"
    _, _, meta = load_checkpoint(p)
    assert meta["next_epoch"] == 0 and meta["step"] == 1
    tR = cpu_trainer(dict(base, model_save_dir=str(tmp_path / "run_mid2"), pretrained_path=str(p),
                          resume=True, epochs=1))
    assert tR._start_epoch == 0
    tR.train()
    assert (tmp_path / "run_mid2" / "latest.ckpt").exists()


def test_sigterm_stale_flag_cleared_at_entry(tmp_path):
    t = cpu_trainer(base_config(tmp_path, model_save_dir=str(tmp_path / "run_stale"), epochs=1))
    t._stop_requested = True  # stale, from a prior interrupted run
    t.train()
    _, _, meta = load_checkpoint(tmp_path / "run_stale" / "latest.ckpt")
    assert meta["next_epoch"] == 1


def test_sigterm_during_final_step_completes_epoch(tmp_path):
    t = cpu_trainer(base_config(tmp_path, model_save_dir=str(tmp_path / "run_final")))
    steps_per_epoch = len(t.train_dataloader)
    assert steps_per_epoch >= 2
    orig_step, calls = t._train_step, []

    def step_hook(state, imgs, labels, mask, gen):
        calls.append(1)
        if len(calls) == steps_per_epoch:  # epoch 0's final step in flight
            t._stop_requested = True
        return orig_step(state, imgs, labels, mask, gen)

    t._train_step = step_hook
    assert t.train() is None
    assert len(calls) == steps_per_epoch
    _, _, meta = load_checkpoint(tmp_path / "run_final" / "latest.ckpt")
    assert meta["next_epoch"] == 1 and meta["step"] == steps_per_epoch


def test_sigterm_real_signal_and_handler_restored_on_every_exit(tmp_path):
    t = cpu_trainer(base_config(tmp_path, model_save_dir=str(tmp_path / "run_sig")))
    orig_flush, fired = t._flush_train_logs, []

    def flush_hook(pending, epoch, window_imgs, window_start):
        r = orig_flush(pending, epoch, window_imgs, window_start)
        if not fired:
            fired.append(1)
            os.kill(os.getpid(), signal.SIGTERM)
        return r

    t._flush_train_logs = flush_hook
    prev = signal.getsignal(signal.SIGTERM)
    assert t.train() is None
    assert signal.getsignal(signal.SIGTERM) is prev
    _, _, meta = load_checkpoint(tmp_path / "run_sig" / "latest.ckpt")
    assert meta["next_epoch"] == 1
    # an exception out of the epoch loop restores the handler too
    t2 = cpu_trainer(base_config(tmp_path, model_save_dir=str(tmp_path / "run_exc")))

    def boom(*a, **k):
        raise RuntimeError("step failed")

    t2._train_step = boom
    with pytest.raises(RuntimeError, match="step failed"):
        t2.train()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_checkpoint_interval_throttles_latest(tmp_path, monkeypatch):
    pairs = [make_pair_dirs(tmp_path, "ci", n_images=6)]
    trainer = cpu_trainer(base_config(tmp_path, pairs=pairs, epochs=5, checkpoint_interval=3,
                                      model_save_dir=str(tmp_path / "run")))
    writes, real = [], Trainer.checkpoint

    def spy(self, path, **kw):
        writes.append(Path(path).name)
        return real(self, path, **kw)

    monkeypatch.setattr(Trainer, "checkpoint", spy)
    trainer.train()
    assert writes.count("latest.ckpt") == 2  # epoch 3 and the final epoch 5
    # a boundary stop on an epoch the throttle skipped still writes
    t2 = cpu_trainer(base_config(tmp_path, pairs=pairs, epochs=5, checkpoint_interval=3,
                                 model_save_dir=str(tmp_path / "run2")))
    orig_flush = t2._flush_train_logs

    def flush_hook(*a):
        t2._stop_requested = True
        return orig_flush(*a)

    t2._flush_train_logs = flush_hook
    assert t2.train() is None
    _, _, meta = load_checkpoint(tmp_path / "run2" / "latest.ckpt")
    assert meta["next_epoch"] == 1


# ------------------------------------------------ the slice against the JAX one
def jax_trainer(cfg):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t = jtrain.Trainer(dict(cfg))
        t.init()
    return t


def test_both_trainers_two_epochs_agree(tmp_path, monkeypatch):
    """Both Trainers, two epochs, one fixture, a dropout-free architecture,
    flips off in both (the step factories are patched here, not in the
    packages), the JAX Trainer's initial weights carried into the port's.
    Per-step train loss and components rtol 1e-4, LR rtol 1e-6, val loss
    and test loss rtol 1e-4, best.ckpt and latest.ckpt parameters atol 1e-5
    and BN running statistics rtol 1e-3, the same files in the run directory (but for the validation
    image, which the port does not draw yet)."""
    monkeypatch.setattr(jtrain, "make_train_step", partial(jtrain.make_train_step, augment=False))
    monkeypatch.setattr(ttrain, "make_train_step", partial(ttrain.make_train_step, augment=False))
    pairs = [make_pair_dirs(tmp_path, str(i), n_images=10, boxes_per_image=3, seed=i) for i in range(2)]
    defn = write_defn(tmp_path / "both.yml", dataset_pairs=pairs,
                      split={"train": 0.6, "val": 0.2, "test": 0.2})
    with nodrop_models():
        # batch 8 = the JAX test mesh's 8 devices: no batch is padded there
        # beyond the loader's own wrap-around, so BN sees the same rows
        # lr 1e-4: AdamW's first steps move a weight by about lr whatever the
        # size of its gradient, so where a gradient is rounding noise the two
        # packages differ by a fraction of lr, which atol 1e-5 must hold
        cfg = base_config(tmp_path, pairs=pairs, dataset_descriptor_file=str(defn), epochs=2,
                          batch_size=8, model="test_nodrop", image_hw=(96, 128), learning_rate=1e-4)
        jt = jax_trainer(dict(cfg, model_save_dir=str(tmp_path / "jax")))
        tt = Trainer(dict(cfg, model_save_dir=str(tmp_path / "port")), device="cpu")
        tt._init_dataset_definition()
        tt._init_model()
        variables = jax.tree.map(np.asarray, {"params": jt.state.params,
                                              "batch_stats": jt.state.batch_stats})
        tt.stack.load_state_dict(state_dict_from_flax(variables), strict=True)
        tt._init_dataset()
        tt._init_training_tools()
        tt._init_logger()
        tt._initialized = True
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jres, tres = jt.train(), tt.train()
        want, got = records(tmp_path / "jax"), records(tmp_path / "port")
        wt, gt = ([r for r in rs if "train loss" in r] for rs in (want, got))
        assert [r["step"] for r in gt] == [r["step"] for r in wt] and len(gt) == 4
        for g, w in zip(gt, wt):
            assert g["epoch"] == w["epoch"]
            np.testing.assert_allclose(g["LR"], w["LR"], rtol=1e-6)
            for key in ("train loss", "iou_loss", "objectness_loss", "classification_loss"):
                np.testing.assert_allclose(g[key], w[key], rtol=1e-4, err_msg=f"step {g['step']} {key}")
        wv, gv = ([r for r in rs if "val loss" in r] for rs in (want, got))
        assert len(gv) == len(wv) == 1 and gv[0]["step"] == wv[0]["step"]
        np.testing.assert_allclose(gv[0]["val loss"], wv[0]["val loss"], rtol=1e-4)
        np.testing.assert_allclose(gv[0]["best_val_loss"], wv[0]["best_val_loss"], rtol=1e-4)
        np.testing.assert_allclose(tres[0], jres[0], rtol=1e-4)  # post-train test loss
        np.testing.assert_array_equal(tres[2], jres[2])  # and its confusion matrix
        files = lambda d: sorted(p.name for p in (tmp_path / d).iterdir() if p.name != "validation_bbs.png")
        assert files("port") == files("jax") == ["best.ckpt", "config.json", "latest.ckpt", "metrics.jsonl"]
        for name in ("best.ckpt", "latest.ckpt"):
            _, gvars, gmeta = load_checkpoint(tmp_path / "port" / name)
            _, wvars, wmeta = jload_checkpoint(tmp_path / "jax" / name)
            for key in ("epoch", "step", "next_epoch", "classes", "model_version", "model_name"):
                assert gmeta[key] == wmeta[key], (name, key)
            np.testing.assert_allclose(gmeta["min_val_loss"], wmeta["min_val_loss"], rtol=1e-4)
            flat_g = dict(jax.tree_util.tree_leaves_with_path(gvars))
            for path, w in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, wvars)):
                # BN running statistics of raw 0-255 inputs reach the hundreds
                # and are held relatively. The fixture's frames are bright
                # and flat (220 +- 10), so block 0's variance is a small
                # difference of large float32 sums (flax takes E[x^2] -
                # E[x]^2): rtol 1e-3 there; the parameters atol 1e-5
                tol = dict(rtol=1e-3) if "batch_stats" in str(path) else dict(atol=1e-5)
                np.testing.assert_allclose(flat_g[path], w, err_msg=f"{name} {path}", **tol)


# -------------------------------------------------- checkpoints cross over
def interrupt_after_epoch(trainer, epoch):
    orig = trainer.checkpoint

    def hook(path, model_name, **kw):
        orig(path, model_name, **kw)
        if Path(path).name == "latest.ckpt" and trainer.epoch == epoch:
            trainer._stop_requested = True

    trainer.checkpoint = hook


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_run_interrupted_in_one_package_resumes_in_the_other(tmp_path, first):
    """Stopped after epoch 1 of 3 by one package's Trainer, resumed in
    place by the other's: epoch counter, step, watermark and optimizer
    counts carry over, the run finishes and tests its best checkpoint."""
    base = base_config(tmp_path, epochs=3, model_save_dir=str(tmp_path / "run"))
    one = jax_trainer(base) if first == "jax" else cpu_trainer(dict(base))
    steps_per_epoch = len(one.train_dataloader)
    interrupt_after_epoch(one, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert one.train() is None
    latest = tmp_path / "run" / "latest.ckpt"
    _, _, meta = load_checkpoint(latest)
    assert meta["next_epoch"] == 2 and meta["step"] == 2 * steps_per_epoch
    assert meta["min_val_loss"] is not None and meta["classes"] == CLASSES
    assert meta["model_name"] == "resume"

    resume_cfg = dict(base, pretrained_path=str(latest), resume=True, model_save_dir=None, name=None)
    two = cpu_trainer(resume_cfg) if first == "jax" else jax_trainer(resume_cfg)
    assert two._start_epoch == 2 and two.tuning is False and two.global_step == 2 * steps_per_epoch
    assert two.min_val_loss == pytest.approx(meta["min_val_loss"])
    assert Path(two.model_save_dir).resolve() == (tmp_path / "run").resolve()
    assert two._lr_step_offset == 0  # the saved optimizer count was restored
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        two.train()
    load = load_checkpoint if first == "jax" else jload_checkpoint
    _, _, done = load(latest)
    assert done["next_epoch"] == 3 and done["step"] == 3 * steps_per_epoch
    counts = unpackb(load_checkpoint(latest)[2]["_opt_state_bytes"])["1"]
    assert int(counts["0"]["count"]) == int(counts["2"]["count"]) == 3 * steps_per_epoch
    steps = [r["step"] for r in records(tmp_path / "run") if "train loss" in r]
    assert steps == list(range(1, 3 * steps_per_epoch + 1))  # one log, both packages
