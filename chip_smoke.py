#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yogo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases (any failure exits non-zero):
  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: every CUDA source of the port, one nvcc each, in parallel, with
     ptxas's registers / spills and a SASS summary per kernel (cuobjdump);
  3. kernels against their plain PyTorch versions on the card: the stem
     kernel in both layouts on block-0 weights of the trained base_model
     checkpoint at 772x1032 (B=2 and the B=64 timing batch) and at an odd
     shape, within 1 bf16 ulp (rtol 8e-3, atol 1e-2);
  4. main path: `infer --count` through the port's Predictor on the
     golden scene (4 images of tests/test_golden_fullres.py's generator):
     bf16 in both block layouts (the stem launch counters must move) within
     +-2 detections per image of tests/goldens/detections_fullres_base.npz,
     and float32 with TF32 off within +-1;
  5. timing at B=64, 772x1032 (CUDA events around 20 back-to-back calls):
     kernel, plain version, a cuDNN yardstick and the bytes bound per
     layout; blocks 1-7 in NCHW and channels_last; the stages of the count
     path; images/s of the bf16 count path (host clock);
  6. training (train_phase): one float32 step from the trained checkpoint
     on the card against the same step on the CPU (loss, components, every
     gradient); 30 bf16 steps at B=64 from a fresh init with dropout and
     flips on (finite, falling loss; BN statistics move; scheduler ==
     closed form); 3 steps each with BN frozen and with accumulate=2 +
     remat="blocks" at B=16; the trained state saved, reloaded through
     Predictor and counted on the golden frames through the stem kernel
     (head equal to the in-memory stack's); step time, its forward /
     backward / optimizer split, images/s and peak memory;
  7. one JSON line per kernel ("kernels"), then the last line
     {"ok": true, "device": {...}}.
All numbers also go to chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CKPT = REPO / "tests" / "goldens" / "trained_base_model_fullres.ckpt"
GOLDEN = REPO / "tests" / "goldens" / "detections_fullres_base.npz"
HW = (772, 1032)
TIMING_BATCH = 64
RTOL, ATOL = 8e-3, 1e-2  # 1 bf16 ulp at the stem's output range

# device-memory rate by card name (NVIDIA data sheets), bytes/s, and the
# float32 rate outside the tensor cores (the stem's FMAs), FLOP/s
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12, "H100": 3.35e12}
F32_RATE = 67e12


def log(*a):
    print(*a, flush=True)


def gen_golden_images(n: int = 4, seed: int = 3, hw=HW):
    """((n, 1, 772, 1032) uint8, n label arrays (N_i, 5) [class, x1, y1,
    x2, y2] in image fractions): the frozen generator of
    tests/test_golden_fullres.py (gen_test_images), without the PNG round
    trip (which is lossless), and with every blob's class and rectangle."""
    h, w = hw
    blobs = {0: (36, 36), 1: (24, 48)}
    r = np.random.default_rng(seed)
    out, labels = [], []
    for _ in range(n):
        arr = np.full((h, w), 225, np.uint8)
        rows = []
        for _ in range(int(r.integers(20, 61))):
            cls = int(r.integers(0, 2))
            bh, bw = blobs[cls]
            y = int(r.integers(2, h - 2 - bh))
            x = int(r.integers(2, w - 2 - bw))
            arr[y : y + bh, x : x + bw] = 60 if cls == 0 else 130
            rows.append([cls, x / w, y / h, (x + bw) / w, (y + bh) / h])
        arr += r.integers(0, 12, arr.shape).astype(np.uint8)
        out.append(arr)
        labels.append(np.asarray(rows, np.float32))
    return np.stack(out)[:, None], labels


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate known for {name!r}")


def cuda_ms(fn, reps: int, per_rep: int = 20, warmup: int = 3) -> float:
    """Time of one fn() call in ms: the median over `reps` of CUDA-event
    timings of `per_rep` back-to-back calls, divided by `per_rep`. The
    calls queue up behind one another, so the host work of each call
    overlaps the device work of the one before, and only the device time
    stays in the window."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_rep):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_rep)
    return statistics.median(times)


def train_phase(dev, imgs4, boxes4, smi, *, batch=TIMING_BATCH, steps=30, small_batch=16,
                ckpt=CKPT, model_version="base_model"):
    """Phase 6: the training step on `dev`. Returns (numbers for the
    report, stem launches of the reload-and-count step). Every check
    raises."""
    from yogo_tpu_torch.infer import Predictor
    from yogo_tpu_torch.losses import yogo_loss
    from yogo_tpu_torch.models.yogo import YOGO, no_tf32
    from yogo_tpu_torch.ops.grid import encode_label_grid_np
    from yogo_tpu_torch.ops.stem import LAUNCHES
    from yogo_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from yogo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from yogo_tpu_torch.utils.default_hyperparams import DefaultHyperparams as df
    from yogo_tpu_torch.utils.weights import (
        flax_from_state_dict, optax_state_from_torch, state_dict_from_flax,
    )

    out = {}
    on_card = dev.type == "cuda"
    loss_kw = dict(no_obj_weight=df.NO_OBJ_WEIGHT, iou_weight=df.IOU_WEIGHT,
                   classify_weight=df.CLASSIFY_WEIGHT, label_smoothing=df.LABEL_SMOOTHING)

    # ---- data from a seed: the golden frames and their label grids, tiled
    gold_model, gold_vars, _ = load_checkpoint(ckpt)
    sx, sy = gold_model.grid
    grids4 = np.stack([encode_label_grid_np(b, sx, sy) for b in boxes4])
    n4 = len(imgs4)
    out["labels_per_image"] = [int(g[0].sum()) for g in grids4]

    def tiled(n):
        reps = -(-n // n4)
        return (torch.from_numpy(np.concatenate([imgs4] * reps)[:n]).to(dev),
                torch.from_numpy(np.concatenate([grids4] * reps)[:n]).to(dev),
                torch.ones(n, device=dev))

    # ---- one float32 step from the trained checkpoint: card against CPU.
    # Dropout masks come from a CPU generator with one seed on every side,
    # so they are the same masks; flips are off. A float64 run of the stack
    # on the CPU (decode and loss stay float32) says how far float32 itself
    # is from the truth: near its optimum the trained model's gradients are
    # small residues of large cancelling sums.
    def one_step(device, dtype=torch.float32):
        m = dataclasses.replace(gold_model, compute_dtype=dtype)
        stack = m.module(device)
        stack.load_state_dict(state_dict_from_flax(gold_vars), strict=True)
        stack.to(dtype)
        x = torch.from_numpy(imgs4[:2]).to(device)
        lab = torch.from_numpy(grids4[:2]).to(device)
        with no_tf32(torch.device(device)):
            pred = m.apply(stack, x, train=True, generator=torch.Generator().manual_seed(11))
            loss, comps = yogo_loss(pred, lab, **loss_kw)
            loss.backward()
        grads = {k: p.grad.detach().cpu().double() for k, p in stack.named_parameters()}
        stats = {k: b.detach().cpu().double() for k, b in stack.named_buffers() if "running" in k}
        return float(loss.detach()), {k: float(v.detach()) for k, v in comps.items()}, grads, stats

    t0 = time.time()
    loss_c, comps_c, grads_c, stats_c = one_step(dev)
    loss_h, comps_h, grads_h, stats_h = one_step("cpu")
    loss_d, _, grads_d, _ = one_step("cpu", torch.float64)
    check = {"loss_card": loss_c, "loss_cpu": loss_h, "loss_cpu_float64_stack": loss_d,
             "components_card": comps_c, "components_cpu": comps_h, "seconds": time.time() - t0}
    # tolerances: loss and components rtol 1e-4 against the CPU's; BN
    # running statistics rtol 1e-4; each gradient, measured against the
    # float64 stack's and relative to its max-norm, within 1e-3 or 4 times
    # the error of the CPU's own float32 gradient, whichever is larger
    if not np.isclose(loss_c, loss_h, rtol=1e-4):
        raise AssertionError(f"one-step loss: card {loss_c} vs CPU {loss_h}")
    for k in comps_h:
        if not np.isclose(comps_c[k], comps_h[k], rtol=1e-4, atol=1e-7):
            raise AssertionError(f"one-step {k}: card {comps_c[k]} vs CPU {comps_h[k]}")
    # a bias in front of a BN (block 5) has an exactly zero gradient: its
    # error is measured against the model's largest gradient instead
    floor = 1e-3 * max(float(g.abs().max()) for g in grads_d.values())
    per_param = {}
    for k, g in grads_d.items():
        norm = g.abs().max().clamp(min=floor)
        err_card = float((grads_c[k] - g).abs().max() / norm)
        err_cpu = float((grads_h[k] - g).abs().max() / norm)
        per_param[k] = {"card": err_card, "cpu_float32": err_cpu, "max_norm": float(norm)}
        if not torch.isfinite(grads_c[k]).all() or err_card > max(1e-3, 4 * err_cpu):
            raise AssertionError(
                f"one-step gradient {k}: max-norm error {err_card:.3g} on the card, "
                f"{err_cpu:.3g} on the CPU in float32"
            )
    for k, b in stats_h.items():
        torch.testing.assert_close(stats_c[k], b, rtol=1e-4, atol=1e-6, msg=lambda m, k=k: f"{k}: {m}")
    worst = max(v["card"] for v in per_param.values())
    worst_cpu = max(v["cpu_float32"] for v in per_param.values())
    check["gradient_max_norm_error_vs_float64"] = per_param
    check["worst_gradient_error_card"] = worst
    check["worst_gradient_error_cpu_float32"] = worst_cpu
    out["one_step_card_vs_cpu"] = check
    log(f"train one step f32 B=2, card vs CPU: loss {loss_c:.6f} / {loss_h:.6f} "
        f"(float64 stack {loss_d:.6f}); worst gradient max-norm error against the float64 "
        f"stack: card {worst:.3g}, CPU float32 {worst_cpu:.3g}, over {len(per_param)} tensors")
    del grads_c, grads_h, grads_d

    # ---- a few steps at full width: fresh init, bf16, dropout and flips on
    model = YOGO.create(gold_model.img_size, gold_model.anchor_w, gold_model.anchor_h,
                        gold_model.num_classes, model_version=model_version,
                        compute_dtype=torch.bfloat16)

    def new_state(seed, total_steps):
        stack = model.init(torch.Generator().manual_seed(seed), device=dev)
        optimizer, scheduler, host = make_optimizer(
            stack.parameters(), df.LEARNING_RATE, df.WEIGHT_DECAY, df.DECAY_FACTOR, total_steps)
        return TrainState(stack, optimizer, scheduler), host

    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state, host_schedule = new_state(0, total_steps=100)
    stack = state.stack
    bn_means0 = {k: b.clone() for k, b in stack.named_buffers() if k.endswith("running_mean")}
    x, lab, mask = tiled(batch)
    step = make_train_step(model, loss_kw)
    gen = torch.Generator().manual_seed(1)
    losses, lrs = [], []
    t0 = time.time()
    for i in range(steps):
        lr = state.optimizer.param_groups[0]["lr"]
        if not np.isclose(lr, host_schedule(i), rtol=1e-12):
            raise AssertionError(f"step {i}: scheduler lr {lr} vs closed form {host_schedule(i)}")
        lrs.append(lr)
        _, loss, comps = step(state, x, lab, mask, gen)
        losses.append(loss)
    losses = torch.stack(losses).cpu().tolist()  # waits for the device
    train_s = time.time() - t0
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"loss did not fall: first 5 mean {first}, last 5 mean {last}")
    for k, b0 in bn_means0.items():
        if torch.equal(stack.get_buffer(k), b0):
            raise AssertionError(f"{k} did not move in {steps} training steps")
    if state.step != steps or state.scheduler.last_epoch != steps:
        raise AssertionError(f"step counts {state.step}, {state.scheduler.last_epoch} != {steps}")
    out["train"] = {
        "batch": batch, "steps": steps, "losses": losses, "first5_mean": first,
        "last5_mean": last, "lr_first": lrs[0], "lr_last": lrs[-1],
        "wall_s_incl_warmup": train_s,
        "last_components": {k: float(v) for k, v in comps.items()},
    }
    if on_card:
        out["train"]["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"train {steps} steps bf16 B={batch}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"(first 5 mean {first:.4f}, last 5 mean {last:.4f}), lr {lrs[0]:.3g} -> {lrs[-1]:.3g}")

    # ---- B=16: BN frozen, then accumulate=2 with remat="blocks"
    xs, labs, masks = tiled(small_batch)
    tuned, _ = new_state(2, total_steps=100)
    tuned.stack.load_state_dict(stack.state_dict())
    stats0 = {k: b.clone() for k, b in tuned.stack.named_buffers()}
    tune_step = make_train_step(model, loss_kw, tuning=True)
    tune_losses = [float(tune_step(tuned, xs, labs, masks, gen)[1]) for _ in range(3)]
    for k, b in tuned.stack.named_buffers():
        if not torch.equal(b, stats0[k]):
            raise AssertionError(f"tuning=True changed {k}")
    if not all(np.isfinite(tune_losses)) or torch.equal(tuned.stack.conv3.weight, stack.conv3.weight):
        raise AssertionError(f"tuning steps did not train: {tune_losses}")
    acc, _ = new_state(3, total_steps=100)
    acc_step = make_train_step(model, loss_kw, accumulate=2, remat="blocks")
    half = small_batch // 2
    stacked = [t.reshape(2, half, *t.shape[1:]) for t in (xs, labs, masks)]
    acc_losses = [float(acc_step(acc, *stacked, gen)[1]) for _ in range(3)]
    if not all(np.isfinite(acc_losses)) or acc.step != 3 or acc.scheduler.last_epoch != 3:
        raise AssertionError(f"accumulate=2 remat=blocks: {acc_losses}, step {acc.step}")
    if torch.equal(acc.stack.bn0.running_mean, torch.zeros_like(acc.stack.bn0.running_mean)):
        raise AssertionError("accumulate=2: BN statistics did not move")
    out["tuning_b16_losses"] = tune_losses
    out["accumulate2_remat_blocks_b16_losses"] = acc_losses
    log(f"train B={small_batch}: tuning losses {tune_losses} (BN statistics bit-equal); "
        f"accumulate=2 remat=blocks losses {acc_losses}")
    del tuned, acc

    # ---- round trip through the checkpoint and the stem kernel
    LAUNCHES.clear()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trained.ckpt"
        save_checkpoint(
            path, model, flax_from_state_dict(stack.state_dict()),
            opt_state=optax_state_from_torch(stack, state.optimizer, state.scheduler),
            epoch=0, step=state.step, classes=["cell", "parasite"], model_name="chip_smoke",
        )
        out["checkpoint_bytes"] = path.stat().st_size
        round_trip = {}
        for layout in ("nhwc", "nchw"):
            pred = Predictor.from_checkpoint(path, half=True, device=dev,
                                             channels_last=layout == "nhwc")
            raw = pred.forward_raw(imgs4)
            counts = pred.count(raw, torch.ones(n4, dtype=torch.bool)).cpu().tolist()
            if pred.meta["step"] != steps or "_opt_state_bytes" not in pred.meta:
                raise AssertionError(f"reloaded meta: {sorted(pred.meta)}")
            if raw.shape != (n4, sy, sx, 5 + model.num_classes) or not torch.isfinite(raw.float()).all():
                raise AssertionError(f"reloaded {layout}: bad head {raw.shape}")
            if layout == "nhwc":  # the in-memory stack runs channels_last
                want = model.apply(stack, torch.from_numpy(imgs4).to(dev), decode=False)
                if not torch.equal(raw, want):
                    err = float((raw.float() - want.float()).abs().max())
                    raise AssertionError(f"reloaded head differs from the trained stack's by {err}")
            round_trip[layout] = {"counts": counts}
    launches = dict(LAUNCHES)
    out["round_trip"] = round_trip
    out["round_trip_stem_launches"] = launches
    log(f"train round trip: checkpoint {out['checkpoint_bytes']} B, reloaded head == in-memory head, "
        f"counts {round_trip}, stem launches {launches}")
    if not on_card:
        return out, launches

    # ---- numbers: step time, its split, images/s, peak memory
    def events(n):
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

    timing = {}
    for remat in ("none", "blocks"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timed = make_train_step(model, loss_kw, remat=remat)
        for _ in range(2):
            timed(state, x, lab, mask, gen)
        reps = []
        for _ in range(5):
            a, b = events(2)
            a.record()
            for _ in range(10):
                timed(state, x, lab, mask, gen)
            b.record()
            b.synchronize()
            reps.append(a.elapsed_time(b) / 10)
        ms = statistics.median(reps)
        timing[remat] = {"step_ms": ms, "step_ms_reps": reps, "img_per_s": batch / ms * 1e3,
                         "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30}
    split = {"forward_ms": [], "backward_ms": [], "optimizer_ms": []}
    for _ in range(7):
        state.optimizer.zero_grad(set_to_none=True)
        e = events(4)
        e[0].record()
        pred = model.apply(stack, x.to(torch.bfloat16), train=True, generator=gen)
        loss, _ = yogo_loss(pred, lab, image_mask=mask, **loss_kw)
        e[1].record()
        loss.backward()
        e[2].record()
        state.optimizer.step()
        state.scheduler.step()
        e[3].record()
        e[3].synchronize()
        for key, (p, q) in zip(split, zip(e, e[1:])):
            split[key].append(p.elapsed_time(q))
    timing["split_no_flips"] = {k: statistics.median(v[2:]) for k, v in split.items()}
    out["timing"] = timing
    log("train timing (bf16, B=%d, %dx%d, %s): %s" % (batch, *model.img_size, smi, json.dumps(timing)))
    return out, launches


def main() -> int:
    # ------------------------------------------------------------ 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from yogo_tpu_torch import kernels
    from yogo_tpu_torch.infer import Predictor
    from yogo_tpu_torch.ops import nms
    from yogo_tpu_torch.ops.stem import LAUNCHES, fused_stem_nchw, fused_stem_reference

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)  # nvidia-smi's name, power limit
    report = {"device": kind, "nvidia_smi": smi, "torch": torch.__version__}
    dev = torch.device("cuda")

    # ------------------------------------------------------------- 2. build
    t0 = time.time()
    kernels.build_all()
    report["build_s"] = time.time() - t0
    log(f"build: {report['build_s']:.1f} s for {sorted(kernels.SOURCES)}")
    for name, text in kernels.build_logs.items():
        log(f"--- nvcc csrc/{name}.cu ---\n{text.strip()}")
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    report["sass"] = {}
    for name in kernels.SOURCES:
        try:
            report["sass"][name] = kernels.sass_summary(name, out_dir / f"sass_{name}.txt")
        except (OSError, subprocess.CalledProcessError) as e:  # no cuobjdump: a note, not a failure
            log(f"sass of csrc/{name}.cu: not read ({e})")
            continue
        for fn, s in report["sass"][name].items():
            log(f"sass {fn}: {json.dumps(s)}")

    # ------------------------------------- 3. kernels vs their plain versions
    golden = np.load(GOLDEN)
    n_img = 4
    want_per_image = [len(golden[f"dets_{i}"]) for i in range(n_img)]
    want_classes = np.zeros(2, np.int64)
    for i in range(n_img):
        np.add.at(want_classes, golden[f"dets_{i}"][:, 5:].argmax(axis=1), 1)
    imgs4, boxes4 = gen_golden_images(n_img)
    big = np.concatenate([imgs4] * (TIMING_BATCH // n_img))

    ref_pred = Predictor.from_checkpoint(CKPT, half=True, device=dev)
    w9, b9 = (t.detach() for t in ref_pred.stack.folded_stem())
    rng = np.random.default_rng(0)
    cases = {
        "golden_b2": torch.from_numpy(imgs4[:2, 0].copy()).to(dev),
        "odd_3x70x48": torch.from_numpy(rng.integers(0, 256, (3, 70, 48), np.uint8)).to(dev),
        "timing_b64": torch.from_numpy(big[:, 0].copy()).to(dev),
    }
    max_err = {}
    for layout in ("nhwc", "nchw"):
        fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
        errs = []
        for case, x in cases.items():
            got = fused_stem_nchw(x, w9, b9, layout=layout)
            want = fused_stem_reference(x, w9, b9, layout=layout)
            torch.cuda.synchronize()
            if got.shape != want.shape or not got.is_contiguous(memory_format=fmt):
                raise AssertionError(f"stem {layout} {case}: shape/layout {got.shape} {got.stride()}")
            torch.testing.assert_close(got.float(), want.float(), rtol=RTOL, atol=ATOL)
            errs.append(float((got.float() - want.float()).abs().max()))
            del got, want
        max_err[layout] = max(errs)
        log(f"stem_{layout} vs plain: max abs err {max_err[layout]:.3g} over {list(cases)}")
    report["max_abs_err"] = max_err
    del cases

    # ---------------------------------------------------------- 4. main path
    def per_image_counts(pred, raw):
        per = []
        for i in range(n_img):
            mask = torch.arange(n_img) == i
            per.append(int(pred.count(raw, mask).sum()))
        return per, pred.count(raw, torch.ones(n_img, dtype=torch.bool)).cpu().numpy()

    preds = {}
    LAUNCHES.clear()
    for layout in ("nhwc", "nchw"):
        pred = Predictor.from_checkpoint(
            CKPT, half=True, device=dev, channels_last=layout == "nhwc"
        )
        raw = pred.forward_raw(imgs4)
        per, classes = per_image_counts(pred, raw)
        if not torch.isfinite(raw.float()).all() or raw.shape != (n_img, 97, 129, 7):
            raise AssertionError(f"bf16 {layout}: bad head {raw.shape}")
        log(f"bf16 {layout}: per-image {per} (golden {want_per_image}), "
            f"per-class {classes.tolist()} (golden {want_classes.tolist()}), "
            f"NMS rounds {nms.LAST.rounds}, host syncs {nms.LAST.host_syncs}")
        if any(abs(a - b) > 2 for a, b in zip(per, want_per_image)):
            raise AssertionError(f"bf16 {layout} counts {per} vs golden {want_per_image}")
        report[f"bf16_{layout}"] = {"per_image": per, "per_class": classes.tolist(),
                                    "nms_rounds": nms.LAST.rounds,
                                    "nms_host_syncs": nms.LAST.host_syncs}
        preds[layout] = pred
    launches = dict(LAUNCHES)
    log(f"stem launches on the main path: {launches}")
    for layout in ("nhwc", "nchw"):
        if launches.get(f"stem_{layout}", 0) < 1:
            raise AssertionError(f"stem_{layout} was not launched on the main path")

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        p32 = Predictor.from_checkpoint(CKPT, half=False, device=dev)
        per, classes = per_image_counts(p32, p32.forward_raw(imgs4))
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    log(f"f32 (TF32 off): per-image {per}, per-class {classes.tolist()}")
    if any(abs(a - b) > 1 for a, b in zip(per, want_per_image)):
        raise AssertionError(f"f32 counts {per} vs golden {want_per_image}")
    report["f32"] = {"per_image": per, "per_class": classes.tolist()}
    del p32

    # ------------------------------------------------------------ 5. timing
    x64 = torch.from_numpy(big[:, 0].copy()).to(dev)
    bsz, (h, w), c = TIMING_BATCH, HW, w9.shape[0]
    out_px = bsz * (h // 2) * (w // 2)
    n_bytes = bsz * h * w + out_px * c * 2 + (c * 9 + c) * 4
    n_ops = out_px * c * (2 * 9 + 1)
    bound_ms = {
        "bytes": n_bytes / mem_rate(kind) * 1e3,
        "operations": n_ops / F32_RATE * 1e3,
    }
    bound_by = max(bound_ms, key=bound_ms.get)
    timing = {"bound_ms": bound_ms[bound_by], "bound_by": bound_by, "bytes": n_bytes}
    w_lib = w9.view(c, 1, 3, 3).to(torch.bfloat16)
    b_lib = b9.to(torch.bfloat16)
    for layout in ("nhwc", "nchw"):
        fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
        x_lib = x64[:, None]
        w_l = w_lib.contiguous(memory_format=fmt)

        def library():
            xb = x_lib.to(torch.bfloat16).contiguous(memory_format=fmt)
            return torch.nn.functional.leaky_relu(
                torch.nn.functional.conv2d(xb, w_l, b_lib, stride=2, padding=1), 0.01
            )

        timing[layout] = {
            "ms": cuda_ms(lambda: fused_stem_nchw(x64, w9, b9, layout=layout), 30),
            "plain_ms": cuda_ms(lambda: fused_stem_reference(x64, w9, b9, layout=layout), 20),
            "library_ms": cuda_ms(library, 20),
        }

    # blocks 1-7 by memory format, and the stages of the count path
    stages = {}
    for layout, pred in preds.items():
        stack, model = pred.stack, pred.model
        x_nchw = x64[:, None]
        with torch.inference_mode():
            h0 = fused_stem_nchw(x64, w9, b9, layout=layout)
            raw = model.apply(stack, x_nchw, decode=False)
            mask = torch.ones(bsz, dtype=torch.bool, device=dev)
            stages[layout] = {
                "stem_ms": timing[layout]["ms"],
                "blocks_1_7_ms": cuda_ms(lambda: stack(h0, start_block=1), 10),
                "forward_raw_ms": cuda_ms(lambda: model.apply(stack, x_nchw, decode=False), 10),
                "count_ms": cuda_ms(lambda: pred.count(raw, mask), 10),
                "nms_rounds_b64": nms.LAST.rounds,
                "nms_host_syncs_b64": nms.LAST.host_syncs,
            }

        # the bf16 count path, batch by batch (host clock, synchronized):
        # from host uint8 batches (what predict() does) and from a batch
        # already on the card; 40 batches, so the p75 has 10 beyond it
        for src, batch in (("host", torch.from_numpy(big)), ("device", x_nchw)):
            ones = torch.ones(bsz, dtype=torch.bool)
            for _ in range(2):
                pred.count(pred.forward_raw(batch), ones)
            torch.cuda.synchronize()
            times, total = [], torch.zeros(2, dtype=torch.int64, device=dev)
            for _ in range(40):
                t0 = time.perf_counter()
                total += pred.count(pred.forward_raw(batch), ones)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            q = statistics.quantiles(times, n=4)
            stages[layout][f"count_path_{src}"] = {
                "img_per_s": len(times) * bsz / (sum(times) / 1e3),
                "batch_ms_median": statistics.median(times),
                "batch_ms_p75": q[2],
                "batches": len(times),
                "totals": total.cpu().tolist(),
            }
    timing["stages"] = stages
    report["timing"] = timing
    report["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log("timing (B=64, 772x1032, " + smi + "): " + json.dumps(timing))

    # ---------------------------------------------------------- 6. training
    del preds, x64, pred, stack, raw, h0
    torch.cuda.empty_cache()
    report["training"], train_launches = train_phase(dev, imgs4, boxes4, smi)
    for layout in ("nhwc", "nchw"):
        if train_launches.get(f"stem_{layout}", 0) < 1:
            raise AssertionError(f"stem_{layout} was not launched with the trained weights")

    # ------------------------------------------------------------ 7. report
    rows = []
    for layout, line in (("nhwc", 53), ("nchw", 210)):
        rows.append({
            "name": f"stem_{layout}",
            "route": "cuda",
            "source": "yogo_tpu_torch/csrc/stem.cu",
            "replaces": f"yogo_tpu/ops/pallas_stem.py:{line}",
            "launches": launches[f"stem_{layout}"],
            "launches_train_round_trip": train_launches[f"stem_{layout}"],
            "max_abs_err": max_err[layout],
            "ms": timing[layout]["ms"],
            "plain_ms": timing[layout]["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "bound_share": timing["bound_ms"] / timing[layout]["ms"],
            "library_ms": timing[layout]["library_ms"],
        })
    report["kernels"] = rows
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
