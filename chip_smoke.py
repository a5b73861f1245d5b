#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yogo_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of the repository

Phases (any failure exits non-zero):
  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: every CUDA source of the port, one nvcc each, in parallel, with
     ptxas's registers / spills and a SASS summary per kernel (cuobjdump);
     every int8_conv kernel must have wgmma's IGMMA in its SASS and no
     spills; the dynamic shared memory of its plans at the six timed sites;
  3. kernels against their plain PyTorch versions on the card: the stem
     kernel in both layouts on block-0 weights of the trained base_model
     checkpoint at 772x1032 (B=2; B=4, the batch of phases 4 and 6; B=8,
     phase 8's smaller server; the B=64 timing batch, also phases 5, 7 and
     8's larger server) and at an odd shape, within 1 bf16 ulp (rtol 8e-3,
     atol 1e-2);
     3b. the NMS kernel (nms_phase) against its plain version on the card
     and on the CPU, bit for bit, at B=64 on the golden scene's heads at
     K = 256 and 1,024 and at 1,024 with every slot valid; its time (CUDA
     events) and that of the chain and loop it replaces;
     3c. the LayerNorm kernel (layer_norm_phase) on the ConvNeXt-Small,
     Swin-S and ViTDet-B trunks at B=64, 772x1032, seeded weights: 40, 29
     and 18 row-store launches a bf16 forward, Swin's 24 and ViTDet-B's 8
     windowed stores and as many window merges (csrc/window_merge.cu;
     LN_LAUNCHES), the forward timed with the kernels and
     with the plain chain and layout in their place; each (C, rows, dtype
     in, dtype out) of those launches against the plain version, and its
     time beside its byte bound, the plain chain's and F.layer_norm's; each
     windowed store and merge bit for bit against the plain layout, its
     time beside its byte bound and the plain layout's (`python3
     chip_smoke.py layer_norm` runs phases 1, 2 and 3c alone);
     (`python3 chip_smoke.py vitdet` runs the ViTDet-B trunk's card tests,
     phase 3c on that trunk alone, one full-size forward against the
     benchmark's reference, its peak memory, the share of candidates NMS
     suppresses in the count cells, and its cell once: vitdet_main);
  4. main path: `infer --count` through the port's Predictor on the
     golden scene (4 images of tests/test_golden_fullres.py's generator):
     bf16 in both block layouts (the stem launch counters must move, and
     each count launch the NMS kernel once with no host sync) within
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
  7. the CLI (cli_phase), each command through
     yogo_tpu_torch.__main__.main(argv): 320 distinct 772x1032 frames written
     as PNGs with YOLO labels and a 0.6 / 0.2 / 0.2 definition; `train`
     5 epochs at B=64 bf16 with the packed cache (finite losses, the mean
     train loss falls, one record a step, best.ckpt and latest.ckpt);
     `train --resume` in place, one more epoch three times: under
     torch.profiler (device-busy share of the epoch), with the loader read
     in the dispatching thread, and as shipped (LR and optimizer counts on
     the saved clock each time);
     `test` with the device and the host metrics engine (equal confusion,
     missed, extra, total); both engines and both designs of the greedy
     matching loop on the trained golden checkpoint's detections, and one
     DeviceMetrics.update on the card against the CPU (integer state equal);
     loader images/s from PNGs and from the packed cache; one epoch without
     the cache; `infer --count` on best.ckpt through the stem kernel;
     `infer --save-preds --save-npy --count` on the golden checkpoint with
     --fetch-top-k 512 (candidates), 16 (full-slice fallbacks) and 0 (full
     tensors): the files byte-equal; `infer --draw-boxes`;
  8. serve (serve_phase), the golden checkpoint bf16 at micro-batch 8 and
     64, each server in a thread on port 0: the 4 golden frames as PNG, as
     raw frames and as one 4-frame raw request, equal to one another and to
     the host formatter over Predictor.forward of a batch of the server's
     shape, within +-2 of the golden per-image counts; a low threshold takes
     the full-slice fallback (counted in /metrics) and is still equal;
     16-64 client threads stream raw frames for ~10 s with a hot reload in
     the middle (zero errors, answers unchanged, no kernel rebuilt);
     over one window (tools/serve_load.measure): requests/s and images/s
     from /metrics, latency p50/p99 of the requests that ended in it, batch
     occupancy, the server's mean timers; then the device-busy share under
     the same load (torch.profiler); a small --max-queue answers 503;
  9. int8 (int8_phase): the program of ops/quant.py on the golden checkpoint,
     calibrated on the golden frames tiled to 64; csrc/int8_conv.cu against
     its plain version on the codes entering blocks 4-6 at B=4 and 64 and
     at odd shapes (int8 codes and f32 outputs equal); `infer --quantize`
     through predict on the golden scene with the gates of
     tests/test_golden_fullres_int8.py (the stem and int8 conv launch
     counters must move); the B=64-calibrated program on the golden scene
     fails the gates the JAX package's does (WITNESS_TILED_B64); timing
     at B=64 (kernel, plain, unfold + torch._int_mm, cuDNN bf16, bound per
     block; entry requant; int8 vs bf16 forward_raw and count path); `serve --quantize` at micro-batch 64
     (answers equal the formatter over its int8 Predictor, golden counts
     +-2, a recalibrating hot reload under load). Phase 7 also runs
     `test --quantize` (the int8 conv launches, the stem does not);
 10. ConvNeXt-Small (convnext_phase), full width and depth at 772x1032 on
     seeded perturbed weights: the card's f32 head of one frame against the
     CPU's; bf16 `infer --count` at B=64 through Predictor (no stem launch),
     its time and memory; training steps at B=16 and at B=64 with
     remat="blocks", the trained state reloaded from .ckpt and .pth (equal
     heads); `infer --quantize` (71 int8 conv launches a batch), the kernel
     against its plain version at all 71 sites of that batch and its time
     at three (and torch._int_mm alone at the two 1x1 ones), int8 against
     bf16 forward; `serve` and `serve --quantize` at
     micro-batch 8 equal to the formatter, before and after a reload;
 11. export (export_phase): `export` of the golden checkpoint with the
     default device (the card): the .onnx bytes equal build_onnx on the
     CPU, the parity gate on the card, build / verify ms, the stem launched
     no time; the graph on the golden frames one at a time through the
     interpreter on the card, within +-1 of the f32 goldens;
     `--crop-height 0.25` ((1, 1, 193, 1032)), `--format pth` (head
     bit-equal), `--format stablehlo` (raises); ConvNeXt-Small's graph at
     772x1032 through the gate;
 12. parallel (parallel_phase): a training step in a process group of
     world 1 over NCCL bit-equal to no group; two ranks on the one card
     over gloo (NCCL takes one rank a card): f32 steps on a global batch of
     8 with a masked pad row against one process (rtol 1e-4), BN statistics
     equal on the ranks, --fsdp against the replicated run (rtol 2e-4) and
     its checkpoint; bf16 step ms / peak GiB at world 1 and 2; `infer
     --count --data-parallel` through the CLI (rank 0 alone prints one
     process's line; one stem launch a batch on each rank; --save-preds
     files equal one process's); `--quantize` (rank 0's scales on both
     ranks, bit for bit; the int8 golden gates); ConvNeXt-Small's state
     bytes and peak per rank, replicated and --fsdp;
 13. row-split inference (spatial_phase), base_model at 772x1032 with the
     N = 2 and 4 row shards on the one card (devices=["cuda:0"] * N, not
     scaling): the stem and int8 conv kernels on each shard's window
     bit-equal to the unsplit launches' rows; the bf16 (both layouts), f32
     and int8 golden gates through Predictor / predict with N stem and 3N
     int8 conv launches a batch; `serve --spatial-parallel 2` and `serve
     --data-parallel` over two replicas equal to the formatter over their
     own forwards; bf16 / int8 forward ms for N = 1, 2, 4 at B=64, halo
     bytes and the copy kernels' device ms;
 14. row-split training and ConvNeXt (spatial_train_phase), N = 2 and 4
     row shards on the one card: base_model at 772x1032, one f32 step at
     B=4 split against unsplit (loss, parameters, gradients, BN
     statistics; no stem launch), bf16 step ms / peak GiB / copy device ms
     for N = 1, 2, 4 at B=64, Trainer(devices=["cuda:0"] * 2) fine-tuning
     the golden checkpoint for one epoch on phase 7's frames (its
     best.ckpt holds the golden counts); ConvNeXt-Small at 772x1032 on
     phase 10's weights: f32 and bf16 split heads against unsplit, bf16 and
     int8 forward ms for N = 1, 2, 4 at B=64, 71 N int8 conv launches a
     batch with every shard's launch equal to the unsplit launch's rows on
     the same codes, one f32 split train step against unsplit, `serve
     --spatial-parallel 2` equal to the formatter;
 15. one JSON line per kernel ("kernels"), then the last line
     {"ok": true, "device": {...}}.
All numbers also go to chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from yogo_tpu_torch.tools.golden_scene import gen_golden_images
from yogo_tpu_torch.tools.timing import INT8_RATE, MEM_RATE, cuda_ms, rate

REPO = Path(__file__).resolve().parent
CKPT = REPO / "tests" / "goldens" / "trained_base_model_fullres.ckpt"
GOLDEN = REPO / "tests" / "goldens" / "detections_fullres_base.npz"
HW = (772, 1032)
TIMING_BATCH = 64
RTOL, ATOL = 8e-3, 1e-2  # 1 bf16 ulp at the stem's output range
# the JAX package's int8 program of the golden checkpoint calibrated on the
# 4 golden frames tiled to 64, on the golden scene (tests/int8_calibration_
# witness.py, on the CPU): one box of image 1 matches at IoU 0.726, below
# the gate's 0.8 (calibrated on the 4 frames alone, every gate holds)
WITNESS_TILED_B64 = {"per_image": [47, 53, 49, 29], "matched": 178,
                     "failures": ["image 1: matched IoU 0.726, classes 1 / 1"]}

# the float32 rate outside the tensor cores (the stem's FMAs), FLOP/s; the
# memory and int8 rates by card are tools/timing.py's
F32_RATE = 67e12


def log(*a):
    print(*a, flush=True)


def kernel_counts(since=None, *names, kind="launches"):
    """{kernel: n} of utils/tracing.COUNTS' `<kernel>_kernel_<kind>`
    counters (kind "launches" or "builds"), for the kernels whose name
    starts with one of `names` (default: every kernel), less `since` (an
    earlier kernel_counts() of every kernel): what ran since then, zeros
    left out."""
    from yogo_tpu_torch.utils.tracing import COUNTS

    suffix, since, out = f"_kernel_{kind}", since or {}, {}
    for key, n in list(COUNTS.items()):
        name = key[: -len(suffix)]
        if key.endswith(suffix) and name.startswith(names or "") and n > since.get(name, 0):
            out[name] = n - since.get(name, 0)
    return out


def train_phase(dev, imgs4, boxes4, smi, *, batch=TIMING_BATCH, steps=30, small_batch=16,
                ckpt=CKPT, model_version="base_model"):
    """Phase 6: the training step on `dev`. Returns (numbers for the
    report, stem launches of the reload-and-count step). Every check
    raises."""
    from yogo_tpu_torch.infer import Predictor
    from yogo_tpu_torch.losses import yogo_loss
    from yogo_tpu_torch.models.yogo import YOGO, no_tf32
    from yogo_tpu_torch.ops.grid import encode_label_grid_np
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
    mark = kernel_counts()
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
    launches = kernel_counts(mark, "stem")
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


def png_gray_bytes(arr: np.ndarray) -> bytes:
    """An (H, W) uint8 array as an 8-bit grayscale PNG (filter type 0 on
    every row, zlib level 1), with the standard library only."""
    import struct
    import zlib

    h, w = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr], axis=1).tobytes()

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 1))
        + chunk(b"IEND", b"")
    )


def write_png_gray(path: Path, arr: np.ndarray) -> None:
    path.write_bytes(png_gray_bytes(arr))


def write_dataset(root: Path, n: int, hw) -> Path:
    """n distinct frames of the golden generator (seeds 1000, 1001, ...) as
    PNGs with YOLO label files from the generator's own rectangles, and a
    definition (JSON text in a .yml, which PyYAML reads too) that splits
    them 0.6 / 0.2 / 0.2."""
    img_dir, lbl_dir = root / "images", root / "labels"
    img_dir.mkdir(parents=True)
    lbl_dir.mkdir()
    for i in range(n):
        imgs, boxes = gen_golden_images(1, seed=1000 + i, hw=hw)
        write_png_gray(img_dir / f"frame_{i:04d}.png", imgs[0, 0])
        rows = [
            f"{int(c)} {(x1 + x2) / 2:.6f} {(y1 + y2) / 2:.6f} {x2 - x1:.6f} {y2 - y1:.6f}"
            for c, x1, y1, x2, y2 in boxes[0].tolist()
        ]
        (lbl_dir / f"frame_{i:04d}.txt").write_text("\n".join(rows))
    defn = root / "defn.yml"
    defn.write_text(json.dumps({
        "class_names": ["cell", "parasite"],
        "dataset_paths": {"smoke": {"image_path": str(img_dir), "label_path": str(lbl_dir)}},
        "dataset_split_fractions": {"train": 0.6, "val": 0.2, "test": 0.2},
    }))
    return defn


def busy_share(trace: dict, span: str):
    """(window ms, device-busy ms, share) of the first profiler span named
    `span` in a chrome trace of torch.profiler: the union of the kernels
    and copies (whatever their stream) that lie inside the span's host
    window. The device-side mirrors of host annotations
    ("gpu_user_annotation") are not device work and are left out."""
    events = trace["traceEvents"]
    window = next((e for e in events if e.get("cat") == "user_annotation" and e["name"] == span), None)
    if window is None:
        raise AssertionError(f"the trace holds no span {span!r}")
    start, end = window["ts"], window["ts"] + window["dur"]
    spans = sorted(
        (max(e["ts"], start), min(e["ts"] + e["dur"], end))
        for e in events
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
        and e["ts"] + e["dur"] > start and e["ts"] < end
    )
    busy, edge = 0.0, start
    for a, b in spans:
        if b > edge:
            busy += b - max(a, edge)
            edge = b
    if busy <= 0:
        raise AssertionError(f"the trace holds no device time inside {span!r}")
    return (end - start) / 1e3, busy / 1e3, busy / (end - start), len(spans)


def cli_phase(device_arg, *, hw=HW, n_frames=320, batch=TIMING_BATCH, model_version=None,
              golden_ckpt=CKPT, probe=True, data_dir=None):
    """Phase 7: `train`, `train --resume`, `test` with both metrics engines,
    a decode-path epoch and `infer --count`, each through
    yogo_tpu_torch.__main__.main(argv) as a user would call it. device_arg
    None runs on the card; "cpu" is for rehearsing the control flow at a
    small size. The stem's launch counts are set to 0 at the start and read
    after every command: `train` and `test` must launch it no time (their
    forward takes the plain stem, as in the JAX package), `infer` at least
    once. The dataset is written under `data_dir` when given (phase 14
    trains on it again), else in the phase's own directory. Returns
    (numbers for the report, stem launches by command). Every check
    raises."""
    import pickle

    from yogo_tpu_torch.__main__ import main as cli
    from yogo_tpu_torch.data.definition import DatasetDefinition
    from yogo_tpu_torch.data.loader import get_dataloader
    from yogo_tpu_torch.data.prefetch import prefetch_to_device
    from yogo_tpu_torch.metrics import DeviceMetrics, Metrics
    from yogo_tpu_torch.metrics import device_metrics as dm
    from yogo_tpu_torch.models.yogo import resolve_device
    from yogo_tpu_torch.ops.postprocess import format_preds_batched
    from yogo_tpu_torch.train import make_eval_step, make_optimizer
    from yogo_tpu_torch.utils.checkpoint import load_checkpoint
    from yogo_tpu_torch.utils.default_hyperparams import DefaultHyperparams as df
    from yogo_tpu_torch.utils.msgpack_lite import unpackb
    from yogo_tpu_torch.utils.weights import state_dict_from_flax

    out = {}
    by_command, int8_by_command = {}, {}
    mark = [kernel_counts()]

    def launches_of(command, *, stem, int8=False):
        """Book the stem's and the int8 conv's launches since the last call
        under `command`; each must have launched iff expected."""
        by_command[command] = kernel_counts(mark[0], "stem")
        int8_by_command[command] = kernel_counts(mark[0], "int8_conv").get("int8_conv", 0)
        mark[0] = kernel_counts()
        if stem != bool(by_command[command]) or int8 != bool(int8_by_command[command]):
            raise AssertionError(f"launches in `{command}`: stem {by_command[command]}, int8 conv "
                                 f"{int8_by_command[command]}; expected stem {stem}, int8 {int8}")

    dev = resolve_device(device_arg)
    on_card = dev.type == "cuda"
    dev_flags = [] if device_arg is None else ["--device", device_arg]

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def wall(fn):
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, time.perf_counter() - t0

    if probe:
        def has(mod):
            try:
                __import__(mod)
                return True
            except ImportError:
                return False

        from yogo_tpu_torch import native

        out["probe"] = {
            "yaml": has("yaml"), "PIL": has("PIL"), "wandb": has("wandb"),
            "g++": subprocess.run(["sh", "-c", "command -v g++"], capture_output=True).returncode == 0,
            "png.h": Path("/usr/include/png.h").exists(),
            "jpeglib.h": Path("/usr/include/jpeglib.h").exists(),
            "native_host_library": native.available(),
        }
        log("probe: " + json.dumps(out["probe"]))

    cwd = os.getcwd()
    tmp_ctx = tempfile.TemporaryDirectory()
    tmp = Path(tmp_ctx.name)
    try:
        os.chdir(tmp)
        # ------------------------------------------------------------- data
        data = Path(data_dir or tmp / "data")
        defn, secs = wall(lambda: write_dataset(data, n_frames, hw))
        n_train, n_val, n_test = (int(round(f * n_frames)) for f in (0.6, 0.2, 0.2))
        steps_per_epoch = -(-n_train // batch)
        out["dataset"] = {"frames": n_frames, "hw": list(hw), "write_s": secs,
                          "split": [n_train, n_val, n_test]}
        size = ["--image-hw", str(hw[0]), str(hw[1])]
        common = [str(defn), "--batch-size", str(batch), "--half", "--no-wandb", *size, *dev_flags]
        if model_version:
            common += ["--model", model_version]
        cache = str(tmp / "packed")

        def records(run):
            lines = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
            return ([r for r in lines if "train loss" in r], [r for r in lines if "val loss" in r],
                    [r["_summary"] for r in lines if "_summary" in r])

        # ------------------------------------------------- train, 5 epochs
        epochs = 5
        _, secs = wall(lambda: cli(["train", *common, "--epochs", str(epochs),
                                    "--packed-cache", cache, "--name", "smoke"]))
        launches_of("train", stem=False)
        run = tmp / "trained_models" / "smoke"
        train_recs, val_recs, summaries = records(run)
        if [r["step"] for r in train_recs] != list(range(1, epochs * steps_per_epoch + 1)):
            raise AssertionError(f"metrics.jsonl steps: {[r['step'] for r in train_recs]}")
        logged = [r[k] for r in train_recs for k in ("train loss", "iou_loss", "objectness_loss",
                                                       "classification_loss")]
        logged += [r["val loss"] for r in val_recs]
        if not all(np.isfinite(logged)):
            raise AssertionError(f"non-finite logged loss: {logged}")
        by_epoch = [float(np.mean([r["train loss"] for r in train_recs if r["epoch"] == e]))
                    for e in range(epochs)]
        if not by_epoch[-1] < by_epoch[0]:
            raise AssertionError(f"mean train loss by epoch did not fall: {by_epoch}")
        if len(val_recs) != 2 or not (run / "best.ckpt").exists():
            raise AssertionError(f"validation records {val_recs}, files {sorted(os.listdir(run))}")
        _, _, meta = load_checkpoint(run / "latest.ckpt")
        if meta["next_epoch"] != epochs or meta["step"] != epochs * steps_per_epoch:
            raise AssertionError(f"latest.ckpt: next_epoch {meta['next_epoch']}, step {meta['step']}")
        if len(summaries) != 1 or not np.isfinite(summaries[0]["test loss"]):
            raise AssertionError(f"post-train test summary: {summaries}")
        config = json.loads((run / "config.json").read_text())
        out["train"] = {
            "command_s": secs, "epochs": epochs, "steps_per_epoch": steps_per_epoch,
            "mean_train_loss_by_epoch": by_epoch,
            "val_losses": [r["val loss"] for r in val_recs],
            "images_per_sec_by_epoch": [
                [r["images/sec"] for r in train_recs if r["epoch"] == e][-1] for e in range(epochs)],
            "test_loss": summaries[0]["test loss"],
            "test_total_true_objects": summaries[0]["total num true objects"],
            "config_device": config["device"], "torch_version": config["torch-version"],
        }
        log(f"cli train {epochs} epochs B={batch}: {secs:.1f} s, mean train loss by epoch "
            f"{[round(v, 4) for v in by_epoch]}, val {out['train']['val_losses']}, images/sec by "
            f"epoch {[round(v, 1) for v in out['train']['images_per_sec_by_epoch']]}, "
            f"device {config['device']!r}")

        # ---- resume in place, one more epoch each time: traced, then not
        from torch.profiler import ProfilerActivity, profile

        out["resume"] = {}
        n_summaries = 1
        for label in ("traced", "untraced"):
            epoch = epochs
            epochs += 1
            total = epochs * steps_per_epoch
            argv = ["train", *common, "--epochs", str(epochs), "--packed-cache", cache, "--resume",
                    "--from-pretrained", str(run / "latest.ckpt")]
            prof = None
            if label == "traced":
                acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
                with profile(activities=acts) as prof:
                    _, secs = wall(lambda: cli(argv))
            else:
                _, secs = wall(lambda: cli(argv))
            launches_of(f"train --resume ({label})", stem=False)
            n_summaries += 1
            train_recs, val_recs, summaries = records(run)
            new = [r for r in train_recs if r["step"] > epoch * steps_per_epoch]
            if [r["step"] for r in new] != list(range(epoch * steps_per_epoch + 1, total + 1)) or \
                    any(r["epoch"] != epoch for r in new):
                raise AssertionError(f"resumed records: {[(r['step'], r['epoch']) for r in new]}")
            # the restored optimizer count: the schedule runs on the saved clock
            # (its horizon is this run's --epochs)
            _, _, host_schedule = make_optimizer(
                [torch.nn.Parameter(torch.zeros(1))], df.LEARNING_RATE, df.WEIGHT_DECAY,
                df.DECAY_FACTOR, total)
            for r in new:
                if not np.isclose(r["LR"], host_schedule(r["step"]), rtol=1e-9):
                    raise AssertionError(f"resumed LR at step {r['step']}: {r['LR']} vs "
                                         f"{host_schedule(r['step'])}")
            _, _, meta = load_checkpoint(run / "latest.ckpt")
            counts = unpackb(meta["_opt_state_bytes"])["1"]
            counts = (int(counts["0"]["count"]), int(counts["2"]["count"]))  # AdamW, schedule
            if meta["next_epoch"] != epochs or meta["step"] != total or len(summaries) != n_summaries \
                    or counts != (total, total):
                raise AssertionError(f"after resume: next_epoch {meta['next_epoch']}, step {meta['step']}, "
                                     f"{len(summaries)} summaries, optimizer counts {counts}")
            if not all(np.isfinite([r["train loss"] for r in new])):
                raise AssertionError(f"resumed losses: {new}")
            out["resume"][label] = {"command_s": secs, "epoch": epoch, "steps": [r["step"] for r in new],
                                    "train_losses": [r["train loss"] for r in new],
                                    "images_per_sec": new[-1]["images/sec"]}
            if prof is not None and on_card:
                prof.export_chrome_trace(str(tmp / "resume_trace.json"))
                trace = json.loads((tmp / "resume_trace.json").read_text())
                spans = {}
                for span in ("yogo/train_epoch", "yogo/checkpoint", "yogo/test"):
                    w_ms, b_ms, share, n = busy_share(trace, span)
                    spans[span] = {"window_ms": w_ms, "device_busy_ms": b_ms, "busy_share": share,
                                   "device_events": n}
                out["resume"][label]["profiler_spans"] = spans
                del trace
            del prof
        log("cli resume, in place, LR and optimizer counts on the saved clock: " + json.dumps(out["resume"]))

        # ------------------------------------------ test with both engines
        engines = {}
        for name, flag in (("device", "--fast-eval"), ("host", "--no-fast-eval")):
            for attempt in ("cold", "warm"):
                _, secs = wall(lambda: cli(["test", str(run / "best.ckpt"), str(defn), flag,
                                            "--include-mAP", "--dump-to-disk",
                                            "--packed-cache", cache, *dev_flags]))
                engines.setdefault(name, {})[f"command_s_{attempt}"] = secs
            launches_of(f"test {flag}", stem=False)
            with open("test_metrics.pkl", "rb") as f:
                engines[name]["metrics"] = pickle.load(f)
        md, mh = engines["device"]["metrics"], engines["host"]["metrics"]
        for i, what in ((2, "confusion"), (8, "missed"), (9, "extra"), (10, "total true objects")):
            if not np.array_equal(np.asarray(md[i]), np.asarray(mh[i])):
                raise AssertionError(f"test {what}: device engine {md[i]} vs host engine {mh[i]}")
        if not np.isclose(md[0], mh[0], rtol=1e-6) or not np.isfinite(md[0]):
            raise AssertionError(f"test loss: {md[0]} vs {mh[0]}")
        out["test_best_ckpt"] = {
            "loss": md[0], "confusion": np.asarray(md[2]).tolist(),
            "missed": np.asarray(md[8]).tolist(), "extra": np.asarray(md[9]).tolist(),
            "total_true_objects": int(md[10][0]), "mAP_device": md[1]["map"], "mAP_host": mh[1]["map"],
            **{f"{n}_engine_{k}": v for n, e in engines.items() for k, v in e.items() if k != "metrics"},
        }
        log("cli test best.ckpt, device engine == host engine: " + json.dumps(out["test_best_ckpt"]))

        # ---- test --quantize: the int8 program of `infer --quantize`,
        # calibrated on the first test batch; the stem launches no time (the
        # batch is cast to f32 first, as the float path casts it)
        _, secs = wall(lambda: cli(["test", str(run / "best.ckpt"), str(defn), "--quantize", "--fast-eval",
                                    "--include-mAP", "--dump-to-disk", "--packed-cache", cache, *dev_flags]))
        launches_of("test --quantize", stem=False, int8=on_card)
        with open("test_metrics.pkl", "rb") as f:
            mq = pickle.load(f)
        if not (np.isfinite(mq[0]) and np.isfinite(mq[1]["map"])):
            raise AssertionError(f"test --quantize: loss {mq[0]}, mAP {mq[1]['map']}")
        out["test_quantize"] = {
            "command_s": secs, "loss": mq[0], "mAP": mq[1]["map"], "confusion": np.asarray(mq[2]).tolist(),
            "missed": np.asarray(mq[8]).tolist(), "extra": np.asarray(mq[9]).tolist(),
            "bf16_loss": md[0], "bf16_mAP": md[1]["map"],
            "int8_conv_launches": int8_by_command["test --quantize"],
        }
        log("cli test --quantize best.ckpt: " + json.dumps(out["test_quantize"]))

        # ---- the engines on real detections: the trained golden checkpoint
        # over the same test split (its classes are the generator's)
        if golden_ckpt is not None and tuple(hw) == HW:
            model, variables, _ = load_checkpoint(golden_ckpt)
            model = model.with_compute_dtype(torch.bfloat16)
            stack = model.module(dev)
            stack.load_state_dict(state_dict_from_flax(variables), strict=True)
            sx, sy = model.grid
            loader = get_dataloader(DatasetDefinition.from_yaml(defn), batch, Sx=sx, Sy=sy,
                                    image_hw=hw, packed_cache=cache)["test"]
            eval_step = make_eval_step(model, dict(
                no_obj_weight=df.NO_OBJ_WEIGHT, iou_weight=df.IOU_WEIGHT,
                classify_weight=df.CLASSIFY_WEIGHT, label_smoothing=df.LABEL_SMOOTHING))
            imgs, labels, mask = next(iter(prefetch_to_device(loader, dev)))
            _, preds = eval_step(stack, imgs, labels, mask)
            classes = ["cell", "parasite"]

            def timed(fn, reps=7):
                fn()
                ts = [wall(fn)[1] * 1e3 for _ in range(reps)]
                return statistics.median(ts)

            # one DeviceMetrics.update on the card against the CPU: the
            # integer state must be equal, the lone float sum close
            states = {}
            for where in (dev, torch.device("cpu")):
                m = DeviceMetrics(classes, device=where, include_background=True)
                m.update(preds.to(where), labels.to(where), image_mask=mask.to(where))
                states[where.type] = {k: v.cpu() for k, v in m._state.items()}
            for k, v in states["cpu"].items():
                got = states[dev.type][k]
                if v.is_floating_point():
                    torch.testing.assert_close(got, v, rtol=1e-5, atol=1e-5, msg=lambda m, k=k: f"{k}: {m}")
                elif not torch.equal(got, v):
                    raise AssertionError(f"DeviceMetrics state {k}: card != CPU")
            engines = {}
            for name, m in (("device", DeviceMetrics(classes, device=dev, include_background=False)),
                            ("host", Metrics(classes, include_background=False))):
                m.update(preds, labels, image_mask=mask)
                res = m.compute()
                m.reset()
                engines[name] = {
                    "confusion": res[1].tolist(), "missed": res[7].tolist(), "extra": res[8].tolist(),
                    "total_true_objects": int(res[9][0]), "mAP": float(res[0]["map"]),
                    "update_ms": timed(lambda m=m: m.update(preds, labels, image_mask=mask)),
                }
            # NMS-filtered detections of a trained net: greedy and Hungarian agree
            for k in ("confusion", "missed", "extra", "total_true_objects"):
                if engines["device"][k] != engines["host"][k]:
                    raise AssertionError(f"{k} differs between the engines on the trained golden "
                                         f"checkpoint: {engines}")
            if engines["device"]["total_true_objects"] == 0 or not np.any(engines["device"]["confusion"]):
                raise AssertionError(f"the golden checkpoint matched nothing: {engines}")
            forward_ms = timed(lambda: eval_step(stack, imgs, labels, mask))
            # the greedy loop alone, for both designs, on this batch
            dets = format_preds_batched(preds.float(), min_class_confidence_threshold=0.9,
                                        max_detections=256, image_mask=mask)
            flat = labels.reshape(batch, 6, -1).transpose(1, 2)
            key = (flat[..., 0] > 0.5).float() * 2.0 - torch.arange(
                flat.shape[1], device=dev, dtype=torch.float32) / flat.shape[1]
            gt = torch.gather(flat, 1, torch.topk(key, 256, dim=1)[1][..., None].expand(-1, -1, 6))
            iou = dm._batched_box_iou(dets["boxes_xyxy"].float(), gt[..., 1:5].float())
            iou = torch.where(torch.isfinite(iou), iou, 0.0)
            gt_valid = gt[..., 0] > 0.5

            def fixed_rounds():
                """The other loop design: min(K, G) rounds, the host never asks."""
                iou_w, partner, taken = dm._match_state(iou, dets["valid"], gt_valid)
                for _ in range(min(iou.shape[1:])):
                    dm._greedy_round(iou_w, partner, taken)
                return dm._pair_remainder(partner, taken, dets["valid"], gt_valid)

            want = dm.greedy_match(iou, dets["valid"], gt_valid)
            if not all(torch.equal(a, b) for a, b in zip(fixed_rounds(), want)):
                raise AssertionError("greedy_match: the fixed-rounds loop pairs differently")
            loops = {
                "sync_every_round_ms": timed(lambda: dm.greedy_match(iou, dets["valid"], gt_valid)),
                "fixed_rounds_ms": timed(fixed_rounds),
                "fixed_rounds": min(iou.shape[1:]),
                "matched_pairs_max_per_image": int((want[0] >= 0).sum(dim=1).max()),
            }
            out["golden_ckpt_eval"] = {
                "batch": batch, "detections": int(dets["valid"].sum()), "labels": int(gt_valid.sum()),
                "engines": engines, "engines_equal": True,
                "forward_ms": forward_ms,
                "eval_img_per_s": {n: batch / (forward_ms + e["update_ms"]) * 1e3
                                   for n, e in engines.items()},
                "greedy_match": loops,
                "device_metrics_state_card_equals_cpu": True,
            }
            log("golden checkpoint on the test split, both engines: " + json.dumps(out["golden_ckpt_eval"]))
            del stack, preds, imgs, labels, mask, iou, dets

        # ------------------------------------- loader rates, host only
        sx, sy = load_checkpoint(run / "best.ckpt")[0].grid
        rates = {}
        for name, pc in (("png_decode", None), ("packed_cache", cache)):
            loader = get_dataloader(DatasetDefinition.from_yaml(defn), batch, Sx=sx, Sy=sy,
                                    image_hw=hw, packed_cache=pc)["train"]
            t0 = time.perf_counter()
            n = sum(int(m.sum()) for _, _, m in loader)
            rates[name + "_img_per_s"] = n / (time.perf_counter() - t0)
        out["loader_host_only"] = rates
        log("loader, host only (train split, one epoch): " + json.dumps(rates))

        # ----------------------------------- one epoch on the decode path
        _, secs = wall(lambda: cli(["train", *common, "--epochs", "1", "--name", "decode"]))
        launches_of("train (png decode)", stem=False)
        recs, _, sums = records(tmp / "trained_models" / "decode")
        if len(recs) != steps_per_epoch or not all(np.isfinite([r["train loss"] for r in recs])) \
                or len(sums) != 1:
            raise AssertionError(f"decode-path epoch: {recs}")
        out["decode_epoch"] = {"command_s": secs, "images_per_sec": recs[-1]["images/sec"],
                               "train_losses": [r["train loss"] for r in recs]}
        log("cli train 1 epoch without the packed cache: " + json.dumps(out["decode_epoch"]))

        # ------- infer --count: the checkpoint just trained, and the golden one
        import ast
        import contextlib
        import io

        test_dir = tmp / "test_frames"
        test_dir.mkdir()
        n_labels = 0
        for i in range(8):
            os.link(data / "images" / f"frame_{i:04d}.png", test_dir / f"frame_{i:04d}.png")
            n_labels += len((data / "labels" / f"frame_{i:04d}.txt").read_text().splitlines())
        out["infer_count"] = {"frames": 8, "labels": n_labels}
        ckpts = {"best.ckpt": run / "best.ckpt"}
        if golden_ckpt is not None and tuple(hw) == HW:
            ckpts["golden"] = golden_ckpt
        for name, ckpt in ckpts.items():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli(["infer", str(ckpt), "--path-to-images", str(test_dir), "--count",
                     "--half", "--batch-size", str(batch), "--no-use-tqdm", *dev_flags])
            launches_of(f"infer {name}", stem=on_card)
            printed = buf.getvalue().strip().splitlines()[-1]
            counts = dict(ast.literal_eval(printed))
            out["infer_count"][name] = {"printed": printed, "stem_launches": by_command[f"infer {name}"]}
            log(f"cli infer --count on {name}: {printed} ({n_labels} labels in these frames); "
                f"stem launches {by_command[f'infer {name}']}")
            if sorted(counts) != ["cell", "parasite"] or not all(isinstance(v, int) for v in counts.values()):
                raise AssertionError(f"infer --count on {name} printed {printed!r}")
            # the trained golden net finds the generator's rectangles (the
            # metrics engines above see it miss ~6% of the labels): the count
            # is within a tenth of the labelled objects
            if name == "golden" and abs(sum(counts.values()) - n_labels) > 0.1 * n_labels:
                raise AssertionError(f"infer --count on the golden checkpoint: {printed} for "
                                     f"{n_labels} labelled objects")

        # ---- infer artifacts: --fetch-top-k 512 (candidates), 16 (every
        # frame's full slice) and 0 (full tensors) write the same files, byte
        # for byte; --draw-boxes draws every frame
        art_ckpt = ckpts.get("golden", run / "best.ckpt")
        arts, files = {}, {}
        for k in (512, 16, 0):
            odir = tmp / f"artifacts_k{k}"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                _, secs = wall(lambda: cli([
                    "infer", str(art_ckpt), "--path-to-images", str(test_dir), "--save-preds",
                    "--save-npy", "--count", "--half", "--batch-size", str(batch), "--fetch-top-k",
                    str(k), "--output-dir", str(odir), "--no-use-tqdm", *dev_flags]))
            command = f"infer --save-preds --save-npy --fetch-top-k {k}"
            launches_of(command, stem=on_card)
            files[k] = {p.name: p.read_bytes() for p in sorted(odir.iterdir())}
            sidecar = next(n for n in files[k] if n.endswith(".json"))
            meta = json.loads(files[k].pop(sidecar))
            meta.pop("write_date")
            arts[k] = {"printed": buf.getvalue().strip().splitlines()[-1], "command_s": secs,
                       "files": len(files[k]), "sidecar": meta, "stem_launches": by_command[command]}
        n_txt = sum(n.endswith(".txt") for n in files[0])
        if n_txt != 8 or sum(n.endswith(".npy") for n in files[0]) != 1:
            raise AssertionError(f"infer artifacts: {sorted(files[0])}")
        for k in (512, 16):
            if files[k] != files[0] or arts[k]["printed"] != arts[0]["printed"] \
                    or arts[k]["sidecar"] != arts[0]["sidecar"]:
                diff = sorted(n for n in files[0] if files[k].get(n) != files[0][n])
                raise AssertionError(f"infer --fetch-top-k {k} differs from full tensors: {diff}, "
                                     f"{arts[k]['printed']} vs {arts[0]['printed']}")
        draw_dir = tmp / "drawn"
        _, secs = wall(lambda: cli(["infer", str(art_ckpt), "--path-to-images", str(test_dir),
                                    "--draw-boxes", "--half", "--batch-size", str(batch),
                                    "--output-dir", str(draw_dir), "--no-use-tqdm", *dev_flags]))
        launches_of("infer --draw-boxes", stem=on_card)
        drawn = sorted(p.name for p in draw_dir.iterdir())
        if drawn != sorted(p.name for p in test_dir.iterdir()):
            raise AssertionError(f"infer --draw-boxes wrote {drawn}")
        arts["draw_boxes"] = {"command_s": secs, "images": len(drawn)}
        out["infer_artifacts"] = {"checkpoint": art_ckpt.name, "byte_equal_512_16_0": True,
                                  **{str(k): v for k, v in arts.items()}}
        log("cli infer artifacts, files byte-equal for --fetch-top-k 512 / 16 / 0: "
            + json.dumps(out["infer_artifacts"]))
        out["stem_launches_by_command"] = by_command
        out["int8_conv_launches_by_command"] = int8_by_command
        log("stem launches by command: " + json.dumps(by_command))
        log("int8 conv launches by command: " + json.dumps(int8_by_command))
        return out, by_command
    finally:
        os.chdir(cwd)
        tmp_ctx.cleanup()


def serve_phase(device_arg, imgs4, *, ckpt=CKPT, want_per_image=None, batches=(8, 64),
                load_s=10.0, threads=None, fetch_top_k=512):
    """Phase 8: `serve` on `ckpt`, bf16, one server per micro-batch size in
    `batches`, each in a thread on port 0, driven through the port's
    ServeClient and raw HTTP as a camera client would. device_arg None runs
    on the card; "cpu" rehearses the control flow. The stem's launch counts
    are set to 0 just before each server is built and read after it is shut
    down. Returns (numbers for the report, stem launches by batch size).
    Every check raises."""
    import threading
    import urllib.error
    import urllib.request

    from torch.profiler import ProfilerActivity, profile, record_function

    from yogo_tpu_torch import kernels
    from yogo_tpu_torch.infer import Predictor
    from yogo_tpu_torch.models.yogo import resolve_device
    from yogo_tpu_torch.serve import build_server, format_detections
    from yogo_tpu_torch.serve_client import ServeClient
    from yogo_tpu_torch.tools import serve_load

    dev = resolve_device(device_arg)
    on_card = dev.type == "cuda"
    threads = threads or {8: 32, 64: 64}
    frames = [np.ascontiguousarray(f) for f in imgs4]  # (1, H, W) uint8 each
    n = len(frames)
    thr = {"obj_thresh": 0.5, "iou_thresh": 0.5, "min_class_confidence_threshold": 0.0}
    ref = Predictor.from_checkpoint(ckpt, half=True, device=dev)
    classes = list(ref.meta.get("class_names") or ref.meta.get("classes"))
    out, launches = {}, {}

    def post(port, body, path="/predict", ctype=None):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST",
                                     headers={"Content-Type": ctype} if ctype else {})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, dict(r.headers), json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), json.loads(e.read())

    def serving(**kw):
        srv = build_server(ckpt, port=0, half=True, device=dev, fetch_top_k=fetch_top_k, **kw)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()

        def stop():
            srv.shutdown()
            srv.yogo_batcher.shutdown()
            srv.server_close()
            th.join(timeout=30)

        return srv, stop

    for bsz in batches:
        # the host formatter over Predictor.forward of batches of the
        # server's shape: the frames in the first slots, zero frames after
        decoded = []
        for i in range(0, n, bsz):
            x = np.zeros((bsz, *frames[0].shape), np.uint8)
            x[: len(frames[i:i + bsz])] = np.stack(frames[i:i + bsz])
            decoded += list(ref.forward(x)[: len(frames[i:i + bsz])].cpu().numpy())
        want = [format_detections(d, classes, **thr) for d in decoded]
        # half the K-th objectness of frame 0: more than K cells pass, so
        # the candidates cannot prove the answer and the full slice serves it
        kth = float(np.sort(decoded[0][4].ravel())[-fetch_top_k])
        low = dict(thr, obj_thresh=kth / 2)
        want_low = format_detections(decoded[0], classes, **low)

        mark = kernel_counts()
        t0 = time.perf_counter()
        srv, stop = serving(batch_size=bsz, linger_ms=5.0)
        rep = {"build_and_warmup_s": time.perf_counter() - t0, "client_threads": threads[bsz]}
        try:
            port = srv.server_address[1]
            with ServeClient("127.0.0.1", port, timeout=120) as c:
                raw_single = [c.predict(f) for f in frames]
                raw_batch = c.predict_many(np.stack(frames))
                png = [post(port, png_gray_bytes(f[0]))[2] for f in frames]
                m0 = c.metrics()
                got_low = c.predict(frames[0], **low)
                m1 = c.metrics()
            per_image = [sum(r["counts"].values()) for r in raw_single]
            for name, got in (("raw frames", raw_single), ("one raw batch request", raw_batch),
                              ("PNG", png)):
                if got != want:
                    bad = [i for i in range(n) if got[i] != want[i]]
                    raise AssertionError(f"serve B={bsz}: {name} differ from the host formatter over "
                                         f"Predictor.forward on frames {bad}")
            if want_per_image is not None and any(
                    abs(a - b) > 2 for a, b in zip(per_image, want_per_image)):
                raise AssertionError(f"serve B={bsz}: per-image counts {per_image} vs golden {want_per_image}")
            fallbacks = m1["full_fetch_fallbacks"] - m0["full_fetch_fallbacks"]
            if fallbacks != 1:
                raise AssertionError(f"serve B={bsz}: obj_thresh {low['obj_thresh']} took {fallbacks} "
                                     "fallbacks, not 1")
            if got_low != want_low:
                raise AssertionError(f"serve B={bsz}: obj_thresh {low['obj_thresh']} differs from the "
                                     "host formatter")
            rep.update(per_image=per_image, per_class={k: sum(r["counts"][k] for r in raw_single)
                                                       for k in classes},
                       low_thresh=low["obj_thresh"], low_thresh_detections=len(got_low["detections"]),
                       low_thresh_fallbacks=fallbacks,
                       paths_bit_equal=True)

            # ---- load: client threads, in processes of their own, stream
            # raw single frames; a hot reload of the same checkpoint lands
            # in the middle of the measured window
            builds0, loaded0 = kernel_counts(kind="builds"), dict(kernels._loaded)
            pred0 = srv.yogo_state["predictor"]
            profiled = on_card and bsz == max(batches)
            profile_s = 2.0  # the clients stream on through the profiler's window

            def busy_under_load():  # the device-busy share of a window under the same load
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    with record_function("yogo/serve_load"):
                        time.sleep(profile_s * 0.8)
                trace_path = Path(tempfile.gettempdir()) / f"serve_trace_{os.getpid()}.json"
                prof.export_chrome_trace(str(trace_path))
                w_ms, b_ms, share, n_ev = busy_share(json.loads(trace_path.read_text()),
                                                     "yogo/serve_load")
                trace_path.unlink()
                return {"window_ms": w_ms, "device_busy_ms": b_ms, "busy_share": share,
                        "device_events": n_ev}

            load = serve_load.measure(port, frames, want, threads=threads[bsz], seconds=load_s,
                                      midway=srv.reload_checkpoint,
                                      after=busy_under_load if profiled else None,
                                      after_s=profile_s if profiled else 0.0)
            reload, errors, busy = load.pop("midway"), load.pop("errors"), load.pop("after", None)
            if not reload["ok"] or srv.yogo_state["predictor"] is pred0:
                raise AssertionError(f"serve B={bsz}: hot reload failed: {reload}")
            if kernel_counts(builds0, kind="builds") or dict(kernels._loaded) != loaded0:
                raise AssertionError(f"serve B={bsz}: the reload rebuilt or reloaded a kernel")
            if errors or not load["requests_in_window"]:
                raise AssertionError(f"serve B={bsz}: {len(errors)} errors under load: {errors[:5]}")
            rep["load"] = {**load, "errors": 0, "reload": reload, "device_busy_under_load": busy}
        finally:
            stop()
        launches[bsz] = kernel_counts(mark, "stem")
        rep["stem_launches"] = launches[bsz]
        if on_card and launches[bsz].get("stem_nhwc", 0) < 1:
            raise AssertionError(f"serve B={bsz}: the NHWC stem kernel was not launched")
        out[f"b{bsz}"] = rep
        log(f"serve B={bsz}: " + json.dumps(rep))

    # ---- overload: a small --max-queue sheds whole batch requests with 503
    srv, stop = serving(batch_size=8, linger_ms=20.0, max_queue=8, max_frames_per_request=8,
                        pipeline_depth=1)
    try:
        port = srv.server_address[1]
        body = np.concatenate([frames[i % n] for i in range(8)]).tobytes()
        statuses, retry_after = [], set()
        for _ in range(3):
            results = [None] * 24
            ths = [threading.Thread(target=lambda i=i: results.__setitem__(
                i, post(port, body, ctype="application/octet-stream")), daemon=True) for i in range(24)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=150)
            statuses += [r[0] for r in results if r is not None]
            retry_after |= {r[1].get("Retry-After") for r in results if r is not None and r[0] == 503}
            if 503 in statuses:
                break
        after = post(port, frames[0].tobytes(), ctype="application/octet-stream")
        if 503 not in statuses or retry_after != {"1"} or set(statuses) - {200, 503} or after[0] != 200:
            raise AssertionError(f"overload: statuses {sorted(set(statuses))}, Retry-After "
                                 f"{retry_after}, then {after[0]}")
        out["overload"] = {"requests": len(statuses), "shed_503": statuses.count(503),
                           "answered_200": statuses.count(200),
                           "shed_frames": srv.yogo_batcher.stats()["shed_frames"]}
    finally:
        stop()
    log("serve overload (--max-queue 8, 8-frame requests): " + json.dumps(out["overload"]))
    return out, launches


def int8_conv_build_check(sass: dict, sms: int) -> dict:
    """Phase 2 for csrc/int8_conv.cu: every kernel function has tensor-core
    instructions of wgmma (IGMMA) in `sass` (kernels.sass_summary) and
    ptxas reports no spills (kernels.build_log: the same whether this run
    built the library or found it built); with each function's registers,
    stack and static shared memory, and the dynamic shared memory of its
    launch plans at the main path's six timed sites
    (tools/int8_conv_sites.py) on a card of `sms` SMs. Raises if a check
    fails."""
    from yogo_tpu_torch import kernels
    from yogo_tpu_torch.ops import int8_conv as ic
    from yogo_tpu_torch.tools.int8_conv_sites import SITES

    ptxas = kernels.ptxas_summary(kernels.build_log("int8_conv"))
    if "int8_conv" not in sass or not ptxas:
        raise AssertionError("int8_conv: no SASS or ptxas report of its build")
    igmma = {fn: s["igmma"] for fn, s in sass["int8_conv"].items()}
    if not igmma or not all(igmma.values()):
        raise AssertionError(f"int8_conv: kernel functions without IGMMA: {igmma}")
    spills = {fn: (s["spill_stores"], s["spill_loads"]) for fn, s in ptxas.items()
              if s["spill_stores"] or s["spill_loads"]}
    if spills:
        raise AssertionError(f"int8_conv: ptxas reports spills (stores, loads) in {spills}")
    plans = {}
    for site, ((b, h, w, cin), cout, k, stride, act, s8) in SITES.items():
        plan = ic.launch_plan(b, h, w, ic.padded_channels(cin), cout, k, stride, (k - 1) // 2,
                              out_s8=s8, act=act, num_sms=sms)
        plans[site] = {key: getattr(plan, key) for key in (
            "smem_bytes", "block_n", "consumers", "resident_b", "stages", "grid", "tiles", "k_blocks")}
    # SASS names are demangled, ptxas's are not: each by its own
    out = {"igmma": igmma, "ptxas": ptxas, "plans_at_sites": plans}
    regs = [f["registers"] for f in ptxas.values()]
    log(f"int8_conv build: {len(igmma)} kernels, IGMMA in each ({min(igmma.values())}-{max(igmma.values())}), "
        f"registers {min(regs)}-{max(regs)}, no spills; dynamic shared memory at the sites: "
        + json.dumps({k: v["smem_bytes"] for k, v in plans.items()}))
    return out


def int8_phase(device_arg, imgs4, golden, *, batch=TIMING_BATCH, ckpt=CKPT, timing=True,
               serve_load_s=3.0, threads=64):
    """Phase 9: the int8 program (ops/quant.py, csrc/int8_conv.cu) on
    `ckpt`. device_arg None runs on the card; "cpu" rehearses the control
    flow. In order:
      1. the program built by quantize_conv_stack, calibrated on the golden
         frames tiled to `batch`; the kernel against its plain version on
         the codes entering blocks 4, 5 and 6 at B=4 and B=`batch` (int8
         codes and f32 outputs equal) and at odd shapes (C_in 8 / 24 / 256,
         C_out 7, 1x1, a 3x5 image at stride 2, SiLU);
      2. `infer --quantize` through predict(quantize=True, batch_size=4) on
         the 4 golden frames: the gates of tests/test_golden_fullres_int8.py
         against the committed bf16 detections; the stem's and the int8
         conv's launch counts set to 0 just before and read just after,
         both must move;
      3. timing at B=`batch` (timing=True): each quantized block's kernel
         against its plain version, the library route (unfold in f16, int8,
         torch._int_mm, the epilogue in torch ops) and cuDNN's bf16 conv of
         the block; the entry requant; the int8 and bf16 forward_raw; the
         skipped blocks in f32 and in bf16 (time, head difference); the int8
         count path's images/s from host and device batches;
      4. `serve --quantize --calibration-images` at micro-batch `batch`:
         raw frames bit-equal to the host formatter over the server's int8
         Predictor.forward of a batch of the server's shape, golden counts
         +-2, `serve_load_s` of load from `threads` clients with a hot reload
         that recalibrates (zero errors, no kernel built or loaded).
    Returns (numbers for the report, launches by path). Every check raises."""
    import threading

    from yogo_tpu_torch import kernels
    from yogo_tpu_torch.infer import Predictor, predict
    from yogo_tpu_torch.models.yogo import resolve_device
    from yogo_tpu_torch.ops import int8_conv as ic
    from yogo_tpu_torch.ops import quant
    from yogo_tpu_torch.ops.postprocess import format_preds
    from yogo_tpu_torch.serve import build_server, format_detections
    from yogo_tpu_torch.tools import serve_load
    from yogo_tpu_torch.tools.golden_scene import int8_gates

    dev = resolve_device(device_arg)
    on_card = dev.type == "cuda"
    out, launches = {}, {}
    n = len(imgs4)
    big = np.concatenate([imgs4] * (batch // n))

    def sync():
        if on_card:
            torch.cuda.synchronize()

    # ---------------------------------------- 1. the program; kernel vs plain
    sync()
    t0 = time.perf_counter()
    pred = Predictor.from_checkpoint(ckpt, device=dev, quantize=True, calib=[big])
    sync()
    out["quantize_s"] = time.perf_counter() - t0
    qp, model = pred.qp, pred.model
    specs = model.defn.blocks
    qblocks = [1 + j for j, b in enumerate(qp["blocks"]) if "w8" in b]
    if qblocks != [4, 5, 6]:
        raise AssertionError(f"int8 blocks {qblocks}, expected [4, 5, 6] on base_model")

    def block_args(i, codes):
        """The int8 conv call of block i on `codes`: args, kwargs."""
        blk, spec = qp["blocks"][i - 1], specs[i]
        s8 = i + 1 < len(specs) and "w8" in qp["blocks"][i]
        return (codes, blk["w8"], blk["deq"], blk["b"]), dict(
            cin=specs[i - 1].out, stride=spec.stride, padding=spec.padding, act=spec.act,
            out_scale=qp["scales"][i:i + 1] if s8 else None)

    def codes_at(x):
        rec = []
        quant.quantized_forward(model, qp, torch.from_numpy(x).to(dev), decode=False, record=rec)
        return dict(zip(qblocks, rec))

    def check(args, kw, what):
        """Kernel == plain version: int8 codes equal, f32 within 1 ulp of
        the largest value (the same roundings: expected equal)."""
        got = ic.int8_conv(*args, **kw)
        want = ic.int8_conv_reference(*args, **kw)
        sync()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"int8 conv {what}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
        if got.dtype == torch.int8:
            err = float((got.int() - want.int()).abs().max())
            if err:
                raise AssertionError(f"int8 conv {what}: codes differ by up to {err}")
        else:
            err = float((got - want).abs().max())
            if err > float(np.spacing(np.float32(want.abs().max().item()))):
                raise AssertionError(f"int8 conv {what}: f32 output off by {err}")
        return err

    errs = {}
    for bsz in (n, batch):
        codes = codes_at(big[:bsz])
        for i, q in codes.items():
            args, kw = block_args(i, q.contiguous())
            errs[f"block{i}_b{bsz}"] = check(args, kw, f"block {i} B={bsz}")
        del codes
    rng = np.random.default_rng(0)
    for name, (b, h, w, cin, cout, k, s, act, s8) in {
        "cin8_s1": (2, 9, 11, 8, 16, 3, 1, "leaky_relu", True),
        "cin24_cout7_s2": (2, 9, 11, 24, 7, 3, 2, "leaky_relu", False),
        "cin256_1x1": (2, 6, 9, 256, 8, 1, 1, None, False),
        "3x5_s2_silu": (3, 3, 5, 40, 40, 3, 2, "silu", True),
        "cin384_cout384": (2, 17, 33, 384, 384, 3, 1, "silu", False),
    }.items():
        x = rng.integers(-127, 128, (b, h, w, cin)).astype(np.int8)
        cp = ic.padded_channels(cin)
        q = torch.from_numpy(np.pad(x, ((0, 0), (0, 0), (0, 0), (0, cp - cin)))).to(dev)
        w8 = ic.pack_weights(rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)).to(dev)
        deq = torch.from_numpy(rng.uniform(1e-4, 1e-2, cout).astype(np.float32)).to(dev)
        bias = torch.from_numpy(rng.normal(0, 0.5, cout).astype(np.float32)).to(dev)
        kw = dict(cin=cin, stride=s, padding=(k - 1) // 2, act=act,
                  out_scale=torch.tensor([0.05], device=dev) if s8 else None)
        errs[name] = check((q, w8, deq, bias), kw, name)
    out["max_abs_err"] = max(errs.values())
    out["max_abs_err_by_case"] = errs
    log(f"int8_conv vs plain: max abs err {out['max_abs_err']} over {list(errs)}")

    # ----------------------------------- 2. infer --quantize, golden scene
    tmp_ctx = tempfile.TemporaryDirectory()
    img_dir = Path(tmp_ctx.name) / "golden"
    img_dir.mkdir()
    for i in range(n):
        write_png_gray(img_dir / f"g{i}.png", imgs4[i, 0])
    try:
        mark = kernel_counts()
        preds = predict(ckpt, path_to_images=img_dir, return_full_predictions=True, batch_size=4,
                        quantize=True, device=dev)
        launches["infer"] = kernel_counts(mark, "stem", "int8_conv")
        if on_card and (launches["infer"].get("stem_nhwc", 0) < 1 or launches["infer"].get("int8_conv", 0) < 3):
            raise AssertionError(f"infer --quantize launched {launches['infer']}")
        dets = [format_preds(p, obj_thresh=0.5, iou_thresh=0.5) for p in preds]
        out["golden"] = int8_gates(dets, golden)
        if out["golden"]["failures"]:
            raise AssertionError(f"infer --quantize golden gates: {out['golden']}")
        out["golden"]["launches"] = launches["infer"]
        # the program of step 1, calibrated on the frames tiled to B=batch,
        # on the golden scene: at B=64 it must fail the gates the JAX
        # package's program calibrated on the same batch fails, no more
        dec = quant.quantized_forward(model, qp, torch.from_numpy(imgs4).to(dev)).cpu().numpy()
        tiled = int8_gates([format_preds(p, obj_thresh=0.5, iou_thresh=0.5) for p in dec], golden)
        out["golden_calibrated_b%d" % batch] = tiled
        want = WITNESS_TILED_B64 if batch == 64 else {"failures": []}
        if {k: tiled[k] for k in want} != want:
            raise AssertionError(f"int8 program calibrated on B={batch}, golden scene: {tiled}; "
                                 f"JAX's on the same batch: {want}")
        del dec
        log("infer --quantize on the golden scene: " + json.dumps(out["golden"]))

        # ------------------------------------------------ 3. timing at B=batch
        if timing:
            out["timing"] = int8_timing(dev, pred, big, codes_at, block_args)
            log("int8 timing (B=%d): %s" % (batch, json.dumps(out["timing"])))

        # ------------------------------- 4. serve --quantize, micro-batch B
        frames = [np.ascontiguousarray(f) for f in imgs4]
        thr = {"obj_thresh": 0.5, "iou_thresh": 0.5, "min_class_confidence_threshold": 0.0}
        classes = list(pred.meta.get("class_names") or pred.meta.get("classes"))
        del pred, qp, preds
        if on_card:
            torch.cuda.empty_cache()
        mark = kernel_counts()
        t0 = time.perf_counter()
        srv = build_server(ckpt, port=0, device=dev, batch_size=batch, quantize=True,
                           calibration_images=img_dir, linger_ms=5.0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        rep = {"build_calibrate_warmup_s": time.perf_counter() - t0, "batch": batch}
        try:
            served = srv.yogo_state["predictor"]
            x = np.zeros((batch, *frames[0].shape), np.uint8)
            x[:n] = np.stack(frames)
            want = [format_detections(d, classes, **thr) for d in served.forward(x)[:n].cpu().numpy()]
            port = srv.server_address[1]
            from yogo_tpu_torch.serve_client import ServeClient

            with ServeClient("127.0.0.1", port, timeout=120) as c:
                got = [c.predict(f) for f in frames]
            if got != want:
                raise AssertionError("serve --quantize: answers differ from the host formatter over "
                                     "the server's int8 Predictor.forward")
            per_image = [sum(r["counts"].values()) for r in got]
            want_per_image = [len(golden[f"dets_{i}"]) for i in range(n)]
            if any(abs(a - b) > 2 for a, b in zip(per_image, want_per_image)):
                raise AssertionError(f"serve --quantize: per-image {per_image} vs golden {want_per_image}")
            builds0, loaded0 = kernel_counts(kind="builds"), dict(kernels._loaded)
            load = serve_load.measure(port, frames, want, threads=threads, seconds=serve_load_s,
                                      midway=srv.reload_checkpoint)
            reload, errors = load.pop("midway"), load.pop("errors")
            new_qp = srv.yogo_state["predictor"].qp
            if not reload["ok"] or new_qp is served.qp:
                raise AssertionError(f"serve --quantize: the hot reload did not recalibrate: {reload}")

            def leaves(qp):
                return [qp["stem_w"], qp["stem_b"], qp["scales"], *(t for b in qp["blocks"] for t in b.values())]

            # the same checkpoint on the same images, under load: the same program
            if not all(torch.equal(a, b) for a, b in zip(leaves(served.qp), leaves(new_qp))):
                raise AssertionError("serve --quantize: recalibrating under load built another program")
            if kernel_counts(builds0, kind="builds") or dict(kernels._loaded) != loaded0:
                raise AssertionError("serve --quantize: the reload rebuilt or reloaded a kernel")
            if errors or not load["requests_in_window"]:
                raise AssertionError(f"serve --quantize: {len(errors)} errors under load: {errors[:5]}")
            rep.update(per_image=per_image, bit_equal=True, load={**load, "errors": 0, "reload": reload})
        finally:
            srv.shutdown()
            srv.yogo_batcher.shutdown()
            srv.server_close()
            th.join(timeout=30)
        launches["serve"] = kernel_counts(mark, "stem", "int8_conv")
        if on_card and launches["serve"].get("int8_conv", 0) < 3:
            raise AssertionError(f"serve --quantize launched {launches['serve']}")
        rep["launches"] = launches["serve"]
        out["serve"] = rep
        log(f"serve --quantize B={batch}: " + json.dumps(rep))
    finally:
        tmp_ctx.cleanup()
    return out, launches


NMS_KS = (256, 1024)  # infer --count's and the benchmark's K; validation's and metrics/'


def nms_inputs(pred, raw, k, obj_thresh=None):
    """The arguments format_preds_batched_raw hands to batched_nms on the
    head `raw` at capacity k (boxes, scores, valid, iou_thresh, tiebreak),
    taken from the call itself."""
    from yogo_tpu_torch.ops import postprocess

    got = []
    orig = postprocess.batched_nms

    def grab(boxes, scores, valid, iou, tiebreak=None):
        got.append((boxes, scores, valid, iou, tiebreak))
        return orig(boxes, scores, valid, iou, tiebreak=tiebreak)

    m = pred.model
    postprocess.batched_nms = grab
    try:
        postprocess.format_preds_batched_raw(
            raw, m.anchor_w, m.anchor_h, width_multiplier=m.width_multiplier,
            height_multiplier=m.height_multiplier,
            obj_thresh=pred.obj_thresh if obj_thresh is None else obj_thresh,
            iou_thresh=pred.iou_thresh, max_detections=k)
    finally:
        postprocess.batched_nms = orig
    (args,) = got
    return args


def nms_phase(pred, raw):
    """Phase 3b: the NMS kernel (csrc/nms.cu) against its plain version on
    the card and on the CPU, at K = 256 and 1,024 on the B=64 golden-scene
    head `raw` (the slots the count path hands to NMS), and at K = 1,024
    with every slot valid (objectness threshold 0: the kernel's most work);
    keep equal bit for bit. Timing: the kernel (CUDA events, 20
    back-to-back launches, median of 30: where the wrapper's host time
    exceeds the kernel's, that time; and the kernel's device time from
    torch.profiler) and the chain and loop it replaces (the plain version
    on the card, with its host syncs; the chain alone, device time)."""
    from yogo_tpu_torch.ops import nms

    out = {}
    cases = [(f"golden_k{k}", k, None) for k in NMS_KS] + [("dense_k1024", 1024, 0.0)]
    for name, k, obj in cases:
        boxes, scores, valid, iou, tb = nms_inputs(pred, raw, k, obj)
        mark = kernel_counts()
        got = nms.batched_nms(boxes, scores, valid, iou, tiebreak=tb)
        launches = sum(kernel_counts(mark, "nms").values())
        want = nms.batched_nms_reference(boxes, scores, valid, iou, tiebreak=tb)
        want_cpu = nms.batched_nms(*(t.cpu() for t in (boxes, scores, valid)), iou, tiebreak=tb.cpu())
        if launches != 1 or not (torch.equal(got, want) and torch.equal(got.cpu(), want_cpu)):
            raise AssertionError(f"nms {name}: launches {launches}, kernel keep differs from the plain "
                                 f"version in {int((got != want).sum())} slots (card), "
                                 f"{int((got.cpu() != want_cpu).sum())} (CPU)")
        out[name] = {
            "k": k, "valid": int(valid.sum()), "kept": int(got.sum()), "launches": launches,
            "ms": cuda_ms(lambda: nms.batched_nms(boxes, scores, valid, iou, tiebreak=tb), 30),
            "device_ms": forward_profile(
                {name: lambda: nms.batched_nms(boxes, scores, valid, iou, tiebreak=tb)}, reps=20)[name]["device_ms"],
            "plain_ms": cuda_ms(lambda: nms.batched_nms_reference(boxes, scores, valid, iou, tiebreak=tb), 10),
            "chain_ms": cuda_ms(lambda: nms._suppression(boxes, scores, valid, iou, tiebreak=tb), 10),
        }
        log(f"nms {name}: " + json.dumps(out[name]))
    return out


# the kernel launches of a bf16 forward of each trunk: LayerNorms (ConvNeXt:
# stem, 36 blocks, 3 downsamples; Swin: stem, mlp_norm of 24 blocks, 3
# merges, final; ViTDet-B: mlp_norm of 12 blocks, attn_norm of the 4 global
# blocks, the neck's 2), the attention LayerNorms that store into windows
# and the window merges (one each a Swin block, a ViTDet-B window block)
LN_LAUNCHES = {"convnext_small": {"layer_norm": 40, "layer_norm_windows": 0, "window_merge": 0},
               "swin_small": {"layer_norm": 29, "layer_norm_windows": 24, "window_merge": 24},
               "vitdet_base": {"layer_norm": 18, "layer_norm_windows": 8, "window_merge": 8}}


def layer_norm_phase(dev, big, kind, versions=tuple(LN_LAUNCHES)):
    """Phase 3c: the LayerNorm kernel (csrc/layer_norm.cu) and the window
    merge (csrc/window_merge.cu) on the trunks' main path. A bf16 forward
    of each trunk of `versions` at B=len(big), 772x1032, seeded weights,
    records its LayerNorm and merge calls (the launch counters must read
    LN_LAUNCHES)
    and is timed with the kernels and with the plain chain and the plain
    window layout (pad, roll, partition; reverse, roll, crop, add) in their
    place (CUDA events, and device time by kernel), its head compared with
    the plain one's. Each distinct (C, rows, input dtype, output dtype) of
    the row-store calls is then checked against the plain version on
    seeded rows (f32 within 1e-5; bf16 within one ulp, in at most 1% of
    the elements) and timed: the kernel (median of 30 x 20 launches), its
    byte bound (each element read once, written once, at the card's memory
    rate), the plain chain with the consumer's cast, and F.layer_norm in
    the input's dtype as a yardstick (the port never calls it). Each
    windowed store and each merge shape is checked bit for bit against the
    row store followed by the plain layout (the merge: against the plain
    reverse, roll, crop and add) and timed beside its byte bound and that
    plain layout."""
    import torch.nn.functional as F

    from yogo_tpu_torch.models import yogo as Y
    from yogo_tpu_torch.ops.layer_norm import layer_norm_cuda, plan
    from yogo_tpu_torch.ops.window_merge import window_merge_cuda

    def plain_ln(x, w, b, eps, dtype, windows=None):
        y = Y.layer_norm(x, w, b, eps).to(dtype)
        return y if windows is None else Y.swin_window_layout(y, windows)

    def row_store_then_layout(x, w, b, eps, dtype, windows):
        return Y.swin_window_layout(layer_norm_cuda(x, w, b, eps, dtype), windows)

    x64 = torch.from_numpy(big).to(dev)
    out, shapes, windowed, merges = {"trunks": {}, "shapes": [], "windows": [], "merges": []}, {}, {}, {}
    for version in versions:
        want = LN_LAUNCHES[version]
        model = Y.YOGO.create(HW, 0.04, 0.05, 2, model_version=version, compute_dtype=torch.bfloat16)
        net = model.init(torch.Generator().manual_seed(0), device=dev)
        seen, seen_windows, seen_merges = [], [], []

        def spy(x, w, b, eps, dtype, windows=None, seen=seen, seen_windows=seen_windows):
            if windows is None:
                seen.append((x.shape[-1], x.numel() // x.shape[-1], str(x.dtype), str(dtype), eps))
            else:
                seen_windows.append((tuple(x.shape), str(dtype), eps, windows))
            return layer_norm_cuda(x, w, b, eps, dtype, windows)

        def merge_spy(x, t, windows, seen_merges=seen_merges):
            seen_merges.append((tuple(x.shape), str(t.dtype), windows))
            return window_merge_cuda(x, t, windows)

        def forward(model=model, net=net):
            return model.apply(net, x64, decode=False)

        mark = kernel_counts()
        Y.layer_norm_cuda, Y.window_merge_cuda = spy, merge_spy
        try:
            head = forward()
        finally:
            Y.layer_norm_cuda, Y.window_merge_cuda = layer_norm_cuda, window_merge_cuda
        torch.cuda.synchronize()
        since = kernel_counts(mark)
        launched = {name: since.get(name, 0) for name in want}
        if launched != want or (len(seen), len(seen_windows), len(seen_merges)) != tuple(want.values()):
            raise AssertionError(f"{version}: kernel launches a forward {launched}, not {want}")
        ms = cuda_ms(forward, reps=3, per_rep=2, warmup=1)
        prof = forward_profile({"kernel": forward}, reps=1, top=15)["kernel"]
        Y.layer_norm_cuda, Y.window_merge_cuda = plain_ln, Y.swin_merge_windows
        try:
            plain_head = forward()
            plain_ms = cuda_ms(forward, reps=3, per_rep=2, warmup=1)
            plain_prof = forward_profile({"plain": forward}, reps=1, top=15)["plain"]
            f32_head = model.with_compute_dtype(torch.float32).apply(net, x64, decode=False)
        finally:
            Y.layer_norm_cuda, Y.window_merge_cuda = layer_norm_cuda, window_merge_cuda

        def rel(a, b):
            return float((a.double() - b.double()).norm() / b.double().norm())

        # the kernel's bf16 head is as close to the f32 forward's as the
        # plain chain's: a flipped bf16 ulp re-rounds every later Dense, so
        # the two bf16 heads part by bf16's own noise
        d_kernel, d_plain = rel(head, f32_head), rel(plain_head, f32_head)
        if d_kernel > 1.25 * d_plain:
            raise AssertionError(f"{version}: the kernel's head is {d_kernel:.5f} off the f32 head, "
                                 f"the plain chain's {d_plain:.5f}")
        out["trunks"][version] = {"launches": launched, "forward_ms": ms, "forward_plain_ms": plain_ms,
                                  "head_rel_rms_vs_plain": rel(head, plain_head),
                                  "head_rel_rms_vs_f32": d_kernel, "plain_head_rel_rms_vs_f32": d_plain,
                                  "profile": prof, "plain_profile": plain_prof}
        log(f"layer_norm {version}: " + json.dumps({k: v for k, v in out["trunks"][version].items()
                                                       if "profile" not in k}))
        for found, into in ((seen, shapes), (seen_windows, windowed), (seen_merges, merges)):
            for key in found:
                into.setdefault(key, {}).setdefault(version, 0)
                into[key][version] += 1
        del net, head, plain_head, f32_head
        torch.cuda.empty_cache()

    dtypes = {str(t): t for t in (torch.bfloat16, torch.float32)}
    g = torch.Generator(device=dev).manual_seed(0)
    mem_rate = rate(MEM_RATE, kind)
    for (c, rows, xd, od, eps), by_trunk in sorted(shapes.items(), key=lambda kv: (kv[0][0], -kv[0][1], kv[0][2:4])):
        xdt, odt = dtypes[xd], dtypes[od]
        x = (torch.randn(rows, c, device=dev, generator=g) * 1.5 + 0.5).to(xdt)
        w = torch.rand(c, device=dev, generator=g) + 0.5
        b = torch.randn(c, device=dev, generator=g) * 0.5
        wl, bl = w.to(xdt), b.to(xdt)
        got, want = layer_norm_cuda(x, w, b, eps, odt), plain_ln(x, w, b, eps, odt)
        gf, wf = got.float(), want.float()
        differ = float((gf != wf).float().mean())
        if odt == torch.float32:
            torch.testing.assert_close(gf, wf, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(gf, wf, rtol=2.0 ** -7, atol=1e-5)
            if differ > 0.01:
                raise AssertionError(f"layer_norm C={c} {xd}->{od}: {differ:.4f} of the elements differ")
        n_bytes = rows * c * (xdt.itemsize + odt.itemsize) + 8 * c
        row = {
            "c": c, "rows": rows, "in": xd, "out": od, "eps": eps, "plan": list(plan(c, odt)),
            "launches_a_forward": by_trunk,
            "max_abs_err": float((gf - wf).abs().max()), "share_differing": differ,
            "bytes": n_bytes, "bound_ms": n_bytes / mem_rate * 1e3,
            "ms": cuda_ms(lambda: layer_norm_cuda(x, w, b, eps, odt), 30),
            "plain_ms": cuda_ms(lambda: plain_ln(x, w, b, eps, odt), 10),
            "library_ms": cuda_ms(lambda: F.layer_norm(x, (c,), wl, bl, eps), 10),
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        out["shapes"].append(row)
        log("layer_norm shape: " + json.dumps(row))
        del x, got, want, gf, wf
        torch.cuda.empty_cache()
    for (shape, od, eps, windows), by_trunk in sorted(windowed.items()):
        odt, (bsz, h, w_, c), (hp, wp, _, _) = dtypes[od], shape, windows
        x = torch.randn(shape, device=dev, generator=g) * 1.5 + 0.5
        w = torch.rand(c, device=dev, generator=g) + 0.5
        b = torch.randn(c, device=dev, generator=g) * 0.5
        got = layer_norm_cuda(x, w, b, eps, odt, windows)
        if not torch.equal(got, row_store_then_layout(x, w, b, eps, odt, windows)):
            raise AssertionError(f"layer_norm windows {shape} {windows}: not the row store then the layout")
        n_bytes = bsz * h * w_ * c * 4 + bsz * hp * wp * c * odt.itemsize + 8 * c
        row = {
            "map": list(shape), "windows": list(windows), "out": od, "plan": list(plan(c, odt)),
            "launches_a_forward": by_trunk, "bytes": n_bytes, "bound_ms": n_bytes / mem_rate * 1e3,
            "ms": cuda_ms(lambda: layer_norm_cuda(x, w, b, eps, odt, windows), 30),
            "row_store_ms": cuda_ms(lambda: layer_norm_cuda(x, w, b, eps, odt), 30),
            "plain_layout_ms": cuda_ms(lambda: row_store_then_layout(x, w, b, eps, odt, windows), 10),
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        out["windows"].append(row)
        log("layer_norm windows: " + json.dumps(row))
        del x, got
        torch.cuda.empty_cache()
    for (shape, td, windows), by_trunk in sorted(merges.items()):
        tdt, (bsz, h, w_, c), (hp, wp, win, _) = dtypes[td], shape, windows
        x = torch.randn(shape, device=dev, generator=g)
        t = torch.randn(bsz, win * win, hp * wp // win ** 2, c, device=dev, generator=g).to(tdt)
        got = window_merge_cuda(x, t, windows)
        if not torch.equal(got, Y.swin_merge_windows(x, t, windows)):
            raise AssertionError(f"window_merge {shape} {windows}: not reverse, roll, crop and add")
        n_bytes = bsz * h * w_ * c * (8 + tdt.itemsize)
        row = {
            "map": list(shape), "windows": list(windows), "t": td, "plan": list(plan(c, torch.float32)),
            "launches_a_forward": by_trunk, "bytes": n_bytes, "bound_ms": n_bytes / mem_rate * 1e3,
            "ms": cuda_ms(lambda: window_merge_cuda(x, t, windows), 30),
            "plain_layout_ms": cuda_ms(lambda: Y.swin_merge_windows(x, t, windows), 10),
        }
        row["bound_share"] = row["bound_ms"] / row["ms"]
        out["merges"].append(row)
        log("window_merge: " + json.dumps(row))
        del x, t, got
        torch.cuda.empty_cache()
    for version in versions:
        t = out["trunks"][version]
        for part, prefix, keys in (("shapes", "ln", ("ms", "plain_ms", "library_ms", "bound_ms")),
                                   ("windows", "ln_windows", ("ms", "plain_layout_ms", "bound_ms")),
                                   ("merges", "merge", ("ms", "plain_layout_ms", "bound_ms"))):
            for key in keys:
                t[f"{prefix}_{key}_a_forward"] = sum(r[key] * r["launches_a_forward"].get(version, 0)
                                                     for r in out[part])
            t[f"{prefix}_bound_share"] = (t[f"{prefix}_bound_ms_a_forward"] / t[f"{prefix}_ms_a_forward"]
                                          if t[f"{prefix}_ms_a_forward"] else None)
        log(f"layer_norm {version} a forward: " + json.dumps({k: v for k, v in t.items()
                                                              if k.startswith(("ln_", "merge_"))}))
    return out


def forward_profile(fns, reps=3, top=12):
    """Device time of each fn() by kernel (torch.profiler, CUDA activity
    only), per call: the `top` kernels and the sum of all."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.key, getattr(e, "device_time_total", 0) / 1e3 / reps, e.count / reps)
                       for e in prof.key_averages()), key=lambda r: -r[1])
        out[name] = {"device_ms": sum(r[1] for r in rows),
                     "kernels": [{"kernel": k[:100], "ms": ms, "calls": n} for k, ms, n in rows[:top]]}
    return out


def int8_timing(dev, pred, big, codes_at, block_args):
    """Phase 9's timing at B=len(big): per quantized block the kernel, its
    plain version, the library route, cuDNN's bf16 conv and the bound; the
    entry requant; the int8 and bf16 forward_raw; the int8 count path from host and device batches."""
    import torch.nn.functional as F

    from yogo_tpu_torch.infer import Predictor
    from yogo_tpu_torch.ops import int8_conv as ic
    from yogo_tpu_torch.ops import quant

    kind = torch.cuda.get_device_name(0)
    model, qp = pred.model, pred.qp
    specs = model.defn.blocks
    bsz = len(big)
    x64 = torch.from_numpy(big).to(dev)
    codes = codes_at(big)
    res = {"blocks": {}}
    for i, q in codes.items():
        q = q.contiguous()
        args, kw = block_args(i, q)
        spec, cin = specs[i], kw["cin"]
        blk = qp["blocks"][i - 1]
        w8, deq, bias = blk["w8"], blk["deq"], blk["b"]
        cout, k = w8.shape[:2]
        out = ic.int8_conv(*args, **kw)
        m = out.shape[0] * out.shape[1] * out.shape[2]
        n_ops = 2 * m * cout * k * k * cin
        n_bytes = q.numel() + w8.numel() + 8 * cout + out.numel() * out.element_size()
        bound = {"bytes": n_bytes / rate(MEM_RATE, kind) * 1e3, "operations": n_ops / rate(INT8_RATE, kind) * 1e3}
        w_oihw = w8[..., :cin].permute(0, 3, 1, 2).contiguous()
        w_mm = w_oihw.reshape(cout, -1)  # (N, K) in unfold's (c, dy, dx) order

        def library():
            """unfold in f16 (int8 codes are exact there), int8, torch._int_mm,
            then the same epilogue in torch ops."""
            xh = q[..., :cin].permute(0, 3, 1, 2).half()
            cols = F.unfold(xh, k, padding=spec.padding, stride=spec.stride)  # (B, K, L)
            a = cols.transpose(1, 2).reshape(-1, cols.shape[1]).to(torch.int8)
            acc = torch._int_mm(a, w_mm.t())
            h = quant._act(spec.act, acc.float() * deq + bias)
            if kw["out_scale"] is not None:
                return torch.clamp(torch.round(h / kw["out_scale"]), -127, 127).to(torch.int8)
            return h

        lib = library().reshape(out.shape[0], out.shape[1], out.shape[2], -1)
        if not torch.equal(lib, out[..., : lib.shape[-1]]):
            raise AssertionError(f"block {i}: the library route differs from the kernel")
        h_bf16 = (q[..., :cin].permute(0, 3, 1, 2).float() * 0.01).to(torch.bfloat16)
        w_bf16 = w_oihw.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        res["blocks"][f"block{i}"] = {
            "shape": {"in": list(q.shape), "out": list(out.shape), "out_dtype": str(out.dtype)},
            "ms": cuda_ms(lambda: ic.int8_conv(*args, **kw), 20),
            "plain_ms": cuda_ms(lambda: ic.int8_conv_reference(*args, **kw), 3, per_rep=1, warmup=1),
            "library_ms": cuda_ms(library, 10, per_rep=5),
            "cudnn_bf16_conv_ms": cuda_ms(lambda: F.conv2d(h_bf16, w_bf16, None, spec.stride, spec.padding), 20),
            "bound_ms": max(bound.values()), "bound_by": max(bound, key=bound.get),
            "bytes": n_bytes, "operations": n_ops,
        }
        res["blocks"][f"block{i}"]["bound_share"] = (
            res["blocks"][f"block{i}"]["bound_ms"] / res["blocks"][f"block{i}"]["ms"])
        del lib, out, h_bf16
    # the entry requant: an f32 activation of block 3's output shape -> codes
    b4 = codes[4]
    h3 = torch.empty((bsz, b4.shape[-1], b4.shape[1], b4.shape[2]), device=dev).uniform_(-4, 4)
    h3 = h3.contiguous(memory_format=torch.channels_last)
    res["entry_requant_ms"] = cuda_ms(lambda: quant.requant(h3, qp["scales"][3]), 20)
    del h3, b4, codes
    bf16 = Predictor(model.with_compute_dtype(torch.bfloat16), pred.stack)
    res["forward_raw_ms"] = {
        "int8": cuda_ms(lambda: pred.forward_raw(x64), 10),
        "bf16": cuda_ms(lambda: bf16.forward_raw(x64), 10),
    }
    res["profile"] = forward_profile({"int8": lambda: pred.forward_raw(x64),
                                      "bf16": lambda: bf16.forward_raw(x64)})
    for src, batch in (("host", torch.from_numpy(big)), ("device", x64)):
        ones = torch.ones(bsz, dtype=torch.bool)
        for _ in range(2):
            pred.count(pred.forward_raw(batch), ones)
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            pred.count(pred.forward_raw(batch), ones)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        q = statistics.quantiles(times, n=4)
        res[f"count_path_{src}"] = {"img_per_s": len(times) * bsz / (sum(times) / 1e3),
                                    "batch_ms_median": statistics.median(times), "batch_ms_p75": q[2],
                                    "batches": len(times)}
    return res


# the sites timed at B=64 (every one of the 71 is checked at B=4)
CONVNEXT_TIMED_SITES = ("stage2_block0/pwconv1", "stage2_block0/pwconv2", "down2_conv")
# the card's f32 head against the CPU's on one frame: the same f32 math,
# summed in other orders through 36 blocks (3.2e-6 on a head of max 0.98 on
# the H100); with TF32 on, the fault the gate is for, the gate must fail
CONVNEXT_F32_RTOL, CONVNEXT_F32_ATOL = 5e-5, 5e-5


def perturbed_convnext(model, device, seed=0):
    """A ConvNeXt-Small of `model` from YOGO.init(seed), then every gamma
    drawn from N(0.5, 0.2) and every bias from N(0, 0.1), seeded: at
    init gamma is 1e-6 and each block is the identity."""
    net = model.init(torch.Generator().manual_seed(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("gamma"):
                p.copy_(0.5 + 0.2 * torch.randn(p.shape, generator=gen))
            elif name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return net.to(device)


def convnext_phase(device_arg, imgs4, boxes4, smi, *, hw=HW, batch=TIMING_BATCH, train_batches=(16, 64),
                   train_steps=8, timing=True):
    """Phase 10: ConvNeXt-Small, the convnext family, at full width and
    depth on seeded perturbed weights (perturbed_convnext), 2 classes.
    device_arg None runs on the card; "cpu" rehearses the control flow at
    a small `hw`. In order:
      1. f32 parity: the card's raw head of one frame (TF32 off) against
         the port's CPU f32 forward of the same frame;
      2. bf16 `infer --count` through Predictor.from_checkpoint (a .ckpt of
         the weights) at B=`batch`: finite head of the grid's shape, the
         stem's launch count 0; forward and count-path time, images/s and
         peak memory;
      3. training from YOGO.init: `train_steps` bf16 steps on one batch, no flips, at
         B=train_batches[0] without remat and at B=train_batches[1] with
         remat="blocks" (finite; the last two losses below the first two); step time, images/s, peak
         memory; the trained state
         saved, reloaded through Predictor and counted: the head equal to
         the in-memory model's; the .pth round trip: the same head;
      4. int8: `infer --quantize` through predict() on the golden frames as
         PNGs, one batch calibrated on itself (the int8 conv's launch count
         set to 0 before and read after: 71 a batch); the kernel against its
         plain version on the codes entering each of the 71 sites in that
         batch (B=4; codes and f32 equal); timing at B=`batch` at
         CONVNEXT_TIMED_SITES (kernel, plain, torch._int_mm + the epilogue,
         bound) and int8 against bf16 forward_raw, with their device time
         by kernel;
      5. `serve` at micro-batch 8, bf16 and `--quantize` (calibrated on the
         golden frames' PNGs): the answers, before and after a hot reload,
         equal the host formatter over Predictor.forward of a batch of the
         server's shape.
    Returns (numbers for the report, int8 conv launches a batch). Every
    check raises."""
    import threading

    from yogo_tpu_torch.infer import Predictor, predict
    from yogo_tpu_torch.models.yogo import YOGO, resolve_device
    from yogo_tpu_torch.ops import int8_conv as ic
    from yogo_tpu_torch.ops import quant_convnext as qc
    from yogo_tpu_torch.ops.grid import encode_label_grid_np
    from yogo_tpu_torch.serve import build_server, format_detections
    from yogo_tpu_torch.serve_client import ServeClient
    from yogo_tpu_torch.train import TrainState, make_optimizer, make_train_step
    from yogo_tpu_torch.utils.checkpoint import save_checkpoint
    from yogo_tpu_torch.utils.default_hyperparams import DefaultHyperparams as df
    from yogo_tpu_torch.utils.torch_bridge import save_pth
    from yogo_tpu_torch.utils.weights import flax_from_state_dict

    dev = resolve_device(device_arg)
    on_card = dev.type == "cuda"
    classes = ["cell", "parasite"]
    model = YOGO.create(hw, 0.0425, 0.0555, len(classes), model_version="convnext_small")
    bf16 = model.with_compute_dtype(torch.bfloat16)
    net = perturbed_convnext(model, dev)
    n = len(imgs4)
    big = np.concatenate([imgs4] * (batch // n))
    out = {"params": YOGO.num_params(net), "grid_sx_sy": list(model.grid), "hw": list(hw)}
    tmp_ctx = tempfile.TemporaryDirectory()
    tmp = Path(tmp_ctx.name)
    ckpt = tmp / "convnext.ckpt"
    save_checkpoint(ckpt, model, flax_from_state_dict(net.state_dict()), classes=classes)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def reset_peak():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if on_card else None

    # ------------------------------------------------ 1. f32: card vs CPU
    x1 = torch.from_numpy(imgs4[:1])
    got = model.apply(net, x1.to(dev), decode=False).cpu()
    # the fault the gate is for: the module's own forward with cuDNN's and
    # cuBLAS's TF32 on (YOGO.apply holds no_tf32)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.inference_mode():
            got_tf32 = net(x1.to(dev).float()).permute(0, 2, 3, 1).cpu()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    cpu_net = perturbed_convnext(model, "cpu")
    want = f32_head = model.apply(cpu_net, x1, decode=False)
    del cpu_net
    err = float((got - want).abs().max())
    err_tf32 = float((got_tf32 - want).abs().max())

    def within_gate(a):
        return bool(((a - want).abs() <= CONVNEXT_F32_ATOL + CONVNEXT_F32_RTOL * want.abs()).all())

    out["f32_vs_cpu"] = {"max_abs_err": err, "max_abs_err_tf32_on": err_tf32,
                         "max_abs_head": float(want.abs().max()),
                         "rtol": CONVNEXT_F32_RTOL, "atol": CONVNEXT_F32_ATOL}
    log(f"convnext f32 card vs CPU, one frame: max abs err {err:.3g} with TF32 off, {err_tf32:.3g} with "
        f"it on, on a head of max {float(want.abs().max()):.3g} (rtol {CONVNEXT_F32_RTOL}, "
        f"atol {CONVNEXT_F32_ATOL})")
    if not within_gate(got):
        raise AssertionError(f"convnext f32 head: the card differs from the CPU by {err}")
    if on_card and within_gate(got_tf32):
        raise AssertionError(f"convnext f32 head: the gate does not catch TF32 (max abs err {err_tf32})")

    # ------------------------------------- 2. bf16 infer --count at B=batch
    reset_peak()
    mark = kernel_counts()
    pred = Predictor.from_checkpoint(ckpt, half=True, device=dev)
    ones = torch.ones(batch, dtype=torch.bool)
    raw = pred.forward_raw(big)
    counts = pred.count(raw, ones).cpu().tolist()
    sync()
    sx, sy = model.grid
    if raw.shape != (batch, sy, sx, 5 + len(classes)) or not torch.isfinite(raw.float()).all():
        raise AssertionError(f"convnext bf16 head {tuple(raw.shape)} {raw.dtype}, finite "
                             f"{bool(torch.isfinite(raw.float()).all())}")
    stem = kernel_counts(mark, "stem")
    if stem:
        raise AssertionError(f"convnext launched the stem kernel: {stem}")
    out["bf16"] = {"batch": batch, "head_dtype": str(raw.dtype), "counts": counts, "stem_launches": 0}
    del raw
    if timing:
        x_dev = torch.from_numpy(big).to(dev)
        fwd_ms = cuda_ms(lambda: pred.forward_raw(x_dev), 3, per_rep=3, warmup=1)
        times = []
        for _ in range(8):
            t0 = time.perf_counter()
            pred.count(pred.forward_raw(big), ones)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        out["bf16"].update(forward_raw_ms=fwd_ms, forward_img_per_s=batch / fwd_ms * 1e3,
                           count_path_host={"img_per_s": len(times) * batch / (sum(times) / 1e3),
                                            "batch_ms_median": statistics.median(times)},
                           max_memory_allocated_gib=peak_gib())
        del x_dev
    log(f"convnext bf16 infer --count B={batch}: " + json.dumps(out["bf16"]))
    del pred

    # ------------------------------------------------------ 3. training
    grids4 = np.stack([encode_label_grid_np(b, sx, sy) for b in boxes4])
    loss_kw = dict(no_obj_weight=df.NO_OBJ_WEIGHT, iou_weight=df.IOU_WEIGHT,
                   classify_weight=df.CLASSIFY_WEIGHT, label_smoothing=df.LABEL_SMOOTHING)
    out["train"] = {}
    for bsz, remat in zip(train_batches, ("none", "blocks")):
        reset_peak()
        tnet = model.init(torch.Generator().manual_seed(2), device=dev)
        optimizer, scheduler, _ = make_optimizer(tnet.parameters(), df.LEARNING_RATE, df.WEIGHT_DECAY,
                                                 df.DECAY_FACTOR, 100)
        state = TrainState(tnet, optimizer, scheduler)
        reps = -(-bsz // n)
        xs = torch.from_numpy(np.concatenate([imgs4] * reps)[:bsz]).to(dev)
        labs = torch.from_numpy(np.concatenate([grids4] * reps)[:bsz]).to(dev)
        mask = torch.ones(bsz, device=dev)
        step = make_train_step(bf16, loss_kw, augment=False, remat=remat)
        gen = torch.Generator().manual_seed(1)
        losses, ms = [], []
        for i in range(train_steps):
            if on_card:
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
            losses.append(step(state, xs, labs, mask, gen)[1])
            if on_card:
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
        losses = torch.stack(losses).cpu().tolist()
        # Adam's first steps move every weight by ~lr, gamma (1e-6 at init)
        # by 300x: the loss falls over the steps, not at each
        if not all(np.isfinite(losses)) or not np.mean(losses[-2:]) < np.mean(losses[:2]):
            raise AssertionError(f"convnext train B={bsz} remat={remat}: losses {losses}")
        rec = {"batch": bsz, "remat": remat, "steps": train_steps, "losses": losses,
               "max_memory_allocated_gib": peak_gib()}
        if ms:
            step_ms = statistics.median(ms[2:])  # the first steps build and warm up
            rec.update(step_ms=step_ms, step_ms_all=ms, img_per_s=bsz / step_ms * 1e3)
        out["train"][f"b{bsz}_{remat}"] = rec
        log(f"convnext train bf16 B={bsz} remat={remat} ({smi}): " + json.dumps(rec))
        del optimizer, scheduler, state, xs, labs
    # the last trained state through a .ckpt and a .pth into Predictor
    want = Predictor(bf16, tnet).forward_raw(imgs4)
    variables = flax_from_state_dict(tnet.state_dict())
    save_checkpoint(tmp / "trained.ckpt", model, variables, classes=classes)
    save_pth(tmp / "trained.pth", model, variables, classes=classes)
    del tnet
    for path in (tmp / "trained.ckpt", tmp / "trained.pth"):
        re = Predictor.from_checkpoint(path, half=True, device=dev)
        got = re.forward_raw(imgs4)
        if not torch.equal(got, want):
            raise AssertionError(f"convnext {path.suffix} reload: head differs by "
                                 f"{float((got.float() - want.float()).abs().max())}")
        out[f"reload_{path.suffix[1:]}"] = {
            "bytes": path.stat().st_size, "head_equal": True,
            "counts": re.count(got, torch.ones(n, dtype=torch.bool)).cpu().tolist()}
        del re, got
    log("convnext trained state: .ckpt and .pth reloaded through Predictor, heads equal the "
        "in-memory model's: " + json.dumps({k: out[k] for k in ("reload_ckpt", "reload_pth")}))

    # --------------------------------------------------------- 4. int8
    img_dir = tmp / "golden"
    img_dir.mkdir()
    for i, f in enumerate(imgs4):
        write_png_gray(img_dir / f"frame_{i}.png", f[0])
    reset_peak()
    mark = kernel_counts()
    preds = predict(ckpt, path_to_images=img_dir, quantize=True, batch_size=n,
                    return_full_predictions=True, device=dev)
    launches = sum(kernel_counts(mark, "int8_conv").values())  # none on the CPU
    if (on_card and launches != len(qc.quant_sites())) or not np.isfinite(preds).all():
        raise AssertionError(f"convnext infer --quantize: {launches} int8 conv launches for one batch "
                             f"(expected {len(qc.quant_sites())}), finite {bool(np.isfinite(preds).all())}")
    out["int8"] = {"launches_one_batch": launches}
    del preds

    pred8 = Predictor.from_checkpoint(ckpt, device=dev, quantize=True, calib=[imgs4])
    qp = pred8.qp
    record = []
    raw8 = qc.quantized_convnext_forward(model, qp, torch.from_numpy(imgs4).to(dev), decode=False,
                                         record=record)[:1].cpu()
    # the int8 head of frame 0 within int8 noise of its f32 head (the
    # bound of tests/test_torch_quant_convnext.py for JAX's own program)
    noise = float((raw8 - f32_head).abs().max())
    out["int8"]["vs_f32_head"] = {"max_abs_err": noise, "max_abs_head": float(f32_head.abs().max())}
    log("convnext int8 head of frame 0 against its f32 head: " + json.dumps(out["int8"]["vs_f32_head"]))
    if not 0 < noise < 0.1 * float(f32_head.abs().max()):
        raise AssertionError(f"convnext int8 head of frame 0 differs from the f32 head by {noise}")
    if len(record) != len(qc.quant_sites()):
        raise AssertionError(f"convnext int8 forward recorded {len(record)} sites")
    codes4 = dict(zip((k for k, _ in qc.quant_sites()), record))
    del record

    def site_args(key, q):
        blk = qp["int8"][key]
        return (q.contiguous(), blk["w8"], blk["deq"], blk["b"]), dict(
            cin=q.shape[-1], stride=2 if key.startswith("down") else 1, padding=0, act=None)

    # every site of the batch the main path ran, on the codes that entered it
    errs, shapes = {}, set()
    for key, q in codes4.items():
        args, kw = site_args(key, q)
        got, want = ic.int8_conv(*args, **kw), ic.int8_conv_reference(*args, **kw)
        sync()
        if got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"int8 conv at {key} B={n}: differs from its plain version by "
                                 f"{float((got - want).abs().max())}")
        errs[key] = float((got - want).abs().max())
        shapes.add((tuple(q.shape), tuple(args[1].shape), kw["stride"]))
        del got, want
    out["int8"].update(max_abs_err=max(errs.values()), sites_checked=len(errs), site_shapes_checked=len(shapes))
    log(f"convnext int8_conv vs plain at B={n}: max abs err {out['int8']['max_abs_err']} at {len(errs)} sites, "
        f"{len(shapes)} distinct (codes, weights, stride) shapes")

    if timing:
        kind = torch.cuda.get_device_name(0)
        out["int8"]["sites"] = {}
        for key in CONVNEXT_TIMED_SITES:
            q = codes4[key].repeat(batch // n, 1, 1, 1).contiguous()
            args, kw = site_args(key, q)
            w8, deq, bias = args[1:]
            cout, k, _, cin = w8.shape
            y = ic.int8_conv(*args, **kw)
            m = y.shape[0] * y.shape[1] * y.shape[2]
            n_ops = 2 * m * cout * k * k * cin
            n_bytes = q.numel() + w8.numel() + 8 * cout + y.numel() * 4
            bound = {"bytes": n_bytes / rate(MEM_RATE, kind) * 1e3, "operations": n_ops / rate(INT8_RATE, kind) * 1e3}
            # the library route: the codes as (M, K) rows (a 2x2 stride-2
            # VALID window is a patch: crop to even, reshape and permute),
            # torch._int_mm, then the epilogue in torch ops
            w_mm = w8.reshape(cout, -1).t()  # (K, N), (dy, dx, c) order

            def rows(q=q, k=k):
                if k == 1:
                    return q.reshape(-1, q.shape[-1])
                b_, h_, w_, c_ = q.shape
                p = q[:, : h_ // 2 * 2, : w_ // 2 * 2].reshape(b_, h_ // 2, 2, w_ // 2, 2, c_)
                return p.permute(0, 1, 3, 2, 4, 5).reshape(-1, 4 * c_)

            def library(w_mm=w_mm, deq=deq, bias=bias, rows=rows):
                return torch._int_mm(rows(), w_mm).float() * deq + bias

            lib = library().reshape(y.shape)
            if not torch.equal(lib, y):
                raise AssertionError(f"int8 conv at {key}: the library route differs from the kernel")
            rec = {"shape": {"in": list(q.shape), "out": list(y.shape)},
                   "ms": cuda_ms(lambda args=args, kw=kw: ic.int8_conv(*args, **kw), 5),
                   # 1x1: cuBLASLt's s32 product alone, without the epilogue
                   **({"int_mm_ms": cuda_ms(lambda w_mm=w_mm, rows=rows: torch._int_mm(rows(), w_mm), 5)}
                      if k == 1 else {}),
                   "plain_ms": cuda_ms(lambda args=args, kw=kw: ic.int8_conv_reference(*args, **kw), 3,
                                       per_rep=1, warmup=1),
                   "library_ms": cuda_ms(library, 5),
                   "bound_ms": max(bound.values()), "bound_by": max(bound, key=bound.get),
                   "bytes": n_bytes, "operations": n_ops}
            rec["bound_share"] = rec["bound_ms"] / rec["ms"]
            out["int8"]["sites"][key] = rec
            del q, y, lib
        x_dev = torch.from_numpy(big).to(dev)
        bf = Predictor(bf16, pred8.stack)
        reset_peak()
        out["int8"]["forward_raw_ms"] = {"int8": cuda_ms(lambda: pred8.forward_raw(x_dev), 3, per_rep=3,
                                                         warmup=1),
                                         "bf16": cuda_ms(lambda: bf.forward_raw(x_dev), 3, per_rep=3,
                                                         warmup=1)}
        out["int8"]["max_memory_allocated_gib"] = peak_gib()
        # device time by kernel: where a ConvNeXt forward spends it
        out["int8"]["profile"] = forward_profile({"bf16": lambda: bf.forward_raw(x_dev),
                                                  "int8": lambda: pred8.forward_raw(x_dev)},
                                                 reps=2, top=15)
        del x_dev, bf
    log(f"convnext int8 ({smi}): " + json.dumps(out["int8"]))
    del pred8, qp, codes4

    # --------------------------------------------------------- 5. serve
    sb = 8
    x = np.zeros((sb, *imgs4.shape[1:]), np.uint8)
    x[:n] = imgs4
    thr = {"obj_thresh": 0.5, "iou_thresh": 0.5, "min_class_confidence_threshold": 0.0}

    def serve_once(**kw):
        """A server at micro-batch `sb` answers the golden frames in one
        request and, after a hot reload, again; both answers must equal the
        host formatter over the first served Predictor.forward of a batch
        of the server's shape. Returns (record, int8 conv launches from
        start-up to the last answer)."""
        mark = kernel_counts()
        srv = build_server(ckpt, port=0, device=dev, batch_size=sb, linger_ms=5.0, **kw)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            served = srv.yogo_state["predictor"]
            with ServeClient("127.0.0.1", srv.server_address[1], timeout=120) as c:
                t0 = time.perf_counter()
                got = c.predict_many(imgs4)
                one_request_ms = (time.perf_counter() - t0) * 1e3
                if not srv.reload_checkpoint()["ok"]:
                    raise AssertionError(f"convnext serve {kw}: the reload failed")
                got_reloaded = c.predict_many(imgs4)
            served_launches = sum(kernel_counts(mark, "int8_conv").values())
        finally:
            srv.shutdown()
            srv.yogo_batcher.shutdown()
            srv.server_close()
            th.join(timeout=30)
        want = [format_detections(d, classes, **thr) for d in served.forward(x)[:n].cpu().numpy()]
        if got != want or got_reloaded != want:
            raise AssertionError(f"convnext serve {kw}: answers differ from the host formatter over "
                                 f"Predictor.forward (before the reload {got == want}, after {got_reloaded == want})")
        return {"batch": sb, "answers_equal_formatter": True, "reloaded_answers_equal": True,
                "per_image": [sum(r["counts"].values()) for r in got],
                "one_request_of_4_frames_ms": one_request_ms}, served_launches

    out["serve"], _ = serve_once(half=True)
    log("convnext serve B=8 bf16: " + json.dumps(out["serve"]))
    out["serve_quantize"], serve_launches = serve_once(quantize=True, calibration_images=img_dir)
    # 71 a dispatch: start-up's warm-up and the two answers (a reload
    # recalibrates in f32 and launches none)
    if on_card and (serve_launches == 0 or serve_launches % len(qc.quant_sites())):
        raise AssertionError(f"convnext serve --quantize: {serve_launches} int8 conv launches")
    out["serve_quantize"]["int8_conv_launches"] = serve_launches
    log("convnext serve B=8 --quantize: " + json.dumps(out["serve_quantize"]))
    tmp_ctx.cleanup()
    return out, launches


def onnx_input_shape(model_bytes: bytes) -> tuple:
    """The dims of an ONNX graph's first input (ValueInfoProto ->
    TypeProto.tensor_type -> TensorShapeProto), read with the port's parser."""
    from yogo_tpu_torch.utils import onnx_proto as op

    graph = op.parse_message(op.parse_message(model_bytes)[7][0])
    tensor_type = op.parse_message(op.parse_message(graph[11][0])[2][0])[1][0]
    shape = op.parse_message(op.parse_message(tensor_type)[2][0])
    return tuple(op.parse_message(d)[1][0] for d in shape[1])


def export_phase(device_arg, imgs4, *, want_per_image, ckpt=CKPT, convnext_hw=HW):
    """Phase 11: `export`. device_arg None runs on the card (the CLI
    without --device); "cpu" rehearses the control flow (ConvNeXt at a small
    `convnext_hw`). In order:
      1. `export` of the golden checkpoint through main(): the .onnx file's
         bytes equal build_onnx run on the CPU's variables in this process;
         the gate's max deviation; build_onnx and verify_onnx (reference
         forward and interpreter on the device) timed apart; the stem's
         launch count over every export command 0;
      2. the exported graph, run by run_model on the device one golden frame
         at a time, through count_class_predictions (obj 0.5, iou 0.5):
         per-image counts within +-1 of the f32 goldens;
      3. `--crop-height 0.25`: the graph's input is (1, 1, 193, 1032) and
         the gate passes; `--format pth`: load_any gives a head on the
         device bit-equal to the .ckpt's; `--format stablehlo` raises,
         naming the JAX package's command;
      4. ConvNeXt-Small at `convnext_hw` on phase 10's seeded weights: the
         bytes of build_onnx over the weights held on the device equal those
         over the CPU's; the gate passes on the device; times and size.
    Returns the numbers for the report (stem launches under "stem_launches").
    Every check raises."""
    from yogo_tpu_torch.__main__ import main as cli
    from yogo_tpu_torch.models.yogo import YOGO, resolve_device
    from yogo_tpu_torch.ops.postprocess import count_class_predictions
    from yogo_tpu_torch.utils.checkpoint import load_any
    from yogo_tpu_torch.utils.export_model import build_onnx, verify_onnx
    from yogo_tpu_torch.utils.onnx_interp import run_model
    from yogo_tpu_torch.utils.weights import flax_from_state_dict, state_dict_from_flax

    dev = resolve_device(device_arg)
    flags = [] if device_arg is None else ["--device", device_arg]
    out = {}
    tmp_ctx = tempfile.TemporaryDirectory()
    tmp = Path(tmp_ctx.name)

    def ms_since(t0):
        return (time.perf_counter() - t0) * 1e3

    # ---------------------------------------------- 1. export, the CLI
    mark = kernel_counts()
    t0 = time.perf_counter()
    cli(["export", str(ckpt), "--output-filename", str(tmp / "golden"), *flags])
    cli_ms = ms_since(t0)
    blob = (tmp / "golden.onnx").read_bytes()
    model, variables, _ = load_any(ckpt)
    t0 = time.perf_counter()
    cpu_blob = build_onnx(model, variables)
    build_ms = ms_since(t0)
    if blob != cpu_blob:
        raise AssertionError("export: the file differs from build_onnx on the CPU")
    t0 = time.perf_counter()
    max_dev = verify_onnx(model, variables, blob, device=dev)
    verify_ms = ms_since(t0)
    out["golden"] = {"max_dev": max_dev, "build_ms": build_ms, "verify_ms": verify_ms,
                     "export_cli_ms": cli_ms, "bytes": len(blob)}
    log(f"export golden base_model {model.img_size}: {len(blob)} bytes, gate max dev {max_dev:.3g}, "
        f"build {build_ms:.1f} ms, verify {verify_ms:.1f} ms, CLI {cli_ms:.1f} ms")

    # ------------------------------- 2. the graph on the golden frames
    per = []
    for i in range(len(imgs4)):
        dec = run_model(blob, {"images": imgs4[i : i + 1]}, device=dev)[0]
        per.append(int(count_class_predictions(torch.from_numpy(dec), obj_thresh=0.5, iou_thresh=0.5).sum()))
    log(f"export: the graph on the golden frames, per image {per} (f32 golden {want_per_image})")
    if any(abs(a - b) > 1 for a, b in zip(per, want_per_image)):
        raise AssertionError(f"export: graph counts {per} vs golden {want_per_image}")
    out["golden"]["per_image"] = per

    # ------------------------------------- 3. crop, .pth, stablehlo
    cli(["export", str(ckpt), "--crop-height", "0.25", "--output-filename", str(tmp / "crop"), *flags])
    crop_shape = onnx_input_shape((tmp / "crop.onnx").read_bytes())
    if crop_shape != (1, 1, 193, 1032):
        raise AssertionError(f"export --crop-height 0.25: input {crop_shape}")
    cli(["export", str(ckpt), "--format", "pth", "--output-filename", str(tmp / "golden"), *flags])
    heads = []
    for path in (ckpt, tmp / "golden.pth"):
        m, v, _ = load_any(path)
        stack = m.module(dev)
        stack.load_state_dict(state_dict_from_flax(v), strict=True)
        heads.append(m.apply(stack, torch.from_numpy(imgs4[:1]).to(dev), decode=False).cpu())
    if not torch.equal(*heads):
        raise AssertionError("export --format pth: the reloaded head differs from the .ckpt's")
    try:
        cli(["export", str(ckpt), "--format", "stablehlo", *flags])
        raise AssertionError("export --format stablehlo did not raise")
    except NotImplementedError as e:
        if "python -m yogo_tpu export --format stablehlo" not in str(e):
            raise
    stem = kernel_counts(mark, "stem")
    out["stem_launches"] = sum(stem.values())
    log(f"export --crop-height 0.25: input {crop_shape}; --format pth: head bit-equal; "
        f"stablehlo raises; stem launches over every export command: {out['stem_launches']}")
    if stem:
        raise AssertionError(f"export launched the stem kernel: {stem}")

    # ---------------------------------------------- 4. ConvNeXt-Small
    cnx = YOGO.create(convnext_hw, 0.0425, 0.0555, 2, model_version="convnext_small")
    cnx_vars = flax_from_state_dict(perturbed_convnext(cnx, dev).state_dict())
    t0 = time.perf_counter()
    cnx_blob = build_onnx(cnx, cnx_vars)
    cnx_build_ms = ms_since(t0)
    if cnx_blob != build_onnx(cnx, flax_from_state_dict(perturbed_convnext(cnx, "cpu").state_dict())):
        raise AssertionError("export convnext: the bytes differ from the CPU weights' build")
    t0 = time.perf_counter()
    cnx_dev = verify_onnx(cnx, cnx_vars, cnx_blob, device=dev)
    out["convnext"] = {"max_dev": cnx_dev, "build_ms": cnx_build_ms, "verify_ms": ms_since(t0),
                       "bytes": len(cnx_blob), "hw": list(convnext_hw)}
    del cnx_blob, cnx_vars
    log(f"export convnext_small {convnext_hw}: " + json.dumps(out["convnext"]))

    tmp_ctx.cleanup()
    return out


# --------------------------------------------------------------- 12. parallel
PARALLEL_WORKER = "--parallel-worker"
RANK_TIMEOUT_S = 600
F32_GLOBAL_BATCH = 8


def run_ranks(mode: str, spec: dict, world: int, work: Path, timeout: float = RANK_TIMEOUT_S):
    """`world` processes of this script in PARALLEL_WORKER mode `mode`, one
    rank each (RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT set here),
    stdout and stderr to files in `work`. Polled: the first rank to fail
    kills every other, and so does the time limit; then it raises. Returns
    each rank's result (work/<mode>.<rank>.json)."""
    import socket

    (work / f"{mode}.json").write_text(json.dumps(spec))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs, files = [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
        out = open(work / f"{mode}.{rank}.out", "w")
        err = open(work / f"{mode}.{rank}.err", "w")
        files += [out, err]
        procs.append(subprocess.Popen(
            [sys.executable, "-X", "faulthandler", str(REPO / "chip_smoke.py"), PARALLEL_WORKER, mode,
             str(work)],
            env=env, stdout=out, stderr=err, cwd=str(work)))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad else "timed out"
                break
            time.sleep(0.5)
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad else None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    if failed:
        tails = "\n".join(f"--- rank {r} ---\n{(work / f'{mode}.{r}.out').read_text()[-1500:]}"
                          f"\n{(work / f'{mode}.{r}.err').read_text()[-3000:]}" for r in range(world))
        raise AssertionError(f"parallel {mode}: {failed}\n{tails}")
    return [json.loads((work / f"{mode}.{r}.json").read_text()) for r in range(world)]


def _dp_setup(spec):
    """What every worker shares: the device, the golden frames with their
    label grids (tiled) and the base_model config of the golden checkpoint."""
    from yogo_tpu_torch.ops.grid import encode_label_grid_np
    from yogo_tpu_torch.parallel.distributed import local_device
    from yogo_tpu_torch.utils.checkpoint import load_checkpoint

    dev = local_device(spec["device"])
    gold_model, _, _ = load_checkpoint(CKPT)
    model = dataclasses.replace(gold_model, img_size=tuple(spec["hw"]))
    imgs4, boxes4 = gen_golden_images(4, hw=tuple(spec["hw"]))
    sx, sy = model.grid
    grids4 = np.stack([encode_label_grid_np(b, sx, sy) for b in boxes4])
    return dev, model, imgs4, grids4


def _dp_batch(imgs4, grids4, n, pad_last=False):
    """n rows of the golden frames tiled, with their label grids and mask;
    pad_last: the last row a masked copy of the first (a pad row)."""
    reps = -(-n // len(imgs4))
    imgs = np.concatenate([imgs4] * reps)[:n].copy()
    grids = np.concatenate([grids4] * reps)[:n].copy()
    mask = np.ones(n, np.float32)
    if pad_last:
        imgs[-1], grids[-1], mask[-1] = imgs[0], grids[0], 0.0
    return imgs, grids, mask


def _dp_steps(model, stack, batches, dev, *, fsdp=False, timed=0):
    """Steps of make_train_step on `batches` (this rank's rows), flips and
    dropout on, seeded per step; timed > 0 adds that many synchronized
    steps on the last batch and returns their host-clock ms too."""
    from yogo_tpu_torch.parallel.mesh import fully_shard_stack
    from yogo_tpu_torch.train import TrainState, make_optimizer, make_train_step, step_seed
    from yogo_tpu_torch.utils.default_hyperparams import DefaultHyperparams as df

    loss_kw = dict(no_obj_weight=df.NO_OBJ_WEIGHT, iou_weight=df.IOU_WEIGHT,
                   classify_weight=df.CLASSIFY_WEIGHT, label_smoothing=df.LABEL_SMOOTHING)
    if fsdp:
        fully_shard_stack(stack)
    opt, sched, _ = make_optimizer(stack.parameters(), df.LEARNING_RATE, df.WEIGHT_DECAY,
                                   df.DECAY_FACTOR, 100)
    state = TrainState(stack, opt, sched)
    step = make_train_step(model, loss_kw)
    gen = torch.Generator()
    losses, ms = [], []
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b) for b in batches]
    for k in range(len(batches) + timed):
        gen.manual_seed(step_seed(0, k))
        t0 = time.perf_counter()
        loss = float(step(state, *batches[min(k, len(batches) - 1)], gen)[1])  # a fence
        if k >= len(batches):
            ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    return state, losses, ms


def _state_bytes(state) -> int:
    """This rank's bytes of parameters and AdamW moments (an FSDP shard's
    local part only)."""
    def local(t):
        t = t.to_local() if hasattr(t, "to_local") else t
        return t.numel() * t.element_size()

    n = sum(local(p) for p in state.stack.parameters())
    for st in state.optimizer.state.values():
        n += sum(local(v) for k, v in st.items() if k in ("exp_avg", "exp_avg_sq"))
    return n


def _tree_shapes(tree, prefix=""):
    """{'a/b/c': shape} of a nested dict of arrays."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _tree_shapes(v, f"{prefix}{k}/").items()}
    return {prefix[:-1]: list(np.shape(tree))}


def _peak_reset(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_gib(dev):
    return torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None


def dp_worker_world1(work: Path, spec: dict) -> dict:
    """One process: a float32 step (TF32 off) on the golden frames and
    three bf16 steps at B=spec["batch"] with no process group, then the
    same in a group of world 1 (NCCL on the card), cuDNN deterministic;
    then timed bf16 steps in the group."""
    import torch.distributed as dist
    from datetime import timedelta

    from yogo_tpu_torch.parallel.mesh import full_state_dict

    dev, model, imgs4, grids4 = _dp_setup(spec)
    # cuDNN's backward may pick atomics-based algorithms that differ run to
    # run; two runs of one step compare bit for bit only without them
    cudnn_flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    bf16 = model.with_compute_dtype(torch.bfloat16)
    f32_batch = [_dp_batch(imgs4, grids4, 4)]
    big = [_dp_batch(imgs4, grids4, spec["batch"])] * 3

    def runs():
        st, f32_losses, _ = _dp_steps(model, model.init(torch.Generator().manual_seed(0), device=dev),
                                      f32_batch, dev)
        params = {k: v.cpu() for k, v in full_state_dict(st.stack).items()}
        _, bf16_losses, _ = _dp_steps(bf16, bf16.init(torch.Generator().manual_seed(0), device=dev),
                                      big, dev)
        return params, f32_losses, bf16_losses

    p0, f0, b0 = runs()
    dist.init_process_group(spec["backend"], init_method="env://", world_size=1, rank=0,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S),
                            device_id=dev if spec["backend"] == "nccl" else None)
    try:
        probe = torch.ones(2, device=dev)
        dist.all_reduce(probe)  # the group really carries a collective
        p1, f1, b1 = runs()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn_flags
        _peak_reset(dev)
        _, _, ms = _dp_steps(bf16, bf16.init(torch.Generator().manual_seed(0), device=dev),
                             big[:1], dev, timed=spec["timed_steps"])
        peak = _peak_gib(dev)
    finally:
        dist.destroy_process_group()
    return {"bit_equal": all(torch.equal(p0[k], p1[k]) for k in p0) and sorted(p0) == sorted(p1),
            "max_abs_diff": max(float((p0[k].double() - p1[k].double()).abs().max()) for k in p0),
            "f32_losses": [f0, f1], "bf16_losses": [b0, b1], "all_reduce_probe": probe.tolist(),
            "step_ms": ms, "peak_gib": peak}


def dp_worker_world2(work: Path, spec: dict) -> dict:
    """One rank of world 2 over gloo (two ranks share the one card): f32
    steps replicated and under --fsdp (and its checkpoint), timed bf16
    steps, `infer --count --data-parallel` and `infer --quantize
    --data-parallel` through the CLI, ConvNeXt-Small's state per rank."""
    import contextlib
    import io

    import yogo_tpu_torch.infer as infer_mod
    from yogo_tpu_torch.__main__ import main as cli
    from yogo_tpu_torch.parallel.distributed import barrier, initialize_multihost, process_shard
    from yogo_tpu_torch.parallel.mesh import full_state_dict, local_rows
    from yogo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from yogo_tpu_torch.utils.weights import flax_from_state_dict, optax_state_from_torch

    if not initialize_multihost(backend="gloo", device=spec["device"], timeout_s=RANK_TIMEOUT_S):
        raise AssertionError("no process group")
    rank, world = process_shard()
    dev, model, imgs4, grids4 = _dp_setup(spec)
    out = {"rank": rank}

    # ---- f32, TF32 off: replicated, then --fsdp, from one seed
    log(f"rank {rank}: f32 steps")
    glob = [_dp_batch(imgs4, grids4, F32_GLOBAL_BATCH, pad_last=True)] * 2
    mine = [tuple(local_rows(a, F32_GLOBAL_BATCH // world) for a in b) for b in glob]
    st, out["f32_losses"], _ = _dp_steps(model, model.init(torch.Generator().manual_seed(0), device=dev),
                                         mine, dev)
    out["bn_stats"] = {k: v.cpu().tolist() for k, v in st.stack.state_dict().items() if "running" in k}
    shapes = _tree_shapes(flax_from_state_dict(st.stack.state_dict()))
    log(f"rank {rank}: f32 steps under --fsdp")
    st, out["fsdp_losses"], _ = _dp_steps(model, model.init(torch.Generator().manual_seed(0), device=dev),
                                          mine, dev, fsdp=True)
    variables = flax_from_state_dict(full_state_dict(st.stack))  # every rank gathers
    opt_state = optax_state_from_torch(st.stack, st.optimizer, st.scheduler)
    if rank == 0:
        save_checkpoint(work / "fsdp.ckpt", model, variables, opt_state=opt_state, step=st.step)
        _, v, meta = load_checkpoint(work / "fsdp.ckpt")
        out["fsdp_ckpt"] = {"same_shapes": _tree_shapes(v) == shapes,
                            "step": meta["step"], "opt_state": "_opt_state_bytes" in meta}
    del st, variables, opt_state

    # ---- bf16 at global batch spec["batch"]: step time and memory per rank
    log(f"rank {rank}: bf16 steps")
    bf16 = model.with_compute_dtype(torch.bfloat16)
    b = spec["batch"] // world
    _peak_reset(dev)
    _, _, out["bf16_step_ms"] = _dp_steps(bf16, bf16.init(torch.Generator().manual_seed(0), device=dev),
                                          [_dp_batch(imgs4, grids4, b)], dev, timed=spec["timed_steps"])
    out["bf16_peak_gib"] = _peak_gib(dev)

    # ---- infer through the CLI: counts, launches, per-image files, int8
    img_dir = Path(spec["img_dir"])
    base = ["infer", str(CKPT), "--path-to-images", str(img_dir), "--half", "--no-use-tqdm",
            "--data-parallel", *(["--device", spec["device"]] if spec["device"] else [])]
    cmds = {
        "count": [*base, "--count", "--batch-size", "1"],
        "save_preds": [*base, "--save-preds", "--output-dir", str(work / f"preds_{rank}"),
                       "--batch-size", "1"],
        "quantize": [*base, "--quantize", "--count", "--save-preds", "--output-dir",
                     str(work / f"preds_q_{rank}"), "--batch-size", str(spec["quant_batch"])],
    }
    scales = []
    orig = infer_mod.quant_program_of_rank0

    def spy(*a, **k):
        qp = orig(*a, **k)
        scales.append(qp["scales"].float().cpu().numpy().tobytes().hex())
        return qp

    infer_mod.quant_program_of_rank0 = spy
    out["cli"] = {}
    for name, argv in cmds.items():
        log(f"rank {rank}: infer {name}")
        mark = kernel_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(argv)
        out["cli"][name] = {"printed": [ln for ln in buf.getvalue().splitlines() if ln.startswith("[(")],
                            "launches": kernel_counts(mark, "stem", "int8_conv")}
        barrier()
    infer_mod.quant_program_of_rank0 = orig
    out["int8_scales_hex"] = scales

    # ---- ConvNeXt-Small, full width and depth: state bytes and peak per rank
    if spec["convnext"]:
        from yogo_tpu_torch.models.yogo import YOGO
        from yogo_tpu_torch.ops.grid import encode_label_grid_np

        cnx = YOGO.create(tuple(spec["hw"]), 0.0425, 0.0555, 2, model_version="convnext_small")
        cgrids = np.stack([encode_label_grid_np(bx, *cnx.grid)
                           for bx in gen_golden_images(4, hw=tuple(spec["hw"]))[1]])
        out["convnext"] = {}
        for mode in ("replicated", "fsdp"):
            log(f"rank {rank}: convnext {mode}")
            _peak_reset(dev)
            st, losses, _ = _dp_steps(cnx.with_compute_dtype(torch.bfloat16), perturbed_convnext(cnx, dev),
                                      [_dp_batch(imgs4, cgrids, 4)] * 2, dev, fsdp=mode == "fsdp")
            out["convnext"][mode] = {"losses": losses, "state_bytes": _state_bytes(st),
                                     "peak_gib": _peak_gib(dev)}
            del st
    return out


DP_WORKERS = {"world1": dp_worker_world1, "world2": dp_worker_world2}


def dp_worker_main(argv) -> int:
    """Entry of a PARALLEL_WORKER process: run the mode, write its result."""
    import torch.distributed as dist

    mode, work = argv[0], Path(argv[1])
    sys.path.insert(0, str(REPO))
    spec = json.loads((work / f"{mode}.json").read_text())
    try:
        out = DP_WORKERS[mode](work, spec)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    rank = int(os.environ.get("RANK", "0"))
    (work / f"{mode}.{rank}.json").write_text(json.dumps(out))
    return 0


def parallel_phase(device_arg, imgs4, golden, smi, *, hw=HW, batch=TIMING_BATCH, timed_steps=10,
                   quant_batch=2, convnext=True):
    """Phase 12: multi-process data parallelism (parallel/, the train step,
    global BatchNorm, FSDP, `infer --data-parallel`). device_arg None runs
    on the card; "cpu" rehearses the control flow (gloo everywhere), the
    training parts at a small `hw`; `imgs4` are the 772x1032 golden frames
    the CLI infers on. In order:
      1. world 1: a float32 step (TF32 off) in a process group of world 1
         (NCCL on the card) gives parameters bit-equal to the same step with
         no group, and three bf16 steps at B=`batch` equal losses; then
         timed bf16 steps in the group;
      2. world 2, two ranks on the one card over gloo: f32, global batch 8
         (4 a rank, rank 1's last row a masked pad row), two steps: losses
         within rtol 1e-4 of one process on the same global batch, BN
         running statistics equal on both ranks; the same under --fsdp
         within rtol 2e-4 of the replicated run, its checkpoint read back
         with the same shapes; bf16 at global batch `batch`: step ms and
         peak GiB per rank (gloo's collectives are staged through the host);
      3. `infer --count --data-parallel --half` through the CLI, world 2: rank
         0 alone prints, the line of one process running the same command;
         the NHWC stem launched once a batch on each rank; the per-image
         files of `--save-preds` equal one process's; `--quantize`: rank 1
         runs rank 0's scales bit for bit, the int8 golden gates hold;
      4. ConvNeXt-Small (full width and depth, phase 10's seeded weights)
         at B=4 a rank, two bf16 steps replicated and under --fsdp: each
         rank's parameter + AdamW bytes and peak GiB.
    Returns the numbers; every check raises."""
    import contextlib
    import io

    from yogo_tpu_torch.__main__ import main as cli
    from yogo_tpu_torch.models.yogo import resolve_device
    from yogo_tpu_torch.tools.golden_scene import int8_gates

    dev = resolve_device(device_arg)
    on_card = dev.type == "cuda"
    tmp_ctx = tempfile.TemporaryDirectory()
    work = Path(tmp_ctx.name)
    img_dir = work / "golden"
    img_dir.mkdir()
    for i in range(len(imgs4)):
        write_png_gray(img_dir / f"g{i}.png", imgs4[i, 0])
    spec = {"device": device_arg, "hw": list(hw), "batch": batch, "timed_steps": timed_steps,
            "img_dir": str(img_dir), "quant_batch": quant_batch, "convnext": convnext,
            "backend": "nccl" if on_card else "gloo"}
    out = {}
    t_phase = time.time()

    # ---------------------------------------------------------- 1. world 1
    (w1,) = run_ranks("world1", spec, 1, work)
    if not w1["bit_equal"] or w1["f32_losses"][0] != w1["f32_losses"][1]:
        raise AssertionError(f"world 1 in a {spec['backend']} group differs from no group: "
                             f"losses {w1['f32_losses']}, parameters by {w1['max_abs_diff']}")
    if w1["bf16_losses"][0] != w1["bf16_losses"][1] or w1["all_reduce_probe"] != [1.0, 1.0]:
        raise AssertionError(f"world 1 bf16 losses {w1['bf16_losses']}, probe {w1['all_reduce_probe']}")
    ms1 = statistics.median(w1["step_ms"]) if w1["step_ms"] else None
    out["world1"] = {"backend": spec["backend"], "bit_equal": True, "f32_loss": w1["f32_losses"][0],
                     "bf16_losses": w1["bf16_losses"][0], "bf16_step_ms": ms1,
                     "bf16_img_per_s": batch / ms1 * 1e3 if ms1 else None, "peak_gib": w1["peak_gib"]}
    log(f"parallel world 1 ({spec['backend']}, {smi}): " + json.dumps(out["world1"]))

    # ------------------------------- 2.-4. world 2 over gloo on one device
    # the single-process references first: the f32 steps on the global
    # batch, the CLI commands the ranks run
    _, model, imgs_hw, grids4 = _dp_setup({"device": device_arg, "hw": list(hw)})
    glob = [_dp_batch(imgs_hw, grids4, F32_GLOBAL_BATCH, pad_last=True)] * 2
    _, ref_losses, _ = _dp_steps(model, model.init(torch.Generator().manual_seed(0), device=dev), glob, dev)
    single = {}
    dev_flag = ["--device", device_arg] if device_arg else []
    for name, extra in (("count", ["--count", "--batch-size", "1"]),
                        ("save_preds", ["--save-preds", "--output-dir", str(work / "preds_single"),
                                        "--batch-size", "1"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli(["infer", str(CKPT), "--path-to-images", str(img_dir), "--half", "--no-use-tqdm",
                 *dev_flag, *extra])
        single[name] = [ln for ln in buf.getvalue().splitlines() if ln.startswith("[(")]
    if on_card:
        torch.cuda.empty_cache()

    w2 = run_ranks("world2", spec, 2, work)
    # f32 against one process, BN statistics across the ranks
    for r in w2:
        np.testing.assert_allclose(r["f32_losses"], ref_losses, rtol=1e-4)
        np.testing.assert_allclose(r["fsdp_losses"], r["f32_losses"], rtol=2e-4)
    if w2[0]["bn_stats"] != w2[1]["bn_stats"]:
        raise AssertionError("BN running statistics differ between the ranks")
    if not (w2[0]["fsdp_ckpt"]["same_shapes"] and w2[0]["fsdp_ckpt"]["opt_state"]
            and w2[0]["fsdp_ckpt"]["step"] == 2):
        raise AssertionError(f"--fsdp checkpoint: {w2[0]['fsdp_ckpt']}")
    out["world2_f32"] = {"losses": w2[0]["f32_losses"], "single_process": ref_losses,
                         "max_rel_diff": max(abs(a - b) / abs(b) for a, b in zip(w2[0]["f32_losses"], ref_losses)),
                         "fsdp_max_rel_diff": max(abs(a - b) / abs(b) for a, b in
                                                  zip(w2[0]["fsdp_losses"], w2[0]["f32_losses"])),
                         "fsdp_losses": w2[0]["fsdp_losses"], "bn_equal_on_ranks": True,
                         "fsdp_ckpt": w2[0]["fsdp_ckpt"]}
    log("parallel f32, world 2 (gloo) against one process: " + json.dumps(out["world2_f32"]))
    # the CLI: rank 0 alone prints, one process's line; one stem launch a batch
    cli_r = [r["cli"] for r in w2]
    if cli_r[0]["count"]["printed"] != single["count"] or cli_r[1]["count"]["printed"]:
        raise AssertionError(f"infer --count --data-parallel printed {cli_r[0]['count']['printed']} / "
                             f"{cli_r[1]['count']['printed']}; one process: {single['count']}")
    rounds = -(-len(imgs4) // 2)  # --batch-size 1, two images a rank
    for r, c in enumerate(cli_r):
        if on_card and c["count"]["launches"].get("stem_nhwc", 0) != rounds:
            raise AssertionError(f"rank {r}: stem launches {c['count']['launches']} for {rounds} batches")
    per_image = {}
    for name in ("single", "0", "1"):
        d = work / ("preds_single" if name == "single" else f"preds_{name}")
        for f in sorted(d.glob("*.txt")):
            per_image.setdefault(name, {})[f.name] = f.read_text()
    merged = {**per_image.get("0", {}), **per_image.get("1", {})}
    if merged != per_image["single"] or set(per_image.get("0", {})) & set(per_image.get("1", {})):
        raise AssertionError("infer --save-preds --data-parallel: files differ from one process's")
    counts_per_image = [len(t.splitlines()) for _, t in sorted(merged.items())]
    # int8: rank 0's scales on both ranks, the golden gates on the merged files
    if len(w2[0]["int8_scales_hex"]) != 1 or w2[0]["int8_scales_hex"] != w2[1]["int8_scales_hex"]:
        raise AssertionError("the int8 scales differ between the ranks")
    dets = []
    for i in range(len(imgs4)):
        for r in range(2):
            f = work / f"preds_q_{r}" / f"g{i}.txt"
            if f.exists():
                rows = np.loadtxt(f, ndmin=2) if f.read_text().strip() else np.zeros((0, 5))
                d = np.zeros((len(rows), 5 + 2), np.float32)
                d[:, :4] = rows[:, 1:5]
                d[np.arange(len(rows)), 5 + rows[:, 0].astype(int)] = 1.0
                dets.append(d)
    gates = int8_gates(dets, golden)
    if gates["failures"]:
        raise AssertionError(f"infer --quantize --data-parallel golden gates: {gates}")
    for r, c in enumerate(cli_r):
        if on_card and c["quantize"]["launches"].get("int8_conv", 0) < 3:
            raise AssertionError(f"rank {r}: int8 conv launches {c['quantize']['launches']}")
    out["infer"] = {"printed": cli_r[0]["count"]["printed"], "single_process": single["count"],
                    "per_image": counts_per_image,
                    "launches": {f"rank{r}": {k: c[k]["launches"] for k in c} for r, c in enumerate(cli_r)},
                    "int8_scales_equal": True, "int8_gates": gates,
                    "int8_printed": cli_r[0]["quantize"]["printed"]}
    log("parallel infer --data-parallel, world 2: " + json.dumps(out["infer"]))
    ms2 = [statistics.median(r["bf16_step_ms"]) for r in w2] if w2[0]["bf16_step_ms"] else None
    out["world2_bf16"] = {
        "backend": "gloo (collectives staged through the host, not NCCL's)",
        "global_batch": batch, "step_ms_by_rank": ms2,
        "img_per_s": batch / max(ms2) * 1e3 if ms2 else None,
        "peak_gib_by_rank": [r["bf16_peak_gib"] for r in w2]}
    log(f"parallel bf16 steps, world 1 vs world 2 ({smi}): "
        + json.dumps({"world1": out["world1"], "world2": out["world2_bf16"]}))
    if convnext:
        out["convnext"] = {f"rank{r['rank']}": r["convnext"] for r in w2}
        log(f"parallel ConvNeXt-Small B=4 a rank, replicated vs --fsdp ({smi}): "
            + json.dumps(out["convnext"]))
    out["seconds"] = time.time() - t_phase
    tmp_ctx.cleanup()
    return out


SPATIAL_NS = (2, 4)
# kernel kinds of a forward's device time, by the first of these words in
# a kernel's lower-cased name (the rest are "other": BN, activations, casts)
KERNEL_KINDS = (("copies", ("copy", "catarray")), ("stem", ("stem",)), ("int8_conv", ("int8",)),
                ("convs", ("conv", "xmma", "cudnn", "sm90_", "implicit")))


def device_ms_by_kind(fn, reps=3):
    """Device time of one fn() call by kernel kind (KERNEL_KINDS; torch.profiler,
    CUDA activity only) and its kernel count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {kind: 0.0 for kind, _ in KERNEL_KINDS}
    out.update(other=0.0, kernels=0.0)
    for e in prof.key_averages():
        ms = getattr(e, "device_time_total", 0) / 1e3 / reps
        if ms <= 0:
            continue
        name = e.key.lower()
        kind = next((k for k, words in KERNEL_KINDS if any(w in name for w in words)), "other")
        out[kind] += ms
        out["kernels"] += e.count / reps
    out["total"] = sum(out[k] for k, _ in KERNEL_KINDS) + out["other"]
    return out


def host_enqueue_ms(fn, reps=10):
    """Host time to enqueue one fn() call on an idle card (synchronized
    before each; the device work is not waited for): median of `reps`."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def spatial_phase(device_arg, imgs4, golden, smi, *, ckpt=CKPT, batch=TIMING_BATCH, ns=SPATIAL_NS,
                  timing=True):
    """Phase 13: row-split inference (`--spatial-parallel N`,
    parallel/spatial.py) on `ckpt` at its full size, the N row shards
    mapped onto one device (devices=[dev] * N: the path on the card, not
    scaling). device_arg None runs on the card; "cpu" rehearses the control
    flow. For each N in `ns`:
      1. the stem kernel on each shard's window of the golden frames, NHWC
         and NCHW: the kept rows bit-equal to the unsplit launch's rows;
      2. the bf16 main path, Predictor(devices=[dev] * N).forward_raw and
         its count on the golden frames, the stem's launch counts set to 0
         just before and read just after (N NHWC launches; at N = ns[0]
         also the NCHW stack, N NCHW launches): per-image counts within +-2
         of the golden, the difference from the unsplit port printed; f32
         (TF32 off) within +-1;
      3. int8 (the program calibrated once on the golden frames with the
         unsplit forward): the int8 conv kernel on each shard's window of
         the unsplit codes entering blocks 4-6, the kept rows bit-equal to
         the unsplit launch's; the row-split program's forward with the
         launch counts set to 0 just before (N stem, 3N int8 conv launches);
         predict(quantize=True, spatial_parallel=N) on the golden scene
         within the int8 gates;
    then
      4. `serve --spatial-parallel ns[0]` and `serve --data-parallel` over
         two replicas, micro-batch 4: the golden frames as one raw batch
         request equal the host formatter over the servers' own forwards
         (each replica's half of the batch), per-image counts within +-2 of
         the golden; the launches of that dispatch;
      5. timing (timing=True) at B=`batch`: bf16 and int8 forward_raw for
         N = 1 and `ns` (CUDA events), the halo bytes a batch, each
         forward's device time by kernel kind (torch.profiler: the window
         copies, stem, int8 conv, cuDNN convs, the rest) and the host's
         time to enqueue it.
    Returns (numbers for the report, launches by path); every check raises."""
    import threading

    from yogo_tpu_torch.infer import Predictor, predict
    from yogo_tpu_torch.ops import int8_conv as ic
    from yogo_tpu_torch.ops import quant
    from yogo_tpu_torch.ops.postprocess import format_preds
    from yogo_tpu_torch.ops.stem import fused_stem_nchw
    from yogo_tpu_torch.parallel import spatial
    from yogo_tpu_torch.serve import build_server, format_detections
    from yogo_tpu_torch.serve_client import ServeClient
    from yogo_tpu_torch.tools.golden_scene import int8_gates

    dev = torch.device("cuda", 0) if device_arg is None else torch.device(device_arg)
    on_card = dev.type == "cuda"
    n_img = len(imgs4)
    want_per_image = [len(golden[f"dets_{i}"]) for i in range(n_img)]
    out, launches = {"n": list(ns)}, {}
    t_phase = time.time()

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counts(pred, raw):
        return [int(pred.count(raw, torch.arange(n_img) == i).sum()) for i in range(n_img)]

    mark = kernel_counts()

    def launched():
        sync()
        return kernel_counts(mark, "stem", "int8_conv")

    def clear():
        nonlocal mark
        sync()
        mark = kernel_counts()

    pred1 = Predictor.from_checkpoint(ckpt, half=True, device=dev)
    model, h = pred1.model, int(pred1.model.img_size[0])
    plans = {n: spatial.plan_rows(model.defn.blocks, h, n) for n in ns}
    per1 = counts(pred1, pred1.forward_raw(imgs4))

    # ------------------------------------------- 1. the stem, shard by shard
    x = torch.from_numpy(imgs4[:, 0].copy()).to(dev)
    w9, b9 = (t.detach() for t in pred1.stack.folded_stem())
    for layout in ("nhwc", "nchw"):
        whole = fused_stem_nchw(x, w9, b9, layout=layout)
        for n in ns:
            lr = plans[n][0]
            for k, ((lo, hi), (a, b, t)) in enumerate(zip(lr.own_out, lr.windows)):
                part = fused_stem_nchw(x[:, a:b].contiguous(), w9, b9, layout=layout)
                if not torch.equal(part[:, :, t:t + hi - lo], whole[:, :, lo:hi]):
                    raise AssertionError(f"stem {layout} N={n} shard {k}: rows [{lo}, {hi}) differ "
                                         "from the unsplit launch's")
    out["stem_shards_bit_equal"] = {"layouts": ["nhwc", "nchw"], "n": list(ns),
                                    "windows": {n: [list(w) for w in plans[n][0].windows] for n in ns}}
    log(f"spatial: stem per shard bit-equal to the unsplit rows: {json.dumps(out['stem_shards_bit_equal'])}")

    # ------------------------------------ 2. bf16 and f32 main path, golden
    f32 = Predictor.from_checkpoint(ckpt, device=dev)
    per1_f32 = counts(f32, f32.forward_raw(imgs4))
    for n in ns:
        rep = {}
        variants = [("nhwc", pred1)]
        if n == ns[0]:
            variants.append(("nchw", Predictor.from_checkpoint(ckpt, half=True, device=dev,
                                                               channels_last=False)))
        for layout, base in variants:
            pn = Predictor(base.model, base.stack, devices=[dev] * n)
            clear()
            raw = pn.forward_raw(imgs4)
            got = launched()
            per = counts(pn, raw)
            if raw.shape != (n_img, *model.grid[::-1], 5 + model.num_classes) or \
                    not torch.isfinite(raw.float()).all():
                raise AssertionError(f"spatial bf16 {layout} N={n}: bad head {tuple(raw.shape)}")
            if on_card and got.get(f"stem_{layout}", 0) != n:
                raise AssertionError(f"spatial bf16 {layout} N={n}: stem launches {got}, not {n}")
            if any(abs(a - b) > 2 for a, b in zip(per, want_per_image)):
                raise AssertionError(f"spatial bf16 {layout} N={n}: counts {per} vs golden {want_per_image}")
            rep[f"bf16_{layout}"] = {"per_image": per, "minus_unsplit": [a - b for a, b in zip(per, per1)],
                                     "launches": got, "halo_bytes": pn.rows.halo_bytes}
            launches[f"infer_bf16_{layout}_n{n}"] = got
        pn = Predictor(f32.model, f32.stack, devices=[dev] * n)
        per = counts(pn, pn.forward_raw(imgs4))
        if any(abs(a - b) > 1 for a, b in zip(per, want_per_image)):
            raise AssertionError(f"spatial f32 N={n}: counts {per} vs golden {want_per_image}")
        rep["f32"] = {"per_image": per, "minus_unsplit": [a - b for a, b in zip(per, per1_f32)]}
        out[f"n{n}"] = rep
        log(f"spatial N={n} golden counts (golden {want_per_image}): " + json.dumps(rep))
    del f32, pn

    # --------------------------------------------------------------- 3. int8
    pq = Predictor.from_checkpoint(ckpt, device=dev, quantize=True, calib=[imgs4])
    qp = pq.qp
    specs = model.defn.blocks
    qblocks = [1 + j for j, b in enumerate(qp["blocks"]) if "w8" in b]
    rec = []
    quant.quantized_forward(model, qp, torch.from_numpy(imgs4).to(dev), decode=False, record=rec)
    checked = 0
    for i, codes in zip(qblocks, rec):
        blk, spec = qp["blocks"][i - 1], specs[i]
        s8 = i + 1 < len(specs) and "w8" in qp["blocks"][i]
        kw = dict(cin=specs[i - 1].out, stride=spec.stride, padding=spec.padding, act=spec.act,
                  out_scale=qp["scales"][i:i + 1] if s8 else None)
        codes = codes.contiguous()
        whole = ic.int8_conv(codes, blk["w8"], blk["deq"], blk["b"], **kw)
        for n in ns:
            lr = plans[n][i]
            for k, ((lo, hi), (a, b, t)) in enumerate(zip(lr.own_out, lr.windows)):
                part = ic.int8_conv(codes[:, a:b].contiguous(), blk["w8"], blk["deq"], blk["b"], **kw)
                if not torch.equal(part[:, t:t + hi - lo], whole[:, lo:hi]):
                    raise AssertionError(f"int8_conv block {i} N={n} shard {k}: rows [{lo}, {hi}) differ "
                                         "from the unsplit launch's")
                checked += 1
    out["int8_conv_shards_bit_equal"] = {"blocks": qblocks, "shard_launches_checked": checked}
    raw1 = pq.forward_raw(imgs4)
    tmp_ctx = tempfile.TemporaryDirectory()
    img_dir = Path(tmp_ctx.name) / "golden"
    img_dir.mkdir()
    for i in range(n_img):
        write_png_gray(img_dir / f"g{i}.png", imgs4[i, 0])
    for n in ns:
        pn = Predictor(model, pq.stack, qp=qp, devices=[dev] * n)
        clear()
        raw = pn.forward_raw(imgs4)
        got = launched()
        if on_card and (got.get("stem_nhwc", 0) != n or got.get("int8_conv", 0) != len(qblocks) * n):
            raise AssertionError(f"spatial int8 N={n}: launches {got}, not {n} stem and "
                                 f"{len(qblocks) * n} int8 conv")
        launches[f"infer_quantize_n{n}"] = got
        max_dev = float((raw - raw1).abs().max())
        preds = predict(ckpt, path_to_images=img_dir, return_full_predictions=True, batch_size=n_img,
                        quantize=True, spatial_parallel=n, devices=[dev] * n)
        gates = int8_gates([format_preds(p, obj_thresh=0.5, iou_thresh=0.5) for p in preds], golden)
        if gates["failures"]:
            raise AssertionError(f"spatial int8 N={n}: golden gates {gates}")
        out[f"n{n}"]["int8"] = {"launches": got, "head_max_abs_dev_from_unsplit": max_dev,
                                "golden": gates}
        log(f"spatial int8 N={n}: " + json.dumps(out[f"n{n}"]["int8"]))
    tmp_ctx.cleanup()

    # ------------------------------------------------------------ 4. servers
    thr = {"obj_thresh": 0.5, "iou_thresh": 0.5, "min_class_confidence_threshold": 0.0}
    classes = list(pred1.meta.get("class_names") or pred1.meta.get("classes"))
    frames = np.ascontiguousarray(imgs4)
    for name, kw in ((f"serve_spatial_{ns[0]}", dict(spatial_parallel=ns[0], devices=[dev] * ns[0])),
                     ("serve_data_parallel_2", dict(data_parallel=True, devices=[dev] * 2))):
        srv = build_server(ckpt, port=0, half=True, batch_size=n_img, linger_ms=5.0, **kw)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            preds = srv.yogo_state["predictors"]
            g = n_img // len(preds)
            decoded = np.concatenate([p.forward(frames[k * g:(k + 1) * g]).cpu().numpy()
                                      for k, p in enumerate(preds)])
            want = [format_detections(d, classes, **thr) for d in decoded]
            clear()
            with ServeClient("127.0.0.1", srv.server_address[1], timeout=120) as c:
                got = c.predict_many(frames)
            got_launches = launched()
            info = srv.yogo_info
        finally:
            srv.shutdown()
            srv.yogo_batcher.shutdown()
            srv.server_close()
            th.join(timeout=30)
        per = [sum(r["counts"].values()) for r in got]
        if got != want:
            raise AssertionError(f"{name}: answers differ from the host formatter over the server's forward")
        if any(abs(a - b) > 2 for a, b in zip(per, want_per_image)):
            raise AssertionError(f"{name}: counts {per} vs golden {want_per_image}")
        stems = sum(len(p.devices) for p in preds)
        if on_card and got_launches.get("stem_nhwc", 0) != stems:
            raise AssertionError(f"{name}: one dispatch launched {got_launches}, not {stems} stems")
        launches[name] = got_launches
        out[name] = {"per_image": per, "replicas": len(preds), "launches_one_dispatch": got_launches,
                     "spatial_parallel": info["spatial_parallel"],
                     "data_parallel_devices": info["data_parallel_devices"], "bit_equal": True}
        log(f"spatial {name}: " + json.dumps(out[name]))

    # ------------------------------------------------------------- 5. timing
    if timing and on_card:
        big = torch.from_numpy(np.concatenate([imgs4] * (batch // n_img))).to(dev)
        t = {"batch": batch, "card": smi, "bf16_forward_ms": {}, "int8_forward_ms": {},
             "halo_bytes": {}, "device_ms_by_kind": {}, "host_enqueue_ms": {}}
        for n in (1, *ns):
            pb = pred1 if n == 1 else Predictor(model, pred1.stack, devices=[dev] * n)
            p8 = pq if n == 1 else Predictor(model, pq.stack, qp=qp, devices=[dev] * n)
            t["bf16_forward_ms"][n] = cuda_ms(lambda: pb.forward_raw(big), 10)
            t["int8_forward_ms"][n] = cuda_ms(lambda: p8.forward_raw(big), 5, per_rep=5)
            for name, p in (("bf16", pb), ("int8", p8)):
                t["device_ms_by_kind"][f"{name}_n{n}"] = device_ms_by_kind(lambda: p.forward_raw(big))
                t["host_enqueue_ms"][f"{name}_n{n}"] = host_enqueue_ms(lambda: p.forward_raw(big))
            if n > 1:
                pb.forward_raw(big)
                t["halo_bytes"][n] = pb.rows.halo_bytes
                p8.forward_raw(big)
                t["halo_bytes"][f"{n}_int8"] = p8.rows.halo_bytes
        out["timing"] = t
        log(f"spatial timing (B={batch}, N shards on one card, {smi}): " + json.dumps(t))
        del big
    out["seconds"] = time.time() - t_phase
    return out, launches


# one step's update of a parameter whose gradient is zero in exact arithmetic
# (a conv bias in front of a BN: base_model's conv5) is AdamW's lr-sized
# answer to float noise, of the noise's sign
SPATIAL_TRAIN_ZERO_GRAD = ("conv5.bias",)
# the split's BN running statistics against the unsplit step's. (On the
# CPU, whose batch_norm is 9e-5 off the float64 variance at B=4 772x1032
# where the split's float64 sums are 5e-8 off, a rehearsal sets 1e-3.)
SPATIAL_TRAIN_BN_RTOL = 1e-5
# the bf16 ConvNeXt head split against unsplit, relative to the head's
# largest value: the same bf16 ops on the same rows, summed in other orders
# where cuDNN picks another algorithm for another height, through 36 blocks
CONVNEXT_SPLIT_BF16_REL = 3e-2


def spatial_train_phase(device_arg, imgs4, boxes4, golden, smi, *, ckpt=CKPT, data_defn=None,
                        ns=SPATIAL_NS, batch=TIMING_BATCH, small=4, timing=True, convnext_hw=HW,
                        serve_n=2):
    """Phase 14: row-split training and ConvNeXt-Small's row split, the N
    row shards on the one card (devices=[dev] * N: the path, not scaling).
    device_arg None runs on the card; "cpu" rehearses the control flow
    (convnext_hw small). In order:
      1. base_model at `ckpt`'s size from a seeded init, one f32 step (TF32
         off) at B=`small` with flips and dropout on, split N in `ns`
         against the unsplit step: loss rtol 1e-5, every parameter rtol
         1e-4 / atol 1e-6 (an element whose gradient changes sign between
         the two, AdamW's lr-sized answer to float noise, and
         SPATIAL_TRAIN_ZERO_GRAD held to 2 lr instead, and counted), every
         gradient within 1e-4 of the float64 step's, relative to its
         parameter's largest, or within 4 times the unsplit gradient's
         own error where float32 cancels (grad_gate), the BN running
         statistics rtol SPATIAL_TRAIN_BN_RTOL; the stem launched no time;
      2. (timing) bf16 steps at B=`batch` for N = 1 and `ns`: step ms
         (median of 10, CUDA events), peak GiB, the step's device ms by
         kernel kind (the window copies forward and backward);
      3. Trainer(devices=[dev] * 2, spatial_parallel=2) fine-tuning the
         golden checkpoint for one epoch on `data_defn` (phase 7's 320
         frames; BN frozen, as a fine-tune is): its best.ckpt reloaded by
         the float Predictor holds the golden counts (+-1 a frame, f32);
      4. ConvNeXt-Small at `convnext_hw` on phase 10's seeded weights
         (perturbed_convnext): the f32 split head at B=`small` against the
         unsplit (rtol = atol = 1e-4, TF32 off); bf16 forward_raw for N =
         1 and `ns` at B=`batch`, each split head against the unsplit within
         CONVNEXT_SPLIT_BF16_REL of its largest value, ms and device ms by
         kind; int8 (calibrated on the golden frames, unsplit): 71 N
         int8_conv launches a batch, each shard's launch at B=`small` equal
         to the unsplit launch's rows on the same codes at all 71 sites, the
         codes against the unsplit program's (counted), the head within
         phase 10's int8 noise gate of the f32 head (0.1 of its largest
         value), forward ms at B=`batch`; one
         f32 split train step at B=`small` against the unsplit (loss rtol
         1e-5, every gradient as in 1.);
         `serve --spatial-parallel serve_n` bf16 at micro-batch 4 equal to
         the host formatter over the server's own forward.
    Returns (numbers for the report, launches by path). Every check raises."""
    import copy
    import threading

    from yogo_tpu_torch.infer import Predictor
    from yogo_tpu_torch.models.yogo import YOGO
    from yogo_tpu_torch.ops import int8_conv as ic
    from yogo_tpu_torch.ops import quant_convnext as qc
    from yogo_tpu_torch.ops.grid import encode_label_grid_np
    from yogo_tpu_torch.parallel import spatial
    from yogo_tpu_torch.serve import build_server, format_detections
    from yogo_tpu_torch.serve_client import ServeClient
    from yogo_tpu_torch.train import Trainer, TrainState, make_optimizer, make_train_step
    from yogo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from yogo_tpu_torch.utils.default_hyperparams import DefaultHyperparams as df
    from yogo_tpu_torch.utils.weights import flax_from_state_dict

    dev = torch.device("cuda", 0) if device_arg is None else torch.device(device_arg)
    on_card = dev.type == "cuda"
    n_img = len(imgs4)
    want_per_image = [len(golden[f"dets_{i}"]) for i in range(n_img)]
    out, launches = {"n": list(ns), "card": smi}, {}
    t_phase = time.time()
    lr = 1e-3
    loss_kw = dict(no_obj_weight=df.NO_OBJ_WEIGHT, iou_weight=df.IOU_WEIGHT,
                   classify_weight=df.CLASSIFY_WEIGHT, label_smoothing=df.LABEL_SMOOTHING)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def reset_peak():
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if on_card else None

    def tiled(x, n):
        return np.concatenate([x] * -(-n // len(x)))[:n]

    def grad_gate(tag, got, want, ref):
        """Each parameter's split float32 gradient `got` against the float64
        step's `ref`, relative to its largest element: within 1e-4, or
        within 4 times the unsplit float32 gradient's (`want`) own error
        (a gradient that is a residue of cancelling float32 sums, as block
        0's over raw frames). Returns the worst."""
        worst = (-1.0, None, None)
        for k, r in ref.items():
            if k in SPATIAL_TRAIN_ZERO_GRAD:
                continue
            scale = r.abs().max().clamp(min=1e-30)
            e_split = float((got[k].double() - r).abs().max() / scale)
            e_unsplit = float((want[k].double() - r).abs().max() / scale)
            if e_split > max(1e-4, 4 * e_unsplit):
                raise AssertionError(f"{tag}: gradient of {k} off the float64 step's by {e_split} of its max "
                                     f"(the unsplit step's by {e_unsplit})")
            worst = max(worst, (e_split, k, e_unsplit))
        return {"grad_max_rel_err_vs_float64": worst[0], "grad_worst": worst[1],
                "unsplit_grad_rel_err_there": worst[2]}

    def steps_of(model, base, n, x, labels, *, steps=1, remat="none", augment=True):
        """`steps` steps of make_train_step from a copy of `base`, rows over
        n handles to `dev` (unsplit at 1): (losses, state, the gradients of
        the last step before the optimizer's clamp, stem launches)."""
        stack = copy.deepcopy(base)
        opt, sched, _ = make_optimizer(stack.parameters(), lr, df.WEIGHT_DECAY, df.DECAY_FACTOR, 100)
        grads = {}

        def grab(opt, args, kwargs):
            grads.update({k: p.grad.detach().clone() for k, p in stack.named_parameters()})

        opt.register_step_pre_hook(grab)
        state = TrainState(stack, opt, sched)
        rows = spatial.RowSplit(model, [dev] * n) if n > 1 else None
        step = make_train_step(model, loss_kw, augment=augment, remat=remat, rows=rows)
        mask = torch.ones(len(x), device=dev)
        mark = kernel_counts()
        losses = [float(step(state, x, labels, mask, torch.Generator().manual_seed(11 + k))[1])
                  for k in range(steps)]
        sync()
        sd = {k: v.detach().clone() for k, v in stack.state_dict().items()}
        return losses, sd, grads, sum(kernel_counts(mark, "stem").values()), (state, step, rows)

    # -------------------------------- 1. base_model: the f32 gate at B=small
    gold_model, _, _ = load_checkpoint(ckpt)
    sx, sy = gold_model.grid
    grids4 = np.stack([encode_label_grid_np(b, sx, sy) for b in boxes4])
    f32 = dataclasses.replace(gold_model, compute_dtype=torch.float32)
    base = f32.init(torch.Generator().manual_seed(5), device=dev)
    x4 = torch.from_numpy(tiled(imgs4, small)).to(dev)
    lab4 = torch.from_numpy(tiled(grids4, small)).to(dev)
    l1, sd1, g1, _, _ = steps_of(f32, base, 1, x4, lab4)
    g64 = steps_of(dataclasses.replace(f32, compute_dtype=torch.float64), copy.deepcopy(base).double(), 1,
                   x4, lab4)[2]
    out["f32_gate"] = {"batch": small, "loss_unsplit": l1[0]}
    launches["train_spatial_f32"] = {}
    for n in ns:
        ln, sdn, gn, stems, _ = steps_of(f32, base, n, x4, lab4)
        launches["train_spatial_f32"][n] = stems
        if not np.isclose(ln[0], l1[0], rtol=1e-5):
            raise AssertionError(f"split training N={n}: loss {ln[0]} vs unsplit {l1[0]}")
        grad_rep = grad_gate(f"split training N={n}", gn, g1, g64)
        flipped = 0
        for k, w in sd1.items():
            if not w.is_floating_point():
                continue
            if k.endswith(("running_mean", "running_var")):
                if not torch.allclose(sdn[k], w, rtol=SPATIAL_TRAIN_BN_RTOL, atol=1e-6):
                    raise AssertionError(f"split training N={n}: BN statistic {k} differs by "
                                         f"{float(((sdn[k] - w) / w).abs().max())} relative")
                continue
            bad = ~torch.isclose(sdn[k], w, rtol=1e-4, atol=1e-6)
            if k in SPATIAL_TRAIN_ZERO_GRAD:
                excused = torch.ones_like(bad)
            else:
                excused = torch.sign(gn[k]) != torch.sign(g1[k])
            flipped += int((bad & excused).sum())
            if bool((bad & ~excused).any()) or float((sdn[k] - w).abs().max()) > 2 * lr + 1e-6:
                raise AssertionError(f"split training N={n}: parameter {k} differs by "
                                     f"{float((sdn[k] - w).abs().max())}")
        if on_card and stems:
            raise AssertionError(f"split training N={n} launched the stem kernel {stems} times")
        out["f32_gate"][f"n{n}"] = {"loss": ln[0], **grad_rep, "sign_flipped_elements": flipped}
    log(f"spatial training f32 gate at B={small} ({smi}): " + json.dumps(out["f32_gate"]))
    del base, sd1, g1, g64

    # --------------------------------------- 2. bf16 step timing at B=batch
    bf16 = dataclasses.replace(gold_model, compute_dtype=torch.bfloat16)
    if timing and on_card:
        base = bf16.init(torch.Generator().manual_seed(5), device=dev)
        xb = torch.from_numpy(tiled(imgs4, batch)).to(dev)
        labb = torch.from_numpy(tiled(grids4, batch)).to(dev)
        t = {"batch": batch, "step_ms": {}, "peak_gib": {}, "device_ms_by_kind": {}, "halo_bytes": {}}
        launches["train_spatial_bf16"] = {}
        for n in (1, *ns):
            reset_peak()
            stack = copy.deepcopy(base)
            opt, sched, _ = make_optimizer(stack.parameters(), lr, df.WEIGHT_DECAY, df.DECAY_FACTOR, 1000)
            state = TrainState(stack, opt, sched)
            rows = spatial.RowSplit(bf16, [dev] * n) if n > 1 else None
            step = make_train_step(bf16, loss_kw, rows=rows)
            mask = torch.ones(batch, device=dev)
            gen = torch.Generator().manual_seed(3)
            mark = kernel_counts()

            def one():
                return step(state, xb, labb, mask, gen)[1]

            t["step_ms"][n] = cuda_ms(one, reps=10, per_rep=1, warmup=2)
            t["peak_gib"][n] = peak_gib()
            t["device_ms_by_kind"][n] = device_ms_by_kind(one)
            sync()
            launches["train_spatial_bf16"][n] = sum(kernel_counts(mark, "stem").values())
            if launches["train_spatial_bf16"][n]:
                raise AssertionError(f"bf16 split training N={n} launched the stem kernel")
            if rows is not None:
                t["halo_bytes"][n] = rows.halo_bytes
            del stack, opt, sched, state, step, rows
        out["bf16_timing"] = t
        log(f"spatial training bf16 B={batch} ({smi}): " + json.dumps(t))
        del base, xb, labb

    # ---------------------------------------- 3. the Trainer, one epoch
    if data_defn is not None:
        tmp_ctx = tempfile.TemporaryDirectory()
        run_dir = Path(tmp_ctx.name) / "run"
        cfg = {
            "learning_rate": 1e-5, "decay_factor": df.DECAY_FACTOR, "weight_decay": df.WEIGHT_DECAY,
            "label_smoothing": df.LABEL_SMOOTHING, "iou_weight": df.IOU_WEIGHT,
            "no_obj_weight": df.NO_OBJ_WEIGHT, "classify_weight": df.CLASSIFY_WEIGHT,
            "epochs": 1, "batch_size": batch if on_card else small,
            "anchor_w": gold_model.anchor_w, "anchor_h": gold_model.anchor_h, "model": None,
            "half": True, "rgb": False, "image_hw": tuple(gold_model.img_size),
            "pretrained_path": str(ckpt), "normalize_images": False, "dataset_split_override": None,
            "dataset_descriptor_file": str(data_defn), "name": "spatial", "note": None, "tags": None,
            "wandb_entity": None, "wandb_project": None, "use_wandb": False,
            "model_save_dir": str(run_dir), "spatial_parallel": 2, "fast_eval": True,
        }
        t0 = time.time()
        trainer = Trainer(cfg, devices=[dev] * 2)
        trainer.init()
        start = trainer.global_step  # the checkpoint's
        mark = kernel_counts()
        trainer.train()
        sync()
        launches["trainer_spatial_2"] = sum(kernel_counts(mark, "stem").values())
        steps = trainer.global_step - start
        del trainer
        pred = Predictor.from_checkpoint(run_dir / "best.ckpt", device=dev)
        raw = pred.forward_raw(imgs4)
        per = [int(pred.count(raw, torch.arange(n_img) == i).sum()) for i in range(n_img)]
        if any(abs(a - b) > 1 for a, b in zip(per, want_per_image)):
            raise AssertionError(f"Trainer(spatial_parallel=2) best.ckpt: counts {per} vs golden {want_per_image}")
        out["trainer"] = {"devices": [str(dev)] * 2, "steps": steps, "seconds": time.time() - t0,
                          "per_image": per, "golden": want_per_image,
                          "stem_launches_train_and_test": launches["trainer_spatial_2"]}
        log("spatial Trainer, one fine-tune epoch, best.ckpt counted f32: " + json.dumps(out["trainer"]))
        del pred, raw
        tmp_ctx.cleanup()

    # ---------------------------------------------------- 4. ConvNeXt-Small
    classes = ["cell", "parasite"]
    cmodel = YOGO.create(convnext_hw, 0.0425, 0.0555, len(classes), model_version="convnext_small")
    cbf16 = cmodel.with_compute_dtype(torch.bfloat16)
    net = perturbed_convnext(cmodel, dev)
    cx4 = torch.from_numpy(tiled(imgs4, small)[..., :convnext_hw[0], :convnext_hw[1]].copy()).to(dev)
    cnx = {}
    # f32 heads at B=small, TF32 off (YOGO.apply / RowSplit hold no_tf32)
    head1 = Predictor(cmodel, net).forward_raw(cx4)
    cnx["f32"] = {}
    for n in ns:
        head = Predictor(cmodel, net, devices=[dev] * n).forward_raw(cx4)
        err = float((head - head1).abs().max())
        if not torch.allclose(head, head1, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"convnext f32 split N={n}: head off by {err}")
        cnx["f32"][n] = {"max_abs_err": err, "max_abs_head": float(head1.abs().max())}
    log(f"spatial convnext f32 heads at B={small}: " + json.dumps(cnx["f32"]))

    # bf16 heads and time at B=batch
    cbig = torch.from_numpy(tiled(imgs4, batch if on_card else small)[..., :convnext_hw[0], :convnext_hw[1]]
                            .copy()).to(dev)
    p1 = Predictor(cbf16, net)
    ref = p1.forward_raw(cbig).float()
    cnx["bf16"] = {"batch": len(cbig), "ms": {}, "device_ms_by_kind": {}, "head_rel_err": {}, "halo_bytes": {}}
    for n in (1, *ns):
        pn = p1 if n == 1 else Predictor(cbf16, net, devices=[dev] * n)
        mark = kernel_counts()
        head = pn.forward_raw(cbig).float()
        rel = float((head - ref).abs().max() / ref.abs().max())
        if rel > CONVNEXT_SPLIT_BF16_REL or not torch.isfinite(head).all():
            raise AssertionError(f"convnext bf16 split N={n}: head off by {rel} of its max")
        if kernel_counts(mark, "stem"):
            raise AssertionError("convnext launched the stem kernel")
        cnx["bf16"]["head_rel_err"][n] = rel
        if n > 1:
            cnx["bf16"]["halo_bytes"][n] = pn.rows.halo_bytes
        if timing and on_card:
            cnx["bf16"]["ms"][n] = cuda_ms(lambda: pn.forward_raw(cbig), 5, per_rep=2, warmup=1)
            cnx["bf16"]["device_ms_by_kind"][n] = device_ms_by_kind(lambda: pn.forward_raw(cbig), reps=2)
        del pn, head
    del ref
    log(f"spatial convnext bf16 B={len(cbig)} ({smi}): " + json.dumps(cnx["bf16"]))

    # int8: calibrated once on the golden frames, unsplit
    qp = qc.quantize_convnext(cmodel, net, [cx4[:min(small, n_img)]], device=dev)
    keys = [k for k, _ in qc.quant_sites()]
    rec1 = []
    qraw1 = qc.quantized_convnext_forward(cmodel, qp, cx4, decode=False, record=rec1)
    seen = {}
    site_conv = qc.QuantLayers.site_conv

    def spy(self, key, h, stride):
        y = site_conv(self, key, h, stride)
        if key in self.int8:
            seen.setdefault(key, []).append(y)
        return y

    cnx["int8"] = {"launches_by_n": {}, "codes_equal_sites": {}, "head_max_abs_dev": {}, "ms": {}}
    checked = 0
    launches["convnext_int8_spatial"] = {}
    for n in ns:
        pq = Predictor(cmodel, net, qp=qp, devices=[dev] * n)
        rec = []
        seen.clear()
        qc.QuantLayers.site_conv = spy
        try:
            sync()
            mark = kernel_counts()
            qraw = pq.rows.forward_raw(pq.shard_weights, cx4, record=rec)
            sync()
            got = sum(kernel_counts(mark, "int8_conv").values())
        finally:
            qc.QuantLayers.site_conv = site_conv
        launches["convnext_int8_spatial"][n] = got
        if on_card and got != len(keys) * n:
            raise AssertionError(f"convnext int8 split N={n}: {got} int8_conv launches, not {len(keys) * n}")
        for key, codes in zip(keys, rec):
            blk = qp["int8"][key]
            whole = ic.int8_conv(codes.contiguous(), blk["w8"], blk["deq"], blk["b"], cin=codes.shape[-1],
                                 stride=2 if key.startswith("down") else 1, padding=0, act=None)
            if len(seen[key]) != n or not torch.equal(torch.cat(seen[key], 1), whole):
                raise AssertionError(f"convnext int8 split N={n}: a shard's launch at {key} differs from "
                                     "the unsplit launch's rows on the same codes")
            checked += n
        # the codes against the unsplit program's: cuDNN and cuBLAS may sum a
        # shard's float convs and Dense layers in another order than the
        # whole image's (another height, another algorithm), and a code that
        # sat on a rounding boundary moves by one; the head is then held
        # to phase 10's int8 noise gate against the f32 head
        shares = [float((a == b).float().mean()) for a, b in zip(rec, rec1)]
        cnx["int8"]["codes_equal_sites"][n] = sum(s == 1.0 for s in shares)
        cnx["int8"].setdefault("codes_equal_share_by_site", {})[n] = shares
        cnx["int8"]["head_max_abs_dev"][n] = float((qraw - qraw1).abs().max())
        noise = float((qraw - head1).abs().max())
        cnx["int8"].setdefault("vs_f32_head", {})[n] = noise
        if not noise < 0.1 * float(head1.abs().max()):
            raise AssertionError(f"convnext int8 split N={n}: head off the f32 head by {noise}")
        cnx["int8"]["launches_by_n"][n] = got
        del pq, rec
    cnx["int8"]["shard_launches_checked"] = checked
    cnx["int8"]["unsplit_vs_f32_head"] = float((qraw1 - head1).abs().max())
    del rec1, seen
    if timing and on_card:
        for n in (1, *ns):
            if n == 1:
                def fwd():
                    return qc.quantized_convnext_forward(cmodel, qp, cbig, decode=False)
            else:
                pq = Predictor(cmodel, net, qp=qp, devices=[dev] * n)

                def fwd(pq=pq):
                    return pq.rows.forward_raw(pq.shard_weights, cbig)
            cnx["int8"]["ms"][n] = cuda_ms(fwd, 5, per_rep=2, warmup=1)
    log(f"spatial convnext int8 ({smi}): " + json.dumps(cnx["int8"]))

    # one f32 split train step at B=small against the unsplit
    csx, csy = cmodel.grid
    clab = torch.from_numpy(np.stack([encode_label_grid_np(boxes4[k % n_img], csx, csy)
                                      for k in range(small)])).to(dev)
    cl1, _, cg1, _, _ = steps_of(cmodel, net, 1, cx4, clab)
    cg64 = steps_of(cmodel.with_compute_dtype(torch.float64), copy.deepcopy(net).double(), 1, cx4, clab)[2]
    cnx["train"] = {"loss_unsplit": cl1[0]}
    for n in ns:
        cln, _, cgn, _, _ = steps_of(cmodel, net, n, cx4, clab, remat="blocks")
        if not np.isclose(cln[0], cl1[0], rtol=1e-5):
            raise AssertionError(f"convnext split train N={n}: loss {cln[0]} vs {cl1[0]}")
        cnx["train"][n] = {"loss": cln[0], **grad_gate(f"convnext split train N={n}", cgn, cg1, cg64)}
    del cg1, cg64
    log(f"spatial convnext f32 train step B={small} remat=blocks: " + json.dumps(cnx["train"]))

    # serve --spatial-parallel serve_n, bf16, micro-batch 4
    tmp_ctx = tempfile.TemporaryDirectory()
    cckpt = Path(tmp_ctx.name) / "convnext.ckpt"
    save_checkpoint(cckpt, cmodel, flax_from_state_dict(net.state_dict()), classes=classes)
    del net
    thr = {"obj_thresh": 0.5, "iou_thresh": 0.5, "min_class_confidence_threshold": 0.0}
    frames = np.ascontiguousarray(imgs4[..., :convnext_hw[0], :convnext_hw[1]])
    srv = build_server(cckpt, port=0, half=True, batch_size=n_img, linger_ms=5.0,
                       spatial_parallel=serve_n, devices=[dev] * serve_n)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        (p,) = srv.yogo_state["predictors"]
        want = [format_detections(d, classes, **thr) for d in p.forward(frames).cpu().numpy()]
        with ServeClient("127.0.0.1", srv.server_address[1], timeout=300) as c:
            got = c.predict_many(frames)
        info = srv.yogo_info
    finally:
        srv.shutdown()
        srv.yogo_batcher.shutdown()
        srv.server_close()
        th.join(timeout=30)
        tmp_ctx.cleanup()
    if got != want or info["spatial_parallel"] != serve_n:
        raise AssertionError(f"convnext serve --spatial-parallel {serve_n}: answers differ from the "
                             "host formatter over the server's forward")
    cnx["serve"] = {"spatial_parallel": serve_n, "per_image": [sum(r["counts"].values()) for r in got],
                    "bit_equal": True}
    log("spatial convnext serve: " + json.dumps(cnx["serve"]))
    out["convnext"] = cnx
    out["seconds"] = time.time() - t_phase
    return out, launches


def main() -> int:
    # ------------------------------------------------------------ 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from yogo_tpu_torch import kernels
    from yogo_tpu_torch.infer import Predictor
    from yogo_tpu_torch.ops.stem import fused_stem_nchw, fused_stem_reference
    from yogo_tpu_torch.utils.tracing import COUNTS

    def nms_per_call(before: dict) -> tuple:
        """(keep updates, host syncs, kernel launches) an NMS call since the
        COUNTS copy `before`, a mean over the calls."""
        n = max(COUNTS["nms_calls"] - before.get("nms_calls", 0), 1)
        return tuple((COUNTS[k] - before.get(k, 0)) / n
                     for k in ("nms_rounds", "nms_host_syncs", "nms_kernel_launches"))

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
    for name in kernels.SOURCES:
        log(f"--- nvcc csrc/{name}.cu ---\n{kernels.build_log(name).strip()}")
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
    report["ptxas"] = {name: kernels.ptxas_summary(kernels.build_log(name)) for name in kernels.SOURCES}
    report["int8_conv_build"] = int8_conv_build_check(
        report["sass"], torch.cuda.get_device_properties(dev).multi_processor_count)

    # ------------------------------------- 3. kernels vs their plain versions
    golden = dict(np.load(GOLDEN))
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
        # the batch shapes of phases 4 and 6 (4 frames) and of phase 8's
        # B=8 server (phases 5, 7 and 8's B=64 run the timing shape)
        "golden_b4": torch.from_numpy(imgs4[:, 0].copy()).to(dev),
        "serve_b8": torch.from_numpy(big[:8, 0].copy()).to(dev),
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

    # -------------------------------------------- 3b. NMS against its plain version
    with torch.inference_mode():
        report["nms"] = nms_phase(ref_pred, ref_pred.forward_raw(big))

    # --------------------------------- 3c. LayerNorm on the trunks' main path
    report["layer_norm"] = layer_norm_phase(dev, big, kind)
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 4. main path
    def per_image_counts(pred, raw):
        per = []
        for i in range(n_img):
            mask = torch.arange(n_img) == i
            per.append(int(pred.count(raw, mask).sum()))
        before = dict(COUNTS)
        classes = pred.count(raw, torch.ones(n_img, dtype=torch.bool)).cpu().numpy()
        return per, classes, nms_per_call(before)

    preds = {}
    mark = kernel_counts()
    for layout in ("nhwc", "nchw"):
        pred = Predictor.from_checkpoint(
            CKPT, half=True, device=dev, channels_last=layout == "nhwc"
        )
        raw = pred.forward_raw(imgs4)
        per, classes, (rounds, syncs, nms_launches) = per_image_counts(pred, raw)
        if not torch.isfinite(raw.float()).all() or raw.shape != (n_img, 97, 129, 7):
            raise AssertionError(f"bf16 {layout}: bad head {raw.shape}")
        log(f"bf16 {layout}: per-image {per} (golden {want_per_image}), "
            f"per-class {classes.tolist()} (golden {want_classes.tolist()}), "
            f"NMS rounds {rounds}, host syncs {syncs}, kernel launches {nms_launches}")
        if any(abs(a - b) > 2 for a, b in zip(per, want_per_image)):
            raise AssertionError(f"bf16 {layout} counts {per} vs golden {want_per_image}")
        if nms_launches != 1.0 or syncs != 0 or rounds != 0:
            raise AssertionError(f"bf16 {layout}: the count's NMS made {nms_launches} kernel launches, "
                                 f"{syncs} host syncs and {rounds} loop rounds a call, not 1, 0 and 0")
        report[f"bf16_{layout}"] = {"per_image": per, "per_class": classes.tolist(),
                                    "nms_rounds": rounds,
                                    "nms_host_syncs": syncs,
                                    "nms_kernel_launches": nms_launches}
        preds[layout] = pred
    launches = kernel_counts(mark, "stem")
    log(f"stem launches on the main path: {launches}")
    for layout in ("nhwc", "nchw"):
        if launches.get(f"stem_{layout}", 0) < 1:
            raise AssertionError(f"stem_{layout} was not launched on the main path")

    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        p32 = Predictor.from_checkpoint(CKPT, half=False, device=dev)
        per, classes, _ = per_image_counts(p32, p32.forward_raw(imgs4))
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
        "bytes": n_bytes / rate(MEM_RATE, kind) * 1e3,
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
            before = dict(COUNTS)
            stages[layout] = {
                "stem_ms": timing[layout]["ms"],
                "blocks_1_7_ms": cuda_ms(lambda: stack(h0, start_block=1), 10),
                "forward_raw_ms": cuda_ms(lambda: model.apply(stack, x_nchw, decode=False), 10),
                "count_ms": cuda_ms(lambda: pred.count(raw, mask), 10),
            }
            rounds, syncs, nms_launches = nms_per_call(before)
            if nms_launches != 1.0 or syncs != 0:
                raise AssertionError(f"B=64 {layout} count: {nms_launches} NMS kernel launches and "
                                     f"{syncs} host syncs a call, not 1 and 0")
            stages[layout].update(nms_rounds_b64=rounds, nms_host_syncs_b64=syncs,
                                  nms_kernel_launches_b64=nms_launches)

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

    # ------------------------------------- 7. train / test / infer, by CLI
    torch.cuda.empty_cache()
    shared = tempfile.TemporaryDirectory()  # phase 7's dataset, trained on again in phase 14
    data_dir = Path(shared.name) / "data"
    report["cli"], cli_launches = cli_phase(None, data_dir=data_dir)
    cli_stem = {f"stem_{layout}": {c: n.get(f"stem_{layout}", 0) for c, n in cli_launches.items()}
                for layout in ("nhwc", "nchw")}
    if cli_stem["stem_nhwc"]["infer best.ckpt"] < 1:
        raise AssertionError("infer --count on the trained checkpoint did not launch the stem kernel")
    report["cli"]["step_img_per_s_resident_batch"] = report["training"]["timing"]["none"]["img_per_s"]
    log("trainer images/sec against the resident-batch step rate: " + json.dumps({
        "trainer_by_epoch": report["cli"]["train"]["images_per_sec_by_epoch"],
        "trainer_resumed_epochs": {k: v["images_per_sec"] for k, v in report["cli"]["resume"].items()},
        "decode_path_epoch": report["cli"]["decode_epoch"]["images_per_sec"],
        "resident_batch_step": report["cli"]["step_img_per_s_resident_batch"]}))

    # ------------------------------------------------------------- 8. serve
    torch.cuda.empty_cache()
    report["serve"], serve_launches = serve_phase(None, imgs4, want_per_image=want_per_image)
    ceiling = report["timing"]["stages"]["nhwc"]
    log("serve under load against the count path's images/s (" + smi + "): " + json.dumps({
        **{f"b{b}": {k: report["serve"][f"b{b}"]["load"][k] for k in (
            "requests_per_s", "images_per_s", "latency_ms_p50", "latency_ms_p99",
            "mean_batch_occupancy", "fallbacks", "device_busy_under_load")} for b in serve_launches},
        "count_path_b64_img_per_s": {src: ceiling[f"count_path_{src}"]["img_per_s"]
                                     for src in ("host", "device")}}))

    # -------------------------------------------------------------- 9. int8
    torch.cuda.empty_cache()
    report["int8"], int8_launches = int8_phase(None, imgs4, golden)
    t8 = report["int8"]["timing"]
    log("int8 against bf16 (" + smi + "): " + json.dumps({
        "forward_raw_ms": t8["forward_raw_ms"],
        "count_path_img_per_s": {f"{p}_{src}": (t8 if p == "int8" else ceiling)[f"count_path_{src}"]["img_per_s"]
                                 for p in ("int8", "bf16") for src in ("host", "device")}}))

    # ---------------------------------------------------------- 10. convnext
    torch.cuda.empty_cache()
    report["convnext"], convnext_int8_launches = convnext_phase(None, imgs4, boxes4, smi)

    # ------------------------------------------------------------ 11. export
    torch.cuda.empty_cache()
    report["export"] = export_phase(None, imgs4, want_per_image=want_per_image)

    # ---------------------------------------------------------- 12. parallel
    torch.cuda.empty_cache()
    report["parallel"] = parallel_phase(None, imgs4, golden, smi)
    dp_launches = report["parallel"]["infer"]["launches"]

    # ----------------------------------------------------------- 13. spatial
    torch.cuda.empty_cache()
    report["spatial"], sp_launches = spatial_phase(None, imgs4, golden, smi)

    # --------------------------------------- 14. row-split training, ConvNeXt
    torch.cuda.empty_cache()
    try:
        report["spatial_train"], spt_launches = spatial_train_phase(
            None, imgs4, boxes4, golden, smi, data_defn=data_dir / "defn.yml")
    finally:
        shared.cleanup()

    # ----------------------------------------------------------- 15. report
    rows = []
    for layout, line in (("nhwc", 53), ("nchw", 210)):
        rows.append({
            "name": f"stem_{layout}",
            "route": "cuda",
            "source": "yogo_tpu_torch/csrc/stem.cu",
            "replaces": f"yogo_tpu/ops/pallas_stem.py:{line}",
            "launches": launches[f"stem_{layout}"],
            "launches_train_round_trip": train_launches[f"stem_{layout}"],
            "launches_cli_by_command": cli_stem[f"stem_{layout}"],
            "launches_serve_by_batch": {f"b{b}": n.get(f"stem_{layout}", 0)
                                        for b, n in serve_launches.items()},
            "launches_convnext_count_path": report["convnext"]["bf16"]["stem_launches"],
            "launches_export": report["export"]["stem_launches"],
            "launches_infer_data_parallel_by_rank": {
                r: n["count"].get(f"stem_{layout}", 0) for r, n in dp_launches.items()},
            # phase 13: one forward of the golden frames with N row shards
            # on the card; one dispatch of each multi-device server
            "launches_infer_spatial_by_n": {
                n: sp_launches[f"infer_bf16_{layout}_n{n}"].get(f"stem_{layout}", 0)
                for n in SPATIAL_NS if f"infer_bf16_{layout}_n{n}" in sp_launches},
            "launches_serve_multi_device_one_dispatch": {
                k: v.get(f"stem_{layout}", 0) for k, v in sp_launches.items() if k.startswith("serve")},
            # phase 14: training steps with N row shards (f32 gate, bf16
            # timing) and the spatial Trainer's epoch; the kernel has no
            # backward, so none is expected
            "launches_train_spatial_by_n": {
                "f32": spt_launches["train_spatial_f32"],
                "bf16": spt_launches.get("train_spatial_bf16", {}),
                "trainer_n2_epoch_and_test": spt_launches["trainer_spatial_2"]},
            "max_abs_err": max_err[layout],
            "ms": timing[layout]["ms"],
            "plain_ms": timing[layout]["plain_ms"],
            "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"],
            "bound_share": timing["bound_ms"] / timing[layout]["ms"],
            "library_ms": timing[layout]["library_ms"],
        })
    blocks = t8["blocks"]

    def total(key):
        return sum(b[key] for b in blocks.values())

    by = {}
    for b in blocks.values():
        by[b["bound_by"]] = by.get(b["bound_by"], 0.0) + b["bound_ms"]
    rows.append({
        "name": "int8_conv",
        "route": "cuda",
        "source": "yogo_tpu_torch/csrc/int8_conv.cu",
        # the XLA s8 conv of the JAX package's quantized forward (no Pallas kernel)
        "replaces": "yogo_tpu/ops/quant.py:612",
        "launches": int8_launches["infer"]["int8_conv"],
        "launches_test_quantize": report["cli"]["int8_conv_launches_by_command"]["test --quantize"],
        "launches_serve_quantize_b64": int8_launches["serve"]["int8_conv"],
        "launches_infer_quantize_data_parallel_by_rank": {
            r: n["quantize"].get("int8_conv", 0) for r, n in dp_launches.items()},
        "launches_infer_quantize_spatial_by_n": {
            n: sp_launches[f"infer_quantize_n{n}"].get("int8_conv", 0) for n in SPATIAL_NS},
        "spatial_shard_launches_checked": report["spatial"]["int8_conv_shards_bit_equal"][
            "shard_launches_checked"],
        # phase 14: ConvNeXt-Small's int8 program split over N shards at
        # B=4, 71 N a batch; every shard launch checked against the unsplit
        # launch on the same codes
        "launches_convnext_infer_quantize_spatial_by_n": spt_launches["convnext_int8_spatial"],
        "spatial_convnext_shard_launches_checked": report["spatial_train"]["convnext"]["int8"][
            "shard_launches_checked"],
        "max_abs_err": report["int8"]["max_abs_err"],
        # the three quantized blocks of one B=64 forward, summed; by block beside
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": max(by, key=by.get),
        "bound_share": total("bound_ms") / total("ms"),
        "library_ms": total("library_ms"),
        "by_block": {k: {key: b[key] for key in ("ms", "plain_ms", "library_ms", "cudnn_bf16_conv_ms",
                                                   "bound_ms", "bound_by", "bound_share")}
                     for k, b in blocks.items()},
        # phase 10: ConvNeXt-Small's int8 program; checked at all its sites
        # (B=4), timed at three (B=64)
        "launches_convnext_infer_quantize": convnext_int8_launches,
        "launches_convnext_serve_quantize_b8": report["convnext"]["serve_quantize"]["int8_conv_launches"],
        "max_abs_err_convnext": report["convnext"]["int8"]["max_abs_err"],
        "convnext_sites_checked": report["convnext"]["int8"]["sites_checked"],
        "convnext_site_shapes_checked": report["convnext"]["int8"]["site_shapes_checked"],
        "by_convnext_site": {k: {key: v[key] for key in ("ms", "plain_ms", "library_ms", "int_mm_ms",
                                                           "bound_ms", "bound_by", "bound_share") if key in v}
                             for k, v in report["convnext"]["int8"]["sites"].items()},
    })
    rows.append({
        "name": "nms",
        "route": "cuda",
        "source": "yogo_tpu_torch/csrc/nms.cu",
        # the XLA while_loop of the JAX package's greedy NMS (no Pallas kernel)
        "replaces": "yogo_tpu/ops/nms.py:68-89",
        # phase 4: a Predictor.count on the main path (checked there: 1 a
        # call, no host sync), and phase 5's at B=64
        "launches": report["bf16_nhwc"]["nms_kernel_launches"],
        "launches_count_path_b64": report["timing"]["stages"]["nhwc"]["nms_kernel_launches_b64"],
        "by_case": report["nms"],
    })
    ln = report["layer_norm"]
    rows.append({
        "name": "layer_norm",
        "route": "cuda",
        "source": "yogo_tpu_torch/csrc/layer_norm.cu",
        # none: the JAX package leaves flax's nn.LayerNorm to XLA's fusion
        "replaces": None,
        # phase 3c: a bf16 forward of each trunk at B=64
        "launches": {v: t["launches"] for v, t in ln["trunks"].items()},
        "max_abs_err": max(r["max_abs_err"] for r in ln["shapes"]),
        # the LayerNorms of one B=64 forward of each trunk, summed
        "ms": {v: t["ln_ms_a_forward"] for v, t in ln["trunks"].items()},
        "plain_ms": {v: t["ln_plain_ms_a_forward"] for v, t in ln["trunks"].items()},
        "bound_ms": {v: t["ln_bound_ms_a_forward"] for v, t in ln["trunks"].items()},
        "bound_by": "bytes",
        "bound_share": {v: t["ln_bound_share"] for v, t in ln["trunks"].items()},
        "library_ms": {v: t["ln_library_ms_a_forward"] for v, t in ln["trunks"].items()},
        "by_shape": ln["shapes"],
        # Swin's attention LayerNorms, stored into its windows (the same source)
        "windows_ms": ln["trunks"]["swin_small"]["ln_windows_ms_a_forward"],
        "windows_plain_layout_ms": ln["trunks"]["swin_small"]["ln_windows_plain_layout_ms_a_forward"],
        "windows_bound_share": ln["trunks"]["swin_small"]["ln_windows_bound_share"],
        "by_windowed_shape": ln["windows"],
    })
    swin = ln["trunks"]["swin_small"]
    rows.append({
        "name": "window_merge",
        "route": "cuda",
        "source": "yogo_tpu_torch/csrc/window_merge.cu",
        # none: the JAX package has no Swin trunk
        "replaces": None,
        "launches": swin["launches"]["window_merge"],
        "ms": swin["merge_ms_a_forward"],
        "plain_ms": swin["merge_plain_layout_ms_a_forward"],
        "bound_ms": swin["merge_bound_ms_a_forward"],
        "bound_by": "bytes",
        "bound_share": swin["merge_bound_share"],
        "by_shape": ln["merges"],
    })
    report["kernels"] = rows
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


def layer_norm_main() -> int:
    """`python3 chip_smoke.py layer_norm`: phases 1, 2 (the LayerNorm and
    window merge sources alone, one after the other, each build timed) and
    3c; the report is written as chip_smoke_layer_norm.json beside the
    smoke's own report."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from yogo_tpu_torch import kernels

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    report = {"device": kind, "nvidia_smi": smi, "build_s": {}, "ptxas": {}}
    for name in ("layer_norm", "window_merge"):
        t0 = time.time()
        kernels.build_all([name])
        report["build_s"][name] = time.time() - t0
        report["ptxas"][name] = kernels.ptxas_summary(kernels.build_log(name))
        log(f"--- nvcc csrc/{name}.cu ({report['build_s'][name]:.1f} s) ---\n{kernels.build_log(name).strip()}")
    imgs4, _ = gen_golden_images(4)
    big = np.concatenate([imgs4] * (TIMING_BATCH // 4))
    report["layer_norm"] = layer_norm_phase(torch.device("cuda"), big, kind)
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_layer_norm.json").write_text(json.dumps(report, indent=1))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind}}))
    return 0


VITDET_SEED = 3000000019


def nms_load(cells, seed, n=16):
    """How much work NMS gets in each count cell: n frames of the cell's
    traffic pool of `seed` through its Predictor on the benchmark's
    weights (bf16 head), then per image the candidates (objectness above
    the count's threshold, at most max_detections) and the detections the
    reference's NMS keeps. -> {cell: candidates, kept, the share
    suppressed, and the candidates' median box width and height over the
    anchor's}."""
    from yogo_bench import manifest, reference, scene
    from yogo_bench.drivers.count import bench_weights, build_predictor

    man, out = manifest.load(), {}
    for name in cells:
        cell = manifest.cell(man, name)
        cfg, mix = manifest.config(man, cell["config"]), manifest.traffic(cell["traffic"])
        th = mix["thresholds"]
        w = bench_weights(cfg, torch.device("cuda"))
        pred = build_predictor(cfg, w, torch.device("cuda"), **th)
        frames, _ = scene.pool(seed, range(n), hw=cfg["img_size"], blobs=mix["blobs"])
        with torch.inference_mode():
            raw = pred.forward_raw(frames).float()
        cand = kept = 0
        wh = []
        for b in range(n):
            obj = torch.sigmoid(raw[b, ..., 4])
            cand += min(int((obj > th["obj_thresh"]).sum()), th["max_detections"])
            kept += len(reference.detections(raw[b], cfg, **th)[0])
            wh.append(torch.exp(raw[b][obj > th["obj_thresh"]][:, 2:4]))
        wh = torch.cat(wh)
        out[name] = {"frames": n, "candidates": cand, "kept": kept, "suppressed_share": 1 - kept / max(cand, 1),
                     "median_w_over_anchor": float(wh[:, 0].median()) if len(wh) else None,
                     "median_h_over_anchor": float(wh[:, 1].median()) if len(wh) else None}
        log(f"nms load {name}: " + json.dumps(out[name]))
        del pred, w, raw
        torch.cuda.empty_cache()
    return out


def vitdet_main() -> int:
    """`python3 chip_smoke.py vitdet`: the ViTDet-B trunk (models/yogo.py
    ViTDetBase) on the card: its card tests (tests/test_torch_vitdet.py -m
    cuda); phase 3c on that trunk alone (its launches a forward, each
    LayerNorm, windowed-store and merge shape against the plain version
    and beside its byte bound); one full-size bf16 forward of 8
    golden-scene frames through Predictor on the benchmark's seeded
    weights against the plain float32 reference
    (yogo_bench/families/vitdet.py) and the peak memory of a B=64 forward;
    the share of candidates NMS suppresses in each count cell (nms_load);
    then the cell vitdet_base.count once (`python3 -m yogo_bench.run`,
    untraced, 10 s), which must read correct. The report is written as
    chip_smoke_vitdet.json beside the smoke's own report."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from yogo_bench import manifest, reference
    from yogo_bench.drivers.count import bench_weights, build_predictor, rel_rms

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    report = {"device": kind, "nvidia_smi": smi}
    tests = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--noconftest",
                            "tests/test_torch_vitdet.py", "-m", "cuda"], cwd=REPO, capture_output=True, text=True,
                           timeout=900)
    report["card_tests"] = tests.stdout.strip().splitlines()[-1]
    log(f"card tests: {report['card_tests']}")
    if tests.returncode:
        log(tests.stdout[-4000:])
        return 1

    dev = torch.device("cuda")
    imgs4, _ = gen_golden_images(4)
    big = np.concatenate([imgs4] * (TIMING_BATCH // 4))
    report["layer_norm"] = layer_norm_phase(dev, big, kind, ("vitdet_base",))
    torch.cuda.empty_cache()

    man = manifest.load()
    cfg = manifest.config(man, "vitdet_base")
    w = bench_weights(cfg, dev)
    pred = build_predictor(cfg, w, dev)
    x = pred.to_device(big)
    raw = pred.forward_raw(x[:8])
    ref = reference.head(w, big[:8], cfg)
    report["head_rel_rms_b8"] = rel_rms(raw, ref)
    log(f"full-size head (B=8) against the reference: rel RMS {report['head_rel_rms_b8']:.6f}")
    del ref, raw
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pred.forward_raw(x)
    torch.cuda.synchronize()
    report["peak_bytes_b64_forward"] = torch.cuda.max_memory_allocated()
    report["peak_rise_bytes_b64_forward"] = torch.cuda.max_memory_allocated() - base
    log(f"B=64 forward: peak {report['peak_bytes_b64_forward'] / 1e9:.3f} GB "
        f"({report['peak_rise_bytes_b64_forward'] / 1e9:.3f} GB above the weights and inputs)")
    ok = report["head_rel_rms_b8"] < manifest.limits("vitdet_base.count")["checks"]["head_rel_rms"]
    del pred, w, x
    torch.cuda.empty_cache()
    report["nms_load"] = nms_load(("base_model.count", "convnext_small.count", "swin_small.count",
                                   "vitdet_base.count"), VITDET_SEED)

    cell = subprocess.run([sys.executable, "-m", "yogo_bench.run", "--workload", "vitdet_base.count", "--seed",
                           str(VITDET_SEED), "--seconds", "10", "--trace", "0"], cwd=REPO, capture_output=True,
                          text=True, timeout=900)
    result = json.loads(cell.stdout.strip().splitlines()[-1]) if cell.returncode == 0 else None
    report["cell"] = result
    log(f"vitdet_base.count: rc {cell.returncode}; " + json.dumps(result))
    ok = ok and bool(result) and result["correct"]
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_vitdet.json").write_text(json.dumps(report, indent=1))
    log(json.dumps({"ok": ok, "device": {"platform": "gpu", "kind": kind}}))
    return 0 if ok else 1


if __name__ == "__main__":
    if sys.argv[1:2] == [PARALLEL_WORKER]:
        sys.exit(dp_worker_main(sys.argv[2:]))
    if sys.argv[1:2] == ["layer_norm"]:
        sys.exit(layer_norm_main())
    if sys.argv[1:2] == ["vitdet"]:
        sys.exit(vitdet_main())
    sys.exit(main())
