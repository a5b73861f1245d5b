"""Where a training step's time goes on the GPU: a torch.profiler trace of a
few steady-state steps of `make_train_step` (base_model, 772x1032, bf16,
B=64, dropout and flips on), summed by kernel name.

    python3 -m yogo_tpu_torch.tools.train_profile [--batch 64] [--steps 5] [--remat none]

Prints the device time per step of the heaviest kernels, the device's busy
share of the traced window (kernel time over the wall time between the
first kernel's start and the last one's end, from CUDA events around the
window) and writes everything to chiprun_out/train_profile.json. Images and
label grids are seeded noise: the step's cost does not depend on them (the
loss runs over the full grid whatever the labels).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from yogo_tpu_torch.models.yogo import REMAT_MODES, YOGO
from yogo_tpu_torch.ops.grid import encode_label_grid_np
from yogo_tpu_torch.train import TrainState, make_optimizer, make_train_step
from yogo_tpu_torch.utils.default_hyperparams import DefaultHyperparams as df

HW = (772, 1032)


def seeded_batch(model: YOGO, batch: int, device, seed: int = 0):
    rng = np.random.default_rng(seed)
    sx, sy = model.grid
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, 1, *HW), np.uint8))
    grids = []
    for _ in range(batch):
        lo = rng.uniform(0.0, 0.9, (40, 2))
        boxes = np.concatenate([rng.integers(0, 2, (40, 1)), lo, lo + 0.04], axis=1)
        grids.append(encode_label_grid_np(boxes.astype(np.float32), sx, sy))
    return imgs.to(device), torch.from_numpy(np.stack(grids)).to(device), torch.ones(batch, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=df.BATCH_SIZE)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--remat", choices=REMAT_MODES, default="none")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_profile: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]

    model = YOGO.create(HW, 0.035, 0.047, 2, compute_dtype=torch.bfloat16)
    stack = model.init(torch.Generator().manual_seed(0), device=dev)
    optimizer, scheduler, _ = make_optimizer(
        stack.parameters(), df.LEARNING_RATE, df.WEIGHT_DECAY, df.DECAY_FACTOR, 1000)
    state = TrainState(stack, optimizer, scheduler)
    step = make_train_step(
        model,
        dict(no_obj_weight=df.NO_OBJ_WEIGHT, iou_weight=df.IOU_WEIGHT,
             classify_weight=df.CLASSIFY_WEIGHT, label_smoothing=df.LABEL_SMOOTHING),
        remat=args.remat,
    )
    imgs, labels, mask = seeded_batch(model, args.batch, dev)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        step(state, imgs, labels, mask, gen)
    torch.cuda.synchronize()

    from torch.profiler import ProfilerActivity, profile

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(args.steps):
            step(state, imgs, labels, mask, gen)
        b.record()
        torch.cuda.synchronize()
    window_ms = a.elapsed_time(b)

    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(ev.name, {"calls": 0, "ms": 0.0})
            k["calls"] += 1
            k["ms"] += ev.device_time / 1e3
    device_ms = sum(k["ms"] for k in kernels.values())
    if device_ms <= 0:
        print("train_profile: the trace holds no device time", file=sys.stderr)
        return 1
    rows = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])
    out = {
        "nvidia_smi": smi, "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "batch": args.batch, "steps": args.steps, "remat": args.remat,
        "window_ms_per_step": window_ms / args.steps,
        "device_ms_per_step": device_ms / args.steps,
        "device_busy_share": device_ms / window_ms,
        "kernel_launches_per_step": sum(k["calls"] for k in kernels.values()) / args.steps,
        "kernels": [
            {"name": name, "calls_per_step": k["calls"] / args.steps, "ms_per_step": k["ms"] / args.steps}
            for name, k in rows
        ],
    }
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / f"train_profile_{args.remat}.json").write_text(json.dumps(out, indent=1))
    print(f"{smi}; B={args.batch}, remat={args.remat}: window {out['window_ms_per_step']:.2f} ms/step, "
          f"device {out['device_ms_per_step']:.2f} ms/step, busy {out['device_busy_share']:.3f}, "
          f"{out['kernel_launches_per_step']:.0f} launches/step")
    for row in out["kernels"][: args.top]:
        print(f"{row['ms_per_step']:8.3f} ms  x{row['calls_per_step']:5.1f}  {row['name'][:150]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
