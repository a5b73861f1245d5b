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
  6. one JSON line per kernel ("kernels"), then the last line
     {"ok": true, "device": {...}}.
All numbers also go to chiprun_out/chip_smoke.json. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
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


def gen_golden_images(n: int = 4, seed: int = 3) -> np.ndarray:
    """(n, 1, 772, 1032) uint8: the frozen generator of
    tests/test_golden_fullres.py (gen_test_images), without the PNG
    round trip (which is lossless)."""
    h, w = HW
    blobs = {0: (36, 36), 1: (24, 48)}
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        arr = np.full((h, w), 225, np.uint8)
        for _ in range(int(r.integers(20, 61))):
            cls = int(r.integers(0, 2))
            bh, bw = blobs[cls]
            y = int(r.integers(2, h - 2 - bh))
            x = int(r.integers(2, w - 2 - bw))
            arr[y : y + bh, x : x + bw] = 60 if cls == 0 else 130
        arr += r.integers(0, 12, arr.shape).astype(np.uint8)
        out.append(arr)
    return np.stack(out)[:, None]


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
    imgs4 = gen_golden_images(n_img)
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

    # ------------------------------------------------------------ 6. report
    rows = []
    for layout, line in (("nhwc", 53), ("nchw", 210)):
        rows.append({
            "name": f"stem_{layout}",
            "route": "cuda",
            "source": "yogo_tpu_torch/csrc/stem.cu",
            "replaces": f"yogo_tpu/ops/pallas_stem.py:{line}",
            "launches": launches[f"stem_{layout}"],
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
