"""Readings that set a cell's limits, on the chip at the cell's own size:
the control (the precision below the configuration's) and the faults,
each against the plain reference, on several seeds in one process.

    python3 -m yogo_bench.controls --workload <cell> --seeds 11 22 33 [--out FILE]

  count cells   the control: the reference computed in float8 (e4m3) in
                the program's place; and the program's int8 path
                (Predictor(quantize=True), calibrated on the batch's
                frames). Each head against the reference's float32 head
                of a B=64 batch, as the check compares the bf16 head
                (head_rel_rms)
  train cells   the program's readings, the reference computed in
                float8 (e4m3) in the program's place, and the fault "half
                of the batch left out, the mean taken over the rest"
                planted in the reference, each against the float32
                reference, over set-up's first steps (loss_gap, grad_gap,
                change_gap) and the window's steps k to k + 2 from the
                program's state (win_*), after a short window; a state
                left unchanged reads change_gap 1 by construction

Prints one JSON line a seed and reading. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def count_control(cfg, mix, seed, device):
    from yogo_bench import reference, scene
    from yogo_bench.drivers.count import bench_weights, build_predictor, rel_rms

    frames, _ = scene.pool(seed, range(mix["batch"]), hw=cfg["img_size"], blobs=mix["blobs"])
    w = bench_weights(cfg, device)
    pred = build_predictor(cfg, w, device, quantize=True, calib=[frames], **mix["thresholds"])
    raw = pred.forward_raw(pred.to_device(frames)).clone()
    del pred
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ref = reference.head(w, frames, cfg)
    fp8 = reference.head(w, frames, cfg, cast=reference.fp8)
    return [{"control": "reference in fp8", "head_rel_rms": rel_rms(fp8, ref)},
            {"control": "int8 program", "head_rel_rms": rel_rms(raw, ref)}]


def train_controls(cfg, mix, seed, device, opts, seconds):
    from yogo_bench import reference
    from yogo_bench.drivers.train import Session, compare

    sess = Session(cfg, mix, seed, device, opts)
    sess.window(seconds, False, time.perf_counter)
    sess.release()
    ref, ref_win = sess.reference_steps(), sess.reference_window()
    rows = []
    for name, first, win in (
            ("program (bf16)", (sess.losses, sess.grad1, sess.theta_n), sess.window_steps()),
            ("reference in fp8", sess.reference_steps(cast=reference.fp8), sess.reference_window(cast=reference.fp8)),
            ("fault: half the batch", sess.reference_steps(half_batch=True), sess.reference_window(half_batch=True))):
        gaps = compare(win, ref_win, sess.win["theta"])
        rows.append({"control": name, **compare(first, ref, sess.theta0), **{f"win_{k}": v for k, v in gaps.items()}})
    return rows


def main(argv=None) -> int:
    from yogo_bench import manifest

    ap = argparse.ArgumentParser(prog="python3 -m yogo_bench.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    cfg, mix = manifest.config(man, cell["config"]), manifest.traffic(cell["traffic"])
    opts = manifest.limits(args.workload)
    lines = []
    for seed in args.seeds:
        if mix["driver"] == "count":
            rows = count_control(cfg, mix, seed, "cuda")
        else:
            rows = train_controls(cfg, mix, seed, "cuda", opts, args.seconds)
        for r in rows:
            line = json.dumps({"workload": args.workload, "seed": seed, **r})
            print(line, flush=True)
            lines.append(line)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
