"""Readings that set the limits of a vitdet cell (vitdet_base.count), on
the card at the cell's own size, each against the plain reference's
float32 head of a B=64 batch, as the check compares the program's bf16
head (head_rel_rms):

    python3 -m yogo_bench.controls_vitdet --workload vitdet_base.count --seeds 11 22 33 [--out FILE]

  program              the program as the cell runs it
  reference in fp8     the reference computed in float8 (e4m3) in the
                       program's place (the precision below bfloat16)
  no rel-pos           the program with a planted fault: the decomposed
  global blocks        relative positions left out (zero tables), the
    windowed           four global blocks run over 14x14 windows like the
  no position          others, or the absolute position embedding left
    embedding          out

controls.py's int8 reading has no counterpart: `--quantize` refuses the
vitdet family. Prints one JSON line a seed and reading. The benchmark's
own runs never run this; its CPU tests plant the same faults (`planted`).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

FAULTS = ("no rel-pos", "global blocks windowed", "no position embedding")


@contextlib.contextmanager
def planted(fault: str):
    """The program (yogo_tpu_torch.models.yogo) with `fault` planted while
    the block runs; a model built inside it keeps the fault."""
    from yogo_tpu_torch.models import yogo

    owner = yogo
    if fault == "no rel-pos":
        name, fn = "vit_rel_pos", lambda table, size: table.new_zeros(size, size, table.shape[1])
    elif fault == "no position embedding":
        name, fn = "vit_abs_pos", lambda pos, h, w: pos.new_zeros(1, h, w, pos.shape[-1])
    elif fault == "global blocks windowed":
        init = yogo.ViTBlock.__init__
        name, owner = "__init__", yogo.ViTBlock

        def fn(self, dim, heads, window, rel_size):  # the global blocks keep their tables
            init(self, dim, heads, window or yogo.VIT_WINDOW, rel_size)
    else:
        raise KeyError(fault)
    saved = getattr(owner, name)
    setattr(owner, name, fn)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def count_controls(cfg, mix, seed, device):
    from yogo_bench import reference, scene
    from yogo_bench.drivers.count import bench_weights, build_predictor, rel_rms

    frames, _ = scene.pool(seed, range(mix["batch"]), hw=cfg["img_size"], blobs=mix["blobs"])
    w = bench_weights(cfg, device)
    ref = reference.head(w, frames, cfg)
    rows = []
    for name in ("program",) + FAULTS:
        with planted(name) if name in FAULTS else contextlib.nullcontext():
            pred = build_predictor(cfg, w, device, **mix["thresholds"])
            raw = pred.forward_raw(pred.to_device(frames)).clone()
        del pred
        rows.append({"control": name, "head_rel_rms": rel_rms(raw, ref)})
    fp8 = reference.head(w, frames, cfg, cast=reference.fp8)
    rows.append({"control": "reference in fp8", "head_rel_rms": rel_rms(fp8, ref)})
    return rows


def main(argv=None) -> int:
    from yogo_bench import manifest

    ap = argparse.ArgumentParser(prog="python3 -m yogo_bench.controls_vitdet")
    ap.add_argument("--workload", default="vitdet_base.count")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls_vitdet: no CUDA device", file=sys.stderr)
        return 2
    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    cfg, mix = manifest.config(man, cell["config"]), manifest.traffic(cell["traffic"])
    lines = []
    for seed in args.seeds:
        for r in count_controls(cfg, mix, seed, "cuda"):
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
