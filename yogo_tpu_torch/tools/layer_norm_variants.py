"""Time variants of the LayerNorm kernel on one NVIDIA GPU, at the shapes of
the ConvNeXt-Small and Swin-S trunks' LayerNorms at B=64, 772x1032.

    python3 -m yogo_tpu_torch.tools.layer_norm_variants    # from the repository root

Each variant is csrc/layer_norm.cu with a few text edits (every anchor must
occur in the source exactly once, or the script stops), built with the
port's nvcc flags into yogo_tpu_torch/_build/variants/layer_norm/, all
builds at once (their seconds reported: the kernel's build is part of the
program's set-up), and launched through kernels.launch with the variant's
library in place of the kernel's on seeded rows with ops/layer_norm.plan's
lanes. Every variant computes the same
arithmetic in the same order, so each output must equal the kernel's bit
for bit. Times are CUDA-event medians of 10 reps of 20 back-to-back
launches; the variants take turns, two rounds. Beside them, a yardstick of
the card's memory at the same bytes: torch's copy_ from the input's dtype
to the output's. Prints one line per timing, the sums a forward of each
trunk, and writes chiprun_out/layer_norm_variants.json.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

from yogo_tpu_torch import kernels
from yogo_tpu_torch.ops.layer_norm import plan
from yogo_tpu_torch.tools.timing import MEM_RATE, as_kernel, build_variants, card, cuda_ms, rate

BF16, F32 = torch.bfloat16, torch.float32
# (C, rows, input dtype, output dtype, launches a forward by trunk)
SHAPES = (
    (96, 3186816, BF16, F32, {"convnext_small": 1, "swin_small": 1}),
    (96, 3186816, BF16, BF16, {"convnext_small": 3}),
    (96, 3186816, F32, BF16, {"convnext_small": 1, "swin_small": 4}),
    (192, 792576, BF16, BF16, {"convnext_small": 3}),
    (192, 792576, F32, BF16, {"convnext_small": 1}),
    (192, 800832, F32, BF16, {"swin_small": 4}),
    (384, 196608, BF16, BF16, {"convnext_small": 27}),
    (384, 196608, F32, BF16, {"convnext_small": 1}),
    (384, 203840, F32, BF16, {"swin_small": 36}),
    (384, 800832, F32, BF16, {"swin_small": 1}),
    (768, 49152, BF16, BF16, {"convnext_small": 3}),
    (768, 203840, F32, BF16, {"swin_small": 1}),
    (768, 52800, F32, BF16, {"swin_small": 5}),
    (1536, 52800, F32, BF16, {"swin_small": 1}),
)

_TIER_16 = "  if (ch * VEC <= 16) return launch<TIn, TOut, VEC, 16 / VEC>(x, w, b, y, rows, C, tpr, eps, s);\n"
_THREADS = "constexpr int THREADS = 256;"

# name -> (edits, what it shows)
VARIANTS = {
    "kernel": ([], "csrc/layer_norm.cu as it is"),
    "no_16_build": ([(_TIER_16, "")], "no build of 16 elements a lane: short rows take the 32-element one"),
    "exact_3": ([(_TIER_16, _TIER_16.replace("ch * VEC <= 16", "ch == 3").replace("16 / VEC", "3"))],
                "a build of exactly the trunks' 3 chunks a lane (the fewest registers)"),
    "threads_128": ([(_THREADS, "constexpr int THREADS = 128;")], "blocks of 4 warps"),
    "threads_512": ([(_THREADS, "constexpr int THREADS = 512;")], "blocks of 16 warps"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("layer_norm_variants: CUDA is not available", file=sys.stderr)
        return 1
    smi = card()
    print(smi, flush=True)
    t0 = time.time()
    libs = build_variants("layer_norm", {name: edits for name, (edits, _) in VARIANTS.items()})
    build_s = time.time() - t0
    print(f"built {len(libs)} variants at once in {build_s:.1f} s", flush=True)
    mem_rate = rate(MEM_RATE, torch.cuda.get_device_name(0))
    g = torch.Generator(device="cuda").manual_seed(0)
    report = {"device": smi, "build_s_all_at_once": build_s, "shapes": []}
    for c, rows, xd, od, launches in SHAPES:
        x = (torch.randn(rows, c, device="cuda", generator=g) * 1.5 + 0.5).to(xd)
        w = torch.rand(c, device="cuda", generator=g) + 0.5
        b = torch.randn(c, device="cuda", generator=g) * 0.5
        y = torch.empty(rows, c, dtype=od, device="cuda")
        tpr, ch = plan(c, od)

        def launch(lib):
            with as_kernel("layer_norm", lib):
                kernels.launch("layer_norm", x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                               rows, c, int(xd == BF16), int(od == BF16), tpr, ch, 1e-6)

        launch(libs["kernel"][0])
        want = y.clone()
        for name, (lib, _) in libs.items():
            launch(lib)
            if not torch.equal(y, want):
                raise AssertionError(f"variant {name} differs from the kernel at C={c} {xd}->{od}")
        n_bytes = rows * c * (xd.itemsize + od.itemsize)
        row = {"c": c, "rows": rows, "in": str(xd), "out": str(od), "plan": [tpr, ch], "launches": launches,
               "bound_ms": n_bytes / mem_rate * 1e3, "ms": {name: [] for name in libs},
               "copy_ms": cuda_ms(lambda: y.copy_(x))}
        for _ in range(2):
            for name, (lib, _) in libs.items():
                row["ms"][name].append(cuda_ms(lambda: launch(lib)))
        print(json.dumps(row), flush=True)
        report["shapes"].append(row)
        del x, y, want
        torch.cuda.empty_cache()
    report["a_forward_ms"] = {}
    for trunk in ("convnext_small", "swin_small"):
        t = report["a_forward_ms"][trunk] = dict.fromkeys([*libs, "bound", "copy"], 0.0)
        for r in report["shapes"]:
            n = r["launches"].get(trunk, 0)
            for name in libs:
                t[name] += min(r["ms"][name]) * n
            t["bound"] += r["bound_ms"] * n
            t["copy"] += r["copy_ms"] * n
        print(f"{trunk} a forward: " + json.dumps(t), flush=True)
    out_dir = Path.cwd() / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "layer_norm_variants.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
