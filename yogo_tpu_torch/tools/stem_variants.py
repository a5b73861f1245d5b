"""Time variants of the stem kernel on one NVIDIA GPU, to see what bounds it.

    python3 -m yogo_tpu_torch.tools.stem_variants    # from the repository root

Each variant is csrc/stem.cu with a few text edits (every anchor must occur
in the source exactly once, or the script stops), built with the port's nvcc
flags into yogo_tpu_torch/_build/variants/, all builds at once, and launched
through its own C entry point at B=64, 772x1032, C=16 on random uint8 images,
in both layouts. The variants that still compute the stem are held against
fused_stem_reference (rtol 8e-3, atol 1e-2). Times are CUDA-event medians of
10 reps of 20 back-to-back launches; the variants take turns, two rounds.
Beside them, two yardsticks of the card's memory: torch's zero_ of a 408 MB
bf16 tensor (writes only) and copy_ between two (reads and writes).
Prints one line per timing and writes chiprun_out/stem_variants.json.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from yogo_tpu_torch import kernels
from yogo_tpu_torch.ops.stem import fused_stem_reference

B, H, W, C = 64, 772, 1032, 16
RTOL, ATOL = 8e-3, 1e-2

_STORE = "    if (staged) {\n      // through the warp's slab"
_FMA = "for (int dx = 0; dx < 3; ++dx) acc = fmaf(wt[3 * dy + dx], t[dy][2 * i + dx], acc);"
_LOAD = "        bulk_load(s_in + 16 + s * stage, b.src, b.bytes, &full[s]);"
_PLANE = "  const size_t plane = (size_t)H2 * W2;"

# name -> (edits, whether the output is still the stem's, what it shows)
VARIANTS = {
    "kernel": ([], True, "csrc/stem.cu as it is"),
    "no_stores": (
        [(_STORE, "    if (W == -1) {\n    } else if (staged) {\n      // through the warp's slab"),
         ("    } else if (valid) {  // shapes", "    } else if (W == -1) {  // shapes")],
        False, "computes everything, stores nothing: compute and input alone"),
    "one_fma": (
        [(_FMA, "for (int dx = 0; dx < 3; ++dx)\n              if (3 * dy + dx == 0) "
                "acc = fmaf(wt[3 * dy + dx], t[dy][2 * i + dx], acc);")],
        False, "1 of the 9 FMAs of each output: the FMA work nearly gone"),
    "no_input_copy": (
        [(_LOAD, "        mbar_arrive(&full[s]);")],
        False, "the producer signals each band without copying it: no input traffic"),
    "plane_pitch_128": (
        [(_PLANE, "  const size_t plane = ((size_t)H2 * W2 + 63) / 64 * 64;")],
        False, "NCHW planes 128-byte aligned (a padded buffer): no sector split at plane starts"),
    "two_pixel_threads": (
        [("  static constexpr int PX = C <= 16 ? 4 : 2;", "  static constexpr int PX = 2;"),
         ("  static constexpr int WARPS = C <= 16 ? 8 : 4;", "  static constexpr int WARPS = 8;")],
        True, "2 pixels a thread at C=16 (4 in the kernel)"),
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"anchor not found exactly once in csrc/stem.cu: {old!r}")
        src = src.replace(old, new)
    return src


def build(out_dir: Path) -> dict:
    src = (kernels.CSRC_DIR / "stem.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, _, _) in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(variant_source(src, edits))
        procs[name] = subprocess.Popen(
            [kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        f = ctypes.CDLL(str(out_dir / f"{name}.so")).yogo_stem_launch
        f.restype, f.argtypes = kernels.SOURCES["stem"]["yogo_stem_launch"]
        libs[name] = f
    return libs


def cuda_ms(fn, reps: int = 10, per_rep: int = 20) -> float:
    for _ in range(3):
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
    if not torch.cuda.is_available():
        print("stem_variants: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build(kernels.BUILD_DIR / "variants")
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, (B, H, W), dtype=torch.uint8, device="cuda", generator=g)
    w = torch.randn(C, 9, device="cuda", generator=g) * 0.05
    bias = torch.randn(C, device="cuda", generator=g)
    # room for the padded planes of plane_pitch_128
    out = torch.empty(B * C * ((H // 2) * (W // 2) + 64), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(f, layout, xs=x):
        code = f(xs.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 xs.shape[0], H, W, C, int(layout == "nhwc"), 0.01, stream)
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")

    report = {"device": smi, "shape": [B, H, W, C], "variants": {}, "yardsticks": {}}
    for name, f in libs.items():
        _, computes, what = VARIANTS[name]
        report["variants"][name] = {"what": what, "ms": {"nhwc": [], "nchw": []}}
        if computes:
            xs = x[:2]
            for layout in ("nhwc", "nchw"):
                launch(f, layout, xs)
                want = fused_stem_reference(xs, w, bias, layout=layout)
                got = out[: want.numel()]
                if layout == "nhwc":
                    got = got.view(2, H // 2, W // 2, C).permute(0, 3, 1, 2)
                torch.testing.assert_close(got.reshape(want.shape).float(), want.float(),
                                           rtol=RTOL, atol=ATOL)
    for _ in range(2):
        for name, f in libs.items():
            for layout in ("nhwc", "nchw"):
                ms = cuda_ms(lambda: launch(f, layout))
                report["variants"][name]["ms"][layout].append(ms)
                print(f"{name} {layout}: {ms:.4f} ms", flush=True)
    a = torch.empty(B * C * (H // 2) * (W // 2), dtype=torch.bfloat16, device="cuda")
    b = torch.empty_like(a)
    mb = a.numel() * 2 / 1e6
    for name, fn, n_bytes in (("zero_", a.zero_, a.numel() * 2),
                              ("copy_", lambda: b.copy_(a), a.numel() * 4)):
        ms = cuda_ms(fn)
        report["yardsticks"][name] = {"ms": ms, "tb_per_s": n_bytes / ms / 1e9}
        print(f"yardstick {name} of {mb:.1f} MB: {ms:.4f} ms, {n_bytes / ms / 1e9:.3f} TB/s", flush=True)
    out_dir = Path.cwd() / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "stem_variants.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
