"""What the port's measurements share: the card's rates, a CUDA-event
timer, the card's name and power limit, and text-edited builds of a kernel
source (the variant scripts: tools/stem_variants.py,
tools/int8_conv_variants.py).
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

from yogo_tpu_torch import kernels

# device-memory rate by card name (NVIDIA data sheets), bytes/s
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12, "H100": 3.35e12}
# dense int8 tensor-core rate by card name (NVIDIA data sheets), operations/s
INT8_RATE = {"H100 PCIe": 1513e12, "H100 NVL": 1671e12, "H200": 1979e12, "H100": 1979e12}


def rate(table: dict, name: str) -> float:
    """The rate of `table` for the card called `name` (first key it contains)."""
    for key, value in table.items():
        if key in name:
            return value
    raise RuntimeError(f"no rate known for {name!r}")


def cuda_ms(fn, reps: int = 10, per_rep: int = 20, warmup: int = 3) -> float:
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


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def variant_source(src: str, edits) -> str:
    """src with each (old, new) of `edits` applied in turn; every `old`
    must occur exactly once in the text it is applied to."""
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"anchor not found exactly once in the kernel source: {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(source: str, variants: dict) -> dict:
    """Build csrc/<source>.cu with each variant's edits (name -> edits) into
    yogo_tpu_torch/_build/variants/<source>/ with the port's nvcc flags,
    all at once. Returns name ->
    (the loaded library, its exported functions typed as in
    kernels.SOURCES[source]; nvcc's output)."""
    src = (kernels.CSRC_DIR / f"{source}.cu").read_text()
    out_dir = kernels.BUILD_DIR / "variants" / source
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
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
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn, (restype, argtypes) in kernels.SOURCES[source].items():
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        libs[name] = (lib, log)
    return libs
