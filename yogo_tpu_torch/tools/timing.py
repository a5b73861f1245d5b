"""What the port's measurements share: the card's rates, a CUDA-event
timer, the card's name and power limit, and text-edited builds of a kernel
source with the seam that launches one (the variant scripts:
tools/stem_variants.py, tools/int8_conv_variants.py,
tools/layer_norm_variants.py).
"""

from __future__ import annotations

import statistics
import subprocess
from contextlib import contextmanager

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
    yogo_tpu_torch/_build/variants/<source>/, all at once, as kernels builds
    the source itself. Returns name -> (the library, bound as kernels.load
    binds the source's; nvcc's output)."""
    src = (kernels.CSRC_DIR / f"{source}.cu").read_text()
    out_dir = kernels.BUILD_DIR / "variants" / source
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, edits in variants.items():
        (out_dir / f"{name}.cu").write_text(variant_source(src, edits))
    kernels.nvcc({name: (source, out_dir / f"{name}.cu", out_dir / f"{name}.so") for name in variants})
    return {name: (kernels.bind(source, out_dir / f"{name}.so"), (out_dir / f"{name}.log").read_text())
            for name in variants}


@contextmanager
def as_kernel(source: str, lib):
    """Inside the block, kernels.load(source) returns `lib` (a variant's
    library from build_variants), so kernels.launch and the op that wraps
    it run the variant."""
    saved = kernels._loaded.get(source)
    kernels._loaded[source] = lib
    try:
        yield
    finally:
        if saved is None:
            kernels._loaded.pop(source)
        else:
            kernels._loaded[source] = saved
