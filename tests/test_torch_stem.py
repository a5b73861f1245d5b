"""The port's fused stem (yogo_tpu_torch/ops/stem.py) against the JAX
package's Pallas stem kernels (interpret mode on the CPU), and the CUDA
kernel against its plain version where a GPU is present.

JAX is imported inside the tests that compare with it, so the CUDA test
runs on a GPU machine without JAX:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_stem.py -m cuda
Tolerance: 1 bf16 ulp (rtol 8e-3, atol 1e-2) - both sides accumulate in
f32 in a different order and round once to bf16.
"""

import ctypes
import re
import types

import numpy as np
import pytest
import torch

from yogo_tpu_torch import kernels
from yogo_tpu_torch.ops import stem
from yogo_tpu_torch.utils import tracing

RTOL, ATOL = 8e-3, 1e-2


def launches() -> dict:
    """The stem kernel's launches so far, by layout."""
    return {layout: tracing.COUNTS[f"stem_{layout}_kernel_launches"] for layout in stem.LAYOUTS}


def _params(seed: int, c: int = 16, bias: bool = False, bn: bool = True):
    rng = np.random.default_rng(seed)
    p = {"kernel": (0.05 * rng.standard_normal((3, 3, 1, c))).astype(np.float32)}
    p["bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32) if bias else None
    if bn:
        p["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        p["bn_bias"] = (0.2 * rng.standard_normal(c)).astype(np.float32)
        p["mean"] = (5 * rng.standard_normal(c)).astype(np.float32)
        p["var"] = rng.uniform(10, 200, c).astype(np.float32)
    return p


def _fold_torch(p):
    def t(a):
        return None if a is None else torch.from_numpy(a)

    return stem.fold_stem_params(
        t(p["kernel"].transpose(3, 2, 0, 1)), t(p["bias"]),
        t(p.get("scale")), t(p.get("bn_bias")), t(p.get("mean")), t(p.get("var")),
    )


@pytest.mark.parametrize("bias,bn", [(False, True), (True, True), (True, False)])
def test_fold_matches_jax(bias, bn):
    from yogo_tpu.ops.pallas_stem import fold_stem_params

    p = _params(0, bias=bias, bn=bn)
    jw, jb = fold_stem_params(
        p["kernel"], p["bias"], p.get("scale"), p.get("bn_bias"), p.get("mean"), p.get("var")
    )
    w, b = _fold_torch(p)
    assert w.shape == (16, 9) and b.shape == (16,) and w.dtype == torch.float32
    # JAX (3, 3, C) [dy, dx, c] -> the kernel's (C, 9) [c, 3*dy + dx]
    want_w = np.asarray(jw).reshape(9, 16).T
    np.testing.assert_allclose(w.numpy(), want_w, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
@pytest.mark.parametrize("shape", [(2, 16, 24), (2, 70, 48)])
def test_reference_matches_pallas_interpret(shape, layout):
    import jax.numpy as jnp

    from yogo_tpu.ops.pallas_stem import fused_stem, fused_stem_nchw

    p = _params(1)
    w, b = _fold_torch(p)
    imgs = np.random.default_rng(2).integers(0, 256, shape, np.uint8)
    got = stem.fused_stem_reference(torch.from_numpy(imgs), w, b, layout=layout)
    assert got.dtype == torch.bfloat16
    assert got.shape == (shape[0], 16, shape[1] // 2, shape[2] // 2)

    jw = jnp.asarray(w.numpy().T.reshape(3, 3, 16))
    jb = jnp.asarray(b.numpy())
    if layout == "nhwc":
        assert got.is_contiguous(memory_format=torch.channels_last)
        want = np.asarray(fused_stem(jnp.asarray(imgs), jw, jb, interpret=True), np.float32)
        got_np = got.permute(0, 2, 3, 1).float().numpy()
    else:
        assert got.is_contiguous()
        want = np.asarray(fused_stem_nchw(jnp.asarray(imgs), jw, jb, interpret=True), np.float32)
        got_np = got.float().numpy()
    np.testing.assert_allclose(got_np, want, rtol=RTOL, atol=ATOL)


def test_reference_matches_flax_block0():
    """The folded stem computes block 0 of the flax stack (conv + BN +
    leaky) up to the bf16 rounding of the output."""
    import jax.numpy as jnp

    from yogo_tpu.models.defns import base_model
    from yogo_tpu.models.yogo import ConvStack

    p = _params(3)
    w, b = _fold_torch(p)
    imgs = np.random.default_rng(4).integers(0, 256, (2, 32, 48), np.uint8)
    sub = ConvStack(blocks=base_model(2).blocks[:1])
    v = {
        "params": {"conv0": {"kernel": p["kernel"]},
                   "bn0": {"scale": p["scale"], "bias": p["bn_bias"]}},
        "batch_stats": {"bn0": {"mean": p["mean"], "var": p["var"]}},
    }
    want = np.asarray(sub.apply(v, jnp.asarray(imgs[..., None], jnp.float32), train=False))
    got = stem.fused_stem_reference(torch.from_numpy(imgs), w, b, layout="nhwc")
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).float().numpy(), want, rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_takes_plain_version_without_launching():
    w, b = _fold_torch(_params(5))
    imgs = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (1, 8, 10), np.uint8))
    before = launches()
    for layout in stem.LAYOUTS:
        got = stem.fused_stem_nchw(imgs, w, b, layout=layout)
        assert torch.equal(got, stem.fused_stem_reference(imgs, w, b, layout=layout))
    assert launches() == before


@pytest.mark.parametrize(
    "imgs,wshape,layout,match",
    [
        (np.zeros((1, 7, 8), np.uint8), (16, 9), "nchw", "even"),
        (np.zeros((1, 8, 8), np.float32), (16, 9), "nchw", "uint8"),
        (np.zeros((8, 8), np.uint8), (16, 9), "nchw", "uint8"),
        (np.zeros((1, 8, 8), np.uint8), (16, 3, 3), "nchw", r"\(C, 9\)"),
        (np.zeros((1, 8, 8), np.uint8), (16, 9), "hwcn", "layout"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(imgs, wshape, layout, match):
    w = torch.zeros(wshape)
    with pytest.raises(ValueError, match=match):
        stem.fused_stem_nchw(torch.from_numpy(imgs), w, torch.zeros(16), layout=layout)


@pytest.fixture
def cuda():
    """Skips the test where there is no CUDA GPU (decided when the test
    runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")


# (B, H, W): W/2 odd and even, not a multiple of the 2 pixels a thread
# computes nor of the 8 that one 16-byte NCHW store holds; NCHW planes whose
# warp runs are not 16-byte aligned (10x12); H/2 not a multiple of the 8-row
# band; B=1; and B=1000 small images, more bands than the persistent grid
# has blocks
CUDA_SHAPES = [(2, 772, 1032), (1, 772, 1030), (3, 70, 48), (1, 2, 2), (2, 6, 6),
               (2, 10, 12), (2, 18, 130), (1000, 4, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", stem.LAYOUTS)
@pytest.mark.parametrize("c", stem.STEM_CHANNELS)
def test_cuda_kernel_matches_plain_version(cuda, c, layout):
    w, b = (t.cuda() for t in _fold_torch(_params(7, c=c)))
    rng = np.random.default_rng(8)
    cases = [torch.from_numpy(rng.integers(0, 256, s, np.uint8)).cuda() for s in CUDA_SHAPES]
    # a base that is not 16-byte aligned: 772 * 1030 = 8 (mod 16)
    misaligned = torch.from_numpy(rng.integers(0, 256, (3, 772, 1030), np.uint8)).cuda()[1:]
    assert misaligned.is_contiguous() and misaligned.data_ptr() % 16 == 8
    fmt = torch.channels_last if layout == "nhwc" else torch.contiguous_format
    for x in cases + [misaligned]:
        n = launches()
        got = stem.fused_stem_nchw(x, w, b, layout=layout)
        torch.cuda.synchronize()
        assert launches() == {**n, layout: n[layout] + 1}
        want = stem.fused_stem_reference(x, w, b, layout=layout)
        assert got.shape == want.shape and got.is_contiguous(memory_format=fmt)
        torch.testing.assert_close(got.float(), want.float(), rtol=RTOL, atol=ATOL,
                                   msg=lambda m: f"{tuple(x.shape)}: {m}")


def _fake_nvcc(tmp_path, body: str):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return str(nvcc)


def test_build_runs_nvcc_for_sm90a_into_a_hashed_library(tmp_path, monkeypatch):
    """The build plumbing, with a stand-in for nvcc (there is none here):
    one nvcc per source, every one for sm_90a, each library named by its
    sources' hash, and nothing rebuilt."""
    from yogo_tpu_torch import kernels

    args = tmp_path / "args"
    nvcc = _fake_nvcc(tmp_path, (
        f'echo "$@" >> {args}\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && touch "$2"; shift; done\n'
        'echo "ptxas info: 50 registers"\n'
    ))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "find_nvcc", lambda: nvcc)
    kernels.build_all()
    built = sorted(f(n).name for n in kernels.SOURCES for f in (kernels._lib_path, kernels._log_path))
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == built
    assert sorted(kernels.SOURCES) == ["int8_conv", "layer_norm", "nms", "stem"]
    runs = args.read_text().splitlines()
    assert len(runs) == 4 and all("arch=compute_90a,code=sm_90a" in r for r in runs)
    assert sorted(r.rsplit("csrc/", 1)[1] for r in runs) == ["int8_conv.cu", "layer_norm.cu", "nms.cu", "stem.cu"]
    assert all("50 registers" in kernels.build_log(n) for n in kernels.SOURCES)
    args.unlink()
    kernels.build_all()  # already built: nvcc is not run again
    assert not args.exists()


class _FakeLib:
    """Stands in for ctypes.CDLL where no kernel library can be built (no
    nvcc): every symbol exists, as an object ctypes would type."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, symbol):
        fn = types.SimpleNamespace()
        setattr(self, symbol, fn)
        return fn


_C_KINDS = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}


@pytest.mark.parametrize("name", sorted(kernels.SOURCES))
def test_sources_bind_each_kernel_s_launch_entry(tmp_path, monkeypatch, name):
    """kernels.SOURCES[name] has the argument kinds of the extern "C"
    prototype of yogo_<name>_launch in csrc/<name>.cu, the stream last, and
    load binds that entry and yogo_cuda_error_string, once."""
    src = (kernels.CSRC_DIR / f"{name}.cu").read_text()
    params = [" ".join(p.split()) for p in re.search(
        rf'extern "C" int yogo_{name}_launch\(([^)]*)\)', src).group(1).split(",")]
    kinds = [ctypes.c_void_p if "*" in p else _C_KINDS[p.rsplit(" ", 1)[0]] for p in params]
    assert kernels.SOURCES[name] == kinds and params[-1] == "void* stream"
    assert kernels._sources(name) == [kernels.CSRC_DIR / f"{name}.cu"]

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_loaded", {})
    monkeypatch.setattr(kernels.ctypes, "CDLL", _FakeLib)
    kernels._lib_path(name).touch()
    kernels._log_path(name).touch()
    lib = kernels.load(name)
    assert lib.path == str(kernels._lib_path(name)) and kernels.load(name) is lib
    entry = getattr(lib, f"yogo_{name}_launch")
    assert (entry.restype, entry.argtypes) == (ctypes.c_int, kinds)
    err = lib.yogo_cuda_error_string
    assert (err.restype, err.argtypes) == (ctypes.c_char_p, [ctypes.c_int])


def test_variants_build_as_the_sources_do(tmp_path, monkeypatch):
    """tools/timing.build_variants runs nvcc as build_all does (the same
    flags, a build counted), into _build/variants/<source>/, keeps nvcc's
    output beside each library and binds it as load does."""
    from yogo_tpu_torch.tools.timing import build_variants

    args = tmp_path / "args"
    nvcc = _fake_nvcc(tmp_path, (
        f'echo "$@" >> {args}\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && touch "$2"; shift; done\n'
        'echo "ptxas info: 40 registers"\n'
    ))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "find_nvcc", lambda: nvcc)
    monkeypatch.setattr(kernels.ctypes, "CDLL", _FakeLib)
    before = tracing.COUNTS["stem_kernel_builds"]
    libs = build_variants("stem", {"kernel": [], "slope": [("float slope, void*", "float slope,  void*")]})
    assert tracing.COUNTS["stem_kernel_builds"] - before == 2
    out_dir = tmp_path / "build" / "variants" / "stem"
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "kernel.cu", "kernel.log", "kernel.so", "slope.cu", "slope.log", "slope.so"]
    assert (out_dir / "kernel.cu").read_text() == (kernels.CSRC_DIR / "stem.cu").read_text()
    for run in args.read_text().splitlines():
        assert " ".join(kernels.NVCC_FLAGS) in run and run.endswith(".cu")
    for name, (lib, log) in libs.items():
        assert lib.path == str(out_dir / f"{name}.so") and "40 registers" in log
        assert lib.yogo_stem_launch.argtypes == kernels.SOURCES["stem"]
        assert lib.yogo_cuda_error_string.restype is ctypes.c_char_p


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    from yogo_tpu_torch import kernels

    nvcc = _fake_nvcc(tmp_path, 'echo "stem.cu(1): error: boom"\nexit 2\n')
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "find_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="error: boom"):
        kernels.build_all(["stem"])
    assert list((tmp_path / "build").iterdir()) == []


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """A change to a csrc/ header that a .cu includes names a new library,
    so a stale build is never loaded; a file it does not include does not."""
    from yogo_tpu_torch import kernels

    (tmp_path / "stem.cu").write_text('#include <cuda_runtime.h>\n#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    monkeypatch.setattr(kernels, "CSRC_DIR", tmp_path)
    first = kernels._lib_path("stem")
    assert [p.name for p in kernels._sources("stem")] == ["common.cuh", "inner.cuh", "stem.cu"]
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert kernels._lib_path("stem") == first
    (tmp_path / "inner.cuh").write_text("// v2\n")
    second = kernels._lib_path("stem")
    assert second != first and second.name.startswith("libstem-")
    (tmp_path / "common.cuh").write_text('#pragma once\n#include "inner.cuh"\n// edited\n')
    assert kernels._lib_path("stem") not in (first, second)


def test_sass_summary_counts_the_longest_loop():
    from yogo_tpu_torch.kernels import parse_sass

    listing = """
        Function : void k<16, true>(int)
        /*0000*/                   LDC R1, c[0x0][0x28] ;                  /* 0x00000a00ff017b82 */
        /*0010*/                   LDS.U8 R0, [R2] ;
        /*0020*/                   FFMA R3, R0, R4, R3 ;
        /*0030*/                   STG.E.128 desc[UR4][R2.64], R4 ;
        /*0040*/               @P0 BRA 0x10 ;                           /* 0xfffffffc006c8947 */
        /*0050*/              @!P0 BRA 0x70 ;
        /*0060*/                   EXIT ;
        /*0070*/                   BRA 0x70;
        /*0080*/                   NOP;
        Function : void g<128, 1, true>(CUtensorMap_st, Params)
        /*0000*/                   WARPGROUP.ARRIVE ;
        /*0010*/                   IGMMA.64x128x32.S8.S8 R24, gdesc[UR8], R24, gsb0 ;
        /*0020*/                   IGMMA.64x128x32.S8.S8 R88, gdesc[UR12], R88, gsb0 ;
        /*0030*/                   IMMA.16832.S8.S8 R4, R8, R12, R4 ;
        /*0040*/                   EXIT ;
"""
    got = parse_sass(listing)
    assert got == {
        "void k<16, true>(int)": {
            "instructions": 8, "ffma": 1, "igmma": 0, "imma": 0,
            "loop": {"instructions": 4, "ffma": 1, "lds": 1, "stg": 1}},
        "void g<128, 1, true>(CUtensorMap_st, Params)": {
            "instructions": 5, "ffma": 0, "igmma": 2, "imma": 1,
            "loop": {"instructions": 0, "ffma": 0, "lds": 0, "stg": 0}},
    }


def test_stem_variants_edit_the_current_source():
    """Every text edit of the variant-timing script still finds its anchor
    exactly once in csrc/stem.cu, and the kernel variant is the source."""
    from yogo_tpu_torch import kernels
    from yogo_tpu_torch.tools import stem_variants
    from yogo_tpu_torch.tools.timing import variant_source

    src = (kernels.CSRC_DIR / "stem.cu").read_text()
    assert variant_source(src, stem_variants.VARIANTS["kernel"][0]) == src
    for name, (edits, _, _) in stem_variants.VARIANTS.items():
        assert variant_source(src, edits) != src or name == "kernel"
    with pytest.raises(ValueError, match="anchor"):
        variant_source(src, [("no such line in the kernel", "")])
