"""Build and bind the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface, and loaded with `ctypes` - no
PyTorch headers, so a build takes seconds. Libraries go to
`yogo_tpu_torch/_build/` (git-ignored), named by a hash of the source and
flags, so a stale build is never loaded. Nothing is built at import: the
first call that needs a kernel builds it, and `build_all()` builds every
source at once, one `nvcc` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# source stem -> C functions it exports, with their ctypes signatures
SOURCES: Dict[str, Dict[str, tuple]] = {
    "stem": {
        "yogo_stem_launch": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p],
        ),
        "yogo_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) of this process's
# builds, by source
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Compile the named sources (default: all) that are not built yet, one
    nvcc per source, concurrently. Raises with the compiler output if any
    build fails."""
    with _lock:
        todo = [n for n in (SOURCES if names is None else names) if not _lib_path(n).exists()]
        if not todo:
            return
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for n in todo:
            tmp = _lib_path(n).with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        errors = []
        for n, (tmp, p) in procs.items():
            build_logs[n], _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"nvcc failed for csrc/{n}.cu:\n{build_logs[n]}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _lib_path(n))  # atomic: no half-written library
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed, with
    argtypes/restype set for every exported function."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (restype, argtypes) in SOURCES[name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _loaded[name] = lib
        return _loaded[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.yogo_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
