"""ctypes bindings for the native host pipeline (csrc/yogo_host.cpp: libpng /
libjpeg decode + antialias resize, batch decode, label parser).

Builds the shared library on first use with g++ into `_build/` next to the
CUDA kernels' libraries, named by a hash of the source and the flags; every
entry point is gated - callers fall back to the PIL/python paths when the
toolchain or the image libraries' headers are unavailable. This is host
code: the gate does not apply to the CUDA kernels (kernels.py), which
build or raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from yogo_tpu_torch.kernels import BUILD_DIR, CSRC_DIR

_SRC = CSRC_DIR / "yogo_host.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
GXX_LIBS = ("-lpng", "-ljpeg", "-lz", "-pthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> Path:
    """The library, named by a hash of its source and the compiler flags
    (the scheme of kernels._lib_path), so a stale build is never loaded."""
    h = hashlib.sha256()
    h.update(_SRC.name.encode() + b"\0" + _SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    return BUILD_DIR / f"libyogo_host-{h.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> bool:
    # compile to a process-unique temp path then rename: concurrent first
    # builds from several processes must never leave a half-written .so
    # that a sibling dlopens (os.replace is atomic on the same filesystem)
    tmp = lib_path.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp), *GXX_LIBS]
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
        return True
    except (subprocess.SubprocessError, FileNotFoundError, OSError):
        tmp.unlink(missing_ok=True)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None if unavailable.
    Opt out entirely with YOGO_TPU_NO_NATIVE=1."""
    global _lib, _tried
    if os.environ.get("YOGO_TPU_NO_NATIVE", "0") not in ("", "0"):
        return None
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            return None
        lib_path = _lib_path()
        if not lib_path.exists() and not _build(lib_path):
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError:
            return None
        lib.yogo_decode_image.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.yogo_decode_image.restype = ctypes.c_int
        lib.yogo_image_size.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.yogo_image_size.restype = ctypes.c_int
        lib.yogo_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.yogo_decode_batch.restype = ctypes.c_int
        lib.yogo_parse_labels.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int,
        ]
        lib.yogo_parse_labels.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def image_size(path) -> Optional[Tuple[int, int]]:
    lib = get_lib()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.yogo_image_size(os.fsencode(path), ctypes.byref(h), ctypes.byref(w)):
        return None
    return h.value, w.value


def decode_image(
    path, out_hw: Tuple[int, int], channels: int = 1
) -> Optional[np.ndarray]:
    """Decode+resize one image -> (C, H, W) uint8, or None on failure."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((channels, out_hw[0], out_hw[1]), np.uint8)
    rc = lib.yogo_decode_image(
        os.fsencode(path),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_hw[0],
        out_hw[1],
        channels,
    )
    return out if rc == 0 else None


def decode_batch(
    paths: List, out_hw: Tuple[int, int], channels: int = 1, n_threads: int = 4
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Decode many images into one (N, C, H, W) buffer via the native thread
    pool. Returns (batch, ok_mask) or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.zeros((n, channels, out_hw[0], out_hw[1]), np.uint8)
    ok = np.zeros(n, np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.yogo_decode_batch(
        arr,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_hw[0],
        out_hw[1],
        channels,
        n_threads,
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out, ok.astype(bool)


def parse_labels(path, max_rows: int = 4096) -> Optional[np.ndarray]:
    """Parse a YOLO txt -> (N, 5) float64 [cls, xc, yc, w, h] (f64 so the
    values match the python fallback parser's float() exactly); rows with
    non-numeric class tokens carry cls = -1 for the caller to resolve.
    Returns None when the library is unavailable, the file can't be read,
    or the file is malformed - the caller's python parser then produces
    the reference's error messages. Files larger than max_rows re-parse
    with an exact-size buffer (no silent truncation)."""
    lib = get_lib()
    if lib is None:
        return None
    while True:
        out = np.empty((max_rows, 5), np.float64)
        n = lib.yogo_parse_labels(
            os.fsencode(path),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            max_rows,
        )
        if n < 0:  # -1 unreadable, -2 malformed: python path decides
            return None
        if n <= max_rows:
            return out[:n].copy()
        max_rows = n  # capacity overflow: retry with the exact count
