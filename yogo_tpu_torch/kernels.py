"""Build and bind the port's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface, and loaded with `ctypes` - no
PyTorch headers, so a build takes seconds. Libraries go to
`yogo_tpu_torch/_build/` (git-ignored), named by a hash of the sources (the
`.cu` and every `csrc/` header it includes) and the flags, so a stale build
is never loaded. Nothing is built at import: the
first call that needs a kernel builds it, and `build_all()` builds every
source at once, one `nvcc` process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from collections import Counter
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
    "int8_conv": {
        "yogo_int8_conv_launch": (
            ctypes.c_int,
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
        ),
        "yogo_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register / shared-memory report) of this process's
# builds, by source
build_logs: Dict[str, str] = {}
# nvcc runs started by this process, by source: a library is built once
# and loaded once, whatever reloads a caller does
BUILDS: Counter = Counter()


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _sources(name: str) -> list:
    """csrc/<name>.cu and every file of csrc/ it includes with #include
    "...", directly or through another such file, in a fixed order."""
    todo, seen = [CSRC_DIR / f"{name}.cu"], []
    while todo:
        path = todo.pop()
        if path in seen or not path.exists():
            continue
        seen.append(path)
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return sorted(seen)


def _lib_path(name: str) -> Path:
    """The library of csrc/<name>.cu, named by a hash of its sources (the
    .cu and the headers it includes) and the compiler flags."""
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
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
            BUILDS[n] += 1
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


_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([^;]*);")
_SASS_BRANCH = re.compile(r"^\S*\s+(0x[0-9a-f]+)")


def parse_sass(text: str) -> Dict[str, dict]:
    """Per kernel function of a `cuobjdump -sass` listing: its instruction
    count (NOPs left out) and, for its longest loop (a backward branch and
    the code it jumps back over), the loop body's instruction count and its
    FFMA, shared-load (LDS) and global-store (STG) counts."""
    out: Dict[str, dict] = {}
    ops: list = []  # (address, opcode, branch target or None)
    name = None

    def close():
        if name is None:
            return
        loop: list = []
        for i, (addr, _, target) in enumerate(ops):
            if target is not None and target < addr:
                body = [o for a, o, _ in ops[: i + 1] if a >= target]
                if len(body) > len(loop):
                    loop = body
        out[name] = {
            "instructions": len(ops),
            "ffma": sum(o == "FFMA" for _, o, _ in ops),
            "loop": {"instructions": len(loop), "ffma": loop.count("FFMA"),
                     "lds": loop.count("LDS"), "stg": loop.count("STG")},
        }

    for line in text.splitlines():
        if "Function :" in line:
            close()
            name, ops = line.split("Function :", 1)[1].strip(), []
            continue
        m = _SASS_INSTR.search(line)
        if m and m.group(2) != "NOP":
            b = _SASS_BRANCH.match(m.group(3)) if m.group(2) == "BRA" else None
            ops.append((int(m.group(1), 16), m.group(2), int(b.group(1), 16) if b else None))
    close()
    return out


def sass_summary(name: str, dump: Optional[Path] = None) -> Dict[str, dict]:
    """parse_sass of the built library of csrc/<name>.cu, with demangled
    function names where the toolkit has cu++filt; the listing is written to
    `dump` if given."""
    bindir = Path(find_nvcc()).parent
    text = subprocess.run(
        [str(bindir / "cuobjdump"), "-sass", str(_lib_path(name))],
        capture_output=True, text=True, check=True,
    ).stdout
    filt = bindir / "cu++filt"
    if filt.exists():
        text = subprocess.run([str(filt)], input=text, capture_output=True, text=True).stdout or text
    if dump is not None:
        dump.write_text(text)
    return parse_sass(text)


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.yogo_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} ({msg})")
