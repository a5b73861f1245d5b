"""Build, bind, launch and count the port's CUDA kernels.

Each `csrc/<name>.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into
its own shared library with a plain C interface, and loaded with `ctypes` -
no PyTorch headers, so a build takes seconds. Libraries go to
`yogo_tpu_torch/_build/` (git-ignored), named by a hash of the sources (the
`.cu` and every `csrc/` header it includes) and the flags, so a stale build
is never loaded. nvcc's output (ptxas's register and spill report) is
kept beside each library, so `build_log` reads it whether this process
built the library or found it built. Nothing is built at import: the
first call that needs a kernel builds it, and `build_all()` builds every
source at once, one `nvcc` process each, all started together.

Each source exports one launch entry, `yogo_<name>_launch(..., stream)`,
which returns a CUDA error code, and `yogo_cuda_error_string(code)`.
`launch` is the one way the ops call them: on the caller's device and
current stream, raising on an error code. The counters are
utils/tracing.COUNTS': `<name>_kernel_builds` counts nvcc runs and
`<name>_kernel_launches` launches (the stem's per layout).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import torch

from yogo_tpu_torch.utils import tracing

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# source stem -> the argtypes of its launch entry yogo_<name>_launch (which
# returns an int), the stream handle last
SOURCES: Dict[str, list] = {
    "stem": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
    "int8_conv": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
    "nms": [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    "layer_norm": [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


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


def hashed_lib(stem: str, files: Iterable[Path], flags: Sequence[str]) -> Path:
    """BUILD_DIR/lib<stem>-<hash>.so, the hash over the names and bytes of
    `files` and the compiler `flags`: a stale build is never loaded."""
    h = hashlib.sha256()
    for path in files:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{stem}-{h.hexdigest()[:16]}.so"


def _lib_path(name: str) -> Path:
    """The library of csrc/<name>.cu, named by a hash of its sources (the
    .cu and the headers it includes) and the compiler flags."""
    return hashed_lib(name, _sources(name), NVCC_FLAGS)


def _log_path(name: str) -> Path:
    """nvcc's output of the build of _lib_path(name), beside it."""
    return _lib_path(name).with_suffix(".log")


def compile_libs(jobs: Dict[str, Tuple[Sequence[str], Path]]) -> None:
    """Run every job's compiler command (key -> (command, library path)),
    all at once, each with `-o` to a name of its own that is renamed onto
    the library when it succeeds, and its output kept beside the library
    as <library>.log, renamed too: no process loads a half-written library
    or reads a half-written log. Raises with the output of every failed
    command."""
    procs = {}
    for key, (cmd, lib) in jobs.items():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        procs[key] = (lib, tmp, subprocess.Popen(
            [cmd[0], "-o", str(tmp), *cmd[1:]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    errors = []
    for key, (lib, tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{Path(p.args[0]).name} failed for {key}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            tmp_log = tmp.with_suffix(".log")
            tmp_log.write_text(out)
            os.replace(tmp_log, lib.with_suffix(".log"))
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))


def nvcc(jobs: Dict[str, Tuple[str, Path, Path]]) -> None:
    """compile_libs with nvcc and NVCC_FLAGS: key -> (source name, .cu
    file, library path). Each run adds one to <source>_kernel_builds."""
    if not jobs:
        return
    cmd = [find_nvcc(), *NVCC_FLAGS]
    for name, _, _ in jobs.values():
        tracing.add(**{f"{name}_kernel_builds": 1})
    compile_libs({key: ([*cmd, str(cu)], lib) for key, (_, cu, lib) in jobs.items()})


def build_all(names: Optional[Iterable[str]] = None) -> None:
    """Compile the named sources (default: all) that are not built yet (no
    library, or no compiler output beside it), one nvcc per source,
    concurrently. Raises with the compiler output if any build fails."""
    with _lock:
        nvcc({n: (n, CSRC_DIR / f"{n}.cu", _lib_path(n)) for n in (SOURCES if names is None else names)
              if not (_lib_path(n).exists() and _log_path(n).exists())})


def build_log(name: str) -> str:
    """nvcc's output (with `-Xptxas -v`: registers, spills, shared memory
    per kernel) of the library of csrc/<name>.cu, built first if needed."""
    build_all([name])
    return _log_path(name).read_text()


def bind(name: str, path: Path) -> ctypes.CDLL:
    """The library at `path`, built from csrc/<name>.cu (or a variant of
    it), with yogo_<name>_launch and yogo_cuda_error_string typed."""
    lib = ctypes.CDLL(str(path))
    entry = getattr(lib, f"yogo_{name}_launch")
    entry.restype, entry.argtypes = ctypes.c_int, SOURCES[name]
    lib.yogo_cuda_error_string.restype, lib.yogo_cuda_error_string.argtypes = ctypes.c_char_p, [ctypes.c_int]
    return lib


def load(name: str) -> ctypes.CDLL:
    """The bound library of csrc/<name>.cu, built and loaded once."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = bind(name, _lib_path(name))
        return _loaded[name]


def launch(name: str, device, *args, counter: Optional[str] = None) -> None:
    """Call yogo_<name>_launch(*args, stream) of csrc/<name>.cu on `device`
    (a CUDA device), with the handle of its current stream: the kernel is
    queued there, nothing waits. Raises with the CUDA error a non-zero code
    names; else adds one to `<counter or name>_kernel_launches`."""
    lib = load(name)
    with torch.cuda.device(device):
        code = getattr(lib, f"yogo_{name}_launch")(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.yogo_cuda_error_string(code).decode()
        raise RuntimeError(f"the {name} kernel failed to launch: CUDA error {code} ({msg})")
    tracing.add(**{f"{counter or name}_kernel_launches": 1})


_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)([^;]*);")
_SASS_BRANCH = re.compile(r"^\S*\s+(0x[0-9a-f]+)")


def parse_sass(text: str) -> Dict[str, dict]:
    """Per kernel function of a `cuobjdump -sass` listing: its instruction
    count (NOPs left out), its tensor-core instructions (IGMMA: `wgmma`
    with s8 operands; IMMA: `mma.sync` s8) and, for its longest loop (a
    backward branch and the code it jumps back over), the loop body's
    instruction count and its FFMA, shared-load (LDS) and global-store (STG)
    counts."""
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
            "igmma": sum(o == "IGMMA" for _, o, _ in ops),
            "imma": sum(o == "IMMA" for _, o, _ in ops),
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


_PTXAS_FN = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def ptxas_summary(text: str) -> Dict[str, dict]:
    """Per kernel function (mangled name) of an nvcc build log with
    `-Xptxas -v`: registers, static shared memory, stack frame and spill
    bytes."""
    out: Dict[str, dict] = {}
    fn = None
    for line in text.splitlines():
        m = _PTXAS_FN.search(line)
        if m:
            fn = m.group(1)
            out[fn] = {"registers": 0, "smem": 0, "stack": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if fn is None:
            continue
        m = _PTXAS_SPILL.search(line)
        if m:
            out[fn].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = _PTXAS_USED.search(line)
        if m:
            out[fn]["registers"] = int(m.group(1))
            smem = _PTXAS_SMEM.search(line)
            out[fn]["smem"] = int(smem.group(1)) if smem else 0
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
