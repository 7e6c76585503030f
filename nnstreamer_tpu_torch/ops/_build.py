"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exports plain C entry points and is compiled at
first use by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/torch_kernels/`` at the repository root, then loaded with
``ctypes``.  The library's file name carries a hash of its source and
flags, so an edited source rebuilds and a stale build is never loaded.
No PyTorch headers are involved: a build takes seconds, not minutes.

Every entry point returns ``cudaGetLastError()`` after its launch as an
int; the Python wrappers raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else CUDA_HOME's."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str, out: Path) -> Tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, Path(tmp)


def build(names: Iterable[str]) -> List[Path]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together; returns the library paths."""
    names = list(names)
    outs = [_lib_path(n) for n in names]
    jobs = [(n, out, *_start_build(n, out)) for n, out in zip(names, outs) if not out.exists()]
    errors = []
    for name, out, proc, tmp in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed, with
    ``argtypes`` set from ``signatures`` and ``restype`` int for each
    entry point."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            lib.nns_error_string.argtypes = [ctypes.c_int]
            lib.nns_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                entry = getattr(lib, fn)
                entry.argtypes = list(argtypes)
                entry.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point of `lib` reported a CUDA error."""
    if err != 0:
        text = lib.nns_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} at launch: {text}")
