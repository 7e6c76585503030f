"""The persistent build directory of the hand-written kernels.

Port of ``nnstreamer_tpu/core/compile_cache.py``: where the JAX package
persists XLA executables, the port persists what it compiles itself, the
``nvcc`` builds of ``csrc/*.cu`` (``ops/_build.py``, kind ``"kernels"``)
and the ``g++`` builds of the native core and its examples
(``native/runtime.py``, kind ``"native"``).  A library's file name carries
a hash of its source, flags and :func:`host_fingerprint`, so a warm
directory is reused across processes and a changed source or toolkit
rebuilds.

Config (``core/config.py`` ini and env overrides)::

    [cuda]
    cache_dir = ~/.cache/nnstreamer_tpu_torch   ; "" disables

Env: ``NNS_TPU_CUDA_CACHE_DIR``.  A configured directory holds one
subdirectory per kind.  Unset, a checkout builds into
``build/torch_kernels/`` and ``build/torch_native/`` at its root, an
installed package into ``~/.cache/nnstreamer_tpu_torch/<kind>/``.  ``""``
means no persistent cache: each process builds into a temporary directory
of its own, removed at exit.  :func:`enable` is idempotent and runs at the
first build; a later call naming another directory warns and keeps the
first.
"""

from __future__ import annotations

import atexit
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

from . import config as nns_config
from .log import get_logger

log = get_logger("compile_cache")

_ROOT = Path(__file__).resolve().parents[2]
#: a checkout (sources beside ``pyproject.toml``) builds under its own ``build/``
_CHECKOUT = (_ROOT / "pyproject.toml").is_file()
_DEFAULT_DIR = "~/.cache/nnstreamer_tpu_torch"
#: the build directory's name of each kind in a checkout
_CHECKOUT_DIRS = {"kernels": "torch_kernels", "native": "torch_native"}

_lock = threading.Lock()
#: (mode, root) once enabled: ("default", None), ("dir", root) or ("temp", root)
_state: Optional[Tuple[str, Optional[Path]]] = None
_fingerprint: Dict[str, str] = {}


def _tool_line(cmd: str) -> str:
    """The first line of ``<cmd> --version`` that names a release (nvcc's
    ``Cuda compilation tools, release 12.8, V12.8.93``), or the first line;
    ``"<cmd>: none"`` where the tool is missing."""
    path = shutil.which(cmd)
    if path is None and cmd == "nvcc":
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        path = str(cand) if cand.exists() else None
    if path is None:
        return f"{cmd}: none"
    try:
        out = subprocess.run([path, "--version"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd}: {e}"
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    release = [ln for ln in lines if "release" in ln]
    return (release or lines or [f"{cmd}: no version"])[0]


def host_fingerprint(compiler: str = "nvcc") -> str:
    """What a library built here is compatible with: the machine and the
    compiler's release line (``nvcc --version`` for the kernels, ``g++
    --version`` for the native core), asked once a process.  It enters
    each library's name, so a toolkit change rebuilds."""
    with _lock:
        got = _fingerprint.get(compiler)
        if got is None:
            got = f"{platform.system()}-{platform.machine()} {_tool_line(compiler)}"
            _fingerprint[compiler] = got
        return got


def enable(cache_dir: Optional[str] = None) -> Optional[Path]:
    """Settle the build root (idempotent): ``cache_dir``, else the ini's or
    env's ``[cuda] cache_dir``, else the defaults (module docstring).
    Returns the configured root, or None for the defaults and for ``""``."""
    global _state
    with _lock:
        if _state is not None:
            mode, root = _state
            current = {"dir": root, "temp": ""}.get(mode)  # None: the defaults
            if cache_dir is not None:
                want = Path(os.path.expanduser(cache_dir)) if cache_dir else ""
                if want != current:
                    log.warning("kernel cache already enabled at %s; ignoring request for %s "
                                "(call reset_for_tests() first to re-point)",
                                root or "the default directories",
                                cache_dir or "no persistent cache")
            return root if mode == "dir" else None
        raw = cache_dir if cache_dir is not None else nns_config.get_value(
            "cuda", "cache_dir", None)
        if raw is None:
            _state = ("default", None)
        elif not raw:
            tmp = Path(tempfile.mkdtemp(prefix="nns_torch_kernels_"))
            atexit.register(shutil.rmtree, tmp, True)
            _state = ("temp", tmp)
        else:
            _state = ("dir", Path(os.path.expanduser(raw)))
        log.debug("kernel build cache: %s %s", *_state)
        return _state[1] if _state[0] == "dir" else None


def default_dir(kind: str = "kernels") -> Path:
    """The directory of `kind` where nothing is configured."""
    if _CHECKOUT:
        return _ROOT / "build" / _CHECKOUT_DIRS[kind]
    return Path(os.path.expanduser(_DEFAULT_DIR)) / kind


def cache_dir(kind: str = "kernels") -> Path:
    """The directory the libraries of `kind` (``"kernels"`` or
    ``"native"``) build into and load from; created."""
    enable()
    mode, root = _state
    path = default_dir(kind) if mode == "default" else root / kind
    path.mkdir(parents=True, exist_ok=True)
    return path


def persistent() -> bool:
    """False where ``cache_dir = ""`` sent builds to a temporary directory."""
    enable()
    return _state[0] != "temp"


def reset_for_tests() -> None:
    global _state
    with _lock:
        _state = None
