"""ctypes bindings for the port's native core (``core/nns_tpu_core.cc``).

Port of ``nnstreamer_tpu/native/runtime.py`` over the port's own copy of
the C++ core: the library is built from this package's sources with
``g++ -O2 -std=c++17 -fPIC -shared -pthread`` at first use into
``build/torch_native/`` at the root of a checkout (an installed package,
with no checkout around it, builds into its own ``native/build/``, as the
JAX runtime does), named by a hash of its source and flags (an edited
source rebuilds, a stale build is never loaded), compiled to a temporary
name and renamed into place, so a concurrent loader never opens a
half-written file.  Nothing here loads
the JAX package's build or includes its header.

:class:`NativeMailbox` is API-compatible with the ``queue.Queue`` subset
the scheduler uses (put/put_nowait/get/get_nowait raising queue.Full and
queue.Empty, qsize, maxsize) but blocks inside the C++ condvar with the
GIL released (ctypes drops it for the call): immediate wake-ups instead of
Python poll loops.  Python object lifetime: a strong reference is taken
(Py_IncRef) before a pointer enters the native queue and handed back to
Python on pop; ``close()`` drains and releases leftovers.

Unlike the JAX package, the port's scheduler and ``appsrc`` keep
``queue.Queue``: on the card, path a's pipeline ran slower on these
mailboxes (``chip_smoke.py`` p5 measures both in alternating pairs).  The
core builds at the first :func:`available` or class construction;
``NNS_TPU_NO_NATIVE`` (any value), the reference's switch, keeps it
unloaded.  :func:`build_example` builds a custom-filter subplugin of
``examples/`` against the port's header ``include/nns_tpu_custom_filter.h``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue as _pyqueue
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Any, List, Optional

from ..core.log import get_logger

log = get_logger("native")

HERE = Path(__file__).resolve().parent
CORE_SRC = HERE / "core" / "nns_tpu_core.cc"
INCLUDE_DIR = HERE / "include"
EXAMPLES_DIR = HERE / "examples"
_ROOT = HERE.parents[1]
BUILD_DIR = (_ROOT / "build" / "torch_native" if (_ROOT / "pyproject.toml").is_file()
             else HERE / "build")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
#: the build's bound: a wedged compiler must not hold the caller forever
BUILD_TIMEOUT_S = 120.0

_lib: Optional[ctypes.CDLL] = None
_build_lock = threading.Lock()
_build_failed = False


def compile_command(src: Path, out: Path) -> List[str]:
    """The ``g++`` command line that builds `src` into `out`: the port's
    ``include/`` is its one include directory."""
    return ["g++", *CXX_FLAGS, f"-I{INCLUDE_DIR}", "-o", str(out), str(src)]


def library_path(src: Path) -> Path:
    """``build/torch_native/lib<stem>-<hash>.so``: the hash covers the
    source, the port's headers and the flags."""
    h = hashlib.sha256(Path(src).read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.h")):
        h.update(header.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(src).stem}-{h.hexdigest()[:16]}.so"


def compile_library(src: Path) -> Path:
    """Build `src` (if its hashed library is missing) and return the
    library's path; raises ``RuntimeError`` naming the compiler's output
    when ``g++`` is missing or fails."""
    out = library_path(src)
    if out.exists():
        return out
    if shutil.which("g++") is None:
        raise RuntimeError(f"g++ not found: cannot build {Path(src).name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        r = subprocess.run(compile_command(src, Path(tmp)), capture_output=True, text=True,
                           timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to run for {Path(src).name}: {e}") from None
    if r.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {Path(src).name}:\n{r.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return out


def build_example(name: str) -> Path:
    """Build ``examples/<name>.cc`` (e.g. ``scaler_custom``, the
    ``mult:<f>`` scaler subplugin) and return the ``.so`` to pass as a
    ``framework=custom`` model."""
    return compile_library(EXAMPLES_DIR / f"{name}.cc")


def _load() -> Optional[ctypes.CDLL]:
    """dlopen the core library, building it first where it is missing;
    None where ``NNS_TPU_NO_NATIVE`` is set, or (with a warning, once)
    where the build fails."""
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed or os.environ.get("NNS_TPU_NO_NATIVE"):
        return None
    with _build_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            so = compile_library(CORE_SRC)
        except RuntimeError as e:
            log.warning("native core unavailable: %s", e)
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(so))
        c = ctypes
        for fn, res, args in (
            ("nns_oq_create", c.c_void_p, [c.c_size_t]),
            ("nns_oq_push", c.c_int, [c.c_void_p, c.c_void_p, c.c_double]),
            ("nns_oq_pop", c.c_int, [c.c_void_p, c.c_double, c.POINTER(c.c_void_p)]),
            ("nns_oq_pop_n", c.c_int,
             [c.c_void_p, c.c_size_t, c.c_double, c.POINTER(c.c_void_p)]),
            ("nns_oq_push_n", c.c_int,
             [c.c_void_p, c.POINTER(c.c_void_p), c.c_size_t, c.c_double]),
            ("nns_oq_size", c.c_size_t, [c.c_void_p]),
            ("nns_oq_close", None, [c.c_void_p]),
            ("nns_oq_destroy", None, [c.c_void_p]),
            ("nns_pool_create", c.c_void_p, [c.c_size_t, c.c_size_t, c.c_size_t]),
            ("nns_pool_acquire", c.c_void_p, [c.c_void_p]),
            ("nns_pool_release", c.c_int, [c.c_void_p, c.c_void_p]),
            ("nns_pool_block_size", c.c_size_t, [c.c_void_p]),
            ("nns_pool_outstanding", c.c_size_t, [c.c_void_p]),
            ("nns_pool_destroy", None, [c.c_void_p]),
            ("nns_reader_open", c.c_void_p, [c.c_char_p, c.c_uint64]),
            ("nns_reader_total", c.c_uint64, [c.c_void_p]),
            ("nns_reader_read", c.c_int, [c.c_void_p, c.c_uint64, c.c_void_p]),
            ("nns_reader_prefetch", None, [c.c_void_p, c.c_uint64]),
            ("nns_reader_close", None, [c.c_void_p]),
        ):
            entry = getattr(lib, fn)
            entry.restype, entry.argtypes = res, args
        _lib = lib
        log.info("native core loaded: %s", so)
        return _lib


def available() -> bool:
    """True when the native core is loadable (built here at the first
    call)."""
    return _load() is not None


def _timeout(t: Optional[float]) -> float:
    return -1.0 if t is None else float(t)


class NativeMailbox:
    """queue.Queue-compatible bounded mailbox backed by the C++ condvar
    queue.  Raises queue.Full / queue.Empty like the stdlib class."""

    def __init__(self, maxsize: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native core unavailable")
        self._lib = lib
        self._h = lib.nns_oq_create(max(0, maxsize))
        self._maxsize = max(0, maxsize)
        self._closed = False

    # -- stdlib-compatible subset -------------------------------------------
    def put(self, item: Any, timeout: Optional[float] = None) -> None:
        if self._closed:
            raise _pyqueue.Full
        ref = ctypes.py_object(item)
        ctypes.pythonapi.Py_IncRef(ref)
        # CPython: id(obj) IS the PyObject* address
        rc = self._lib.nns_oq_push(self._h, id(item), _timeout(timeout))
        if rc != 0:
            ctypes.pythonapi.Py_DecRef(ref)
            raise _pyqueue.Full

    def put_nowait(self, item: Any) -> None:
        self.put(item, timeout=0.0)

    def put_many(self, items: list, timeout: Optional[float] = None) -> int:
        """Push a run of items in ONE native call: waits (bounded) for
        space for the first, appends the rest as capacity allows.  Returns
        the number of leading items consumed (0 on timeout)."""
        if self._closed:
            raise _pyqueue.Full
        n_items = len(items)
        if n_items == 0:
            return 0
        arr = (ctypes.c_void_p * n_items)()
        for i, item in enumerate(items):
            # a strong reference per item BEFORE its pointer enters the queue
            ctypes.pythonapi.Py_IncRef(ctypes.py_object(item))
            arr[i] = id(item)
        rc = self._lib.nns_oq_push_n(self._h, arr, n_items, _timeout(timeout))
        consumed = max(0, rc)
        for i in range(consumed, n_items):
            ctypes.pythonapi.Py_DecRef(ctypes.py_object(items[i]))
        if rc == -2:
            raise _pyqueue.Full  # closed
        return consumed

    def _take(self, ptr) -> Any:
        obj = ctypes.cast(ptr, ctypes.py_object).value
        ctypes.pythonapi.Py_DecRef(ctypes.py_object(obj))
        return obj

    def _pop(self, timeout: Optional[float]) -> Any:
        out = ctypes.c_void_p()
        rc = self._lib.nns_oq_pop(self._h, _timeout(timeout), ctypes.byref(out))
        if rc != 0:
            raise _pyqueue.Empty
        return self._take(out)

    def get(self, timeout: Optional[float] = None) -> Any:
        if self._closed:
            raise _pyqueue.Empty
        return self._pop(timeout)

    def get_many(self, max_n: int, timeout: Optional[float] = None) -> list:
        """Pop up to ``max_n`` items in ONE native call: wait (bounded) for
        the first, take the rest without waiting.  Raises queue.Empty on
        timeout."""
        if self._closed or max_n <= 0:
            raise _pyqueue.Empty
        arr = (ctypes.c_void_p * max_n)()
        rc = self._lib.nns_oq_pop_n(self._h, max_n, _timeout(timeout), arr)
        if rc <= 0:
            raise _pyqueue.Empty
        return [self._take(arr[i]) for i in range(rc)]

    def get_nowait(self) -> Any:
        return self.get(timeout=0.0)

    def qsize(self) -> int:
        if self._closed:
            return 0
        return int(self._lib.nns_oq_size(self._h))

    def empty(self) -> bool:
        return self.qsize() == 0

    @property
    def maxsize(self) -> int:
        return self._maxsize

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Wake all waiters, drain, release references.  The native queue
        itself is freed at GC (``__del__``): a straggler entering put/get
        after close sees the closed flag, against still-valid memory."""
        if self._closed:
            return
        self._closed = True
        self._lib.nns_oq_close(self._h)
        while True:
            try:
                self._pop(timeout=0.0)
            except _pyqueue.Empty:
                break

    def __del__(self):  # pragma: no cover — GC order dependent
        try:
            if self._h:
                self.close()
                # no references left: no concurrent callers; destroy still
                # waits for a waiter mid-exit in C++
                self._lib.nns_oq_destroy(self._h)
                self._h = None
        except Exception:  # allow-silent: __del__ during interpreter exit
            pass


class BufferPool:
    """Aligned recycled buffers (≙ gst_tensor_allocator): ``acquire()``
    returns (pointer, writable memoryview over an aligned block);
    ``release(pointer)`` recycles it."""

    def __init__(self, block_size: int, prealloc: int = 4, alignment: int = 64):
        lib = _load()
        if lib is None:
            raise RuntimeError("native core unavailable")
        self._lib = lib
        self._h = lib.nns_pool_create(block_size, prealloc, alignment)
        if not self._h:
            raise ValueError("bad pool parameters (alignment power of two?)")
        self.block_size = block_size

    def acquire(self):
        ptr = self._lib.nns_pool_acquire(self._h)
        if not ptr:
            raise MemoryError("pool allocation failed")
        buf = (ctypes.c_char * self.block_size).from_address(ptr)
        return ptr, memoryview(buf).cast("B")

    def release(self, ptr: int) -> None:
        if self._lib.nns_pool_release(self._h, ptr) != 0:
            raise ValueError("double release of pool block")

    @property
    def outstanding(self) -> int:
        return int(self._lib.nns_pool_outstanding(self._h))

    def destroy(self) -> None:
        if self._h:
            self._lib.nns_pool_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.destroy()
        except Exception:  # allow-silent: GC-order-dependent teardown
            pass


class SampleReader:
    """mmap-backed fixed-size sample reader (the native datarepo loader):
    the file is mapped once; ``read(i)`` is one memcpy out of the page
    cache with the GIL released, ``prefetch(i)`` madvises a sample."""

    def __init__(self, path: str, sample_size: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native core unavailable")
        self._lib = lib
        self._h = lib.nns_reader_open(path.encode(), sample_size)
        if not self._h:
            raise OSError(f"cannot map {path!r} (empty or unreadable)")
        self.sample_size = sample_size
        self.total = int(lib.nns_reader_total(self._h))

    def read(self, index: int):
        """-> uint8 numpy array holding sample `index`."""
        import numpy as np

        # a negative int would wrap to 2^64-1 through ctypes: refuse here
        if not 0 <= int(index) < self.total:
            raise IndexError(f"sample {index} out of range (total {self.total})")
        out = np.empty(self.sample_size, np.uint8)
        if self._lib.nns_reader_read(self._h, int(index),
                                     out.ctypes.data_as(ctypes.c_void_p)) != 0:
            raise IndexError(f"sample {index} out of range (total {self.total})")
        return out

    def prefetch(self, index: int) -> None:
        if self._h and 0 <= index < self.total:
            self._lib.nns_reader_prefetch(self._h, int(index))

    def close(self) -> None:
        if self._h:
            self._lib.nns_reader_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover — GC order dependent
        try:
            self.close()
        except Exception:  # allow-silent: GC-order-dependent teardown
            pass
