"""Deterministic fake backends for tests, on the host.

Port of ``nnstreamer_tpu/backends/fakes.py``: ``passthrough``, ``scaler``,
``average`` and ``framecounter`` (element behaviour without a model, as in
the reference's custom-filter examples), and ``async-sim`` with its
``FakeDeviceArray``, so the dispatch window's and the ingest lane's
threading contracts (FIFO completion, where the blocking waits happen,
buffer reuse) and the filter's OOM and device-loss ladder (through the
``device.oom``/``device.lost`` fault sites) can be pinned without a card.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, List, Optional

import numpy as np

from ..core.resilience import FAULTS
from ..core.types import StreamSpec, TensorSpec
from .base import FilterBackend, register_backend


class Passthrough(FilterBackend):
    """Identity model."""

    NAME = "passthrough"

    def set_input_info(self, in_spec: StreamSpec) -> StreamSpec:
        return in_spec

    def invoke(self, inputs: List[Any]) -> List[Any]:
        return list(inputs)

    def invoke_batch(self, inputs: List[Any]) -> List[Any]:
        return list(inputs)


class Scaler(FilterBackend):
    """Multiply by a constant from custom props ("factor:2")."""

    NAME = "scaler"

    @property
    def factor(self) -> float:
        return float(self.custom_props.get("factor", "2"))

    def set_input_info(self, in_spec: StreamSpec) -> StreamSpec:
        return in_spec

    def invoke(self, inputs: List[Any]) -> List[Any]:
        return [np.asarray(a) * np.asarray(a).dtype.type(self.factor) for a in inputs]

    def invoke_batch(self, inputs: List[Any]) -> List[Any]:
        return self.invoke(inputs)


class Average(FilterBackend):
    """Reduce each tensor to its scalar mean (float32, shape (1,))."""

    NAME = "average"

    def set_input_info(self, in_spec: StreamSpec) -> StreamSpec:
        return StreamSpec(
            tuple(TensorSpec((1,), np.float32, t.name) for t in in_spec.tensors),
            in_spec.fmt, in_spec.framerate)

    def invoke(self, inputs: List[Any]) -> List[Any]:
        return [np.asarray([np.asarray(a).mean()], np.float32) for a in inputs]


class FrameCounter(FilterBackend):
    """Emit a running frame counter (ordering and liveness tests)."""

    NAME = "framecounter"

    def __init__(self):
        super().__init__()
        self._n = 0

    def set_input_info(self, in_spec: StreamSpec) -> StreamSpec:
        return StreamSpec((TensorSpec((1,), np.int64, "count"),), in_spec.fmt,
                          in_spec.framerate)

    def invoke(self, inputs: List[Any]) -> List[Any]:
        self._n += 1
        return [np.asarray([self._n], np.int64)]


class FakeDeviceArray:
    """A numpy value posing as an output still being computed on a device.

    It follows the port's asynchronous-copy protocol
    (``core.buffer.start_host_copies``): ``copy_to_host_async`` is a
    prefetch hint, and ``__array__`` (materialization) blocks until the
    simulated device completed the batch and then pays the transfer cost
    ON THE CALLING THREAD.  Every wait that happens before completion is
    recorded with the calling thread's name, so a test can pin "the
    dispatch thread never waited on the device" structurally."""

    __slots__ = ("_value", "_done", "_transfer_s", "_sim", "_host")

    def __init__(self, value: np.ndarray, done: threading.Event, transfer_s: float,
                 sim: "AsyncSim"):
        self._value = value
        self._done = done
        self._transfer_s = transfer_s
        self._sim = sim
        self._host: Optional[np.ndarray] = None  # transfer paid once

    @property
    def shape(self):
        return self._value.shape

    @property
    def dtype(self):
        return self._value.dtype

    def is_ready(self) -> bool:
        return self._done.is_set()

    def copy_to_host_async(self) -> None:
        """A prefetch hint only: nothing overlaps."""

    def _materialize(self) -> np.ndarray:
        if self._host is None:
            if not self.is_ready():
                self._sim.blocking_syncs.append(threading.current_thread().name)
                self._done.wait()
            if self._transfer_s > 0:
                time.sleep(self._transfer_s)  # the transfer occupies the caller
            self._host = self._value
        return self._host

    def __array__(self, dtype=None, copy=None):
        host = self._materialize()
        return host if dtype is None else host.astype(dtype, copy=False)

    def __getitem__(self, idx):
        return self._materialize()[idx]

    def __len__(self) -> int:
        return len(self._value)


class AsyncSim(FilterBackend):
    """Deterministic asynchronous-device simulator: affine ``y = 2x + 1``
    served by one simulated device worker (one batch in service at a time).

    Custom props (milliseconds unless noted):

    * ``compute_ms``  — device service time per batch.
    * ``transfer_ms`` — device-to-host materialization cost, paid on the
      thread that waits.
    * ``manual``      — "1": batches complete only via :meth:`release_one`
      / :meth:`release_all` (deterministic window tests).

    ``invoke_batch`` carries the ``device.oom``/``device.lost`` fault
    sites where the torch-cuda backend has them.

    ``blocking_syncs`` lists the thread of every wait that happened before
    its batch completed; ``to_device`` copies off the staging buffer, as a
    real placement does."""

    NAME = "async-sim"
    SUPPORTS_STAGING = True

    def __init__(self):
        super().__init__()
        self._pending: "deque[threading.Event]" = deque()
        self._cv = threading.Condition()
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        self.blocking_syncs: List[str] = []

    def _ms(self, key: str) -> float:
        return float(self.custom_props.get(key, 0.0)) / 1000.0

    @property
    def manual(self) -> bool:
        return self.custom_props.get("manual", "") in ("1", "true")

    def set_input_info(self, in_spec: StreamSpec) -> StreamSpec:
        return in_spec

    # -- the simulated device ------------------------------------------------
    def _ensure_server(self) -> None:
        if self.manual or (self._worker is not None and self._worker.is_alive()):
            return
        self._closed = False
        self._worker = threading.Thread(target=self._serve, name="async-sim-device",
                                        daemon=True)
        self._worker.start()

    def _serve(self) -> None:
        service = self._ms("compute_ms")
        while True:
            with self._cv:
                while not self._pending:
                    if self._closed:
                        return
                    self._cv.wait()
                ev = self._pending.popleft()
            if service > 0:
                time.sleep(service)  # one batch in service at a time
            ev.set()

    def release_one(self) -> bool:
        """manual mode: complete the oldest batch in service."""
        with self._cv:
            if not self._pending:
                return False
            self._pending.popleft().set()
            return True

    def release_all(self) -> int:
        n = 0
        with self._cv:
            while self._pending:
                self._pending.popleft().set()
                n += 1
        return n

    def close(self):
        with self._cv:
            self._closed = True
            for ev in self._pending:
                ev.set()  # never strand a parked batch at teardown
            self._pending.clear()
            self._cv.notify_all()
            worker, self._worker = self._worker, None
        if worker is not None and worker.is_alive():
            worker.join(timeout=2.0)

    # -- execution -------------------------------------------------------------
    def to_device(self, arrays: List[Any]) -> List[Any]:
        return [np.array(a, copy=True) for a in arrays]

    def invoke(self, inputs: List[Any]) -> List[Any]:
        return [np.asarray(a) * 2 + 1 for a in inputs]

    def invoke_batch(self, inputs: List[Any]) -> List[Any]:
        if FAULTS.is_armed():
            FAULTS.check("device.oom")
            FAULTS.check("device.lost")
        done = threading.Event()
        outs = [FakeDeviceArray(np.asarray(a) * 2 + 1, done, self._ms("transfer_ms"), self)
                for a in inputs]
        self._ensure_server()
        with self._cv:
            self._pending.append(done)
            self._cv.notify_all()
        return outs


for _cls in (Passthrough, Scaler, Average, FrameCounter, AsyncSim):
    register_backend(_cls)
