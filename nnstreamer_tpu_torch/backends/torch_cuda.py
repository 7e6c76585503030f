"""torch-cuda: the filter backend that runs PyTorch models on the GPU.

Port of ``nnstreamer_tpu/backends/jax_xla.py`` (unsharded path).  Model
resolution (the ``model=`` property):

* a name registered in-process via :func:`register_torch_model`;
* any other name with custom prop ``arch:<zoo-name>`` builds a model
  family from ``nnstreamer_tpu_torch.models`` (``model=zoo
  custom=arch:mobilenet_v2,dtype:bfloat16``), initialized from ``seed``.

Placement: the model runs on ``cuda:0`` (``gpu.N`` picks another card)
unless the accelerator wish list says ``cpu``; with no CUDA device and no
cpu wish, ``open`` raises.  A registered module is never moved: the
backend uses it as it is when it already lives on the target device in
eval mode, and a private copy otherwise.  Micro-batches are padded up to
the next power of two by repeating the last row, so the set of batch
shapes the model sees stays small, and outputs are sliced back.  A fused
postprocess (a decoder's device half) runs on the model outputs on the
same device.  Inference runs under ``torch.inference_mode()``, on the
calling thread's current CUDA stream.

Staging (the filter's ingest lane, ``to_device``): on CUDA the lane's
pinned staging buffer is copied on a separate copy stream with
``non_blocking=True`` and ``to_device`` returns once the copy's event has
completed; the compute stream waits on that event before the batch's
first launch, and each staged tensor is recorded on the compute stream so
the caching allocator cannot hand its memory to the next copy while the
model still reads it.  On the CPU ``to_device`` copies off the staging
buffer (a ``torch.from_numpy`` view would alias the pooled buffer).
"""

from __future__ import annotations

import copy
import inspect
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.buffer import materialize
from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec, dtype_to_name
from .base import FilterBackend, register_backend

_registry_lock = threading.Lock()
_model_registry: Dict[str, Tuple[torch.nn.Module, Optional[StreamSpec], Optional[StreamSpec]]] = {}


def register_torch_model(
    name: str,
    module: torch.nn.Module,
    in_spec: Optional[StreamSpec] = None,
    out_spec: Optional[StreamSpec] = None,
) -> None:
    """Register an in-process model under `name`.

    ``module(*inputs)`` takes one batched tensor per input (leading batch
    dim) and returns a tensor or a list/tuple of tensors.  Opening a filter
    never moves or mode-switches the registered module: the backend runs it
    as it is when its parameters and buffers already live on the filter's
    device and it is in eval mode, and runs a private copy otherwise."""
    with _registry_lock:
        _model_registry[name] = (module, in_spec, out_spec)


def unregister_torch_model(name: str) -> bool:
    with _registry_lock:
        return _model_registry.pop(name, None) is not None


def pick_device(wishes: List[str]) -> torch.device:
    """The first satisfiable accelerator wish: ``cpu``, or a CUDA card for
    ``auto``/``default``/``gpu``/``gpu.N``.  Raises when none is."""
    for wish in wishes:
        kind, _, ordinal = wish.lower().partition(".")
        if kind == "cpu":
            return torch.device("cpu")
        if kind in ("auto", "default", "gpu", "cuda") and torch.cuda.is_available():
            index = int(ordinal) if ordinal.isdigit() else 0
            if index >= torch.cuda.device_count():
                raise RuntimeError(f"accelerator {wish!r}: no CUDA device {index}")
            return torch.device("cuda", index)
    raise RuntimeError(
        f"torch-cuda: no CUDA device for accelerator wishes {wishes} "
        "(pass accelerator=cpu to run on the CPU)")


def _placed(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``module`` when it already lives on `device` in eval mode, else a
    private copy placed there in eval mode (the original stays as it is)."""
    tensors = itertools.chain(module.parameters(), module.buffers())
    if not any(m.training for m in module.modules()) and all(
            t.device == device for t in tensors):
        return module
    return copy.deepcopy(module).to(device).eval()


#: attribute that :meth:`TorchCuda.to_device` sets on each staged CUDA
#: tensor: the copy stream's event the compute stream must wait on
_COPY_EVENT = "_nns_copy_event"


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _normalize_out(out) -> List[Any]:
    return list(out) if isinstance(out, (list, tuple)) else [out]


class TorchCuda(FilterBackend):
    NAME = "torch-cuda"
    SUPPORTS_STAGING = True  # to_device copies off the staging buffer, on both placements

    def __init__(self):
        super().__init__()
        self._module: Optional[torch.nn.Module] = None
        self._device: Optional[torch.device] = None
        self._copy_stream = None  # the ingest lane's host-to-device stream (CUDA)
        self._in_spec: Optional[StreamSpec] = None
        self._out_spec: Optional[StreamSpec] = None
        self._declared_out: Optional[StreamSpec] = None  # the model's own, before any post
        # fused postprocesses: (fn, whether it takes a ``device`` keyword)
        self._posts: List[Tuple[Callable[..., Any], bool]] = []

    @property
    def device(self) -> Optional[torch.device]:
        return self._device

    # -- model loading ------------------------------------------------------
    def _resolve_model(self, model_path: Optional[str]):
        if not model_path:
            raise ValueError("torch-cuda requires model= (registry key or zoo)")
        with _registry_lock:
            entry = _model_registry.get(model_path)
        if entry is not None:
            return entry + (True,)
        arch = self.custom_props.get("arch")
        if arch:
            from .. import models as zoo

            return zoo.build(arch, self.custom_props) + (False,)
        raise FileNotFoundError(
            f"torch-cuda cannot resolve model {model_path!r} "
            "(not registered; for the zoo pass custom=arch:<zoo-name>)")

    def open(self, model_path, props):
        super().open(model_path, props)
        module, self._in_spec, self._out_spec, registered = self._resolve_model(model_path)
        self._declared_out = self._out_spec
        self._device = pick_device(props.get("accelerators") or ["auto"])
        # a registered module is shared with its registrant and other
        # filters; a zoo build is this backend's own
        self._module = (_placed(module, self._device) if registered
                        else module.to(self._device).eval())
        self._posts = []
        self._copy_stream = (torch.cuda.Stream(self._device)
                             if self._device.type == "cuda" else None)

    def close(self):
        self._module = None
        self._posts = []
        self._copy_stream = None

    def get_model_info(self):
        return self._in_spec, self._out_spec

    # -- device-fused postprocess -------------------------------------------
    def append_postprocess(self, fn: Callable[[List[Any]], List[Any]]) -> None:
        """Run ``fn`` on the model outputs, on this backend's device, inside
        every invoke: only its (usually tiny) result leaves the card.  A
        postprocess that takes a ``device`` keyword gets this backend's
        device."""
        try:
            takes_device = "device" in inspect.signature(fn).parameters
        except (TypeError, ValueError):
            takes_device = False
        self._posts.append((fn, takes_device))

    def _run_posts(self, outs: List[Any], device: torch.device) -> List[Any]:
        for fn, takes_device in self._posts:
            outs = _normalize_out(fn(outs, device=device) if takes_device else fn(outs))
        return outs

    def set_input_info(self, in_spec: StreamSpec) -> StreamSpec:
        """Output schema of one frame.  With a declared model output (the
        zoo's), one zero row of it goes through the fused postprocesses on
        the host, where the ops run their plain versions: no model call and
        no kernel launch, as the JAX backend's ``eval_shape`` runs nothing.
        Without one, a batch of one zero frame runs through the model and
        its postprocesses on the device."""
        if not in_spec.is_static:
            raise ValueError("torch-cuda needs a static input schema")
        declared = self._declared_out
        if declared is not None and declared.is_static:
            rows = [torch.zeros((1,) + t.shape, dtype=getattr(torch, dtype_to_name(t.dtype)))
                    for t in declared.tensors]
            with torch.inference_mode():
                outs = self._run_posts(rows, torch.device("cpu"))
        else:
            outs = self.invoke_batch([np.zeros((1,) + t.shape, t.dtype) for t in in_spec.tensors])
        host = materialize(outs)
        spec = StreamSpec(
            tuple(TensorSpec(tuple(o.shape[1:]), o.dtype) for o in host),
            FORMAT_STATIC, in_spec.framerate)
        self._out_spec = spec
        return spec

    # -- staging (the filter's ingest lane) ---------------------------------
    def staging_placement(self):
        return ("dev", self._device.type, self._device.index)

    def to_device(self, arrays: List[Any]) -> List[Any]:
        """Copy host-staged arrays to this backend's device; runs on the
        lane thread and returns once the copies are complete (the lane
        reuses the buffers right after).  On CUDA the copies run on the
        copy stream, and each returned tensor carries the copy's event for
        :meth:`invoke_batch`."""
        dev = self._device
        if dev.type != "cuda":
            # a private copy: from_numpy alone would alias the pooled buffer
            return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]
        with torch.cuda.device(dev), torch.cuda.stream(self._copy_stream):
            # the pool's buffers are views of pinned tensors: true async copies
            xs = [torch.from_numpy(np.asarray(a)).to(dev, non_blocking=True) for a in arrays]
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        done.synchronize()
        for x in xs:
            setattr(x, _COPY_EVENT, done)
        return xs

    # -- execution ----------------------------------------------------------
    def _put(self, a: Any) -> torch.Tensor:
        event = getattr(a, _COPY_EVENT, None)
        if event is not None:
            # a tensor staged on the copy stream: order the compute stream
            # after its copy, and keep the allocator from reusing its memory
            # until the compute stream is done with it
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            a.record_stream(stream)
            return a
        return torch.as_tensor(a).to(self._device)

    @staticmethod
    def _pad_rows(t: torch.Tensor, bucket: int) -> torch.Tensor:
        """Pad dim 0 to `bucket` rows by repeating the last row."""
        n = int(t.shape[0])
        if bucket == n:
            return t
        return torch.cat([t, t[-1:].expand((bucket - n,) + tuple(t.shape[1:]))])

    def invoke(self, inputs: List[Any]) -> List[Any]:
        return [o[0] for o in self.invoke_batch([self._put(a)[None] for a in inputs])]

    def invoke_batch(self, inputs: List[Any]) -> List[Any]:
        """One model call for the whole micro-batch; outputs stay on the
        device, sliced back to the batch's true size."""
        n = int(inputs[0].shape[0])
        bucket = _next_pow2(n)
        xs = [self._pad_rows(self._put(a), bucket) for a in inputs]
        with torch.inference_mode():
            outs = self._run_posts(_normalize_out(self._module(*xs)), self._device)
        return [o[:n] for o in outs] if bucket != n else outs


register_backend(TorchCuda)
