"""torch-cuda: the filter backend that runs PyTorch models on the GPU.

Port of ``nnstreamer_tpu/backends/jax_xla.py`` (unsharded path).  Model
resolution (the ``model=`` property, after the filter resolved
``file://`` and ``model://`` URIs), in the JAX backend's order:

* a name registered in-process via :func:`register_torch_model`;
* a ``.py`` file whose ``get_model()`` returns ``(module[, in_spec,
  out_spec])``;
* a ``.pt2`` file: a ``torch.export`` program (:func:`export_model`,
  ``nns-tpu-torch-convert``), the port's counterpart of the JAX backend's
  ``.jaxexport`` (:class:`ExportedModule`);
* with custom prop ``arch:<zoo-name>``, a model family from
  ``nnstreamer_tpu_torch.models`` (``model=zoo
  custom=arch:mobilenet_v2,dtype:bfloat16``) initialized from ``seed``,
  its weights then loaded from ``model`` when that is a file: a
  ``torch.save``d ``state_dict`` (the counterpart of the JAX backend's
  flax msgpack file, and what ``tensor_trainer model-save-path=`` writes),
  or from the newest marker-committed step when it is a directory that
  ``tensor_trainer checkpoint-path=`` writes (``core/checkpoint.py``; the
  counterpart of the JAX backend's orbax directory), so a pipeline serves
  what a co-hosted trainer wrote.  A directory without a committed step
  raises and says whether it is empty.

A ``jax.export`` artifact (``.jaxexport``, ``.stablehlo``: a StableHLO
module, which torch cannot load) raises naming the ``.pt2`` route; a step
that the JAX package wrote with orbax raises saying so.

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

Device errors: every model call runs inside ``core.resilience.device_call``
(the ``device.oom`` / ``device.lost`` fault sites, and torch's
``OutOfMemoryError`` and sticky CUDA errors typed as ``DeviceOomError`` /
``DeviceLostError``); the copies run inside it with ``inject=False``.
``trim_caches`` releases the caching allocator's free segments and returns
how many CUDA got back (their bytes add to ``trimmed_bytes``).  The backend is unsharded, so ``remesh_spec_after_loss``
is ``None`` (a loss re-raises into supervision) and
``dead_ordinals_after_loss`` probes its own card; the filter passes the
dead ordinals back as ``exclude_ordinals`` and ``pick_device`` skips them.
"""

from __future__ import annotations

import copy
import importlib.util
import inspect
import itertools
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.buffer import materialize
from ..core.resilience import DeviceLostError, device_call
from ..core.types import (FORMAT_STATIC, StreamSpec, TensorSpec, dtype_from_name,
                          dtype_to_name)
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


def pick_device(wishes: List[str], exclude=()) -> torch.device:
    """The first satisfiable accelerator wish: ``cpu``, or a CUDA card for
    ``auto``/``default``/``gpu``/``gpu.N``.  Raises when none is.  Cards
    in ``exclude`` (ordinals lost earlier) are never picked: a bare
    ``gpu`` takes the first card left, ``gpu.N`` of a lost card raises."""
    dead = {int(i) for i in exclude}
    for wish in wishes:
        kind, _, ordinal = wish.lower().partition(".")
        if kind == "cpu":
            return torch.device("cpu")
        if kind in ("auto", "default", "gpu", "cuda") and torch.cuda.is_available():
            count = torch.cuda.device_count()
            if ordinal.isdigit():
                index = int(ordinal)
                if index >= count:
                    raise RuntimeError(f"accelerator {wish!r}: no CUDA device {index}")
                if index in dead:
                    raise DeviceLostError(f"accelerator {wish!r}: CUDA device {index} was lost",
                                          device_ids=(index,))
                return torch.device("cuda", index)
            alive = [i for i in range(count) if i not in dead]
            if not alive:
                raise DeviceLostError(f"accelerator {wish!r}: every CUDA device was lost",
                                      device_ids=tuple(sorted(dead)))
            return torch.device("cuda", alive[0])
    raise RuntimeError(
        f"torch-cuda: no CUDA device for accelerator wishes {wishes} "
        "(pass accelerator=cpu to run on the CPU)")


def _checkpoint_weights(path: str) -> Dict[str, torch.Tensor]:
    """The model weights of the newest marker-committed step under a
    trainer's ``checkpoint-path``; raises where there is none."""
    from ..core import checkpoint as ckpt

    step = ckpt.latest_step(path)
    if step is None:
        what = ("the directory is empty" if not os.listdir(path)
                else "no step_<N> directory has its step_<N>.ok marker")
        raise FileNotFoundError(f"torch-cuda: {path}: no committed checkpoint step ({what})")
    return ckpt.restore_state(path, step)["params"]


def _placed(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``module`` when it already lives on `device` in eval mode, else a
    private copy placed there in eval mode (the original stays as it is)."""
    tensors = itertools.chain(module.parameters(), module.buffers())
    if not any(m.training for m in module.modules()) and all(
            t.device == device for t in tensors):
        return module
    return copy.deepcopy(module).to(device).eval()


#: the JAX package's serialized ``jax.export`` artifact extensions
_EXPORTED_MODEL_EXTS = (".jaxexport", ".stablehlo")
#: the port's serialized ``torch.export`` program
PROGRAM_EXT = ".pt2"


def _module_device(module: torch.nn.Module) -> torch.device:
    t = next(itertools.chain(module.parameters(), module.buffers()), None)
    return t.device if t is not None else torch.device("cpu")


def export_model(module: torch.nn.Module, frame_specs, path: str,
                 batch_polymorphic: bool = True) -> None:
    """Serialize ``module`` as a ``.pt2`` ``torch.export`` program (weights
    in it), the counterpart of the JAX backend's ``export_model``.

    ``frame_specs``: one ``(shape, dtype)`` pair per input tensor, for a
    SINGLE frame (no batch dim).  With ``batch_polymorphic`` (default) a
    symbolic leading batch dim is prepended, so the program serves both
    per-frame and micro-batched invokes natively; without it the program
    takes the frame shapes only.  The trace runs on fake tensors of the
    module's device in eval mode (the module's mode is restored after):
    the port's kernels are recorded as their ``nns_torch::`` operators,
    which pick the kernel or the plain version when the program runs.  The
    example batch is 2: ``torch.export`` specializes sizes 0 and 1.
    """
    device = _module_device(module)
    lead = (2,) if batch_polymorphic else ()
    example = tuple(torch.zeros(lead + tuple(int(d) for d in shape),
                                dtype=getattr(torch, np.dtype(dtype).name), device=device)
                    for shape, dtype in frame_specs)
    dynamic = None
    if batch_polymorphic:
        batch = torch.export.Dim("batch", min=1)
        dynamic = tuple({0: batch} for _ in example)
        if any(prm.kind is inspect.Parameter.VAR_POSITIONAL
               for prm in inspect.signature(module.forward).parameters.values()):
            dynamic = (dynamic,)  # ``forward(*xs)``: the inputs are one argument
    was_training = module.training
    module.eval()
    try:
        program = torch.export.export(module, example, dynamic_shapes=dynamic, strict=False)
    finally:
        module.train(was_training)
    torch.export.save(program, path)


def _program_device(program) -> torch.device:
    t = next(itertools.chain(program.state_dict.values(), program.constants.values()), None)
    return t.device if isinstance(t, torch.Tensor) else torch.device("cpu")


class ExportedModule(torch.nn.Module):
    """A ``.pt2`` program as the module the backend runs.

    The operators are registered (``nnstreamer_tpu_torch.ops``) before
    ``torch.export.load``; ``.to(device)`` places the program with
    ``torch.export.passes.move_to_device_pass`` (weights, constants and the
    devices named inside the graph, so a program exported on the CPU runs
    on the card) and drops its parameters' ``requires_grad``.  Batch
    handling as the JAX backend's ``_load_exported``: a per-frame call of
    a batch-polymorphic program adds and strips a length-1 axis, and a
    micro-batch against a fixed-shape program runs frame by frame.
    :attr:`in_spec` / :attr:`out_spec` are the per-frame schemas from the
    program's input and output metadata."""

    def __init__(self, path: str):
        super().__init__()
        from .. import ops  # noqa: F401 -- registers the kernels' operators

        program = torch.export.load(path)
        sig = program.graph_signature
        vals = {n.name: n.meta.get("val") for n in program.graph.nodes}
        ins = [vals[name] for name in sig.user_inputs]
        outs = [vals[name] for name in sig.user_outputs]
        self.path = path
        self.in_ranks = [v.dim() for v in ins]
        self.symbolic = any(not isinstance(d, int) for v in ins for d in v.shape)
        self.in_spec = self._frame_spec(ins)
        self.out_spec = self._frame_spec(outs)
        self.__dict__["_program"] = program  # not a submodule: eval()/to() are this class's
        self._place(_program_device(program))

    def _frame_spec(self, vals) -> Optional[StreamSpec]:
        tensors = []
        for v in vals:
            if not isinstance(v, torch.Tensor):
                return None
            shape = tuple(v.shape[1:]) if self.symbolic else tuple(v.shape)
            if any(not isinstance(d, int) for d in shape):
                return None
            tensors.append(TensorSpec(tuple(int(d) for d in shape),
                                      dtype_from_name(str(v.dtype).removeprefix("torch."))))
        return StreamSpec(tuple(tensors), FORMAT_STATIC)

    def _place(self, device: torch.device) -> None:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(self.__dict__["_program"], device)
        self.__dict__["_program"] = program
        gm = program.module()
        for p in gm.parameters():
            p.requires_grad_(False)
        self.__dict__["_gm"] = gm
        self.device = device

    def to(self, *args, **kwargs):
        device, dtype, _, _ = torch._C._nn._parse_to(*args, **kwargs)
        if dtype is not None:
            raise TypeError(f"{self.path}: an exported program keeps its own dtypes")
        if device is not None and torch.device(device) != self.device:
            self._place(torch.device(device))
        return self

    def train(self, mode: bool = True):
        self.training = mode  # the program is traced in eval mode: nothing to switch
        return self

    def forward(self, *xs):
        gm = self.__dict__["_gm"]
        ranks = self.in_ranks
        if self.symbolic:
            if all(x.dim() == r - 1 for x, r in zip(xs, ranks)):
                return [o[0] for o in _normalize_out(gm(*[x[None] for x in xs]))]
            return _normalize_out(gm(*xs))
        if all(x.dim() == r + 1 for x, r in zip(xs, ranks)):
            frames = [_normalize_out(gm(*[x[b] for x in xs])) for b in range(int(xs[0].shape[0]))]
            return [torch.stack(parts) for parts in zip(*frames)]
        return _normalize_out(gm(*xs))


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
        if model_path.lower().endswith(PROGRAM_EXT):
            module = ExportedModule(model_path)
            return module, module.in_spec, module.out_spec, False
        if model_path.endswith(_EXPORTED_MODEL_EXTS):
            raise NotImplementedError(
                f"torch-cuda: {model_path}: a jax.export artifact is a StableHLO module, which "
                "torch cannot load; convert the source model to a torch.export program (.pt2) "
                "with nns-tpu-torch-convert, or save a module with "
                "backends.torch_cuda.export_model")
        if model_path.endswith(".py") and os.path.isfile(model_path):
            spec = importlib.util.spec_from_file_location(
                f"_nns_torch_model_{abs(hash(model_path))}", model_path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if not hasattr(mod, "get_model"):
                raise ValueError(f"{model_path}: must define get_model()")
            got = mod.get_model()
            got = tuple(got) if isinstance(got, (list, tuple)) else (got,)
            return got[:3] + (None,) * (3 - len(got[:3])) + (False,)
        arch = self.custom_props.get("arch")
        if arch:
            from .. import models as zoo

            module, in_spec, out_spec = zoo.build(arch, self.custom_props)
            if os.path.isdir(model_path):
                module.load_state_dict(_checkpoint_weights(model_path), strict=True)
            elif os.path.isfile(model_path):  # a torch.save'd state_dict of the zoo build
                state = torch.load(model_path, map_location="cpu", weights_only=True)
                module.load_state_dict(state, strict=True)
            return module, in_spec, out_spec, False
        raise FileNotFoundError(
            f"torch-cuda cannot resolve model {model_path!r} (not registered; for files pass "
            "custom=arch:<zoo-name>)")

    def open(self, model_path, props):
        super().open(model_path, props)
        module, self._in_spec, self._out_spec, registered = self._resolve_model(model_path)
        self._declared_out = self._out_spec
        wishes = props.get("accelerators") or ["auto"]
        exclude = props.get("exclude_ordinals") or ()
        self._device = pick_device(wishes, exclude=exclude) if exclude else pick_device(wishes)
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

    def reload(self, model_path):
        """Inline model reload in place: the new model is resolved and
        placed on this backend's card before the old one is dropped, so a
        failed load leaves the old model serving.  The card (and with it
        the element's accelerator and dead ordinals), the copy stream and
        the fused device halves stay; the schema of a fused output stays
        the one negotiated."""
        module, in_spec, out_spec, registered = self._resolve_model(model_path)
        module = (_placed(module, self._device) if registered
                  else module.to(self._device).eval())
        self.model_path = model_path
        self._module, self._in_spec, self._declared_out = module, in_spec, out_spec
        if not self._posts:
            self._out_spec = out_spec

    # -- device-resource hooks (the filter's OOM and device-loss ladder) ----
    def trim_caches(self) -> int:
        """Release the caching allocator's free segments on this
        backend's card (``torch.cuda.empty_cache``); returns the segments
        that CUDA got back and adds their reserved bytes to
        :attr:`trimmed_bytes`.  The padded batch buckets keep no scratch of
        their own.  On the CPU there is nothing to release."""
        dev = self._device
        if dev is None or dev.type != "cuda":
            return 0

        def held():
            stats = torch.cuda.memory_stats(dev)
            return stats.get("segment.all.current", 0), stats.get("reserved_bytes.all.current", 0)

        with torch.cuda.device(dev):
            segs, before = held()
            torch.cuda.empty_cache()
            segs_after, after = held()
        self.trimmed_bytes += max(0, before - after)
        return max(0, segs - segs_after)

    def dead_ordinals_after_loss(self, lost_ids):
        """Reported ordinals win; otherwise probe this backend's own card
        (a synchronize raises once its context is lost): dead -> its
        ordinal, alive -> ``()`` (a spurious or injected loss condemns
        nobody and the restart re-picks the card)."""
        ids = tuple(int(i) for i in (lost_ids or ()))
        dev = self._device
        if ids or dev is None or dev.type != "cuda":
            return ids
        try:
            torch.cuda.synchronize(dev)
        except Exception:  # noqa: BLE001 — the probe's answer is "dead"
            return (int(dev.index),)
        return ()

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
        return device_call(self._to_device_raw, arrays, inject=False)

    def _to_device_raw(self, arrays: List[Any]) -> List[Any]:
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
        return [o[0] for o in self.invoke_batch([a[None] for a in inputs])]

    def invoke_batch(self, inputs: List[Any]) -> List[Any]:
        """One model call for the whole micro-batch; outputs stay on the
        device, sliced back to the batch's true size.  Runs inside
        ``device_call``: the fault sites fire here, and a real OOM or
        sticky CUDA error surfaces typed."""
        return device_call(self._invoke_batch_raw, inputs)

    def _invoke_batch_raw(self, inputs: List[Any]) -> List[Any]:
        n = int(inputs[0].shape[0])
        bucket = _next_pow2(n)
        xs = [self._pad_rows(self._put(a), bucket) for a in inputs]
        with torch.inference_mode():
            outs = self._run_posts(_normalize_out(self._module(*xs)), self._device)
        return [o[:n] for o in outs] if bucket != n else outs


register_backend(TorchCuda)
