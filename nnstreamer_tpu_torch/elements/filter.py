"""tensor_filter: run a model on every frame or micro-batch of a stream.

Port of ``nnstreamer_tpu/elements/filter.py`` for the serving path: the
backend is resolved from ``framework=`` at ``start()`` and opened with the
element's properties.  ``framework=auto`` picks it from the model file's
extension after ``model://`` resolution (``detect_framework``), and
restarts and hot swaps keep the framework resolved at start.  The
property's default is ``torch-cuda``, where the JAX filter's is ``auto``:
every port pipeline names no framework and means the card.
``max-batch`` > 1 makes the scheduler hand micro-batches
(``handle_frame_batch``) that run as one ``invoke_batch``; a decoder's
device half can be folded into the backend (``fuse_device_postprocess``),
after which the filter emits each micro-batch as ONE device-resident
``BatchFrame`` (batch-through).

The asynchronous device feed (``core/feed.py``) keeps the dispatch thread
out of device I/O:

* ``ingest-lane`` (auto|on|off): host frames are stacked into pooled
  (pinned, on CUDA) staging buffers and copied to the device on a lane
  thread, one batch ahead: batch k is dispatched when k+1 is submitted.
* ``dispatch-depth`` N > 1: up to N micro-batches stay in flight; each
  one's device-to-host copy is queued at dispatch time and a reaper
  thread waits for it, while this thread stacks and dispatches the next.

Both keep FIFO order: every boundary (EOS, the scheduler's idle hook, any
event) dispatches the staged batch and drains the window first.  ``Flush``
discards both.

Device-resource resilience (degrade, don't die): every backend call goes
through the OOM and device-loss ladder.  A ``DeviceOomError`` trims what
can be recreated (the backend's allocator cache, the staging pools) and
retries once, a micro-batch as two halves that land in a strictly smaller
padded bucket, concatenated back on the card in order; a second OOM
surfaces to supervision.  A ``DeviceLostError`` on an unsharded backend
records the ordinals a probe finds dead and re-raises into supervision,
whose restart re-picks the card.  No rung moves work off the card or to a
plain version of a kernel.

Hot swap (``is-updatable``, ``core/lifecycle.py``): ``request_reload``
stages the new model on a second backend off the hot path (open, schema
check, warm-up on its own CUDA stream), swaps at a drained frame boundary,
serves errors inside the observation window with the retained old backend
and rolls back on a burst.  Restarts and swaps re-apply the decoder's
fused device half to every new backend.  The ingest lane is refused under
``error-policy=skip|restart`` and ``stall-policy=restart``: its one-batch
deferral would charge a failure to the wrong frames.

Model I/O (the JAX filter's properties): ``input-combination`` picks and
orders the tensors handed to the model, ``output-combination`` composes
each output frame from ``iN`` (the frame's own input tensors, as the
filter received them, never a staging buffer) and ``oN`` (model outputs);
manual model info (``input``/``input-type``/``inputname``/``inputranks``,
the output side, ``inputlayout``/``outputlayout``) declares or checks
the model's schemas; ``invoke-dynamic`` advertises a flexible output
stream and is per-frame; ``config-file`` applies a key=value file.
``batch-through`` with ``output-combination`` is refused, and the fusion
pass skips a filter with ``output-combination`` or ``invoke-dynamic``.

Telemetry: ``latency``/``throughput``/``latency-report`` measure the
host's wall time around the backend call (on the card, with the dispatch
window, that is launch time, not model time); ``metrics_info`` and
``histograms_info`` feed the metrics registry (invokes, the dispatch
window and the ingest lane); ``trace=1`` holds the process's
``torch.profiler`` session (``core/profiler.py``) from ``start()`` to
``stop()``, whose last holder writes a Chrome trace into ``trace-dir``.
``mesh`` (a serving mesh) is not ported: set, it raises naming ROADMAP
A11.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..backends import find_backend, parse_accelerator
from ..backends.base import FilterBackend
from ..core import config as nns_config
from ..core import registry
from ..core.buffer import (
    BatchFrame,
    Flush,
    TensorFrame,
    _is_torch,
    concat_tensors,
    materialize,
    start_host_copies,
)
from ..core.feed import CompletionWindow, HostStagingLane, StagedBatch
from ..core.lifecycle import HotSwapCoordinator, SwapTicket
from ..core.liveness import thread_census
from ..core.model_uri import resolve_model_uri
from ..core.profiler import trace_start, trace_stop
from ..core.resilience import FAULTS, DeviceLostError, DeviceOomError
from ..core.telemetry import TL_INVOKE_META, TL_RX_META
from ..core.types import (
    ANY,
    FORMAT_FLEXIBLE,
    FORMAT_STATIC,
    StreamSpec,
    TensorSpec,
    dtype_from_name,
    parse_dims_string,
)
from ..pipeline.element import ElementError, Property, TransformElement, element


# shared model table: filters with the same shared-tensor-filter-key share
# one backend instance
_shared_lock = threading.Lock()
_shared_table: Dict[str, Tuple[FilterBackend, int]] = {}


def _shared_acquire(key: str, factory) -> FilterBackend:
    with _shared_lock:
        if key in _shared_table:
            be, refs = _shared_table[key]
            _shared_table[key] = (be, refs + 1)
            return be
        be = factory()
        _shared_table[key] = (be, 1)
        return be


def _shared_release(key: str) -> bool:
    """True when the caller holds the last reference and closes it."""
    with _shared_lock:
        if key not in _shared_table:
            return True
        be, refs = _shared_table[key]
        if refs <= 1:
            del _shared_table[key]
            return True
        _shared_table[key] = (be, refs - 1)
        return False


def _concat(pieces: List[Any]):
    """Concatenate batch pieces on axis 0 (torch when any piece is)."""
    return pieces[0] if len(pieces) == 1 else concat_tensors(pieces, 0)


def _parse_combination(text: str) -> Optional[List[Tuple[str, int]]]:
    """Parse "0,2" / "i0,o1" combination strings into (src, idx) pairs;
    a bare index is tagged "" (the input side for input-combination, the
    output side for output-combination)."""
    if not text:
        return None
    out = []
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if part[0] in ("i", "o"):
            out.append((part[0], int(part[1:])))
        else:
            out.append(("", int(part)))
    return out or None


def _batched_tensors(frames: Sequence[TensorFrame],
                     select: Optional[List[int]] = None) -> List[Any]:
    """ONE batched tensor list for a mixed plain/BatchFrame list: plain
    frames gain a length-1 batch axis, blocks pass through.  ``select``
    narrows to the given tensor indices (input-combination)."""
    pieces = []
    for f in frames:
        tens = [f.tensors[i] for i in select] if select is not None else list(f.tensors)
        pieces.append(tens if isinstance(f, BatchFrame) else [t[None] for t in tens])
    return [_concat([p[t] for p in pieces]) for t in range(len(pieces[0]))]


def _logical_infos(frames: Sequence[TensorFrame]) -> List[Tuple[Any, Any, Dict[str, Any]]]:
    """(pts, duration, meta) per LOGICAL frame, in stream order."""
    infos = []
    for f in frames:
        if isinstance(f, BatchFrame):
            infos.extend(f.frames_info)
        else:
            infos.append((f.pts, f.duration, f.meta))
    return infos


def detect_framework(model_path: str, custom: str = "") -> str:
    """``framework=auto``: the first registered backend of the model
    extension's priority list (``core.config.framework_priority``).

    Port of the JAX ``detect_framework`` (reference:
    ``_detect_framework_from_config``, tensor_filter_common.c:1171), with
    ``torch-cuda`` in the place of ``jax-xla``: it wins a file only when the
    pipeline supplies ``custom=arch:<zoo-family>`` (it loads a ``.pt`` as
    that family's state_dict, and cannot load a bare file), so a TorchScript
    ``.pt`` goes to ``torch`` and ``.tflite``/``.onnx`` to the importers;
    a ``.pt2`` (a ``torch.export`` program) it loads bare."""
    ext = os.path.splitext(model_path)[1]
    has_arch = any(part.partition(":")[0].strip() == "arch"
                   for part in str(custom or "").split(",") if ":" in part)
    for cand in nns_config.framework_priority(ext):
        if not registry.exists(registry.KIND_FILTER, cand):
            continue
        if cand == "torch-cuda" and ext not in ("", ".py", ".pt2") and not has_arch:
            continue
        return cand
    raise ElementError(f"cannot auto-detect a backend for model {model_path!r} (ext {ext!r})")


@element("tensor_filter")
class TensorFilter(TransformElement):
    BATCH_AWARE = True  # consumes the batch axis (micro-batching)

    PROPERTIES = {
        "framework": Property(
            str, "torch-cuda", "backend name, or auto (from the model file's extension: "
            "core.config.framework_priority)"),
        "model": Property(str, "", "registry key, .py file, file://, model://<name>[/<version>], "
                          "or with custom=arch:<zoo-name> a zoo name or state_dict file"),
        "custom": Property(str, "", "backend-specific options 'k1:v1,k2:v2'"),
        "accelerator": Property(
            str, "", "ordered wish list 'true:gpu.N,cpu' or 'cpu' (empty = cuda:0)"),
        "max-batch": Property(int, 1, "micro-batch up to N queued frames into one invoke"),
        "batch-timeout": Property(
            int, 0, "ms to wait filling a micro-batch (0 = only drain queued)"),
        "dispatch-depth": Property(
            int, 4,
            "micro-batches kept in flight in the completion-driven dispatch "
            "window (a reaper thread waits for each batch's device-to-host "
            "copy; the dispatch thread keeps stacking and dispatching; "
            "1 = synchronous)"),
        "ingest-lane": Property(
            str, "auto",
            "auto|on|off — double-buffered host-to-device staging: host frames "
            "are stacked into pooled (pinned) staging buffers and copied to the "
            "device from a lane thread, one batch ahead, so the copy overlaps "
            "the previous batch's compute (auto = on when the backend supports "
            "staged placement and max-batch>1)"),
        "batch-through": Property(
            bool, False,
            "emit micro-batches as ONE BatchFrame (device-resident) instead of "
            "per-frame outputs (set automatically by the device-fusion pass)"),
        "is-updatable": Property(bool, False, "allow hot model reload"),
        "staged-reload": Property(
            bool, True,
            "hot reloads stage, validate and warm the new model on a second backend and "
            "swap at a frame boundary (false = the backend's inline reload, still "
            "guarded: a failed reload keeps the old model serving)"),
        "observation-window": Property(
            float, 5.0,
            "seconds after a hot swap during which invoke errors are served by the "
            "retained old model and an error burst rolls the swap back"),
        "rollback-error-burst": Property(
            int, 3, "invoke errors within observation-window that roll a hot swap back"),
        "shared-tensor-filter-key": Property(str, "", "share one backend instance"),
        # not ported: set, it raises at start() naming the ROADMAP item
        "mesh": Property(str, "", "serve the model sharded across a device mesh (not ported: "
                         "ROADMAP A11)"),
        "input-combination": Property(str, "", "subset/reorder input tensors, e.g. '0,2'"),
        "output-combination": Property(str, "", "compose output from 'iN'/'oN' tensors"),
        "latency": Property(int, 0, "1 = enable per-invoke latency measurement"),
        "throughput": Property(int, 0, "1 = enable throughput measurement"),
        "latency-report": Property(int, 0, "1 = post latency bus messages"),
        "invoke-dynamic": Property(bool, False, "output schema varies per buffer"),
        # manual model-info override: declare or check the I/O schemas
        "input": Property(str, "", "manual input dims 'd:d:d[,d:d]' (reference dialect)"),
        "input-type": Property(str, "", "manual input element types 't[,t]'"),
        "inputname": Property(str, "", "manual input tensor names"),
        "inputranks": Property(str, "", "true ranks of manual input dims"),
        "output": Property(str, "", "manual output dims (validated/declared)"),
        "output-type": Property(str, "", "manual output element types"),
        "outputname": Property(str, "", "manual output tensor names"),
        "outputranks": Property(str, "", "true ranks of manual output dims"),
        "inputlayout": Property(str, "", "NCHW|NHWC|ANY per input (recorded; declarative)"),
        "outputlayout": Property(str, "", "NCHW|NHWC|ANY per output (recorded; declarative)"),
        "config-file": Property(
            str, "", "key=value file applied as properties (explicit pipeline-text "
            "properties win)"),
        "trace": Property(int, 0, "1 = capture a torch.profiler trace while running"),
        "trace-dir": Property(str, "/tmp/nns_tpu_trace", "profiler output dir"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self.backend: Optional[FilterBackend] = None
        self._model_in: Optional[StreamSpec] = None
        self._model_out: Optional[StreamSpec] = None
        # output schemas the backend derived, per input schema (negotiation
        # and the caps event ask for the same one)
        self._derived: Dict[StreamSpec, StreamSpec] = {}
        # set by the pipeline's device-fusion pass for one run
        self._auto_batch_through = False
        self.invokes = 0  # backend calls (one per micro-batch or frame)
        # the depth-N dispatch window (made at start() under the element's
        # final name: its reaper thread is "<name>-reaper")
        self._inflight = CompletionWindow(self.name)
        # the ingest lane and the one-batch deferral that double-buffers it
        self._lane: Optional[HostStagingLane] = None
        self._staged: Optional[Tuple[StagedBatch, List[TensorFrame]]] = None
        # do the backend's outputs support the async copy? latched per backend
        self._win_async: Optional[bool] = None
        self._owns_backend = True
        # the backend class and framework resolved at start() (auto
        # resolved): restarts and hot swaps keep them
        self._backend_cls: Optional[type] = None
        self._framework = ""
        # the decoder device halves the fusion pass folded in: re-applied to
        # every backend this element opens (a restart, a hot swap)
        self._fused_posts: List[Any] = []
        # hot swap state machine (lifetime counters survive restarts)
        self._swapper: Optional[HotSwapCoordinator] = None
        # device-resource resilience, lifetime counters
        self._oom_retries = 0     # invokes retried after a device OOM
        self._oom_shrinks = 0     # micro-batches split into two halves
        self._oom_evictions = 0   # allocator segments released on OOM
        self._oom_trimmed_bytes = 0  # their card bytes
        self._device_lost = 0     # lost-device events seen
        self._remeshes = 0        # backends rebuilt on surviving devices
        self._degraded = False    # serving in a reduced configuration
        self._exclude: Tuple[int, ...] = ()  # ordinals found dead
        # latency/throughput properties: the last 10 invokes' per-frame µs
        self._latency_ring: deque = deque(maxlen=10)
        self._nframes = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None
        self._invoked_frames = 0
        # handler-entry stamp: the trace span's dispatch segment starts here
        self._t_handler = 0.0
        # combination properties, parsed once at start()
        self._in_comb: Optional[List[Tuple[str, int]]] = None
        self._out_comb: Optional[List[Tuple[str, int]]] = None
        self._out_needs_inputs = False
        self._tracing = False  # holds a torch.profiler session reference

    @property
    def batch_through_active(self) -> bool:
        return bool(self.props["batch-through"]) or self._auto_batch_through

    # -- device fusion (pipeline pass) --------------------------------------
    @property
    def can_fuse_postprocess(self) -> bool:
        """A private, postprocess-capable backend (a shared one serves every
        filter on its key, so no one filter's decoder half may be folded
        into it), and no combination or dynamic output that would change
        what the postprocess sees."""
        return (self.backend is not None and hasattr(self.backend, "append_postprocess")
                and self._owns_backend and not self.props["invoke-dynamic"]
                and not self._out_comb)

    def fuse_device_postprocess(self, fn) -> None:
        """Fold ``fn`` (operates on the model's output list, on device) into
        the backend call; the cached output schema no longer holds.  Kept
        for the run, so a restarted or hot-swapped backend gets it too."""
        if not self.can_fuse_postprocess:
            raise ElementError(f"{self.name}: backend cannot fuse a postprocess")
        self.backend.append_postprocess(fn)
        self._fused_posts.append(fn)
        self._model_out = None
        self._derived.clear()

    def clear_device_fusion(self) -> None:
        """A new pipeline run re-decides fusion (``Pipeline.start``)."""
        self._fused_posts = []
        self._auto_batch_through = False

    # -- batching hook for the scheduler ------------------------------------
    @property
    def preferred_batch(self) -> int:
        be = self.backend
        if be is not None and be.supports_batch:
            return max(1, int(self.props["max-batch"]))
        return 1

    @property
    def batch_wait_s(self) -> float:
        return max(0, int(self.props["batch-timeout"])) / 1000.0

    # -- lifecycle ----------------------------------------------------------
    def _make_backend(self, model: Optional[str]) -> FilterBackend:
        """Open a fresh backend for ``model`` (``model://`` and ``file://``
        resolved) on the element's accelerator, never on a card found dead,
        with the run's fused device halves appended."""
        props = dict(self.props)
        enabled, wishes = parse_accelerator(self.props["accelerator"])
        props["accelerators"] = wishes if enabled else ["cpu"]
        if self._exclude:
            props["exclude_ordinals"] = tuple(self._exclude)
        be = self._backend_cls()
        be.open(resolve_model_uri(model) if model else None, props)
        for fn in self._fused_posts:
            be.append_postprocess(fn)
        return be

    def _resolve_framework(self, model: Optional[str]) -> None:
        """Latch the backend class for this run: ``framework=auto`` detected
        from the model file after ``model://`` resolution."""
        fw = self.props["framework"]
        if fw == "auto":
            if not model:
                raise ElementError(f"{self.name}: framework=auto requires a model")
            fw = detect_framework(resolve_model_uri(model), self.props["custom"])
        try:
            self._backend_cls = find_backend(fw)
        except KeyError:
            raise ElementError(f"{self.name}: unknown framework {fw!r}") from None
        self._framework = fw

    # -- manual model info ---------------------------------------------------
    @staticmethod
    def _apply_rank(shape: tuple, rank: int) -> tuple:
        """Trim/pad OUTERMOST (numpy-leading) unit dims so the shape has the
        declared true rank (inputranks/outputranks)."""
        shape = tuple(shape)
        while len(shape) > rank:
            if shape[0] not in (1, None):
                raise ElementError(
                    f"cannot reduce shape {shape} to rank {rank}: leading "
                    f"dim {shape[0]} != 1")
            shape = shape[1:]
        while len(shape) < rank:
            shape = (1,) + shape
        return shape

    def _manual_spec(self, side: str) -> Optional[StreamSpec]:
        """The manual model-info override of 'input' or 'output' from the
        reference-dialect properties, or None when not configured."""
        dims_text = self.props[side]
        types_text = self.props[f"{side}-type"]
        if not dims_text and not types_text:
            return None
        if not dims_text or not types_text:
            raise ElementError(f"{self.name}: {side} and {side}-type must be given together")
        dims = [d for d in dims_text.split(",") if d.strip()]
        types = [t.strip() for t in types_text.split(",") if t.strip()]
        if len(dims) != len(types):
            raise ElementError(
                f"{self.name}: {side} declares {len(dims)} tensors but "
                f"{side}-type declares {len(types)}")
        names_key = "inputname" if side == "input" else "outputname"
        ranks_key = "inputranks" if side == "input" else "outputranks"
        names = self.props[names_key].split(",") if self.props[names_key] else []
        ranks = ([int(r) for r in self.props[ranks_key].split(",") if r.strip()]
                 if self.props[ranks_key] else [])
        specs = []
        for i, (d, t) in enumerate(zip(dims, types)):
            try:
                shape = parse_dims_string(d)
                if i < len(ranks):
                    shape = self._apply_rank(shape, ranks[i])
                spec = TensorSpec(shape, dtype_from_name(t),
                                  names[i].strip() if i < len(names) else "")
            except (ValueError, ElementError) as e:
                raise ElementError(f"{self.name}: {side}[{i}]: {e}") from None
            specs.append(spec)
        return StreamSpec(tuple(specs), FORMAT_STATIC, None)

    @staticmethod
    def _as_stream_spec(s) -> Optional[StreamSpec]:
        """A backend model-info value (None | StreamSpec) as a StreamSpec,
        or None when empty or unknown."""
        if s is None:
            return None
        return s if s.tensors else None

    _LAYOUTS = ("", "none", "any", "nchw", "nhwc")

    def _check_layouts(self) -> None:
        for key in ("inputlayout", "outputlayout"):
            for i, lay in enumerate(x.strip().lower() for x in self.props[key].split(",")
                                    if x.strip()):
                if lay not in self._LAYOUTS:
                    raise ElementError(
                        f"{self.name}: {key}[{i}]: unknown layout {lay!r} "
                        f"(want NCHW|NHWC|ANY|NONE); note PyTorch owns physical "
                        "layout on the card — this prop is declarative")

    def _apply_manual_info(self) -> None:
        """Manual model info against the backend's (start(), after open):
        an input override declares the input of a model that cannot infer
        it, or reshapes one that can (``set_input_info``); an output
        override declares or must match the model's output."""
        in_override = self._manual_spec("input")
        out_override = self._manual_spec("output")
        fw = self._framework
        if in_override is not None:
            if not self._owns_backend:
                raise ElementError(
                    f"{self.name}: manual input override is incompatible with "
                    "shared-tensor-filter-key (set it on a non-shared filter)")
            model_in = self._as_stream_spec(self._model_in)
            if model_in is None:
                self._model_in = in_override
                try:
                    derived = self.backend.set_input_info(in_override)
                    if self._as_stream_spec(derived) is not None:
                        self._model_out = derived
                except NotImplementedError:
                    pass
            elif not in_override.is_compatible(model_in):
                try:
                    self._model_out = self.backend.set_input_info(in_override)
                except NotImplementedError:
                    raise ElementError(
                        f"{self.name}: input={self.props['input']} conflicts with the "
                        f"model's declared input and backend {fw!r} cannot reshape") from None
                self._model_in = in_override
        if out_override is not None:
            model_out = self._as_stream_spec(self._model_out)
            if model_out is None:
                self._model_out = out_override
            elif not out_override.is_compatible(model_out):
                raise ElementError(
                    f"{self.name}: output={self.props['output']}/"
                    f"{self.props['output-type']} does not match the "
                    f"model's output "
                    f"{tuple((t.shape, str(t.dtype)) for t in model_out.tensors)}")

    def start(self) -> None:
        self._apply_config_file()
        self._check_layouts()
        self._tracing = False
        self._in_comb = _parse_combination(self.props["input-combination"])
        self._out_comb = _parse_combination(self.props["output-combination"])
        # constant per run: does output-combination read any INPUT tensor?
        self._out_needs_inputs = self._out_comb is not None and any(
            src == "i" for src, _ in self._out_comb)
        if self.props["batch-through"] and self._out_comb:
            # the BatchFrame fast path bypasses _compose_outputs
            raise ElementError(
                f"{self.name}: batch-through=true is incompatible with output-combination")
        if self.props["invoke-dynamic"] and int(self.props["max-batch"]) > 1:
            raise ElementError(
                f"{self.name}: invoke-dynamic is per-frame (incompatible with max-batch>1)")
        if self.props["mesh"]:
            raise ElementError(
                f"{self.name}: mesh= is not ported to nnstreamer_tpu_torch yet (ROADMAP A11)")
        # a restart within a run keeps the fusion the pass decided
        self._auto_batch_through = bool(self._fused_posts) and self._auto_batch_through
        lane_mode = str(self.props["ingest-lane"] or "auto").lower()
        if lane_mode not in ("auto", "on", "off"):
            raise ElementError(f"{self.name}: ingest-lane={lane_mode!r} (want auto|on|off)")
        model = self.props["model"] or None
        self._resolve_framework(model)
        fw = self._framework
        key = self.props["shared-tensor-filter-key"]
        if key:
            be = _shared_acquire(key, lambda: self._make_backend(model))
            self._owns_backend = False
        else:
            be = self._make_backend(model)
            self._owns_backend = True
        self.backend = be
        self._model_in, self._model_out = be.get_model_info()
        try:
            self._apply_manual_info()
        except ElementError:
            self.stop()
            raise
        if self._fused_posts:
            self._model_out = None  # the fused schema is derived
        self._derived = {}
        # async device feed, armed for the fresh backend
        self._inflight = CompletionWindow(self.name)
        self._win_async = None
        self._staged = None
        self._lane = None
        # the one-batch dispatch deferral surfaces an invoke error during the
        # NEXT batch's call: fine under fail-stop, but skip/restart would
        # dead-letter or replay the wrong frames, so those exclude the lane
        replay_policy = (self.props.get("error-policy", "fail-stop") != "fail-stop"
                         or self.props.get("stall-policy", "warn") == "restart")
        if lane_mode != "off" and self.preferred_batch > 1:
            if replay_policy:
                if lane_mode == "on":
                    self.stop()
                    raise ElementError(
                        f"{self.name}: ingest-lane=on is incompatible with "
                        "error-policy=skip|restart / stall-policy=restart (deferred "
                        "dispatch would misattribute the failed frames)")
            elif be.SUPPORTS_STAGING:
                self._lane = HostStagingLane(
                    be.to_device, name=self.name, placement=be.staging_placement())
            elif lane_mode == "on":
                self.stop()
                raise ElementError(
                    f"{self.name}: ingest-lane=on but backend {fw!r} does not support "
                    "staged host->device placement")
        elif lane_mode == "on":
            self.stop()
            raise ElementError(
                f"{self.name}: ingest-lane=on requires max-batch>1 "
                "(staging overlaps per-micro-batch copies)")
        # trace only once the backend is open: a start() that failed must
        # not hold a profiler reference (the pipeline never stops it then)
        if self.props["trace"]:
            self._tracing = trace_start(self.props["trace-dir"])

    def stop(self) -> None:
        """Join the lane and reaper threads and drop every backend this
        element holds (serving, staged, retired), so a restart leaves no
        tensor of the old backend on the card."""
        self._discard_staged()
        self._inflight.close()  # drops parked batches and stops the reaper
        if self._lane is not None:
            self._lane.close()
            self._lane = None
        if self._swapper is not None:
            self._swapper.close()  # its lifetime counters survive
        if self._tracing:
            trace_stop()
            self._tracing = False
        if self.backend is not None:
            key = self.props["shared-tensor-filter-key"]
            if _shared_release(key) if key else True:
                self.backend.close()
            self.backend = None

    # -- negotiation --------------------------------------------------------
    def _input_for_backend(self, spec: StreamSpec) -> StreamSpec:
        comb = (self._in_comb if self.backend is not None
                else _parse_combination(self.props["input-combination"]))
        if comb:
            return spec.pick([i for _, i in comb])
        return spec

    def accept_spec(self, pad, spec):
        if self._model_in is not None and spec.tensors:
            got = self._input_for_backend(spec)
            if not self._model_in.is_compatible(got):
                raise ElementError(
                    f"{self.name}: stream schema {got.to_string()} does not match "
                    f"model input {self._model_in.to_string()}")
        return spec

    def derive_spec(self, pad=0):
        in_spec = self.sink_specs.get(0, ANY)
        if self.props["invoke-dynamic"]:
            # per-buffer output schemas: a flexible stream, negotiated late
            return StreamSpec((), FORMAT_FLEXIBLE, in_spec.framerate)
        if self._model_out is not None:
            out = self._model_out
        elif self.backend is not None and in_spec.tensors:
            if in_spec not in self._derived:
                self._derived[in_spec] = self.backend.set_input_info(
                    self._input_for_backend(in_spec))
            out = self._derived[in_spec]
        else:
            return ANY
        comb = self._out_comb
        if comb:
            # 'iN' indexes the ORIGINAL input tensors (before input-combination)
            tensors = [in_spec.tensors[i] if src == "i" else out.tensors[i] for src, i in comb]
            out = StreamSpec(tuple(tensors), out.fmt, in_spec.framerate or out.framerate)
        return out

    # -- telemetry ------------------------------------------------------------
    def _compose_outputs(self, orig_inputs: List[Any], outputs: List[Any]) -> List[Any]:
        comb = self._out_comb
        if not comb:
            return outputs
        return [orig_inputs[i] if src == "i" else outputs[i] for src, i in comb]

    def _record_stats(self, dt_s: float, nframes: int) -> None:
        """One backend call of ``nframes`` logical frames took ``dt_s`` of
        host wall time (on the card: the launches, not the model's device
        time)."""
        self.invokes += 1
        self._invoked_frames += nframes
        if self.props["latency"]:
            self._latency_ring.append(dt_s * 1e6 / max(nframes, 1))
            if self.props["latency-report"] and self._pipeline is not None:
                from ..pipeline.pipeline import BusMessage

                self._pipeline.post(BusMessage(
                    "element", self.name, {"latency-us": self.latency_us, "batch": nframes}))
        if self.props["throughput"]:
            t = time.monotonic()
            if self._t_first is None:
                self._t_first = t
            self._t_last = t
            self._nframes += nframes

    @property
    def latency_us(self) -> float:
        """Average per-frame invoke latency of the last 10 invokes, µs: the
        host's wall time around the backend call."""
        return float(np.mean(self._latency_ring)) if self._latency_ring else 0.0

    @property
    def throughput_fps(self) -> float:
        """Outputs/sec since start."""
        if not self._nframes or self._t_first is None or self._t_last == self._t_first:
            return 0.0
        return self._nframes / (self._t_last - self._t_first)

    @staticmethod
    def _stamp_invoke_spans(frames: Sequence[TensorFrame], dispatch_s: float,
                            compute_s: float) -> None:
        """Frames that carry a server receive stamp (``TL_RX_META``) get this
        invoke's (dispatch, compute) host durations; one dict probe per
        invoke for a stream that never crossed a wire."""
        probe = frames[0]
        m0 = (probe.frames_info[0][2] if isinstance(probe, BatchFrame) and probe.frames_info
              else probe.meta)
        if TL_RX_META not in m0:
            return
        span = (max(0.0, dispatch_s), max(0.0, compute_s))
        for f in frames:
            if isinstance(f, BatchFrame):
                for _, _, m in f.frames_info:
                    if TL_RX_META in m:
                        m[TL_INVOKE_META] = span
                if TL_RX_META in f.meta:
                    f.meta[TL_INVOKE_META] = span
            elif TL_RX_META in f.meta:
                f.meta[TL_INVOKE_META] = span

    # -- processing ---------------------------------------------------------
    def pending_frames(self) -> int:
        """Logical frames parked in the dispatch window plus the staged (not
        yet dispatched) ingest batch."""
        n = sum(sum(getattr(f, "batch_size", 1) for f in frames)
                for frames in self._inflight.payloads())
        staged = self._staged
        if staged is not None:
            n += len(staged[1])
        return n

    def transform(self, frame: TensorFrame) -> TensorFrame:
        sw = self._swapper
        if sw is not None and sw.has_boundary_work and not len(self._inflight):
            self._swap_tick()  # nothing parked: the drained results are empty
        comb = self._in_comb
        inputs = [frame.tensors[i] for _, i in comb] if comb else list(frame.tensors)
        if FAULTS.is_armed():
            FAULTS.check("filter.invoke", interrupt=lambda: self.interrupted)
        t0 = time.perf_counter()
        # a pre-batched block on the per-frame path: its batch axis still
        # means "batch", and the block stays whole
        if isinstance(frame, BatchFrame):
            out = self._resilient_invoke_batch(inputs)
            dt = time.perf_counter() - t0
            self._record_stats(dt, frame.batch_size)
        else:
            out = self._resilient_invoke(inputs)
            dt = time.perf_counter() - t0
            self._record_stats(dt, 1)
        self._stamp_invoke_spans((frame,), 0.0, dt)
        return frame.with_tensors(self._compose_outputs(frame.tensors, out))

    def handle_frame_batch(
        self, pad: int, frames: List[TensorFrame]
    ) -> List[Tuple[int, TensorFrame]]:
        """Micro-batched path: the scheduler hands N frames; they run as
        invoke_batch calls of at most max-batch logical frames each.  A
        pending hot swap applies first, at a drained frame boundary (the
        drained results go out ahead of this batch's)."""
        sw = self._swapper
        if sw is not None and sw.has_boundary_work:
            pre = self._swap_tick()
            if pre:
                return pre + self._handle_batch(pad, frames)
        return self._handle_batch(pad, frames)

    def _handle_batch(self, pad: int, frames: List[TensorFrame]
                      ) -> List[Tuple[int, TensorFrame]]:
        self._t_handler = time.perf_counter()
        if any(isinstance(f, BatchFrame) for f in frames):
            # block ingest: the batch axis already exists; a staged lane
            # batch is older, so it goes first
            return self._flush_staged() + self._handle_prebatched(frames)
        if len(frames) == 1:
            # a queue-starved moment: release the staged batch and drain the
            # window first, so this frame cannot overtake them
            results = self._flush_staged()
            results.extend(self._drain_inflight())
            results.append((0, self.transform(frames[0])))
            return results
        comb = self._in_comb
        select = [i for _, i in comb] if comb else None
        if self._lane is not None and type(frames[0].tensors[0]) is np.ndarray:
            # host ingest: stacking and the copy to the device move to the
            # lane thread, and dispatch is DEFERRED BY ONE BATCH: by the time
            # batch k's device tensors are needed, its copy has overlapped
            # batch k-1's compute.  The staging buffer holds the model's
            # inputs only: output-combination reads the frames themselves
            job = self._lane.submit([
                [f.tensors[i] for i in select] if select is not None else list(f.tensors)
                for f in frames])
            prev, self._staged = self._staged, (job, frames)
            if prev is None:
                return []
            return self._run_batch(self._staged_result(prev[0]), prev[1])
        results = self._flush_staged()  # a mixed stream keeps FIFO
        results.extend(self._run_batch(_batched_tensors(frames, select), frames))
        return results

    def _handle_prebatched(self, frames: List[TensorFrame]) -> List[Tuple[int, TensorFrame]]:
        """Frames that carry a batch axis (possibly mixed with plain ones):
        one concatenation, chunked so max-batch keeps bounding the invoke's
        batch axis."""
        comb = self._in_comb
        batched = _batched_tensors(frames, [i for _, i in comb] if comb else None)
        infos = _logical_infos(frames)
        mb = max(1, int(self.props["max-batch"]))
        if len(infos) <= mb:
            return self._run_batch(batched, frames)
        # 'iN' entries index the ORIGINAL input tensors: when
        # input-combination narrowed `batched`, the chunks carry the originals
        carry = _batched_tensors(frames) if self._out_needs_inputs and comb else batched
        results = []
        for k in range(0, len(infos), mb):
            cinfos = infos[k:k + mb]
            chunk = BatchFrame(
                tensors=[t[k:k + mb] for t in carry], pts=cinfos[0][0],
                duration=cinfos[0][1], meta=dict(cinfos[0][2]), frames_info=list(cinfos))
            results.extend(self._run_batch([t[k:k + mb] for t in batched], [chunk]))
        return results

    def _run_batch(
        self, batched: List[Any], frames: List[TensorFrame]
    ) -> List[Tuple[int, TensorFrame]]:
        """One invoke_batch, then batch-through (the whole micro-batch leaves
        as ONE frame, outputs still on the device; the next host boundary
        splits it) or the dispatch window."""
        if FAULTS.is_armed():
            FAULTS.check("filter.invoke", interrupt=lambda: self.interrupted)
        t0 = time.perf_counter()
        out_b = self._resilient_invoke_batch(batched)
        dt = time.perf_counter() - t0
        self._record_stats(dt, sum(getattr(f, "batch_size", 1) for f in frames))
        self._stamp_invoke_spans(frames, t0 - self._t_handler if self._t_handler else 0.0, dt)
        if self.batch_through_active:
            infos = _logical_infos(frames)
            p, d, m = infos[0]
            return [(0, BatchFrame(tensors=list(out_b), pts=p, duration=d,
                                   meta=dict(m), frames_info=infos))]
        return self._dispatch_or_park(out_b, frames)

    def _dispatch_or_park(
        self, out_b: List[Any], frames: List[TensorFrame]
    ) -> List[Tuple[int, TensorFrame]]:
        """Depth-N dispatch: start this batch's device-to-host copies right
        behind its launches, park it in the window (its reaper waits for
        the copies), then emit whatever COMPLETED at the front.  A full
        window waits for its oldest entry's completion, never on the
        device."""
        depth = max(1, int(self.props["dispatch-depth"]))
        if self._win_async is None:
            # latched once per backend: the hot path never re-probes
            self._win_async = any(
                _is_torch(o) or hasattr(o, "copy_to_host_async") for o in out_b)
            if not self._win_async and depth > 1:
                self.log.info(
                    "dispatch-depth=%d requested but %r outputs are host-resident: "
                    "the dispatch window degrades to the synchronous path",
                    depth, self._framework)
        if depth > 1 and self._win_async:
            self._inflight.park(start_host_copies(out_b), frames)
            results = self._pop_ready()
            while len(self._inflight) > depth - 1:
                self._wait_window_oldest()
                results.extend(self._pop_ready())
            return results
        # synchronous: batches parked while the window was active go first
        return self._drain_inflight() + self._emit_batch(materialize(out_b), frames)

    def _emit_batch(self, out_np: List[np.ndarray], frames: List[TensorFrame]
                    ) -> List[Tuple[int, TensorFrame]]:
        """One frame per logical input frame, each a view of its rows.
        With output-combination, an ``iN`` entry is the frame's own input
        tensor as the filter received it (a block's rows come to the host
        with the outputs), never the staging buffer the lane recycles."""
        if not self._out_comb:
            return [
                (0, TensorFrame([o[b] for o in out_np], pts=p, duration=d, meta=dict(m)))
                for b, (p, d, m) in enumerate(_logical_infos(frames))
            ]
        need_idx = sorted({i for src, i in self._out_comb if src == "i"})
        results = []
        b = 0
        for f in frames:
            if isinstance(f, BatchFrame):
                ins: List[Any] = [None] * len(f.tensors)
                if need_idx:
                    for i, m in zip(need_idx, materialize([f.tensors[i] for i in need_idx])):
                        ins[i] = m
                for j, (p, d, m) in enumerate(f.frames_info):
                    outs = self._compose_outputs(
                        [t[j] if t is not None else None for t in ins],
                        [o[b + j] for o in out_np])
                    results.append((0, TensorFrame(outs, pts=p, duration=d, meta=dict(m))))
                b += f.batch_size
            else:
                outs = [o[b] for o in out_np]
                results.append((0, f.with_tensors(self._compose_outputs(f.tensors, outs))))
                b += 1
        return results

    def _pop_ready(self) -> List[Tuple[int, TensorFrame]]:
        results: List[Tuple[int, TensorFrame]] = []
        for mats, frames in self._inflight.pop_ready():
            results.extend(self._emit_batch(mats, frames))
        return results

    def _check_stopping(self, what: str) -> None:
        pipe = self._pipeline
        if pipe is not None and pipe._stop_flag.is_set():
            raise ElementError(f"{self.name}: pipeline stopped while waiting on {what}")

    def _wait_window_oldest(self) -> None:
        """Bounded wait for the oldest parked batch's completion; gives up
        when the pipeline stops."""
        while not self._inflight.wait_oldest(timeout=0.05):
            self._check_stopping("the dispatch window")

    def _drain_inflight(self) -> List[Tuple[int, TensorFrame]]:
        results = self._pop_ready()
        while len(self._inflight):
            self._wait_window_oldest()
            results.extend(self._pop_ready())
        return results

    def _staged_result(self, job: StagedBatch) -> List[Any]:
        """A staging job's device tensors (bounded waits); re-raises the
        lane's error here, on the dispatch thread."""
        while not job.wait(timeout=0.05):
            self._check_stopping("the ingest lane")
        # allow-blocking: the job is done (waited above in bounded steps)
        return job.result()

    def _discard_staged(self) -> None:
        """Drop the staged batch unseen (Flush, stop)."""
        if self._staged is not None:
            self._staged[0].discard()
            self._staged = None

    def _flush_staged(self) -> List[Tuple[int, TensorFrame]]:
        """Dispatch the deferred (staged) ingest batch, if any.  Called
        BEFORE draining the window at a boundary: the dispatch parks into
        the window, so the drain that follows emits everything in order."""
        if self._staged is None:
            return []
        job, frames = self._staged
        self._staged = None
        return self._run_batch(self._staged_result(job), frames)

    def handle_eos(self, pad: int) -> List[Tuple[int, TensorFrame]]:
        """Release the staged batch and drain the window before EOS
        propagates."""
        return self._flush_staged() + self._drain_inflight() + self._swap_tick()

    def handle_idle(self) -> List[Tuple[int, TensorFrame]]:
        """Scheduler idle hook: the input went quiet, so overlap has
        nothing left to win: release the staged batch and the window
        instead of holding a live stream's tail until the next frame.  Also
        a frame boundary: a staged swap on an idle stream lands here."""
        return self._flush_staged() + self._drain_inflight() + self._swap_tick()

    def handle_event(self, pad, ev):
        if isinstance(ev, Flush):
            # a flush drops queued frames; the staged batch and the parked
            # window are frames too
            self._discard_staged()
            self._inflight.clear()
            return super().handle_event(pad, ev)
        # any other event must not overtake parked frames
        return self._flush_staged() + self._drain_inflight() + list(
            super().handle_event(pad, ev))

    # -- zero-downtime model rollout (core/lifecycle.py) ---------------------
    def _ensure_swapper(self) -> HotSwapCoordinator:
        if self._swapper is None:
            self._swapper = HotSwapCoordinator(
                self.name, build=lambda m: self._make_backend(m or None),
                validate=self._validate_staged, warmup=self._warmup_staged)
        return self._swapper

    def request_reload(self, model: str = "") -> SwapTicket:
        """Validated hot model swap (``Pipeline.reload_model``): stage the
        new model on a second backend in a background thread (open, schema
        check against the negotiated specs, warm-up on a zero probe frame
        on its own CUDA stream), then swap at the next frame boundary.  A
        staging failure keeps the old model serving and counts
        ``swap_failures``, never the restart budget."""
        if not self.props["is-updatable"]:
            raise ElementError(f"{self.name}: model reload requires is-updatable=true")
        if self.backend is None:
            raise ElementError(f"{self.name}: not started")
        model = model or self.props["model"]
        sw = self._ensure_swapper()
        if not self._owns_backend or not self.props["staged-reload"]:
            # a shared backend is every keyed filter's: no per-element
            # pointer swap can replace it
            return self._inline_reload(model)
        return sw.request(model, observation_window=float(self.props["observation-window"]),
                          error_burst=int(self.props["rollback-error-burst"]))

    def _inline_reload(self, model: str) -> SwapTicket:
        """The backend's own ``reload`` (it keeps its placement and fused
        device halves) with the keep-serving guarantee: a failure logs,
        counts ``swap_failures`` and never reaches supervision."""
        sw = self._ensure_swapper()
        try:
            FAULTS.check("filter.reload.load")
            self.backend.reload(resolve_model_uri(model) if model else model)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — reload boundary
            self.log.error("model reload from %r failed (old model keeps serving): %s", model, e)
            return sw.note_inline_failure(e)
        self.props["model"] = model
        return sw.note_inline_swap(model)

    def _validate_staged(self, be: FilterBackend):
        """Staging-thread schema check: the new model must accept the
        negotiated input stream and keep producing the negotiated output
        schema (downstream never renegotiates during a swap); with a fused
        device half the output compared is the fused one.  Returns the
        model info the element adopts at swap time."""
        raw_in, raw_out = be.get_model_info()
        negotiated = self.sink_specs.get(0)
        got = (self._input_for_backend(negotiated)
               if negotiated is not None and negotiated.tensors else None)
        if got is not None and raw_in is not None and not raw_in.is_compatible(got):
            raise ElementError(
                f"{self.name}: staged model input {raw_in.to_string()} does not accept the "
                f"negotiated stream {got.to_string()}")
        new_out = None if self._fused_posts else raw_out
        if new_out is None and got is not None:
            new_out = be.set_input_info(got)
        cur_out = self.srcpads[0].spec if self.srcpads else None
        if (new_out is not None and cur_out is not None and cur_out.tensors
                and not self.props["invoke-dynamic"] and not self._out_comb
                and not cur_out.is_compatible(new_out)):
            raise ElementError(
                f"{self.name}: staged model output {new_out.to_string()} does not match "
                f"the negotiated downstream schema {cur_out.to_string()}")
        return raw_in, (None if self._fused_posts else raw_out)

    def _probe_inputs(self, be: FilterBackend) -> Optional[List[np.ndarray]]:
        """A zero frame of the negotiated (else the model's) input schema;
        None when neither is static."""
        spec = self.sink_specs.get(0)
        if spec is not None and spec.tensors:
            spec = self._input_for_backend(spec)
        else:
            spec = be.get_model_info()[0]
        if spec is None or not spec.tensors or not spec.is_static:
            return None
        return [np.zeros(t.shape, t.dtype) for t in spec.tensors]

    def _warmup_staged(self, be: FilterBackend) -> None:
        """Staging-thread warm-up: a probe invoke (and a batched one when
        the hot path micro-batches), on a CUDA stream of the staging
        thread's own, so its launches never queue behind the serving
        stream's."""
        probes = self._probe_inputs(be)
        if probes is None:
            return
        dev = getattr(be, "device", None)
        if dev is not None and dev.type == "cuda":
            import torch

            with torch.cuda.device(dev):
                side = torch.cuda.Stream(dev)
                with torch.cuda.stream(side):
                    self._warm(be, probes)
                side.synchronize()
            return
        self._warm(be, probes)

    def _warm(self, be: FilterBackend, probes: List[np.ndarray]) -> None:
        be.invoke(list(probes))
        if be.supports_batch and self.preferred_batch > 1:
            be.invoke_batch([p[None] for p in probes])

    def _swap_tick(self) -> List[Tuple[int, TensorFrame]]:
        """Frame-boundary lifecycle work: apply a staged swap, commit an
        expired observation window and close retired backends, all AFTER
        draining the staged batch and the dispatch window, so a retiring
        backend outlives its last in-flight batch.  Returns the drained
        results (emitted ahead of new output)."""
        sw = self._swapper
        if sw is None or not sw.has_boundary_work:
            return []
        drained = self._flush_staged()
        drained.extend(self._drain_inflight())
        staged = sw.take_staged()
        if staged is not None:
            be, model, raw_in, raw_out, ticket = staged
            old_blob = (self.backend, self._model_in, self._model_out, self.props["model"])
            self.backend = be
            self._win_async = None  # re-latched for the fresh backend
            if raw_in is not None:
                self._model_in = raw_in
            if raw_out is not None:
                self._model_out = raw_out
            self._derived = {}
            self.props["model"] = model
            sw.activated(old_blob, ticket)
            self.log.info("hot-swapped to model %r (version %d)", model, sw.model_version)
        if sw.observing:
            sw.note_ok()  # commits once the observation window elapsed
        sw.reap()
        return drained

    def _backend_invoke(self, inputs: List[Any]) -> List[Any]:
        sw = self._swapper
        if sw is None or not sw.observing:
            return self.backend.invoke(inputs)
        return self._observed_invoke(False, inputs)

    def _backend_invoke_batch(self, inputs: List[Any]) -> List[Any]:
        sw = self._swapper
        if sw is None or not sw.observing:
            return self.backend.invoke_batch(inputs)
        return self._observed_invoke(True, inputs)

    def _observed_invoke(self, batched: bool, inputs: List[Any]) -> List[Any]:
        """Invoke inside the post-swap observation window: an error is
        served by the RETAINED old backend (no frame lost) and counted; a
        burst rolls the swap back.  Neither reaches supervision."""
        sw = self._swapper
        try:
            if FAULTS.is_armed():
                FAULTS.check("filter.reload.post", interrupt=lambda: self.interrupted)
            out = self.backend.invoke_batch(inputs) if batched else self.backend.invoke(inputs)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as e:  # noqa: BLE001 — observation boundary
            verdict = sw.note_error(e)
            if verdict is None:
                raise
            (old_be, old_in, old_out, old_model), rolled_back = verdict
            if rolled_back:
                failed = self.backend
                self.backend = old_be
                self._win_async = None
                self._model_in, self._model_out = old_in, old_out
                self._derived = {}
                self.props["model"] = old_model
                sw.discard(failed)  # closed at the next drained boundary
                p = self._pipeline
                if p is not None:
                    p.incident("swap_rollback", self.name, repr(e))
        else:
            sw.note_ok()
            return out
        # the retry on the old backend runs outside the handler (see
        # _resilient_invoke_batch)
        return old_be.invoke_batch(inputs) if batched else old_be.invoke(inputs)

    # -- device-resource resilience (degrade, don't die) ---------------------
    def _resilient_invoke(self, inputs: List[Any]) -> List[Any]:
        """Per-frame invoke with the OOM and device-loss ladder: a single
        frame has no batch to split, so an OOM trims and retries once."""
        try:
            return self._backend_invoke(inputs)
        except DeviceOomError:
            pass  # retried below, outside the handler (see _resilient_invoke_batch)
        except DeviceLostError as e:
            self._remesh_after_loss(e)
            raise
        self._oom_retries += 1
        self._trim_for_oom()
        return self._backend_invoke(inputs)

    def _resilient_invoke_batch(self, inputs: List[Any]) -> List[Any]:
        """Micro-batch invoke with the ladder: on an OOM, trim and retry
        ONCE as two halves, in order.  The backend pads a batch of n rows
        to the next power of two; a half of ceil(n/2) rows pads to a
        strictly smaller bucket, hence a strictly smaller working set.  The
        halves slice the same inputs (torch has no donation: nothing was
        consumed by the failed attempt; a staged batch's tensors are the
        lane's copies, and its pooled host buffer went back to the pool
        once the copy completed) and their outputs are concatenated on the
        card.  A second OOM surfaces to supervision.

        The trim and the retry run after the handler has exited: inside
        it the failed attempt's traceback still references the model's
        frames, whose activations would then stay allocated on the card
        through the retry."""
        try:
            return self._backend_invoke_batch(inputs)
        except DeviceOomError:
            pass
        except DeviceLostError as e:
            self._remesh_after_loss(e)
            raise
        self._oom_retries += 1
        self._trim_for_oom()
        n = int(inputs[0].shape[0])
        if n <= 1:
            return self._backend_invoke_batch(inputs)
        self._oom_shrinks += 1
        self.log.warning("device OOM on a %d-row micro-batch: trimmed caches, retrying as two "
                         "half-bucket invokes", n)
        h = (n + 1) // 2
        out1 = self._backend_invoke_batch([t[:h] for t in inputs])
        out2 = self._backend_invoke_batch([t[h:] for t in inputs])
        return [concat_tensors([a, b], 0) for a, b in zip(out1, out2)]

    def _trim_for_oom(self) -> None:
        """Release the card memory the backend can recreate before the
        retry: its allocator cache (``oom_evictions`` counts the entries,
        as in the JAX package, ``oom_trimmed_bytes`` their bytes).  The
        staging pools hold host memory, so the card gains nothing from
        them."""
        be = self.backend
        if be is None:
            return
        before = be.trimmed_bytes
        self._oom_evictions += int(be.trim_caches() or 0)
        self._oom_trimmed_bytes += be.trimmed_bytes - before

    def _remesh_after_loss(self, err: DeviceLostError) -> None:
        """The JAX filter re-shards a mesh backend onto the surviving
        devices here.  Every port backend is unsharded (ROADMAP A11), so
        ``remesh_spec_after_loss`` is ``None``: record the ordinals a probe
        finds dead (a restart must not re-pick them) and re-raise into
        supervision, whose restart re-opens the backend.  A shared backend
        is not this element's to replace: re-raised untouched.  Never
        returns."""
        self._device_lost += 1
        be = self.backend
        if be is None or not self._owns_backend:
            raise err
        reported = getattr(err, "device_ids", ()) or ()
        if be.remesh_spec_after_loss(reported) is None:
            dead = be.dead_ordinals_after_loss(reported)
            if dead:
                self._exclude = tuple(sorted(set(self._exclude) | set(dead)))
            raise err
        raise NotImplementedError(
            f"{self.name}: re-meshing a sharded backend is not ported (ROADMAP A11)")

    def health_info(self) -> Dict[str, Any]:
        """Model-rollout and device-resource counters merged into
        ``Pipeline.health()``."""
        info: Dict[str, Any] = {
            "model": self.props["model"],
            "model_version": 0, "swaps": 0, "swap_failures": 0, "rollbacks": 0,
            "oom_retries": self._oom_retries,
            "oom_shrinks": self._oom_shrinks,
            "oom_evictions": self._oom_evictions,
            "oom_trimmed_bytes": self._oom_trimmed_bytes,
            "device_lost": self._device_lost,
            "remeshes": self._remeshes,
            "degraded": 1 if (self._degraded or (
                self.backend is not None and self.backend.degraded)) else 0,
            # the torch.profiler session this element holds (trace=1)
            "profiler_active": 1 if self._tracing else 0,
        }
        if self._swapper is not None:
            info.update(self._swapper.snapshot())
        # named-thread census: the dispatch window's reaper and the ingest
        # lane's stager (a wedged one shows alive with a growing age)
        lane = self._lane
        info["threads"] = thread_census(self._inflight.heartbeat,
                                        lane.heartbeat if lane is not None else None)
        return info

    def metrics_info(self):
        """Registry rows (scrape time only): the invoke counters and the
        asynchronous feed's dispatch window and ingest lane."""
        win = self._inflight
        lane = self._lane
        return [
            ("nns.filter.invokes", self.invokes),
            ("nns.filter.invoked_frames", self._invoked_frames),
            ("nns.filter.invoke_latency", self.latency_us * 1e-6),
            ("nns.feed.window_occupancy", len(win)),
            ("nns.feed.window_reaped", win.reaped),
            ("nns.feed.dispatch_waits", win.dispatch_waits),
            ("nns.feed.lane_pending", lane.pending() if lane is not None else 0),
            ("nns.feed.lane_staged", lane.staged if lane is not None else 0),
        ]

    def histograms_info(self):
        """The dispatch window's dwell (park to pop), a log2 histogram."""
        return [("nns.feed.window_dwell_seconds", self._inflight.dwell)]
