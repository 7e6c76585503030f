"""Data-dependent flow control: tensor_if, tensor_crop, tensor_rate.

Port of ``nnstreamer_tpu/elements/flow.py``:

* ``tensor_if`` — route or modify frames by comparing a value derived
  from them (a_value / tensor_total_value / all_tensors_total_value /
  tensor_average_value / all_tensors_average_value / custom) against
  supplied operands with one of 10 operators, then one of 8 then/else
  behaviours.  The compared value is computed in float64 as in the JAX
  package; on torch tensors it is reduced on their device and one scalar
  per frame comes back to the host (the decision needs it there: one
  synchronization per frame, unavoidable).  Filled outputs stay on the
  input's device.
* ``tensor_crop`` — crop a raw tensor stream by a second stream of
  regions ``[[x, y, w, h], ...]``; a torch raw frame is sliced on its
  device, only the region tensor goes to the host.
* ``tensor_rate`` — framerate conversion by dropping (``throttle``) or
  also duplicating frames against their pts, with its in/out/duplicate/
  drop counters, and its QoS shedding (``qos``, on by default as in the
  JAX package: ``note_qos`` sheds frames up to a reported late pts).  The
  scheduler calls ``note_qos`` on every upstream ``tensor_rate`` when a
  downstream element drops a frame past its deadline
  (``Pipeline._qos_feedback``).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core import registry
from ..core.buffer import TensorFrame, _is_torch, materialize, stack_tensors
from ..core.sync import Collator, SyncPolicy
from ..core.types import ANY, FORMAT_FLEXIBLE, StreamSpec
from ..pipeline.element import Element, ElementError, Property, TransformElement, element
from .transform import numpy_dtype

# -- tensor_if --------------------------------------------------------------

_OPERATORS: Dict[str, Callable[[float, List[float]], bool]] = {
    "eq": lambda v, s: v == s[0],
    "ne": lambda v, s: v != s[0],
    "gt": lambda v, s: v > s[0],
    "ge": lambda v, s: v >= s[0],
    "lt": lambda v, s: v < s[0],
    "le": lambda v, s: v <= s[0],
    "range_inclusive": lambda v, s: s[0] <= v <= s[1],
    "range_exclusive": lambda v, s: s[0] < v < s[1],
    "not_in_range_inclusive": lambda v, s: not (s[0] <= v <= s[1]),
    "not_in_range_exclusive": lambda v, s: not (s[0] < v < s[1]),
}


def register_if_custom(name: str, fn: Callable[[TensorFrame], bool]) -> None:
    """Register a custom tensor_if predicate (≙ nnstreamer_if_custom_register)."""
    registry.register(registry.KIND_CUSTOM, f"if:{name}", fn)


def unregister_if_custom(name: str) -> bool:
    return registry.unregister(registry.KIND_CUSTOM, f"if:{name}")


_BEHAVIORS = (
    "passthrough", "skip", "fill_zero", "fill_values", "fill_with_file",
    "fill_with_file_rpt", "repeat_previous_frame", "tensorpick",
)


def _zeros_like(t):
    if _is_torch(t):
        import torch

        return torch.zeros_like(t)
    return np.zeros_like(np.asarray(t))


def _full_like(t, value: float):
    if _is_torch(t):
        import torch

        return torch.full_like(t, value)
    return np.full_like(np.asarray(t), value)


def _f64_sum(t):
    """The float64 sum of a tensor: numpy on the host, a 0-dim float64
    tensor on a torch tensor's device."""
    if _is_torch(t):
        import torch

        return t.to(torch.float64).sum()
    return np.asarray(t, dtype=np.float64).sum()


@element("tensor_if")
class TensorIf(Element):
    """Two src pads: 0 = the 'then' branch, 1 = the 'else' branch (when
    linked); the behaviours modify or route the frame per branch."""

    NUM_SRC_PADS = None  # 1 or 2

    PROPERTIES = {
        "compared-value": Property(
            str, "a_value",
            "a_value|tensor_total_value|all_tensors_total_value|"
            "tensor_average_value|all_tensors_average_value|custom"),
        "compared-value-option": Property(
            str, "", "a_value: '<refdims>,<tensor>'; total/avg: tensor idx (all_*: comma "
            "list, empty = all); custom: name"),
        "supplied-value": Property(str, "", "operand(s), comma separated"),
        "operator": Property(str, "gt", "|".join(_OPERATORS)),
        "then": Property(str, "passthrough", "|".join(_BEHAVIORS)),
        "then-option": Property(str, "", "tensorpick indices | fill value(s) | fill file path"),
        "else": Property(str, "skip", "|".join(_BEHAVIORS)),
        "else-option": Property(str, "", "tensorpick indices | fill value(s) | fill file path"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        # repeat_previous_frame: the last frame that left each OUTPUT pad,
        # whichever branch produced it (first frame on a pad: zeros)
        self._prev: Dict[int, TensorFrame] = {}
        self._file_cache: Dict[str, bytes] = {}

    def start(self):
        self._prev = {}
        self._file_cache.clear()
        for which in ("then", "else"):
            if self.props[which].lower() not in _BEHAVIORS:
                raise ElementError(f"{self.name}: unknown behavior {self.props[which]!r}")

    def _tensor_indices(self, opt: str, frame: TensorFrame) -> List[int]:
        if not opt:
            return list(range(len(frame.tensors)))
        return [int(s) for s in opt.split(",") if s != ""]

    def _compared_value(self, frame: TensorFrame) -> float:
        mode = self.props["compared-value"].lower()
        opt = self.props["compared-value-option"]
        if mode == "custom":
            return registry.get(registry.KIND_CUSTOM, f"if:{opt}")(frame)
        if mode == "a_value":
            # "<d0>:<d1>:...,<tensor-idx>", innermost first
            coord_s, _, idx_s = opt.partition(",")
            t = frame.tensors[int(idx_s or "0")]
            arr = t if _is_torch(t) else np.asarray(t)
            coords = [int(c) for c in coord_s.split(":")] if coord_s else []
            # innermost-first -> numpy order; unspecified outer dims = 0
            np_index = tuple(reversed(coords))[-arr.ndim:] if arr.ndim else ()
            np_index = (0,) * (arr.ndim - len(np_index)) + np_index
            return float(arr[np_index] if np_index else arr)
        if mode in ("all_tensors_total_value", "all_tensors_average_value"):
            ts = [frame.tensors[i] for i in self._tensor_indices(opt, frame)]
            sums = [_f64_sum(t) for t in ts]
            if any(_is_torch(s) for s in sums):
                sums = [stack_tensors(sums).sum().item()]  # one scalar to the host
            total = sum(sums)
            if mode.endswith("total_value"):
                return float(total)
            count = sum(int(np.prod(t.shape)) for t in ts)
            return float(total / count) if count else 0.0
        t = frame.tensors[int(opt or "0")]
        if mode == "tensor_total_value":
            return float(_f64_sum(t))
        if mode == "tensor_average_value":
            if _is_torch(t):
                import torch

                return t.to(torch.float64).mean().item()
            return float(np.asarray(t, dtype=np.float64).mean())
        raise ElementError(f"{self.name}: unknown compared-value {mode!r}")

    def _decide(self, frame: TensorFrame) -> bool:
        op = self.props["operator"].lower()
        if op not in _OPERATORS:
            raise ElementError(f"{self.name}: unknown operator {op!r}")
        supplied = [float(s) for s in str(self.props["supplied-value"]).split(",") if s != ""]
        if not supplied:
            raise ElementError(f"{self.name}: supplied-value required")
        return _OPERATORS[op](self._compared_value(frame), supplied)

    def _file_bytes(self, path: str) -> bytes:
        data = self._file_cache.get(path)
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
            self._file_cache[path] = data
        return data

    def _fill_from_bytes(self, frame: TensorFrame, raw: bytes, repeat: bool) -> TensorFrame:
        """fill_with_file(_rpt): tensors refilled from a flat byte blob —
        short files pad with zeros (plain) or cycle (rpt).  A torch tensor
        gets its refill on its own device."""
        outs, off = [], 0
        for t in frame.tensors:
            dtype = numpy_dtype(t) if _is_torch(t) else np.asarray(t).dtype
            shape = tuple(t.shape)
            size = int(np.prod(shape))
            n = size * dtype.itemsize
            if repeat and raw:
                reps = -(-(off + n) // len(raw))  # ceil
                chunk = (raw * reps)[off:off + n]
            else:
                chunk = raw[off:off + n]
            buf = np.zeros(n, np.uint8)
            buf[:len(chunk)] = np.frombuffer(chunk, np.uint8)
            arr = buf.view(dtype)[:size].reshape(shape)
            if _is_torch(t):
                import torch

                arr = torch.from_numpy(arr).to(t.device)
            outs.append(arr)
            off += n
        return frame.with_tensors(outs)

    def _behave(self, frame: TensorFrame, which: str, src_pad: int = 0):
        action = self.props[which].lower()
        option = self.props[f"{which}-option"]
        if action == "passthrough":
            return frame
        if action == "skip":
            return None
        if action == "tensorpick":
            return frame.pick([int(s) for s in option.split(",") if s != ""])
        if action == "fill_zero":
            return frame.with_tensors([_zeros_like(t) for t in frame.tensors])
        if action == "fill_values":
            vals = [float(s) for s in option.split(",") if s != ""]
            if not vals:
                raise ElementError(f"{self.name}: fill_values needs {which}-option")
            return frame.with_tensors([_full_like(t, vals[i] if i < len(vals) else vals[-1])
                                       for i, t in enumerate(frame.tensors)])
        if action in ("fill_with_file", "fill_with_file_rpt"):
            if not option:
                raise ElementError(f"{self.name}: {action} needs {which}-option (file path)")
            return self._fill_from_bytes(frame, self._file_bytes(option), action.endswith("rpt"))
        if action == "repeat_previous_frame":
            prev = self._prev.get(src_pad)
            if prev is None:  # first on this pad: zeros (header contract)
                return frame.with_tensors([_zeros_like(t) for t in frame.tensors])
            return frame.with_tensors(list(prev.tensors))
        raise ElementError(f"{self.name}: unknown behavior {action!r}")

    def handle_frame(self, pad, frame):
        cond = self._decide(frame)
        which = "then" if cond else "else"
        src = 0 if cond else (1 if len(self.srcpads) > 1 and self.srcpads[1].is_linked else 0)
        out = self._behave(frame, which, src)
        if out is None:
            return []
        if out is frame:  # passthrough: stamp a copy, never a shared frame
            out = frame.with_tensors(frame.tensors)
        out.meta["tensor_if"] = which
        self._prev[src] = out
        return [(src, out)]


# -- tensor_crop ------------------------------------------------------------


@element("tensor_crop")
class TensorCrop(Element):
    """sink 0 = raw tensors, sink 1 = crop info [[x, y, w, h], ...];
    output: a flexible stream, one cropped tensor per region."""

    NUM_SINK_PADS = None  # exactly 2 used

    PROPERTIES = {
        "lateness": Property(int, -1, "reference parity (unused)"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._collator: Optional[Collator] = None

    def start(self):
        self._collator = Collator(2, SyncPolicy.from_string("nosync"))

    def derive_spec(self, pad=0):
        return StreamSpec((), FORMAT_FLEXIBLE, None)  # per-buffer shapes vary

    def _crop(self, raw_f: TensorFrame, info_f: TensorFrame):
        img = raw_f.tensors[0]
        if not _is_torch(img):
            img = np.asarray(img)
        regions = materialize(info_f.tensors[:1])[0].reshape(-1, 4).astype(np.int64)
        crops = []
        H, W = img.shape[0], img.shape[1]
        for x, y, w, h in regions:
            x0, y0 = max(0, int(x)), max(0, int(y))
            x1, y1 = min(W, x0 + int(w)), min(H, y0 + int(h))
            if x1 <= x0 or y1 <= y0:
                continue
            crops.append(img[y0:y1, x0:x1])
        out = raw_f.with_tensors(crops if crops else [img[0:0, 0:0]])
        out.meta["crop_regions"] = regions.tolist()
        return out

    def _drain(self):
        out = []
        while (group := self._collator.collect()) is not None:
            out.append((0, self._crop(group[0], group[1])))
        return out

    def handle_frame(self, pad, frame):
        self._collator.push(pad, frame)
        return self._drain()

    def handle_eos(self, pad):
        self._collator.mark_eos(pad)
        return self._drain()


# -- tensor_rate ------------------------------------------------------------


@element("tensor_rate")
class TensorRate(TransformElement):
    """Adjust the frame rate by dropping (and, without ``throttle``,
    duplicating) frames against their pts (≙ gsttensor_rate.c:81-88)."""

    PROPERTIES = {
        "framerate": Property(str, "", "target 'n/d'"),
        "throttle": Property(bool, True, "drop-only (no duplication)"),
        "silent": Property(bool, True, "suppress per-frame counter logs"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
        # downstream deadline misses feed back through note_qos and frames
        # up to the reported late pts are shed here, where dropping is
        # cheapest (the scheduler's feedback: ROADMAP A4.3)
        "qos": Property(bool, True, "honor downstream deadline-miss "
                        "feedback by dropping late-flagged frames here"),
        # read-only counters ≙ gsttensor_rate.c:955-977
        "in": Property(int, 0, "input frame count (read-only)"),
        "out": Property(int, 0, "output frame count (read-only)"),
        "duplicate": Property(int, 0, "duplicated frame count (read-only)"),
        "drop": Property(int, 0, "dropped frame count (read-only)"),
        "qos-dropped": Property(
            int, 0, "frames shed by QoS feedback (read-only; also counted "
            "in drop)"),
    }

    _COUNTER_ATTRS = {"in": "in_frames", "out": "out_frames",
                      "duplicate": "duplicated", "drop": "dropped",
                      "qos-dropped": "qos_dropped"}

    def get_property(self, key):
        attr = self._COUNTER_ATTRS.get(key.replace("_", "-"))
        if attr is not None:
            return getattr(self, attr)
        return super().get_property(key)

    def set_property(self, key, value):
        if key.replace("_", "-") in self._COUNTER_ATTRS:
            raise ElementError(f"{self.name}: {key!r} is read-only")
        super().set_property(key, value)

    def __init__(self, name=None):
        super().__init__(name)
        self._next_ts: Optional[float] = None
        self._last: Optional[TensorFrame] = None
        self.in_frames = self.out_frames = 0
        self.dropped = self.duplicated = 0
        self.qos_dropped = 0
        # frames with pts <= this are shed (a float store/read under the
        # GIL: note_qos comes from downstream threads)
        self._qos_until = float("-inf")

    def start(self):
        self._next_ts = None
        self._last = None
        self.in_frames = self.out_frames = 0
        self.dropped = self.duplicated = 0
        self.qos_dropped = 0
        self._qos_until = float("-inf")

    def note_qos(self, pts: Optional[float], lateness: float) -> None:
        """Deadline-miss feedback from downstream: shed frames up to the
        late frame's pts plus the observed lateness (≙ a QoS event's
        timestamp + jitter in gsttensor_rate.c)."""
        if not self.props["qos"] or pts is None:
            return
        until = pts + max(0.0, lateness)
        if until > self._qos_until:
            self._qos_until = until

    def _period(self) -> Optional[float]:
        fr = self.props["framerate"]
        if not fr:
            return None
        n, _, d = fr.partition("/")
        return float(Fraction(int(d or 1), int(n)))

    def derive_spec(self, pad=0):
        in_spec = self.sink_specs.get(0, ANY)
        period = self._period()
        if period is None or not in_spec.tensors:
            return in_spec
        return StreamSpec(in_spec.tensors, in_spec.fmt,
                          Fraction(1) / Fraction(period).limit_denominator(10**6))

    def transform(self, frame):
        self.in_frames += 1
        if frame.pts is not None and frame.pts <= self._qos_until:
            self.dropped += 1
            self.qos_dropped += 1
            if not self.props["silent"]:
                self.log.info("rate: qos-shed pts=%.4f (until %.4f)", frame.pts,
                              self._qos_until)
            return None
        period = self._period()
        if period is None or frame.pts is None:
            self.out_frames += 1
            return frame
        if self._next_ts is None:
            self._next_ts = frame.pts
        outs = []
        if not self.props["throttle"] and self._last is not None:  # fill gaps
            while frame.pts - self._next_ts >= period:
                dup = self._last.with_tensors(list(self._last.tensors))
                dup.pts = self._next_ts
                outs.append(dup)
                self.duplicated += 1
                self._next_ts += period
        if frame.pts >= self._next_ts:
            f = frame.with_tensors(list(frame.tensors))
            f.pts = self._next_ts
            self._next_ts += period
            self._last = frame
            outs.append(f)
        else:
            self.dropped += 1
            if not self.props["silent"]:
                self.log.info("rate: in=%d out=%d dup=%d drop=%d", self.in_frames,
                              self.out_frames, self.duplicated, self.dropped)
        self.out_frames += len(outs)
        if not outs:
            return None
        return outs[0] if len(outs) == 1 else outs

    def handle_frame(self, pad, frame):
        out = self.transform(frame)
        if out is None:
            return []
        if isinstance(out, list):
            return [(0, f) for f in out]
        return [(0, out)]
