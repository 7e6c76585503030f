"""tensor_transform: elementwise ops on tensor streams.

Port of ``nnstreamer_tpu/elements/transform.py``: ``typecast``,
``arithmetic`` (chained add/sub/mul/div with optional typecast, per-channel
``a|b|c`` vectors on the innermost dim), ``transpose`` and ``dimchg``
(reference dims, innermost first), ``stand`` and ``clamp``, with
``apply=`` naming the tensors the op applies to.

Two routes, chosen per tensor:

* numpy arrays take the numpy route, exactly as in the JAX package;
* torch tensors take the torch route on their own device: a CUDA tensor
  never passes through numpy.  The torch route gives, op by op, the dtype
  and the values the numpy route gives for the same input: each step's
  result dtype is taken from numpy's promotion (a zero probe of the
  input's dtype through the same op), both operands are cast to it, and a
  scalar operand becomes a 0-dim tensor of that dtype on the device (a
  Python-scalar divisor would let CUDA multiply by its reciprocal, which
  is not the correctly rounded quotient).  ``stand`` takes the population
  std (``correction=0``, numpy's ``ddof=0``).  A dtype with no torch
  counterpart raises; nothing falls back to numpy.

Option dialects follow the reference:
  * ``mode=typecast option=float32``
  * ``mode=arithmetic option=typecast:float32,add:-127.5,div:127.5``
  * ``mode=transpose option=1:0:2:3`` (reference dims, innermost-first)
  * ``mode=dimchg option=0:2`` (move reference-dim 0 to position 2)
  * ``mode=stand option=default|dc-average[:dtype]``
  * ``mode=clamp option=min:max``
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.buffer import TensorFrame, _is_torch
from ..core.types import (
    ANY,
    StreamSpec,
    TensorSpec,
    dtype_from_name,
    dtype_to_name,
    ref_dim_to_axis,
)
from ..pipeline.element import ElementError, Property, TransformElement, element

# the dtypes with a torch route (uint16/32/64 have no torch arithmetic on
# the card)
_TORCH_NAMES = ("int8", "uint8", "int16", "int32", "int64", "float16", "float32", "float64",
                "bfloat16")


def torch_dtype(dtype: np.dtype):
    """The torch dtype of a numpy dtype; ElementError where there is none."""
    import torch

    name = dtype_to_name(dtype)
    if name not in _TORCH_NAMES:
        raise ElementError(f"tensor_transform: no torch route for dtype {name}")
    return getattr(torch, name)


def numpy_dtype(t) -> np.dtype:
    """The numpy dtype of a torch tensor's dtype (the schema's vocabulary)."""
    return dtype_from_name(str(t.dtype).rpartition(".")[2])


def _ref_axes_to_numpy_perm(ref_perm: List[int], rank: int) -> List[int]:
    """A reference-dialect transpose spec (innermost-first dims) as a numpy
    axis permutation."""
    if sorted(ref_perm) != list(range(rank)):
        raise ElementError(f"transpose option must be a permutation, got {ref_perm}")
    return [rank - 1 - ref_perm[rank - 1 - j] for j in range(rank)]


class _Op:
    """A parsed transform op: numpy route, torch route, spec -> spec."""

    def __init__(self, apply: Callable, torch_apply: Callable,
                 spec: Callable[[TensorSpec], TensorSpec]):
        self.apply = apply
        self.torch_apply = torch_apply
        self.spec = spec


def _operand(torch, v, dtype, device):
    """A scalar or per-channel operand as a tensor of `dtype` on `device`."""
    return torch.as_tensor(np.asarray(v).astype(dtype), device=device)


@element("tensor_transform")
class TensorTransform(TransformElement):
    PROPERTIES = {
        "mode": Property(str, "", "typecast|arithmetic|transpose|dimchg|stand|clamp"),
        "option": Property(str, "", "mode-specific option string"),
        "acceleration": Property(bool, True, "kept for reference parity (no-op)"),
        "max-buffers": Property(int, 0, "mailbox depth override"),
        "apply": Property(str, "", "tensor indices to transform (empty = all)"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._op: Optional[_Op] = None
        self._apply_idx: Optional[set] = None
        #: tensors transformed by the torch route since start()
        self.torch_applied = 0

    # -- option parsing (once at start; the hot path stays parse-free) ------
    def start(self):
        mode = self.props["mode"]
        if not mode:
            raise ElementError(f"{self.name}: tensor_transform requires mode=")
        builder = getattr(self, f"_build_{mode.replace('-', '_')}", None)
        if builder is None:
            raise ElementError(f"{self.name}: unknown transform mode {mode!r}")
        self._op = builder(self.props["option"])
        apply_opt = self.props["apply"]
        self._apply_idx = ({int(x) for x in apply_opt.split(",") if x.strip()}
                           if apply_opt else None)
        if self._apply_idx is not None and any(i < 0 for i in self._apply_idx):
            raise ElementError(f"{self.name}: apply indices must be >= 0 "
                               f"(got {sorted(self._apply_idx)})")
        self.torch_applied = 0

    def _build_typecast(self, option: str) -> _Op:
        dtype = dtype_from_name(option)

        def torch_apply(a):
            return a.to(torch_dtype(dtype))

        return _Op(lambda a: a.astype(dtype), torch_apply,
                   lambda t: TensorSpec(t.shape, dtype, t.name))

    def _build_arithmetic(self, option: str) -> _Op:
        # "typecast:float32,add:-127.5,div:127.5", applied in order; values
        # may be per-channel vectors "add:1|2|3" (innermost dim)
        steps: List[Tuple[str, Any]] = []
        for part in option.split(","):
            part = part.strip()
            if not part:
                continue
            op, _, val = part.partition(":")
            op = op.strip().lower()
            if op == "typecast":
                steps.append(("typecast", dtype_from_name(val)))
            elif op in ("add", "sub", "mul", "div"):
                vals = [float(v) for v in val.split("|")]
                steps.append((op, vals[0] if len(vals) == 1 else np.asarray(vals)))
            else:
                raise ElementError(f"unknown arithmetic op {op!r}")
        if not steps:
            raise ElementError("arithmetic mode requires option=")

        def step(a, op, v):
            if op == "typecast":
                return a.astype(v)
            if op == "add":
                return a + v
            if op == "sub":
                return a - v
            if op == "mul":
                return a * v
            return a / v

        def apply(a):
            for op, v in steps:
                a = step(a, op, v)
            return a

        # per input dtype: each step's result dtype under numpy's promotion
        plans: Dict[np.dtype, List[np.dtype]] = {}

        def plan(dtype: np.dtype) -> List[np.dtype]:
            if dtype not in plans:
                probe, out = np.zeros((1,), dtype), []
                for op, v in steps:
                    probe = step(probe, op, v)
                    out.append(probe.dtype)
                plans[dtype] = out
            return plans[dtype]

        def torch_apply(a):
            import torch

            for (op, v), dtype in zip(steps, plan(numpy_dtype(a))):
                a = a.to(torch_dtype(dtype))
                if op != "typecast":  # torch.add / sub / mul / div
                    a = getattr(torch, op)(a, _operand(torch, v, dtype, a.device))
            return a

        def spec(t: TensorSpec) -> TensorSpec:
            return TensorSpec(t.shape, plan(t.dtype)[-1], t.name)

        return _Op(apply, torch_apply, spec)

    def _build_transpose(self, option: str) -> _Op:
        ref_perm = [int(x) for x in option.split(":") if x != ""]
        if len(set(ref_perm)) != len(ref_perm):
            raise ElementError(f"transpose option has duplicate axes: {option!r}")

        def apply(a):
            return a.transpose(_ref_axes_to_numpy_perm(ref_perm, a.ndim))

        def torch_apply(a):
            return a.permute(_ref_axes_to_numpy_perm(ref_perm, a.ndim))

        def spec(t: TensorSpec) -> TensorSpec:
            if not t.is_static:
                return t
            perm = _ref_axes_to_numpy_perm(ref_perm, len(t.shape))
            return TensorSpec(tuple(t.shape[p] for p in perm), t.dtype, t.name)

        return _Op(apply, torch_apply, spec)

    def _build_dimchg(self, option: str) -> _Op:
        a_s, _, b_s = option.partition(":")
        ref_from, ref_to = int(a_s), int(b_s)

        def axes(rank):
            return ref_dim_to_axis(ref_from, rank), ref_dim_to_axis(ref_to, rank)

        def torch_apply(a):
            import torch

            return torch.movedim(a, *axes(a.ndim))

        def spec(t: TensorSpec) -> TensorSpec:
            if not t.is_static:
                return t
            src, dst = axes(len(t.shape))
            dims = list(t.shape)
            dims.insert(dst, dims.pop(src))
            return TensorSpec(tuple(dims), t.dtype, t.name)

        return _Op(lambda a: np.moveaxis(a, *axes(a.ndim)), torch_apply, spec)

    def _build_stand(self, option: str) -> _Op:
        parts = (option or "default").split(":")
        kind = parts[0] or "default"
        dtype = dtype_from_name(parts[1]) if len(parts) > 1 else np.dtype(np.float32)
        if kind not in ("default", "dc-average"):
            raise ElementError(f"unknown stand option {kind!r}")

        def apply(a):
            a = a.astype(dtype)
            if kind == "dc-average":
                return a - np.mean(a)
            return (a - np.mean(a)) / (np.std(a) + dtype.type(1e-10))

        def torch_apply(a):
            a = a.to(torch_dtype(dtype))
            if kind == "dc-average":
                return a - a.mean()
            return (a - a.mean()) / (a.std(correction=0) + 1e-10)

        return _Op(apply, torch_apply, lambda t: TensorSpec(t.shape, dtype, t.name))

    def _build_clamp(self, option: str) -> _Op:
        lo_s, _, hi_s = option.partition(":")
        lo, hi = float(lo_s), float(hi_s)
        if lo > hi:
            raise ElementError(f"clamp: min {lo} > max {hi}")

        def torch_apply(a):
            import torch

            # numpy's clip promotes with its bounds (uint8 with float
            # bounds gives float64): the same dtype here
            out = np.clip(np.zeros((1,), numpy_dtype(a)), lo, hi).dtype
            return torch.clamp(a.to(torch_dtype(out)), lo, hi)

        # the spec keeps the input dtype as the JAX package declares it,
        # although numpy's clip of an integer tensor gives float64
        return _Op(lambda a: np.clip(a, lo, hi), torch_apply, lambda t: t)

    # -- negotiation / processing -------------------------------------------
    def _applies(self, i: int) -> bool:
        return self._apply_idx is None or i in self._apply_idx

    def accept_spec(self, pad, spec):
        # a typo'd apply index fails at negotiation, not as a silent no-op
        if self._apply_idx is not None and spec.tensors:
            bad = [i for i in self._apply_idx if i >= len(spec.tensors)]
            if bad:
                raise ElementError(f"{self.name}: apply indices {sorted(bad)} out of range "
                                   f"for a {len(spec.tensors)}-tensor stream")
        return spec

    def derive_spec(self, pad=0):
        in_spec = self.sink_specs.get(0, ANY)
        if self._op is None or not in_spec.tensors:
            return in_spec
        return StreamSpec(
            tuple(self._op.spec(t) if self._applies(i) else t
                  for i, t in enumerate(in_spec.tensors)),
            in_spec.fmt, in_spec.framerate)

    def _apply(self, t):
        if _is_torch(t):
            self.torch_applied += 1
            return self._op.torch_apply(t)
        return self._op.apply(t)

    def transform(self, frame: TensorFrame) -> TensorFrame:
        assert self._op is not None, f"{self.name} not started"
        return frame.with_tensors([self._apply(t) if self._applies(i) else t
                                   for i, t in enumerate(frame.tensors)])
