"""Drop-in int8 layers (``quantize:int8``, ``ops/quantize.py``).

Port of ``nnstreamer_tpu/models/_quant_flax.py``.  :class:`QuantConv2d`
and :class:`QuantLinear` are a bias-free ``nn.Conv2d`` (TensorFlow SAME
padding) and ``nn.Linear`` whose forward runs int8 x int8 -> int32 with
per-output-channel weight scales and per-sample (per-row) activation
scales.  They keep the float ``weight`` as their only parameter, so their
``state_dict`` keys are the float layers' and one converted tree loads
into either build, as the JAX build's ``name="Conv_0"`` keeps the two
param trees equal.  The weight stays float32 whatever the compute dtype
(:func:`to_compute`): it is what the JAX layer quantizes.  The output
takes the input's dtype, the compute dtype, as the JAX layer's ``dtype``.

The int8 weight and its scales are cached per weight version
(``weight._version``, ``data_ptr``, device) in a plain attribute, not in
the ``state_dict``; the JAX graph re-quantizes on every call, to the same
values.  A traced module has no version to key on: its program quantizes
the weight on every call, through the ``quantize_rows`` operator.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import _oplib
from ..ops.quantize import Quantized, int8_conv, int8_dense, quantize_weight


class _QWeightCache:
    """The int8 weight of ``self.weight``, quantized once per version."""

    _qweight: Optional[Tuple[tuple, Quantized]] = None

    def qweight(self) -> Quantized:
        w = self.weight
        if _oplib.tracing():
            return quantize_weight(w.detach())
        key = (w._version, w.data_ptr(), w.device)
        if self._qweight is None or self._qweight[0] != key:
            with torch.no_grad():
                self._qweight = (key, quantize_weight(w.detach()))
        return self._qweight[1]


class QuantConv2d(_QWeightCache, nn.Conv2d):
    """A bias-free SAME-padded Conv2d on the int8 path; it pads itself, so
    callers pass the unpadded input (channels_last on CUDA)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1):
        super().__init__(cin, cout, kernel, stride, padding=0, groups=groups, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_conv(x, self.weight, self.stride[0], self.groups, x.dtype, self.qweight())


class QuantLinear(_QWeightCache, nn.Linear):
    """A bias-free Linear on the int8 path."""

    def __init__(self, in_features: int, features: int):
        super().__init__(in_features, features, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense(x, self.weight, x.dtype, self.qweight())


def dense_or_quant(quant: bool, in_features: int, features: int,
                   dtype: torch.dtype) -> nn.Linear:
    """The bias-free dense layer of the transformer and ViT blocks: an
    ``nn.Linear`` in the compute dtype, or a :class:`QuantLinear` under
    int8 (its weight float32) — one switch for both families."""
    if quant:
        return QuantLinear(in_features, features)
    return nn.Linear(in_features, features, bias=False, dtype=dtype)


def to_compute(part: nn.Module, dtype: torch.dtype) -> None:
    """Cast `part` to the compute dtype in ``channels_last``, except the
    int8 layers' float weights, which stay float32."""
    keep = {m: m.weight.detach().clone() for m in part.modules()
            if isinstance(m, (QuantConv2d, QuantLinear))}
    part.to(dtype=dtype, memory_format=torch.channels_last)
    for m, w in keep.items():
        m.weight = nn.Parameter(w)
