"""The dense-layer factory of the transformer and ViT blocks.

Port of ``nnstreamer_tpu/models/_quant_flax.py`` ``dense_or_quant``,
reduced to the float layer: a bias-free ``nn.Linear`` in the compute dtype.
The int8 layers (``quantize:int8``) wait for ROADMAP A6; the convolutional
builds refuse the prop through :func:`refuse_int8`.
"""

from __future__ import annotations

import torch
from torch import nn


def refuse_int8(props) -> None:
    """Raise for ``quantize:int8``, which is not ported yet."""
    if props.get("quantize", "") == "int8":
        raise NotImplementedError(
            "quantize:int8 is not ported to nnstreamer_tpu_torch yet (ROADMAP A6)")


def dense_or_quant(quant: bool, in_features: int, features: int, dtype: torch.dtype) -> nn.Linear:
    """A bias-free dense layer; ``quant`` (int8) is not ported yet."""
    refuse_int8({"quantize": "int8" if quant else ""})
    return nn.Linear(in_features, features, bias=False, dtype=dtype)
