"""The dense-layer factory of the transformer and ViT blocks.

Port of ``nnstreamer_tpu/models/_quant_flax.py`` ``dense_or_quant``,
reduced to the float layer: a bias-free ``nn.Linear`` in the compute dtype.
The int8 layers (``quantize:int8``) wait for ROADMAP A6.
"""

from __future__ import annotations

import torch
from torch import nn


def dense_or_quant(quant: bool, in_features: int, features: int, dtype: torch.dtype) -> nn.Linear:
    """A bias-free dense layer; ``quant`` (int8) is not ported yet."""
    if quant:
        raise NotImplementedError(
            "quantize:int8 is not ported to nnstreamer_tpu_torch yet (ROADMAP A6)")
    return nn.Linear(in_features, features, bias=False, dtype=dtype)
