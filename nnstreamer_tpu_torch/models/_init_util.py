"""Seeded random weights for the zoo's transformer-family modules.

The JAX package initializes with flax's initializers from a PRNG key
(``nnstreamer_tpu/models/_init_util.py``); the two frameworks cannot draw
the same numbers from one seed, so the port keeps the initializers' scales
and draws from one CPU ``torch.Generator``, the same model on every device.
Parity tests load converted flax weights instead.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def init_seeded(module: nn.Module, seed: int) -> nn.Module:
    """Linear and Conv2d weights normal with std 1/sqrt(fan_in) (flax's
    lecun_normal scale), biases 0; Embedding rows normal with std
    1/sqrt(width) (flax's Embed scale).  Draws in module order."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / math.sqrt(fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) / math.sqrt(m.embedding_dim))
    return module
