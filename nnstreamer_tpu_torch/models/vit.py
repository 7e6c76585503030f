"""ViT image classifier (PyTorch).

Port of ``nnstreamer_tpu/models/vit.py`` (Dosovitskiy et al. 2021): uint8
NHWC frames are scaled to [-1, 1] in the compute dtype (``x * (2/255) -
1``, as the JAX model does; not the ``normalize_u8`` kernel, which rounds
once where this rounds twice), patchified by one stride-``patch`` VALID
convolution with bias, prefixed with a ``cls`` token and added to
``pos_embed``; pre-norm encoder blocks (the transformer's, not causal),
a final LayerNorm, and a float32 ``head`` with bias on token 0.
``attn:flash`` runs the flash kernel, ``attn:xla`` (the default) the plain
reference.

:func:`state_dict_from_flax` converts the JAX package's params.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ._init_util import init_seeded
from .transformer import _DTYPES, Block, LayerNorm, _np, block_state_from_flax


class EncoderBlock(Block):
    """The transformer's pre-norm block with bidirectional attention."""

    causal = False


class ViT(nn.Module):
    """NHWC (N, S, S, 3) uint8 or float -> float32 logits (N, classes)."""

    def __init__(self, size: int = 224, patch: int = 16, d_model: int = 192, n_heads: int = 3,
                 n_layers: int = 6, d_ff: int = 768, num_classes: int = 1001,
                 dtype: torch.dtype = torch.bfloat16, attn_impl: str = "xla", quant: bool = False):
        super().__init__()
        if size % patch:
            raise ValueError(f"size {size} not divisible by patch {patch}")
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, d_model, patch, stride=patch, dtype=dtype)
        self.cls = nn.Parameter(torch.zeros(1, 1, d_model, dtype=dtype))
        self.pos_embed = nn.Parameter(torch.zeros(1, (size // patch) ** 2 + 1, d_model, dtype=dtype))
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, n_heads, d_ff, dtype, attn_impl, quant) for _ in range(n_layers))
        self.ln_f = LayerNorm(d_model, dtype)
        self.head = nn.Linear(d_model, num_classes)  # float32

    def init_weights(self, seed: int) -> "ViT":
        """Seeded random weights (``init_seeded``); ``cls`` 0 and
        ``pos_embed`` normal with std 0.02, as flax initializes them."""
        init_seeded(self, seed)
        g = torch.Generator().manual_seed(seed + 1)
        with torch.no_grad():
            self.cls.zero_()
            self.pos_embed.copy_(torch.randn(self.pos_embed.shape, generator=g) * 0.02)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            return self(x[None])[0]
        if x.dtype == torch.uint8:
            x = x.to(self.dtype) * (2.0 / 255.0) - 1.0
        else:
            x = x.to(self.dtype)
        x = self.patch_embed(x.permute(0, 3, 1, 2))  # (B, D, S/p, S/p)
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)  # (B, T, D), tokens in row-major patch order
        x = torch.cat([self.cls.expand(b, -1, -1), x], dim=1) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        return self.head(self.ln_f(x)[:, 0].float())


def build(custom_props=None):
    """Zoo entry: returns (module, in_spec, out_spec); module(images_u8
    (N, size, size, 3)) -> logits (N, classes).  Props: size (224), patch
    (16), d_model (192), heads (3), layers (6), d_ff (768), classes (1001),
    dtype, attn (xla | flash), seed — the JAX build's, with its defaults."""
    props = custom_props or {}
    size = int(props.get("size", "224"))
    model = ViT(
        size=size,
        patch=int(props.get("patch", "16")),
        d_model=int(props.get("d_model", "192")),
        n_heads=int(props.get("heads", "3")),
        n_layers=int(props.get("layers", "6")),
        d_ff=int(props.get("d_ff", "768")),
        num_classes=int(props.get("classes", "1001")),
        dtype=_DTYPES[props.get("dtype", "bfloat16")],
        attn_impl=props.get("attn", "xla"),
        quant=props.get("quantize", "") == "int8",
    ).init_weights(int(props.get("seed", "0")))
    in_spec = StreamSpec((TensorSpec((size, size, 3), np.uint8, "image"),), FORMAT_STATIC)
    out_spec = StreamSpec(
        (TensorSpec((model.head.out_features,), np.float32, "logits"),), FORMAT_STATIC)
    return model, in_spec, out_spec


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ViT variables ``{"params": ...}`` as this module's
    ``state_dict``: the patch conv's HWIO kernel becomes OIHW, Dense
    kernels (in, out) become (out, in), LayerNorm ``scale``/``bias`` become
    ``weight``/``bias``."""
    params = variables["params"]
    sd = {
        "patch_embed.weight": _np(np.asarray(params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)),
        "patch_embed.bias": _np(params["patch_embed"]["bias"]),
        "cls": _np(params["cls"]),
        "pos_embed": _np(params["pos_embed"]),
        "ln_f.weight": _np(params["ln_f"]["scale"]),
        "ln_f.bias": _np(params["ln_f"]["bias"]),
        "head.weight": _np(np.asarray(params["head"]["kernel"]).T),
        "head.bias": _np(params["head"]["bias"]),
    }
    i = 0
    while f"block{i}" in params:
        sd.update(block_state_from_flax(f"blocks.{i}", params[f"block{i}"]))
        i += 1
    return sd
