"""Decoder-only transformer LM (PyTorch), full-sequence logits.

Port of ``nnstreamer_tpu/models/transformer.py``, reduced to the zoo's
logits entry: tokens (B, T) int32 -> logits (B, T, vocab) float32, one
causal pass over the whole sequence.  The block is pre-norm (flax
LayerNorm: eps 1e-6, statistics in float32), its dense layers bias-free in
the compute dtype, GELU the tanh approximation (``jax.nn.gelu``'s
default); ``lm_head`` is bias-free and runs in float32.  Attention:
``attn:flash`` runs the flash kernel (``ops/flash_attention.py``),
``attn:xla`` (the default) the plain reference
(``parallel/ring_attention.py``).  The KV-cache generation path
(``generate:<N>``, decode, slotted batching) and the sharded mesh path
wait for the generation slice (ROADMAP A7).

:func:`state_dict_from_flax` converts the JAX package's params.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ..ops.flash_attention import flash_attention
from ..parallel.ring_attention import reference_attention
from ._init_util import init_seeded
from ._quant_flax import dense_or_quant

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# props of paths this slice does not port
_GENERATION_PROPS = ("generate", "decode", "slotted", "mesh")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    max_seq: int = 256
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "xla"  # xla (plain reference) | flash (the CUDA kernel)
    quant: bool = False  # int8 dense layers (not ported: ROADMAP A6)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=...)``: eps 1e-6, float32 parameters,
    statistics and affine in float32, output cast to the compute dtype."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, 1e-6).to(self.dtype)


class Block(nn.Module):
    """Pre-norm attention + MLP block.  Each head is a contiguous D/H
    chunk of q, of k and of v (``jnp.split(qkv, 3, -1)`` then a reshape),
    so converted weights compute the same heads."""

    causal = True

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dtype: torch.dtype,
                 attn_impl: str = "xla", quant: bool = False):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} is not divisible by heads {n_heads}")
        self.n_heads, self.attn_impl = n_heads, attn_impl
        self.ln1 = LayerNorm(d_model, dtype)
        self.attn_qkv = dense_or_quant(quant, d_model, 3 * d_model, dtype)
        self.attn_out = dense_or_quant(quant, d_model, d_model, dtype)
        self.ln2 = LayerNorm(d_model, dtype)
        self.mlp_up = dense_or_quant(quant, d_model, d_ff, dtype)
        self.mlp_down = dense_or_quant(quant, d_ff, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        # (B, T, H, D/H) views of the projection: the kernel reads them
        # through their strides, no transpose copy
        q, k, v = (a.reshape(b, t, self.n_heads, d // self.n_heads)
                   for a in self.attn_qkv(self.ln1(x)).split(d, dim=-1))
        if self.attn_impl == "flash":
            a = flash_attention(q, k, v, causal=self.causal)
        else:
            a = reference_attention(q, k, v, causal=self.causal)
        x = x + self.attn_out(a.reshape(b, t, d))
        h = F.gelu(self.mlp_up(self.ln2(x)), approximate="tanh")
        return x + self.mlp_down(h)


class TransformerLM(nn.Module):
    """tokens (B, T) or (T,) int -> logits (B, T, vocab) or (T, vocab) float32."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab, cfg.d_model, dtype=cfg.dtype)
        self.pos_embed = nn.Embedding(cfg.max_seq, cfg.d_model, dtype=cfg.dtype)
        self.blocks = nn.ModuleList(
            Block(cfg.d_model, cfg.n_heads, cfg.d_ff, cfg.dtype, cfg.attn_impl, cfg.quant)
            for _ in range(cfg.n_layers))
        self.ln_f = LayerNorm(cfg.d_model, cfg.dtype)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab, bias=False)  # float32

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.dim() == 1:
            return self(tokens[None])[0]
        t = tokens.shape[1]
        if t > self.cfg.max_seq:
            raise ValueError(f"{t} tokens exceed the model's seq {self.cfg.max_seq}")
        x = self.embed(tokens) + self.pos_embed.weight[:t]
        for block in self.blocks:
            x = block(x)
        return self.lm_head(self.ln_f(x).float())


def _cfg_from_props(props: Dict[str, str]) -> TransformerConfig:
    return TransformerConfig(
        vocab=int(props.get("vocab", "256")),
        d_model=int(props.get("d_model", "128")),
        n_heads=int(props.get("heads", "4")),
        n_layers=int(props.get("layers", "2")),
        d_ff=int(props.get("d_ff", "512")),
        max_seq=int(props.get("seq", "256")),
        dtype=_DTYPES[props.get("dtype", "bfloat16")],
        attn_impl=props.get("attn", "xla"),
        quant=props.get("quantize", "") == "int8",
    )


def build(custom_props=None):
    """Zoo entry, the logits path: returns (module, in_spec, out_spec) with
    tokens (T,) int32 in and logits (T, vocab) float32 out per frame.
    Props: vocab, d_model, heads, layers, d_ff, seq, dtype, attn, seed —
    the JAX build's, with its defaults."""
    props = custom_props or {}
    for key in _GENERATION_PROPS:
        if key in props and not (key == "generate" and int(props[key]) <= 0):
            raise NotImplementedError(
                f"transformer {key}: generation (KV cache, decode, slotted batching) and the "
                "mesh path are not ported to nnstreamer_tpu_torch yet (ROADMAP A7)")
    cfg = _cfg_from_props(props)
    model = init_seeded(TransformerLM(cfg), int(props.get("seed", "0")))
    in_spec = StreamSpec((TensorSpec((None,), np.int32, "tokens"),), FORMAT_STATIC)
    out_spec = StreamSpec((TensorSpec((None, cfg.vocab), np.float32, "logits"),), FORMAT_STATIC)
    return model, in_spec, out_spec


def _np(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))  # a private, writable copy


def block_state_from_flax(prefix: str, p: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """One flax block's params (``ln1``, ``attn_qkv``, ``attn_out``,
    ``ln2``, ``mlp_up``, ``mlp_down``) as :class:`Block` state under
    `prefix`: Dense kernels (in, out) become (out, in), LayerNorm
    ``scale``/``bias`` become ``weight``/``bias``."""
    sd = {}
    for ln in ("ln1", "ln2"):
        sd[f"{prefix}.{ln}.weight"] = _np(p[ln]["scale"])
        sd[f"{prefix}.{ln}.bias"] = _np(p[ln]["bias"])
    for dense in ("attn_qkv", "attn_out", "mlp_up", "mlp_down"):
        sd[f"{prefix}.{dense}.weight"] = _np(np.asarray(p[dense]["kernel"]).T)
    return sd


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's TransformerLM variables ``{"params": ...}`` as
    this module's ``state_dict``."""
    params = variables["params"]
    sd = {
        "embed.weight": _np(params["embed"]["embedding"]),
        "pos_embed.weight": _np(params["pos_embed"]["embedding"]),
        "ln_f.weight": _np(params["ln_f"]["scale"]),
        "ln_f.bias": _np(params["ln_f"]["bias"]),
        "lm_head.weight": _np(np.asarray(params["lm_head"]["kernel"]).T),
    }
    i = 0
    while f"block{i}" in params:
        sd.update(block_state_from_flax(f"blocks.{i}", params[f"block{i}"]))
        i += 1
    return sd
