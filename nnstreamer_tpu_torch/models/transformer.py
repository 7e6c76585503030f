"""Decoder-only transformer LM (PyTorch): full-sequence logits and
KV-cache generation.

Port of ``nnstreamer_tpu/models/transformer.py``.  The block is pre-norm
(flax LayerNorm: eps 1e-6, statistics in float32), its dense layers
bias-free in the compute dtype, GELU the tanh approximation
(``jax.nn.gelu``'s default); ``lm_head`` is bias-free and runs in float32.

* Logits entry: tokens (B, T) int32 -> logits (B, T, vocab) float32, one
  causal pass.  ``attn:flash`` runs the flash kernel
  (``ops/flash_attention.py``; ``flash_attention_grad``, its recompute
  backward, where grad mode is on and q needs a gradient, as in training),
  ``attn:xla`` (the default) the plain reference
  (``parallel/ring_attention.py``).
* Generation (``generate:<N>``, :func:`make_stream_generate`,
  :class:`SlotModel`): the forward with a :class:`KVCache`.  Attention
  over the cache is the reference's dense float32 computation whatever
  ``attn`` says (the JAX package's decode branch never reaches its
  kernel): the new K/V rows are written at each row's position, then q
  and the whole cache in float32, ``scores / sqrt(D/H)``, positions past
  each query masked to -1e30, softmax, the value product in float32 and
  a cast back to the compute dtype.  Sampling (:func:`make_pick`) draws
  the JAX package's threefry bits (``ops/threefry.py``).
* ``quantize:int8``: each block's ``attn_qkv``, ``attn_out``, ``mlp_up``
  and ``mlp_down`` run int8 (:class:`._quant_flax.QuantLinear`, one
  activation scale per token, so a slot's neighbours never change its
  result); ``lm_head`` stays float32, as in the JAX build.

The sharded mesh path waits for the parallel slice (ROADMAP A11).
:func:`state_dict_from_flax` converts the JAX package's params.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ..ops.flash_attention import flash_attention, flash_attention_grad
from ..ops.threefry import Key, fold_in, gumbel, prng_key
from ..parallel.ring_attention import reference_attention
from ._init_util import init_seeded
from ._quant_flax import dense_or_quant

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


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
    quant: bool = False  # int8 dense layers (_quant_flax.QuantLinear)


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


class KVCache:
    """The generation path's cache: K and V pages of every layer,
    ``(layers, B, max_seq, H, D/H)`` in the compute dtype, allocated once,
    and each row's write position ``pos`` (B,) int64.

    The JAX package keeps a per-layer ``index`` and a model-level ``step``
    (scalars unslotted, (S,) vectors slotted); they advance together and
    always hold the same value, so one vector serves both here (a scalar
    position is the vector with B equal entries).  A row (one slot) is
    :meth:`row`, a B = 1 view whose writes land in this cache."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor):
        self.k, self.v, self.pos = k, v, pos

    @classmethod
    def zeros(cls, cfg: "TransformerConfig", batch: int, device) -> "KVCache":
        shape = (cfg.n_layers, batch, cfg.max_seq, cfg.n_heads, cfg.d_model // cfg.n_heads)
        return cls(torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(shape, dtype=cfg.dtype, device=device),
                   torch.zeros(batch, dtype=torch.int64, device=device))

    def row(self, b: int) -> "KVCache":
        return KVCache(self.k[:, b:b + 1], self.v[:, b:b + 1], self.pos[b:b + 1])

    def reset_row(self, b: int) -> None:
        """Zero one row's pages and position (its neighbours untouched)."""
        self.k[:, b].zero_()
        self.v[:, b].zero_()
        self.pos[b] = 0

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.k, self.v, self.pos))


def cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ck: torch.Tensor,
                     cv: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Attention over one layer's cache pages ``ck``/``cv`` (B, S, H, D)
    after writing the new rows ``k``/``v`` (B, T, H, D) at ``[rows, cols]``
    ((B, 1) and (B, T) positions, kept inside ``[0, S)`` by the caller);
    ``mask`` (B, 1, T, S) lets query i of row b see cache positions
    ``<= cols[b, i]``.  The JAX decode branch's float32 computation
    (``transformer.py:122-135``, ``:163-176``): q and the whole cache in
    float32, scores over sqrt(D), -1e30 where masked, softmax, the value
    product, a cast back.  The products are batched matmuls over
    (B, H) of the cache's float32 copy laid out (B, H, S, D), which is
    the einsums' contraction without their layout copies."""
    ck[rows, cols] = k
    cv[rows, cols] = v
    kf, vf = (c.transpose(1, 2).to(torch.float32, memory_format=torch.contiguous_format)
              for c in (ck, cv))
    s = torch.matmul(q.float().transpose(1, 2), kf.transpose(2, 3)) / math.sqrt(q.shape[-1])
    s = torch.where(mask, s, -1e30)
    out = torch.matmul(torch.softmax(s, dim=-1), vf).transpose(1, 2)
    return out.to(q.dtype, memory_format=torch.contiguous_format)


class Block(nn.Module):
    """Pre-norm attention + MLP block.  Each head is a contiguous D/H
    chunk of q, of k and of v (``jnp.split(qkv, 3, -1)`` then a reshape),
    so converted weights compute the same heads.  With ``kv`` (K pages, V
    pages, rows, positions, mask) attention runs over the cache
    (:func:`cached_attention`)."""

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

    def forward(self, x: torch.Tensor, kv: Optional[Tuple[torch.Tensor, ...]] = None
                ) -> torch.Tensor:
        b, t, d = x.shape
        # (B, T, H, D/H) views of the projection: the kernel reads them
        # through their strides, no transpose copy
        q, k, v = (a.reshape(b, t, self.n_heads, d // self.n_heads)
                   for a in self.attn_qkv(self.ln1(x)).split(d, dim=-1))
        if kv is not None:
            a = cached_attention(q, k, v, *kv)
        elif self.attn_impl == "flash":
            train = torch.is_grad_enabled() and q.requires_grad
            a = (flash_attention_grad if train else flash_attention)(q, k, v, causal=self.causal)
        else:
            a = reference_attention(q, k, v, causal=self.causal)
        x = x + self.attn_out(a.reshape(b, t, d))
        h = F.gelu(self.mlp_up(self.ln2(x)), approximate="tanh")
        return x + self.mlp_down(h)


class TransformerLM(nn.Module):
    """tokens (B, T) or (T,) int -> logits (B, T, vocab) or (T, vocab) float32.

    With a ``cache`` the tokens continue each row at its position: they
    are written into the cache, attend over it, and the positions advance
    by T, or by ``T * active`` (B,) so that rows with ``active = 0`` stay
    where they are (idle slots write at their frozen position and never
    advance, as in the JAX package)."""

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

    def forward(self, tokens: torch.Tensor, cache: Optional[KVCache] = None,
                active: Optional[torch.Tensor] = None) -> torch.Tensor:
        if tokens.dim() == 1:
            return self(tokens[None], cache, active)[0]
        t = tokens.shape[1]
        if cache is not None:
            cols = cache.pos[:, None] + torch.arange(t, device=tokens.device)
            rows = torch.arange(tokens.shape[0], device=tokens.device)[:, None]
            mask = (torch.arange(self.cfg.max_seq, device=tokens.device)
                    <= cols[..., None])[:, None]  # (B, 1, T, S)
            x = self.embed(tokens) + self.pos_embed(cols)
            for i, block in enumerate(self.blocks):
                x = block(x, (cache.k[i], cache.v[i], rows, cols, mask))
            cache.pos += t if active is None else t * active
            return self.lm_head(self.ln_f(x).float())
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


def _sampling(props: Dict[str, str]) -> Dict[str, Any]:
    """The sampling props (``temperature``, ``top_k``, ``gen_seed``)."""
    return {"temperature": float(props.get("temperature", "0")),
            "top_k": int(props.get("top_k", "0")),
            "seed": int(props.get("gen_seed", "0"))}


def make_pick(temperature: float, top_k: int):
    """The one sampling rule of every generation path (JAX ``_make_pick``):
    ``pick(logits (B, V), key) -> (B,) int32``.  ``temperature <= 0`` is
    argmax (the first index on ties); else ``logits / temperature`` in
    float32, everything below the ``top_k``-th value set to -1e30 (ties
    at it all kept), and the argmax of it plus Gumbel noise
    (``jax.random.categorical``).  A key of int words draws one (B, V)
    block; a key of tensor words (one key per row) draws a (1, V) block
    per row, as the JAX package's vmapped per-slot pick does."""

    def pick(logits: torch.Tensor, key: Key) -> torch.Tensor:
        if temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        # divided by a device scalar: a CUDA division by a host scalar
        # multiplies by its reciprocal, which rounds differently
        scaled = logits.float() / torch.full((), temperature, dtype=torch.float32,
                                             device=logits.device)
        b, v = scaled.shape
        if top_k > 0:
            kth = scaled.topk(min(top_k, v), dim=-1).values[:, -1:]
            scaled = torch.where(scaled >= kth, scaled, -1e30)
        if any(isinstance(w, torch.Tensor) for w in key):
            noise = gumbel(key, (1, v)).reshape(b, v)
        else:
            noise = gumbel(key, (b, v), scaled.device)
        return (noise + scaled).argmax(dim=-1).to(torch.int32)

    return pick


def make_stream_generate(model: TransformerLM, temperature: float = 0.0, top_k: int = 0,
                         seed: int = 0):
    """KV-cache decoding in two halves whose cache the caller carries
    between calls, so tokens can leave while later ones decode:

    * ``prefill(prompt (B, Tp)) -> (cache, first (B,))``: one causal pass
      fills a fresh cache and picks token 1 with the raw ``gen_seed`` key;
    * ``decode_chunk(cache, tok, t0, n) -> (cache, last (B,), toks (B, n))``:
      n more tokens, step ``t0 + i`` picked with ``fold_in(key0, t0 + i)``.

    Tokens stay on the model's device; the caller copies ``toks`` to the
    host once per chunk.  The prompt is on the model's device and each
    row's ``Tp`` plus the tokens asked for stays within ``max_seq``."""
    pick = make_pick(temperature, top_k)
    key0 = prng_key(seed)

    @torch.inference_mode()
    def prefill(prompt: torch.Tensor):
        cache = KVCache.zeros(model.cfg, prompt.shape[0], prompt.device)
        return cache, pick(model(prompt, cache)[:, -1], key0)

    @torch.inference_mode()
    def decode_chunk(cache: KVCache, tok: torch.Tensor, t0: int, n: int):
        toks = []
        for i in range(n):
            tok = pick(model(tok[:, None], cache)[:, -1], fold_in(key0, t0 + i))
            toks.append(tok)
        return cache, tok, torch.stack(toks, dim=1)

    return prefill, decode_chunk


def make_generate(model: TransformerLM, max_new: int, temperature: float = 0.0,
                  top_k: int = 0, seed: int = 0):
    """One-shot generation: ``gen(prompt (B, Tp)) -> (B, Tp + max_new)``
    int32, the prefill then ONE decode chunk of the remaining tokens
    (:func:`make_stream_generate`'s halves, so the one-shot and streamed
    tokens are the same)."""
    prefill, decode_chunk = make_stream_generate(model, temperature, top_k, seed)

    def gen(prompt: torch.Tensor) -> torch.Tensor:
        tp = prompt.shape[1]
        if tp + max_new > model.cfg.max_seq:
            raise ValueError(f"prompt {tp} + generate {max_new} exceeds max_seq {model.cfg.max_seq}")
        cache, first = prefill(prompt)
        generated = first[:, None]
        if max_new > 1:
            generated = torch.cat([generated, decode_chunk(cache, first, 1, max_new - 1)[2]], dim=1)
        return torch.cat([prompt.to(torch.int32), generated], dim=1)

    return gen


class GenerateLM(nn.Module):
    """The zoo's ``generate:<N>`` entry: tokens (B, T) or (T,) -> the
    prompt followed by N generated tokens, (B, T + N) or (T + N,) int32."""

    def __init__(self, lm: TransformerLM, max_new: int, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0):
        super().__init__()
        self.lm = lm
        self._gen = make_generate(lm, max_new, temperature, top_k, seed)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if tokens.dim() == 1:
            return self(tokens[None])[0]
        return self._gen(tokens)


class SlotModel:
    """The slotted decode path behind ``core/slots.py``'s engine
    (continuous batching): one :class:`KVCache` of ``slots`` rows, each
    row a stream at its own position.

    * ``init_cache()``: zeroed pages and positions;
    * ``reset_slot(cache, slot)``: zero one slot (a join touches only it);
    * ``prefill_fn(n)(cache, toks (1, n), slot) -> (cache, last logits
      (1, V))``: one causal chunk on the slot's B = 1 view, written into
      the slot in place;
    * ``pick_first(logits (1, V)) -> (1,)``: token 1, the raw ``gen_seed``
      key as the unslotted prefill picks it;
    * ``decode_fn(k)(cache, tok, gen, active) -> (cache, tok, gen,
      toks (S, k))``: k tokens for every active slot; a row's key is
      ``key0`` at ``gen == 0`` and ``fold_in(key0, gen)`` else, a (1, V)
      draw per row, so a single occupant's tokens are those of the
      one-shot path.  Idle rows keep their token and count.

    Everything runs under ``torch.inference_mode()`` on the model's
    device; ``tok``, ``gen`` (int32) and ``active`` (int32, 0/1) are (S,)
    tensors there.  The JAX package's compile counters have no eager
    counterpart (ROADMAP A7: a CUDA graph of the decode step would bring
    back the shape-stability contract they pin)."""

    def __init__(self, model: TransformerLM, slots: int, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.model = model
        self.cfg = model.cfg
        self.slots = int(slots)
        self.device = model.lm_head.weight.device
        self._greedy = temperature <= 0.0
        self._pick = make_pick(temperature, top_k)
        self._key0 = prng_key(seed)
        self._sampling = {"temperature": temperature, "top_k": top_k, "seed": seed}

    def at_width(self, slots: int) -> "SlotModel":
        """The same weights and sampling rule at another slot width (a
        resize): the transformer is shared, only the cache ``init_cache``
        makes is sized anew."""
        return SlotModel(self.model, slots, **self._sampling)

    @torch.inference_mode()
    def init_cache(self) -> KVCache:
        return KVCache.zeros(self.cfg, self.slots, self.device)

    @torch.inference_mode()
    def reset_slot(self, cache: KVCache, slot: int) -> KVCache:
        cache.reset_row(slot)
        return cache

    # -- shared-prefix pages (core/slots.py PrefixCache): a slot's pages
    # below its write position never change again (prefill and decode only
    # write forward of it), so they can be published for later streams
    @torch.inference_mode()
    def export_prefix(self, cache: KVCache, slot: int, start: int, stop: int):
        """A COPY of one slot's K and V pages for positions ``[start,
        stop)``, each (layers, stop - start, H, D/H).  The cache is written
        in place, so a view would change under the entry with the slot's
        next stream."""
        return {"k": cache.k[:, slot, start:stop].clone(),
                "v": cache.v[:, slot, start:stop].clone()}

    @torch.inference_mode()
    def attach_prefix(self, cache: KVCache, slot: int, pages_list, n: int) -> KVCache:
        """Copy published pages (per-grain chunks in order, covering ``[0,
        n)``) into a freshly reset slot and set its write position to
        ``n``: the state of a cold prefill paused at ``n``."""
        at = 0
        for pages in pages_list:
            m = pages["k"].shape[1]
            cache.k[:, slot, at:at + m] = pages["k"]
            cache.v[:, slot, at:at + m] = pages["v"]
            at += m
        if at != n:
            raise ValueError(f"attach_prefix: pages cover {at} positions, not {n}")
        cache.pos[slot] = n
        return cache

    @torch.inference_mode()
    def save_positions(self, cache: KVCache) -> torch.Tensor:
        """The rows' write positions before a step (a copy on the card):
        the cache is written in place, and a step that fails part-way has
        advanced them.  Pages past a restored position are rewritten by the
        retry, so only the positions need restoring."""
        return cache.pos.clone()

    @torch.inference_mode()
    def restore_positions(self, cache: KVCache, saved: torch.Tensor) -> None:
        cache.pos.copy_(saved)

    def prefill_fn(self, n: int):
        """The prefill of an n-token chunk (one function for every n:
        eager PyTorch compiles nothing per shape)."""
        del n
        return self._prefill_chunk

    @torch.inference_mode()
    def _prefill_chunk(self, cache: KVCache, toks: torch.Tensor, slot: int):
        return cache, self.model(toks, cache.row(slot))[:, -1]

    @torch.inference_mode()
    def pick_first(self, logits: torch.Tensor) -> torch.Tensor:
        return self._pick(logits, self._key0)

    def _pick_slots(self, logits: torch.Tensor, gen: torch.Tensor) -> torch.Tensor:
        if self._greedy:
            return logits.argmax(dim=-1).to(torch.int32)
        folded = fold_in(self._key0, gen)
        keys = tuple(torch.where(gen == 0, k0, k) for k0, k in zip(self._key0, folded))
        return self._pick(logits, keys)

    def decode_fn(self, k: int):
        """k tokens for every active slot in one call."""
        return partial(self._decode_scan, k)

    @torch.inference_mode()
    def _decode_scan(self, k: int, cache: KVCache, tok: torch.Tensor, gen: torch.Tensor,
                     active: torch.Tensor):
        toks = []
        for _ in range(k):
            nxt = self._pick_slots(self.model(tok[:, None], cache, active)[:, -1], gen)
            tok = torch.where(active > 0, nxt, tok)
            gen = gen + active
            toks.append(nxt)
        return cache, tok, gen, torch.stack(toks, dim=1)


def lm_from_props(props: Dict[str, str], device="cpu") -> TransformerLM:
    """The zoo transformer of ``props``, seeded from ``seed``, on
    ``device`` in eval mode."""
    cfg = _cfg_from_props(props)
    return init_seeded(TransformerLM(cfg), int(props.get("seed", "0"))).to(device).eval()


def build_stream(props: Dict[str, str], device="cpu"):
    """The streaming generator's model (``tensor_generator slots=0``): the
    zoo dialect and seeds (``seed`` = weights, ``gen_seed`` = sampling).
    Returns ``(prefill, decode_chunk, max_seq)``."""
    model = lm_from_props(props, device)
    return (*make_stream_generate(model, **_sampling(props)), model.cfg.max_seq)


def build_slot_stream(props: Dict[str, str], slots: int, device="cpu", mesh=None):
    """The continuous-batching model (``tensor_generator slots=N``), same
    dialect and seeds as :func:`build_stream`.  Returns ``(SlotModel,
    max_seq)``.  A ``mesh`` raises: the sharded decode waits for ROADMAP
    A11."""
    if mesh:
        raise NotImplementedError(
            "mesh-sharded decode is not ported to nnstreamer_tpu_torch yet (ROADMAP A11)")
    model = lm_from_props(props, device)
    return SlotModel(model, slots, **_sampling(props)), model.cfg.max_seq


def build(custom_props=None):
    """Zoo entry: returns (module, in_spec, out_spec).  The logits path
    maps tokens (T,) int32 to logits (T, vocab) float32 per frame; with
    ``generate:<N>`` the module is :class:`GenerateLM`, tokens (T,) to
    tokens (T + N,) int32.  Props: vocab, d_model, heads, layers, d_ff,
    seq, dtype, attn, seed, generate, temperature, top_k, gen_seed — the
    JAX build's, with its defaults (``decode`` and ``slotted`` are
    ignored, as there)."""
    props = custom_props or {}
    if "mesh" in props:
        raise NotImplementedError(
            "transformer mesh: the sharded path is not ported to nnstreamer_tpu_torch yet "
            "(ROADMAP A11)")
    cfg = _cfg_from_props(props)
    model = init_seeded(TransformerLM(cfg), int(props.get("seed", "0")))
    in_spec = StreamSpec((TensorSpec((None,), np.int32, "tokens"),), FORMAT_STATIC)
    max_new = int(props.get("generate", "0"))
    if max_new > 0:
        out_spec = StreamSpec((TensorSpec((None,), np.int32, "tokens"),), FORMAT_STATIC)
        return GenerateLM(model, max_new, **_sampling(props)), in_spec, out_spec
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
