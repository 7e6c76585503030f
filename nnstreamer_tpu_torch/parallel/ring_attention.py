"""Attention across devices — reduced to the unsharded reference.

Port of ``nnstreamer_tpu/parallel/ring_attention.py`` ``reference_attention``:
the ``attn:xla`` path of the model zoo, the JAX package's default.  It is
plain PyTorch in the input dtype (scores, softmax and the value product),
as the JAX einsum/softmax is; a user asks for it with ``attn:xla``, and it
is no fallback of the flash kernel.  Ring and Ulysses sequence parallelism
wait for the parallel slice (ROADMAP A11).
"""

from __future__ import annotations

import torch


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Unsharded exact attention, (B, T, H, D) -> (B, T, H, D)."""
    t, d = q.shape[1], q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (d**0.5)
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
