"""Threefry-2x32 random bits, uniforms and Gumbel noise, bit-equal to JAX's.

The port's own copy of what ``jax.random`` computes for the generation
path's sampling (``nnstreamer_tpu/models/transformer.py`` ``_make_pick``:
``jax.random.PRNGKey``, ``fold_in`` and ``categorical``), in the layout of
``jax_threefry_partitionable = True`` (``jax/_src/prng.py``
``_threefry_random_bits_partitionable``) and with 32-bit integers
(JAX's default, x64 off):

* a key is a pair ``(k1, k2)`` of 32-bit words, each a Python int or an
  int64 tensor (a tensor of keys, one per row);
* ``prng_key(seed)`` is ``(0, seed)`` for a seed in the int32 range;
* ``fold_in(key, data)`` hashes the counter pair ``(0, data)`` under
  ``key``;
* ``random_bits(key, shape)`` hashes, for element ``i`` of the row-major
  ``shape``, the counter pair ``(i >> 32, i & 0xFFFFFFFF)`` and xors the
  two output words;
* ``uniform`` keeps the top 23 bits as a mantissa in ``[1, 2)``, subtracts
  1 and scales to ``[minval, maxval)`` in float32 (``jax.random._uniform``);
* ``gumbel`` is the low mode, ``-log(-log(uniform(tiny, 1)))``
  (``jax.random._gumbel``).

Everything is integer arithmetic on int64 tensors masked to 32 bits, so
the bits are the same on the CPU and on the card; only the float ``log``
of :func:`gumbel` may round differently from XLA's.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = float(np.finfo(np.float32).tiny)


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word) -> Tuple[Word, Word]:
    """The Threefry-2x32 hash of the counter words ``(x1, x2)`` under the
    key ``(k1, k2)``: 20 rounds in five groups of four, a key injection
    after each (``jax/_src/prng.py`` ``_threefry2x32_lowering``).  Words
    broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``'s two words (a seed in the int32 range
    has high word 0, as JAX gives it with 32-bit integers)."""
    seed = int(seed)
    hi = 0 if -2**31 <= seed < 2**31 else (seed >> 32) & _MASK
    return hi, seed & _MASK


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in(key, data)``; ``data`` an int or an int tensor
    (then one key per element)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _MASK
    else:
        data = int(data) & _MASK
    return threefry2x32(key[0], key[1], 0, data)


def random_bits(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as an int64 tensor in
    ``[0, 2**32)``.  With tensor words of shape K (one key per row) the
    result has shape ``K + shape``, each key drawing its own ``shape``
    block from counter 0."""
    k1, k2 = key
    if isinstance(k1, torch.Tensor) or isinstance(k2, torch.Tensor):
        ref = k1 if isinstance(k1, torch.Tensor) else k2
        device = ref.device
        lead = tuple(ref.shape)
        expand = (...,) + (None,) * len(shape)
        k1 = torch.as_tensor(k1, dtype=torch.int64, device=device).expand(lead)[expand]
        k2 = torch.as_tensor(k2, dtype=torch.int64, device=device).expand(lead)[expand]
    count = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                         device=device).reshape(tuple(shape))
    b1, b2 = threefry2x32(k1, k2, count >> 32, count & _MASK)
    return b1 ^ b2


def uniform(key: Key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape, device)
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = (one - 1.0) * float(hi - lo) + float(lo)
    return torch.clamp_min(floats, float(lo))


def gumbel(key: Key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in the default (low)
    mode."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0, device)))
