"""Prompt digests for the shared-prefix KV cache.

Port of the digest part of ``nnstreamer_tpu/core/continuity.py``:
:func:`prompt_digest`, :data:`PREFIX_GRAIN`, :func:`prefix_digests` and
:func:`prefix_route_key`.  The digests are byte-equal to the JAX
package's for the same prompt, so a fleet that mixes both packages sends
one prompt to one prefix owner.

Not ported (ROADMAP A7.3): the resume state and ``resume_signature``.
"""

from __future__ import annotations

import hashlib

import numpy as np


def _tokens(prompt) -> np.ndarray:
    """The prompt as a contiguous int32 (1, Tp) array (a 1-D prompt is
    one row)."""
    return np.ascontiguousarray(np.asarray(prompt, dtype=np.int32)).reshape(1, -1)


def prompt_digest(prompt) -> str:
    """Stable digest of a normalized (1, Tp) int32 prompt: its shape, then
    its bytes."""
    a = np.ascontiguousarray(np.asarray(prompt, dtype=np.int32))
    h = hashlib.sha1()
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()


#: default shared-prefix grain in tokens, a multiple of the slot engine's
#: default ``prefill_chunk`` (32): an attach leaves the rest of the prompt
#: on the chunk grid a cold prefill uses
PREFIX_GRAIN = 64


def prefix_digests(prompt, grain: int) -> list:
    """Chain digests at every full ``grain``-token boundary of a (1, Tp)
    int32 prompt: ``d_0 = H(g, 0, chunk_0)``, ``d_i = H(d_{i-1}, g, i,
    chunk_i)``.  Each digest names its chunk and all of its left context
    (the KV pages of a chunk depend on every token before it); the
    trailing partial chunk gets none."""
    a = _tokens(prompt)
    g = max(1, int(grain))
    out = []
    prev = b""
    for i in range(int(a.shape[1]) // g):
        h = hashlib.sha1()
        h.update(prev)
        h.update(f"|g={g}|i={i}|".encode())
        h.update(a[:, i * g:(i + 1) * g].tobytes())
        d = h.hexdigest()
        out.append(d)
        prev = d.encode()
    return out


def prefix_route_key(prompt, grain: int = PREFIX_GRAIN, declared: int = 0) -> str:
    """Routing key of a prompt's shared-prefix region: the chain digest of
    its first ``declared`` tokens rounded down to the grain (0: the first
    grain), or the whole-prompt digest for a prompt shorter than one
    grain."""
    a = _tokens(prompt)
    g = max(1, int(grain))
    n = int(declared) if declared else g
    k = min(max(0, n), int(a.shape[1])) // g
    if k <= 0:
        return prompt_digest(a)
    return prefix_digests(a[:, :k * g], g)[-1]
