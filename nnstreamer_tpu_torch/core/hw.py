"""Hardware capability probe.

Port of ``nnstreamer_tpu/core/hw.py`` (reference: ``gst/nnstreamer/
hw_accel.c``).  :func:`probe` answers with the JAX probe's keys
(``platform``, ``device_kind``, ``num_devices``, ``accelerated``,
``devices`` and, on failure, ``error``) from ``torch.cuda``: ``platform``
``"cuda"`` with a card (``"cpu"`` without), ``device_kind`` the first
card's name, and per card in ``cards`` its compute capability, SM count
and total memory.  The zoo takes its default dtype from
:func:`preferred_dtype` (bfloat16 with a card, float32 without).

Where the probe runs: asking ``torch.cuda`` in-process initializes CUDA in
the caller, after which a ``fork`` of that process cannot use the card.
So, as the JAX probe does, it runs in a throwaway subprocess, bounded by
``NNS_TPU_HW_PROBE_TIMEOUT`` seconds (30), unless CUDA is already
initialized in the caller, or torch was built without CUDA: then there is
nothing to protect and the answer comes from this process.  A success is cached for the process, a
failure for ``_NEG_TTL_S`` seconds; :func:`reset` drops both.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Dict

_cache: Dict[str, object] = {}
_cache_lock = threading.Lock()
_neg_cache: Dict[str, object] = {}  # the last failed probe's result
_neg_cache_ts = 0.0
_NEG_TTL_S = 60.0  # re-probe a failure after this (the card may come back)

#: the answer from ``torch.cuda``: run as is by the probe's subprocess, and
#: defined here as :func:`_answer` for a process where CUDA is initialized
_ANSWER_SRC = """
def _answer(torch):
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    cards = []
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        cards.append({"name": p.name, "capability": f"{p.major}.{p.minor}",
                      "sms": p.multi_processor_count, "memory_bytes": p.total_memory})
    return {
        "platform": "cuda" if n else "cpu",
        "device_kind": cards[0]["name"] if cards else "cpu",
        "num_devices": n,
        "accelerated": bool(n),
        "devices": [f"cuda:{i}" for i in range(n)] or ["cpu"],
        "cards": cards,
    }
"""
_PROBE_SRC = _ANSWER_SRC + "import json, torch\nprint('HWPROBE ' + json.dumps(_answer(torch)))\n"
exec(_ANSWER_SRC)


def _fail(err: str) -> Dict[str, object]:
    return {
        "platform": "none",
        "device_kind": "none",
        "num_devices": 0,
        "accelerated": False,
        "devices": [],
        "cards": [],
        "error": err,
    }


def _query_devices(timeout_s: float) -> Dict[str, object]:
    """The answer from a throwaway subprocess (killable, and CUDA stays
    uninitialized here), or from this process where CUDA already is."""
    import torch

    if torch.version.cuda is None or torch.cuda.is_initialized():
        return _answer(torch)  # noqa: F821 -- defined by exec(_ANSWER_SRC)
    try:
        r = subprocess.run([sys.executable, "-c", _PROBE_SRC], capture_output=True, text=True,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return _fail(f"device probe timed out after {timeout_s:.0f}s")
    except OSError as e:
        return _fail(f"device probe failed to launch: {e}")
    for line in reversed(r.stdout.splitlines()):
        if line.startswith("HWPROBE "):
            return json.loads(line[len("HWPROBE "):])
    tail = (r.stderr or r.stdout).strip().splitlines()
    return _fail(f"device probe rc={r.returncode}: {tail[-1] if tail else 'no output'}")


def probe(timeout_s: float = None) -> Dict[str, object]:
    """The device probe's answer (see the module docstring); a copy."""
    global _neg_cache_ts
    with _cache_lock:
        if _cache:
            return dict(_cache)
        if _neg_cache and time.monotonic() - _neg_cache_ts < _NEG_TTL_S:
            return dict(_neg_cache)
    if timeout_s is None:
        timeout_s = float(os.environ.get("NNS_TPU_HW_PROBE_TIMEOUT", "30"))
    result = _query_devices(timeout_s)
    with _cache_lock:
        if "error" in result:
            _neg_cache.clear()
            _neg_cache.update(result)
            _neg_cache_ts = time.monotonic()
        else:
            _cache.update(result)
    return dict(result)


def reset() -> None:
    """Drop the cached answers (tests; after the card set-up changed)."""
    global _neg_cache_ts
    with _cache_lock:
        _cache.clear()
        _neg_cache.clear()
        _neg_cache_ts = 0.0


def has_accelerator() -> bool:
    return bool(probe()["accelerated"])


def preferred_dtype() -> str:
    """bfloat16 with a card (its tensor cores' type), float32 on the host CPU."""
    return "bfloat16" if has_accelerator() else "float32"
