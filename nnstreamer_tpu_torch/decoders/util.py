"""Shared decoder helpers (port of ``load_labels`` from
``nnstreamer_tpu/decoders/util.py``)."""

from __future__ import annotations

from typing import List


def load_labels(path: str) -> List[str]:
    """Load one label per line (reference: tensordecutil.c loadImageLabels)."""
    with open(path, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]
