"""Still-image codecs (PNG/JPEG/BMP/...) through Pillow.

A copy of ``nnstreamer_tpu/media/image.py``.  The import is gated: where
Pillow is missing everything loads, and only the image paths raise.
"""

from __future__ import annotations

import numpy as np


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("image support requires Pillow (PIL) — not installed") from e
    return Image


def read_image(path: str, fmt: str = "RGB") -> np.ndarray:
    """Decode to uint8 (H, W, C): fmt RGB -> C=3, GRAY8 -> C=1."""
    img = _pil().open(path)
    if fmt == "RGB":
        return np.asarray(img.convert("RGB"), np.uint8)
    if fmt == "GRAY8":
        return np.asarray(img.convert("L"), np.uint8)[..., None]
    raise ValueError(f"unsupported image format {fmt!r} (RGB|GRAY8)")


def write_image(path: str, arr: np.ndarray) -> None:
    """Encode uint8 (H, W, C) or (H, W); the container follows the extension."""
    a = np.asarray(arr, np.uint8)
    if a.ndim == 3 and a.shape[-1] == 1:
        a = a[..., 0]
    _pil().fromarray(a).save(path)
