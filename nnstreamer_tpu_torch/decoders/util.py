"""Shared decoder helpers: labels, geometry, NMS, RGBA rasterizing.

Port of ``nnstreamer_tpu/decoders/util.py`` (host numpy, as there): label
loading, ``WIDTH:HEIGHT`` options, the IoU matrix and greedy per-class NMS
of the host decode paths, and the RGBA overlay drawing the box, pose and
segment decoders render with.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def load_labels(path: str) -> List[str]:
    """Load one label per line (reference: tensordecutil.c loadImageLabels)."""
    with open(path, "r", encoding="utf-8") as f:
        return [ln.strip() for ln in f if ln.strip()]


def parse_wh(text: str, default: Tuple[int, int]) -> Tuple[int, int]:
    """Parse ``WIDTH:HEIGHT`` (option4/option5 of the reference decoders)."""
    if not text:
        return default
    parts = text.split(":")
    try:
        w = int(parts[0]) if parts[0] else default[0]
        h = int(parts[1]) if len(parts) > 1 and parts[1] else default[1]
        return w, h
    except ValueError:
        return default


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.clip(x, -50.0, 50.0)))


def iou_matrix(boxes: np.ndarray) -> np.ndarray:
    """Pairwise IoU for boxes given as [N,4] = (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = np.maximum(0.0, x2 - x1) * np.maximum(0.0, y2 - y1)
    ix1 = np.maximum(x1[:, None], x1[None, :])
    iy1 = np.maximum(y1[:, None], y1[None, :])
    ix2 = np.minimum(x2[:, None], x2[None, :])
    iy2 = np.minimum(y2[:, None], y2[None, :])
    inter = np.maximum(0.0, ix2 - ix1) * np.maximum(0.0, iy2 - iy1)
    union = area[:, None] + area[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def nms(dets: np.ndarray, iou_threshold: float = 0.5,
        per_class: bool = True) -> np.ndarray:
    """Greedy non-max suppression.

    ``dets``: [N,6] = (x1, y1, x2, y2, score, class).  Returns the surviving
    rows sorted by descending score.  Matches the reference semantics
    (tensordec-boundingbox.c ``nms()``: sort by score, suppress same-class
    overlaps above the threshold).
    """
    if dets.size == 0:
        return dets.reshape(0, 6)
    order = np.argsort(-dets[:, 4], kind="stable")
    dets = dets[order]
    iou = iou_matrix(dets[:, :4])
    n = dets.shape[0]
    keep = np.ones(n, dtype=bool)
    for i in range(n):
        if not keep[i]:
            continue
        over = iou[i] > iou_threshold
        if per_class:
            over &= dets[:, 5] == dets[i, 5]
        over[: i + 1] = False
        keep &= ~over
    return dets[keep]


# -- RGBA raster helpers ----------------------------------------------------

# 20-color palette for classes (RGBA); wraps around for more classes.
PALETTE = np.asarray(
    [
        (230, 25, 75, 255), (60, 180, 75, 255), (255, 225, 25, 255),
        (0, 130, 200, 255), (245, 130, 48, 255), (145, 30, 180, 255),
        (70, 240, 240, 255), (240, 50, 230, 255), (210, 245, 60, 255),
        (250, 190, 212, 255), (0, 128, 128, 255), (220, 190, 255, 255),
        (170, 110, 40, 255), (255, 250, 200, 255), (128, 0, 0, 255),
        (170, 255, 195, 255), (128, 128, 0, 255), (255, 215, 180, 255),
        (0, 0, 128, 255), (128, 128, 128, 255),
    ],
    dtype=np.uint8,
)


def class_color(cls: int) -> np.ndarray:
    return PALETTE[int(cls) % len(PALETTE)]


def blank_canvas(width: int, height: int) -> np.ndarray:
    """Transparent RGBA canvas (the reference draws overlays on RGBA video)."""
    return np.zeros((height, width, 4), dtype=np.uint8)


def draw_rect(canvas: np.ndarray, x1: int, y1: int, x2: int, y2: int,
              color: Sequence[int], thickness: int = 1) -> None:
    """Draw an axis-aligned rectangle outline in-place."""
    h, w = canvas.shape[:2]
    x1, x2 = sorted((int(np.clip(x1, 0, w - 1)), int(np.clip(x2, 0, w - 1))))
    y1, y2 = sorted((int(np.clip(y1, 0, h - 1)), int(np.clip(y2, 0, h - 1))))
    c = np.asarray(color, dtype=np.uint8)
    t = max(1, thickness)
    canvas[y1:min(y1 + t, h), x1:x2 + 1] = c
    canvas[max(y2 - t + 1, 0):y2 + 1, x1:x2 + 1] = c
    canvas[y1:y2 + 1, x1:min(x1 + t, w)] = c
    canvas[y1:y2 + 1, max(x2 - t + 1, 0):x2 + 1] = c


def draw_dot(canvas: np.ndarray, x: int, y: int, color: Sequence[int],
             radius: int = 2) -> None:
    h, w = canvas.shape[:2]
    x, y = int(x), int(y)
    x1, x2 = max(0, x - radius), min(w, x + radius + 1)
    y1, y2 = max(0, y - radius), min(h, y + radius + 1)
    if x1 < x2 and y1 < y2:
        canvas[y1:y2, x1:x2] = np.asarray(color, dtype=np.uint8)


def draw_line(canvas: np.ndarray, x1: int, y1: int, x2: int, y2: int,
              color: Sequence[int]) -> None:
    """Bresenham-free line: sample along the segment (overlay quality only)."""
    n = int(max(abs(x2 - x1), abs(y2 - y1), 1))
    xs = np.linspace(x1, x2, n + 1).round().astype(int)
    ys = np.linspace(y1, y2, n + 1).round().astype(int)
    h, w = canvas.shape[:2]
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    canvas[ys[ok], xs[ok]] = np.asarray(color, dtype=np.uint8)


# 5x7 bitmap font for box labels (digits, upper-case, a few symbols).
# Reference rasterizes label text with a baked-in font (tensordecutil.c
# ``rasters``); this is an original minimal glyph set, column-major bits.
_FONT = {
    "0": "0E1119151311E0", "1": "04060404040E00", "2": "0E11081060F100",
    "3": "0E110C01110E00", "4": "08182848FC0800", "5": "1F101E01110E00",
    "6": "0E101E11110E00", "7": "1F010204080800", "8": "0E110E11110E00",
    "9": "0E11110F010E00",
}


def _glyph(ch: str) -> np.ndarray:
    """7x5 boolean bitmap for a character; generated procedurally for
    letters (coarse but legible), table-driven for digits."""
    if ch in _FONT:
        rows = bytes.fromhex(_FONT[ch])[:7]
        return np.array([[(r >> (4 - c)) & 1 for c in range(5)] for r in rows],
                        dtype=bool)
    # fallback: filled 3x5 block marker for unknown glyphs
    g = np.zeros((7, 5), dtype=bool)
    if ch.strip():
        g[1:6, 1:4] = True
    return g


def draw_label(canvas: np.ndarray, x: int, y: int, text: str,
               color: Sequence[int]) -> None:
    """Stamp a short text label (digits render as glyphs, letters as blocks)."""
    cx = int(x)
    for ch in text[:16]:
        g = _glyph(ch)
        h, w = canvas.shape[:2]
        y1, y2 = max(0, int(y)), min(h, int(y) + 7)
        x1, x2 = max(0, cx), min(w, cx + 5)
        if y2 > y1 and x2 > x1:
            sub = g[: y2 - y1, : x2 - x1]
            region = canvas[y1:y2, x1:x2]
            region[sub] = np.asarray(color, dtype=np.uint8)
        cx += 6


def scale_boxes(boxes: np.ndarray, in_wh: Tuple[int, int],
                out_wh: Tuple[int, int]) -> np.ndarray:
    """Rescale [N,>=4] (x1,y1,x2,y2,...) from model-input to output coords."""
    if boxes.size == 0:
        return boxes
    sx = out_wh[0] / max(1, in_wh[0])
    sy = out_wh[1] / max(1, in_wh[1])
    out = boxes.astype(np.float64).copy()
    out[:, [0, 2]] *= sx
    out[:, [1, 3]] *= sy
    return out
