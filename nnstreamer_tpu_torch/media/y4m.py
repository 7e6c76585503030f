"""YUV4MPEG2 (.y4m) container reader/writer and I420 <-> RGB conversion.

A copy of ``nnstreamer_tpu/media/y4m.py``, the in-process stand-in for
``filesrc ! decodebin ! videoconvert``: uncompressed planar video, BT.601
limited range (the GStreamer default for SD raw video), vectorized over
whole planes in numpy, so its RGB bytes equal the JAX reader's.

Format: an ASCII stream header ``YUV4MPEG2 W<w> H<h> F<n>:<d> ...``, then
per frame ``FRAME\\n`` and the packed I420 planes (Y w*h, U and V
w/2*h/2).
"""

from __future__ import annotations

import itertools
from fractions import Fraction
from typing import BinaryIO, Iterator, Tuple

import numpy as np

# BT.601 limited-range YCbCr <-> full-range RGB
_KR, _KG, _KB = 0.299, 0.587, 0.114


def i420_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(h, w) luma + (h/2, w/2) chroma planes -> (h, w, 3) uint8 RGB."""
    h, w = y.shape
    yf = y.astype(np.float32) - 16.0
    # nearest-neighbour chroma upsample to full resolution
    uf = np.repeat(np.repeat(u, 2, axis=0), 2, axis=1)[:h, :w].astype(np.float32) - 128.0
    vf = np.repeat(np.repeat(v, 2, axis=0), 2, axis=1)[:h, :w].astype(np.float32) - 128.0
    r = 1.164 * yf + 1.596 * vf
    g = 1.164 * yf - 0.392 * uf - 0.813 * vf
    b = 1.164 * yf + 2.017 * uf
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def rgb_to_i420(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(h, w, 3) uint8 RGB -> I420 planes (limited-range BT.601); h and w
    must be even (2x2 chroma subsampling)."""
    h, w, _ = rgb.shape
    if h % 2 or w % 2:
        raise ValueError("I420 needs even width/height")
    f = rgb.astype(np.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    ey = _KR * r + _KG * g + _KB * b  # 0..255
    y = np.clip(16.0 + 219.0 * ey / 255.0, 16, 235).astype(np.uint8)
    cb = (b - ey) / (2.0 * (1.0 - _KB))  # -127.5..127.5
    cr = (r - ey) / (2.0 * (1.0 - _KR))
    # 2x2 box average, then quantize
    cb = cb.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    cr = cr.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))
    u = np.clip(128.0 + 224.0 * cb / 255.0, 16, 240).astype(np.uint8)
    v = np.clip(128.0 + 224.0 * cr / 255.0, 16, 240).astype(np.uint8)
    return y, u, v


def write_y4m(path: str, frames_rgb, framerate: Fraction = Fraction(30, 1)) -> None:
    """Write RGB uint8 frames (N, (h, w, 3)) as an I420 .y4m file."""
    frames = iter(frames_rgb)
    first = next(frames, None)
    if first is None:
        raise ValueError("no frames")
    h, w, _ = np.asarray(first).shape
    fr = Fraction(framerate)
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{w} H{h} F{fr.numerator}:{fr.denominator} Ip A1:1 C420jpeg\n"
                .encode())
        for img in itertools.chain([first], frames):
            f.write(b"FRAME\n")
            for plane in rgb_to_i420(np.asarray(img, np.uint8)):
                f.write(plane.tobytes())


class Y4MReader:
    """Streaming .y4m reader: the header on open, frames from :meth:`frames`."""

    def __init__(self, path_or_file):
        if isinstance(path_or_file, (str, bytes)):
            self._f: BinaryIO = open(path_or_file, "rb")
            self._own = True
        else:
            self._f = path_or_file
            self._own = False
        header = self._f.readline().decode("ascii", "replace").strip()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError("not a YUV4MPEG2 stream")
        self.width = self.height = 0
        self.framerate = Fraction(30, 1)
        self.colorspace = "420"
        for tok in header.split()[1:]:
            tag, val = tok[0], tok[1:]
            if tag == "W":
                self.width = int(val)
            elif tag == "H":
                self.height = int(val)
            elif tag == "F":
                n, _, d = val.partition(":")
                self.framerate = Fraction(int(n), int(d or "1"))
            elif tag == "C":
                self.colorspace = val
        if not self.colorspace.startswith("420"):
            raise ValueError(f"only I420 y4m supported, got C{self.colorspace}")
        if not (self.width and self.height):
            raise ValueError("y4m header missing W/H")

    def frames(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        w, h = self.width, self.height
        ysz, csz = w * h, (w // 2) * (h // 2)
        while True:
            marker = self._f.readline()
            if not marker:
                return
            if not marker.startswith(b"FRAME"):
                raise ValueError(f"bad frame marker {marker[:20]!r}")
            raw = self._f.read(ysz + 2 * csz)
            if len(raw) < ysz + 2 * csz:
                return  # a truncated trailing frame
            y = np.frombuffer(raw, np.uint8, ysz).reshape(h, w)
            u = np.frombuffer(raw, np.uint8, csz, offset=ysz).reshape(h // 2, w // 2)
            v = np.frombuffer(raw, np.uint8, csz, offset=ysz + csz).reshape(h // 2, w // 2)
            yield y, u, v

    def frames_rgb(self) -> Iterator[np.ndarray]:
        for y, u, v in self.frames():
            yield i420_to_rgb(y, u, v)

    def close(self) -> None:
        if self._own:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
