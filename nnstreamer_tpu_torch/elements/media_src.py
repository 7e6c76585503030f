"""File media sources: raw bytes, .y4m video, still images, .wav audio, text.

Port of ``nnstreamer_tpu/elements/media_src.py``, the framework's own
front door where the reference uses stock GStreamer sources (``filesrc``,
``multifilesrc``) with parsers and converters:

- ``filesrc``: raw byte chunks (``blocksize`` per buffer), octet media;
  pairs with ``tensor_converter input-dim=/input-type=``;
- ``videofilesrc`` (alias ``y4msrc``): .y4m -> ``video/x-raw`` payloads in
  RGB/BGRx/GRAY8 with rows padded to 4 bytes, the layout the converter's
  stride removal expects;
- ``imagefilesrc`` (alias ``multifilesrc``): still images through Pillow
  (``media/image.py``; without Pillow it raises);
- ``audiofilesrc`` (alias ``wavsrc``): .wav -> ``audio/x-raw`` payloads of
  ``samples-per-buffer`` frames;
- ``textfilesrc``: one line per buffer as ``text/x-raw``.

Payloads are host bytes: ``tensors[0]`` is a 1-D uint8 array of the raw
media, ``meta["media"]`` its :class:`MediaInfo`, and the advertised schema
a :class:`MediaSpec`, so ``tensor_converter`` derives the exact tensor
schema during negotiation.  ``tensor_converter`` frames them on the host;
the filter stages them to the card.
"""

from __future__ import annotations

import glob
import os
import re
from fractions import Fraction
from typing import Iterator, Optional

import numpy as np

from ..core.buffer import TensorFrame
from ..core.lifecycle import pipeline_quiescing
from ..media.caps import MediaInfo, MediaSpec
from ..pipeline.element import ElementError, Property, SourceElement, element

# printf-style integer fields of a multifilesrc location (img_%04d.png);
# length modifiers (%ld, %lld) are stripped before formatting
_IMG_PATTERN = re.compile(r"%0?\d*(?:ll?)?d")


def _fmt_sample_path(location: str, idx: int) -> str:
    """``location % idx``, a stray ``%`` surfacing as ElementError."""
    try:
        return _IMG_PATTERN.sub(lambda m: m.group(0).replace("l", ""), location, count=1) % idx
    except (ValueError, TypeError) as e:
        raise ElementError(f"bad sample-path pattern {location!r}: {e} (exactly one %d-style "
                           "field is supported; escape other percents as %%)") from None


def _pad_rows(img: np.ndarray, stride: int) -> np.ndarray:
    """(h, w, c) -> flat bytes with each row padded to `stride` bytes."""
    h = img.shape[0]
    flat = img.reshape(h, -1)
    if flat.shape[1] == stride:
        return flat.reshape(-1)
    out = np.zeros((h, stride), np.uint8)
    out[:, :flat.shape[1]] = flat
    return out.reshape(-1)


def _to_format(rgb: np.ndarray, fmt: str) -> np.ndarray:
    """An RGB frame in the source's output pixel format."""
    if fmt == "RGB":
        return rgb
    if fmt == "BGRx":
        return np.concatenate([rgb[..., ::-1], np.full(rgb.shape[:2] + (1,), 255, np.uint8)],
                              axis=-1)
    if fmt == "GRAY8":  # BT.601 luma of the converted RGB
        return np.clip(0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2],
                       0, 255).astype(np.uint8)[..., None]
    raise ValueError(f"unsupported format {fmt!r}")


class _MediaSource(SourceElement):
    def _location(self) -> str:
        if not self.props["location"]:
            raise ElementError(f"{self.name}: location= is required")
        return self.props["location"]

    def _limit_reached(self, n: int) -> bool:
        limit = self.props["num-buffers"]
        return 0 <= limit <= n

    @staticmethod
    def _media_frame(payload: np.ndarray, media: MediaInfo, pts: Optional[float] = None,
                     duration: Optional[float] = None) -> TensorFrame:
        f = TensorFrame([payload], pts=pts, duration=duration)
        f.meta["media"] = media
        return f


@element("filesrc")
class FileSrc(_MediaSource):
    """Raw file bytes in ``blocksize`` chunks (≙ GStreamer filesrc)."""

    PROPERTIES = {
        "location": Property(str, "", "file path"),
        "blocksize": Property(int, 4096, "bytes per buffer"),
        "num-buffers": Property(int, -1, "stop after N buffers (-1 = all)"),
    }

    def output_spec(self):
        return MediaSpec(media=MediaInfo("octet"))

    def frames(self) -> Iterator[TensorFrame]:
        media = MediaInfo("octet")
        n = 0
        with open(self._location(), "rb") as f:
            while not self._limit_reached(n):
                chunk = f.read(self.props["blocksize"])
                if not chunk:
                    return
                if pipeline_quiescing(self):
                    return  # a drain or stop: end the stream here
                yield self._media_frame(np.frombuffer(chunk, np.uint8), media)
                n += 1


@element("videofilesrc", "y4msrc")
class VideoFileSrc(_MediaSource):
    """.y4m file -> video/x-raw payloads (RGB/BGRx/GRAY8, 4-byte row
    stride, BT.601 conversion in ``media/y4m.py``)."""

    PROPERTIES = {
        "location": Property(str, "", ".y4m file path"),
        "format": Property(str, "RGB", "RGB|BGRx|GRAY8 output pixel format"),
        "num-buffers": Property(int, -1, "stop after N frames (-1 = all)"),
        "loop": Property(bool, False, "restart at EOF (stream soak tests)"),
    }

    def _media(self) -> MediaInfo:
        from ..media.y4m import Y4MReader

        with Y4MReader(self._location()) as r:
            return MediaInfo("video", self.props["format"], width=r.width, height=r.height,
                             framerate=r.framerate)

    def output_spec(self):
        return MediaSpec(media=self._media())

    def frames(self) -> Iterator[TensorFrame]:
        from ..media.y4m import Y4MReader

        media = self._media()
        fmt = self.props["format"]
        dt = float(1 / media.framerate) if media.framerate else None
        n = 0
        while True:
            with Y4MReader(self._location()) as r:
                for rgb in r.frames_rgb():
                    if self._limit_reached(n):
                        return
                    try:
                        img = _to_format(rgb, fmt)
                    except ValueError as e:
                        raise ElementError(f"{self.name}: {e}") from None
                    if pipeline_quiescing(self):
                        return  # a drain or stop: end the stream here
                    yield self._media_frame(_pad_rows(img, media.stride), media,
                                            pts=n * dt if dt is not None else None, duration=dt)
                    n += 1
            if not self.props["loop"]:
                return


@element("imagefilesrc", "multifilesrc")
class ImageFileSrc(_MediaSource):
    """Still images (PNG/JPEG/BMP via Pillow) -> video/x-raw payloads
    (≙ ``multifilesrc ! pngdec/jpegdec ! videoconvert``).

    ``location`` is one path, a comma list, a glob or a printf pattern
    (``img_%04d.png``, indexed from 0 to the first gap); all images share
    one size (the stream schema is static).  ``framerate`` spaces pts."""

    PROPERTIES = {
        "location": Property(str, "", "path, comma list, glob, or printf pattern (img_%04d.png)"),
        "format": Property(str, "RGB", "RGB|GRAY8 output pixel format"),
        "framerate": Property(str, "30/1", "pts spacing, N/D"),
        "num-buffers": Property(int, -1, "stop after N frames (-1 = all)"),
        "loop": Property(bool, False, "cycle the file list forever"),
    }

    def __init__(self, name=None):
        super().__init__(name)
        self._cached: Optional[tuple] = None  # (paths, MediaInfo)

    def _fps(self) -> Fraction:
        n, _, d = self.props["framerate"].partition("/")
        den = int(d or "1")
        if den == 0:
            raise ElementError(f"{self.name}: bad framerate {self.props['framerate']!r}")
        return Fraction(int(n), den)  # 0/1: a still-image rate, no pts spacing

    def _paths(self, loc: str) -> list:
        if "," in loc:
            return [p.strip() for p in loc.split(",") if p.strip()]
        if any(ch in loc for ch in "*?["):
            return sorted(glob.glob(loc))
        if not _IMG_PATTERN.search(loc):
            return [loc]
        paths = []
        while os.path.exists(_fmt_sample_path(loc, len(paths))):
            paths.append(_fmt_sample_path(loc, len(paths)))
        return paths

    def _scan(self):
        """(paths, MediaInfo), globbed and probed once per start."""
        if self._cached is None:
            from ..media.image import read_image

            loc = self._location()
            paths = self._paths(loc)
            if not paths:
                raise ElementError(f"{self.name}: no files match {loc!r}")
            first = read_image(paths[0], self.props["format"])
            media = MediaInfo("video", self.props["format"], width=first.shape[1],
                              height=first.shape[0], framerate=self._fps())
            self._cached = (paths, media)
        return self._cached

    def start(self):
        self._cached = None  # re-scan on every run (files may change)
        self._scan()

    def output_spec(self):
        return MediaSpec(media=self._scan()[1])

    def frames(self) -> Iterator[TensorFrame]:
        from ..media.image import read_image

        paths, media = self._scan()
        fps = self._fps()
        dt = float(1 / fps) if fps else None
        n = 0
        while True:
            for p in paths:
                if self._limit_reached(n):
                    return
                img = read_image(p, self.props["format"])
                if img.shape[:2] != (media.height, media.width):
                    raise ElementError(
                        f"{self.name}: {p} is {img.shape[1]}x{img.shape[0]}, stream is "
                        f"{media.width}x{media.height} (static schema; resize your images or "
                        "split the pipeline)")
                f = self._media_frame(_pad_rows(img, media.stride), media,
                                      pts=n * dt if dt is not None else None, duration=dt)
                f.meta["filename"] = p
                if pipeline_quiescing(self):
                    return  # a drain or stop: end the stream here
                yield f
                n += 1
            if not self.props["loop"]:
                return


@element("audiofilesrc", "wavsrc")
class AudioFileSrc(_MediaSource):
    """.wav file -> audio/x-raw payloads of ``samples-per-buffer`` frames."""

    PROPERTIES = {
        "location": Property(str, "", ".wav file path"),
        "samples-per-buffer": Property(int, 1024, "audio frames per buffer"),
        "num-buffers": Property(int, -1, "stop after N buffers (-1 = all)"),
    }

    def _read(self):
        from ..media.wav import read_wav

        rate, channels, fmt, data = read_wav(self._location())
        media = MediaInfo("audio", fmt, rate=rate, channels=channels,
                          samples_per_buffer=max(1, self.props["samples-per-buffer"]))
        return media, data

    def output_spec(self):
        return MediaSpec(media=self._read()[0])

    def frames(self) -> Iterator[TensorFrame]:
        media, data = self._read()
        spb, rate = media.samples_per_buffer, media.rate
        for n, off in enumerate(range(0, len(data) - spb + 1, spb)):
            if self._limit_reached(n):
                return
            chunk = np.frombuffer(data[off:off + spb].tobytes(), np.uint8)
            if pipeline_quiescing(self):
                return  # a drain or stop: end the stream here
            yield self._media_frame(chunk, media, pts=off / rate, duration=spb / rate)


@element("textfilesrc")
class TextFileSrc(_MediaSource):
    """Text file -> one line per buffer as text/x-raw (utf-8 bytes)."""

    PROPERTIES = {
        "location": Property(str, "", "text file path"),
        "num-buffers": Property(int, -1, "stop after N lines (-1 = all)"),
    }

    def output_spec(self):
        return MediaSpec(media=MediaInfo("text"))

    def frames(self) -> Iterator[TensorFrame]:
        media = MediaInfo("text")
        with open(self._location(), "rb") as f:
            for n, line in enumerate(f):
                if self._limit_reached(n):
                    return
                if pipeline_quiescing(self):
                    return  # a drain or stop: end the stream here
                yield self._media_frame(np.frombuffer(line.rstrip(b"\r\n"), np.uint8), media)
