"""Media capabilities: the ``video/x-raw,format=RGB,...`` caps analog.

A copy of ``nnstreamer_tpu/media/caps.py`` (the subset that
``tensor_converter`` and ``capsfilter`` parse); the media sources and file
readers of ``nnstreamer_tpu/media/`` are not ported yet (ROADMAP A4.2b).

Reference media caps accepted by tensor_converter
(``gsttensor_converter.c`` pad template + per-type framing :750-1005):

- ``video/x-raw`` formats RGB / BGRx / GRAY8, with rows padded to 4-byte
  boundaries (the converter strips the padding unless width is aligned);
- ``audio/x-raw`` formats S8/U8/S16/U16/S32/U32/F32/F64, interleaved
  channels, N samples per buffer;
- ``text/x-raw`` (utf8), fixed bytes-per-frame set by ``input-dim``;
- ``application/octet-stream``, reshaped per ``input-dim``/``input-type``.

A :class:`MediaSpec` is a wildcard tensor schema (it constrains nothing
tensor-wise) that carries a :class:`MediaInfo`; sources advertise it, the
schema-negotiation pass flows it through untouched, and
``tensor_converter.derive_spec`` turns it into the exact static tensor
schema — so pipelines negotiate media -> tensors up front exactly like the
reference's caps negotiation does.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Optional

import numpy as np

from ..core.types import FORMAT_FLEXIBLE, StreamSpec

# (numpy dtype, bytes/sample) per audio format name (reference: GstAudioFormat)
AUDIO_FORMATS = {
    "S8": np.dtype(np.int8),
    "U8": np.dtype(np.uint8),
    "S16LE": np.dtype("<i2"),
    "U16LE": np.dtype("<u2"),
    "S32LE": np.dtype("<i4"),
    "U32LE": np.dtype("<u4"),
    "F32LE": np.dtype("<f4"),
    "F64LE": np.dtype("<f8"),
}

# channels per pixel per video format (reference: converter caps RGB/BGRx/GRAY8)
VIDEO_CHANNELS = {"RGB": 3, "BGR": 3, "BGRx": 4, "RGBx": 4, "GRAY8": 1}


def round_up_4(n: int) -> int:
    """GStreamer video rows are padded to 4-byte boundaries."""
    return (n + 3) & ~3


@dataclass(frozen=True)
class MediaInfo:
    """What kind of raw media a payload is, and how it is laid out."""

    mtype: str  # "video" | "audio" | "text" | "octet"
    format: str = ""  # video: RGB|BGRx|GRAY8; audio: S16LE|F32LE|...
    width: int = 0
    height: int = 0
    stride: int = 0  # bytes per video row (0 = packed, no padding)
    framerate: Optional[Fraction] = None
    rate: int = 0  # audio sample rate, Hz
    channels: int = 0  # audio channels
    samples_per_buffer: int = 0  # audio frames per payload (0 = unknown)

    def __post_init__(self):
        if self.mtype == "video":
            if self.format not in VIDEO_CHANNELS:
                raise ValueError(f"unsupported video format {self.format!r}")
            if self.stride == 0:
                object.__setattr__(
                    self, "stride", round_up_4(self.width * self.pixel_channels)
                )
        elif self.mtype == "audio":
            if self.format not in AUDIO_FORMATS:
                raise ValueError(f"unsupported audio format {self.format!r}")
        elif self.mtype not in ("text", "octet"):
            raise ValueError(f"unknown media type {self.mtype!r}")
        if self.framerate is not None:
            object.__setattr__(self, "framerate", Fraction(self.framerate))

    # -- video --------------------------------------------------------------
    @property
    def pixel_channels(self) -> int:
        return VIDEO_CHANNELS[self.format]

    @property
    def row_bytes(self) -> int:
        """Meaningful pixel bytes per row (before stride padding)."""
        return self.width * self.pixel_channels

    # -- audio --------------------------------------------------------------
    @property
    def sample_dtype(self) -> np.dtype:
        return AUDIO_FORMATS[self.format]

    @property
    def bytes_per_frame(self) -> int:
        """One audio frame = one sample across all channels."""
        return self.sample_dtype.itemsize * max(self.channels, 1)

    # -- caps text ----------------------------------------------------------
    def caps_string(self) -> str:
        if self.mtype == "video":
            s = (
                f"video/x-raw,format={self.format},width={self.width},"
                f"height={self.height}"
            )
            if self.framerate is not None:
                s += (
                    f",framerate={self.framerate.numerator}/"
                    f"{self.framerate.denominator}"
                )
            return s
        if self.mtype == "audio":
            return (
                f"audio/x-raw,format={self.format},rate={self.rate},"
                f"channels={self.channels}"
            )
        if self.mtype == "text":
            return "text/x-raw,format=utf8"
        return "application/octet-stream"


def parse_media_caps(text: str) -> MediaInfo:
    """Parse a reference-dialect media caps string into MediaInfo."""
    head, *rest = [p.strip() for p in text.strip().split(",")]
    fields = {}
    for item in rest:
        k, _, v = item.partition("=")
        fields[k.strip()] = v.strip()
    fr = None
    if "framerate" in fields:
        n, _, d = fields["framerate"].partition("/")
        fr = Fraction(int(n), int(d or "1"))
    if head == "video/x-raw":
        return MediaInfo(
            "video",
            fields.get("format", "RGB"),
            width=int(fields.get("width", 0)),
            height=int(fields.get("height", 0)),
            framerate=fr,
        )
    if head == "audio/x-raw":
        return MediaInfo(
            "audio",
            fields.get("format", "S16LE"),
            rate=int(fields.get("rate", 0)),
            channels=int(fields.get("channels", 1)),
        )
    if head == "text/x-raw":
        return MediaInfo("text")
    if head == "application/octet-stream":
        return MediaInfo("octet")
    raise ValueError(f"unknown media caps {text!r}")


@dataclass(frozen=True)
class MediaSpec(StreamSpec):
    """A stream schema for raw media payloads.

    Tensor-wise it is the wildcard (zero tensors, flexible format), so it
    intersects with anything; the attached :class:`MediaInfo` tells
    ``tensor_converter`` how to frame the payload.
    """

    media: Optional[MediaInfo] = None

    def __post_init__(self):
        object.__setattr__(self, "tensors", ())
        object.__setattr__(self, "fmt", FORMAT_FLEXIBLE)
        super().__post_init__()

    def intersect(self, other: StreamSpec) -> Optional[StreamSpec]:
        # media survives intersection with wildcards (the base rule would
        # collapse self.is_any -> other, silently dropping the MediaInfo);
        # note a MediaSpec is itself is_any tensor-wise, so the MediaSpec
        # check must come first
        if isinstance(other, MediaSpec):
            return self if other.media == self.media else None
        if other.is_any:
            return self
        return super().intersect(other)

    def to_string(self) -> str:
        return self.media.caps_string() if self.media else super().to_string()
