"""WAV reader/writer (stdlib ``wave`` + numpy) for the audio file source.

A copy of ``nnstreamer_tpu/media/wav.py``: the ``filesrc ! wavparse``
front of the reference's audio pipelines, feeding ``audio/x-raw`` into
``tensor_converter``.
"""

from __future__ import annotations

import wave
from typing import Tuple

import numpy as np

from .caps import AUDIO_FORMATS

_WIDTH_FMT = {1: "U8", 2: "S16LE", 4: "S32LE"}


def read_wav(path: str) -> Tuple[int, int, str, np.ndarray]:
    """-> (rate, channels, format name, samples (n, channels))."""
    with wave.open(path, "rb") as w:
        channels = w.getnchannels()
        rate = w.getframerate()
        width = w.getsampwidth()
        if width not in _WIDTH_FMT:
            raise ValueError(f"unsupported sample width {width}")
        raw = w.readframes(w.getnframes())
    fmt = _WIDTH_FMT[width]
    return rate, channels, fmt, np.frombuffer(raw, AUDIO_FORMATS[fmt]).reshape(-1, channels)


def write_wav(path: str, samples: np.ndarray, rate: int) -> None:
    """samples (n,) or (n, channels) of u8/i16/i32."""
    arr = np.asarray(samples)
    if arr.ndim == 1:
        arr = arr[:, None]
    width = arr.dtype.itemsize
    if width not in _WIDTH_FMT:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    with wave.open(path, "wb") as w:
        w.setnchannels(arr.shape[1])
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(arr.tobytes())
