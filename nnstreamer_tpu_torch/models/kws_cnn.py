"""Keyword-spotting CNN on log-mel features (PyTorch) — the audio family.

Port of ``nnstreamer_tpu/models/kws_cnn.py``.  Raw PCM in, keyword logits
out; the whole front end runs in the module, on the model's device:

* mono mixdown (integer PCM scaled by 1/32768, float PCM as it is);
* framing (``unfold``: n_fft samples every hop), a symmetric Hann window
  (``np.hanning``, as the reference; ``torch.hann_window`` is periodic);
* |STFT| and the mel filterbank as float32 products against fixed bases
  (``torch.matmul``: the reference computes them outside any Pallas
  kernel; on the card they need TF32 off to stay float32-exact);
* ``log1p``, cast to the compute dtype, then three 3x3 stride-2
  convolutions with relu (flax's SAME padding through ``pad_same``), the
  mean over the two spatial axes, and a float32 dense head.

Defaults are the Speech Commands task's (Warden 2018): 1 s clips at 16 kHz,
n_fft 400 (25 ms), hop 160 (10 ms), 40 mels, 12 classes.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ._init_util import init_seeded
from .mobilenet_v2 import _DTYPES, _np, conv_state, pad_same


def _mel_matrix(n_mels: int, n_fft: int, rate: int) -> np.ndarray:
    """Triangular mel filterbank (HTK mel scale), (n_fft//2+1, n_mels)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, rate / 2, n_bins)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(20.0), hz_to_mel(rate / 2), n_mels + 2))
    weights = np.zeros((n_bins, n_mels), np.float32)
    for i in range(n_mels):
        lo, ctr, hi = mel_pts[i], mel_pts[i + 1], mel_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-6)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-6)
        weights[:, i] = np.maximum(0.0, np.minimum(up, down))
    return weights


class KwsCNN(nn.Module):
    """PCM (N, samples, channels), integer or float -> float32 logits
    (N, num_classes)."""

    def __init__(self, num_classes: int = 12, rate: int = 16000, n_fft: int = 400,
                 hop: int = 160, n_mels: int = 40, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.n_fft, self.hop, self.dtype = n_fft, hop, dtype
        k = np.arange(n_fft // 2 + 1)[:, None] * np.arange(n_fft)[None, :]
        ang = 2.0 * np.pi * k / n_fft
        for name, value in (("window", np.hanning(n_fft)), ("cos_b", np.cos(ang).T),
                            ("sin_b", np.sin(ang).T),
                            ("mel", _mel_matrix(n_mels, n_fft, rate))):
            # fixed bases, not weights: they follow .to(device) but stay
            # float32 and out of the state_dict
            self.register_buffer(name, torch.from_numpy(value.astype(np.float32)),
                                 persistent=False)
        self.convs = nn.ModuleList(
            [nn.Conv2d(cin, cout, 3, 2) for cin, cout in ((1, 32), (32, 64), (64, 64))])
        self.dense = nn.Linear(64, num_classes)

    def forward(self, pcm: torch.Tensor) -> torch.Tensor:
        x = pcm.float().mean(dim=-1)  # mono mixdown
        if not pcm.dtype.is_floating_point:
            x = x / 32768.0
        x = x.unfold(-1, self.n_fft, self.hop) * self.window  # (N, frames, n_fft)
        re, im = x @ self.cos_b, x @ self.sin_b
        mel = (re * re + im * im) @ self.mel  # (N, frames, mels)
        h = torch.log1p(mel).to(self.dtype)[:, None]  # NCHW (N, 1, frames, mels)
        for conv in self.convs:
            h = F.relu(conv(pad_same(conv, h)))
        return self.dense(h.mean(dim=(2, 3)).float())


def build(custom_props=None):
    """Zoo entry: returns (module, in_spec, out_spec).

    module(pcm (N, samples, channels) int16 or float) -> logits (N, classes).
    Custom props: ``dtype``, ``rate``, ``samples``, ``channels``,
    ``classes``, ``seed`` — the JAX build's."""
    props = custom_props or {}
    dtype = _DTYPES[props.get("dtype", "bfloat16")]
    samples = int(props.get("samples", "16000"))  # 1 s clip
    channels = int(props.get("channels", "1"))
    classes = int(props.get("classes", "12"))
    model = KwsCNN(classes, int(props.get("rate", "16000")), dtype=dtype)
    if samples < model.n_fft:
        raise ValueError(f"kws_cnn needs samples >= n_fft ({model.n_fft}); got {samples}")
    init_seeded(model, int(props.get("seed", "0")))
    model.convs.to(dtype)  # the bases and the head stay float32
    in_spec = StreamSpec((TensorSpec((samples, channels), np.int16, "pcm"),), FORMAT_STATIC)
    out_spec = StreamSpec((TensorSpec((classes,), np.float32, "logits"),), FORMAT_STATIC)
    return model, in_spec, out_spec


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's KwsCNN variables as this module's ``state_dict``."""
    params = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    for i in range(3):
        conv_state(sd, f"convs.{i}", params[f"Conv_{i}"])
    sd["dense.weight"] = _np(np.asarray(params["Dense_0"]["kernel"]).T)
    sd["dense.bias"] = _np(params["Dense_0"]["bias"])
    return sd
