"""SSD-MobileNet-v2 (PyTorch) — detection head for the bounding-box decoder.

Port of ``nnstreamer_tpu/models/ssd_mobilenet.py`` (Liu et al. 2016 on
Sandler et al. 2018): the MobileNet-v2 trunk of :mod:`.mobilenet_v2`, its
1280-wide head, four extra feature layers down to 1x1, and 3x3 box/class
heads over the six feature scales (19, 10, 5, 3, 2, 1 at 300x300), run in
float32 on features cast from the compute dtype.

Outputs match the ``mobilenet-ssd`` decoder contract:
  * loc    (P, 4)  raw (yc, xc, h, w) offsets
  * scores (P, C)  logits
with P = 2000 priors in the order of :func:`anchors` (rows are taken from
the heads' NHWC layout, cell by cell).  :func:`write_box_priors` writes the
decoder's option3 file.
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ._quant_flax import refuse_int8
from .mobilenet_v2 import (
    _CFG,
    _DTYPES,
    ConvBN,
    _make_divisible,
    conv_bn_state,
    conv_state,
    ingest,
    init_he,
    trunk,
    trunk_state,
)

# one (grid, scale) row per SSD feature map, 300x300 layout
_FEATURE_MAPS: Sequence[Tuple[int, float]] = (
    (19, 0.2), (10, 0.35), (5, 0.5), (3, 0.65), (2, 0.8), (1, 0.95),
)
_ASPECTS = (1.0, 2.0, 0.5)
_EXTRAS = (512, 256, 256, 128)


def anchors() -> np.ndarray:
    """SSD priors [P, 4] = (yc, xc, h, w), normalized to [0, 1]."""
    out: List[Tuple[float, float, float, float]] = []
    for i, (grid, scale) in enumerate(_FEATURE_MAPS):
        nxt = _FEATURE_MAPS[i + 1][1] if i + 1 < len(_FEATURE_MAPS) else 1.0
        for y, x in itertools.product(range(grid), repeat=2):
            yc = (y + 0.5) / grid
            xc = (x + 0.5) / grid
            for ar in _ASPECTS:
                out.append((yc, xc, scale / np.sqrt(ar), scale * np.sqrt(ar)))
            out.append((yc, xc, np.sqrt(scale * nxt), np.sqrt(scale * nxt)))
    return np.asarray(out, np.float64)


def num_priors() -> int:
    return sum(g * g * (len(_ASPECTS) + 1) for g, _ in _FEATURE_MAPS)


def write_box_priors(path: str) -> str:
    """Write the decoder's option3 file: 4 whitespace rows (yc, xc, h, w)."""
    pri = anchors().T  # [4, P]
    with open(path, "w", encoding="utf-8") as f:
        for row in pri:
            f.write(" ".join(f"{v:.8f}" for v in row) + "\n")
    return path


class SSDMobileNetV2(nn.Module):
    """NHWC uint8 (N, 300, 300, 3) -> float32 (loc (N, P, 4), scores (N, P, C))."""

    def __init__(self, num_classes: int = 91, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype, self.num_classes = dtype, num_classes
        self.stem, self.blocks, c = trunk()
        # the 19x19 map: after the last 96-wide block (stride 16)
        self.tap = sum(n for _, ch, n, _ in _CFG if ch <= 96) - 1
        last = _make_divisible(1280)
        self.head = ConvBN(c, last, 1)
        extras, c = [], last
        for ch in _EXTRAS:
            extras += [ConvBN(c, ch // 2, 1), ConvBN(ch // 2, ch, 3, 2)]
            c = ch
        self.extras = nn.ModuleList(extras)
        widths = (_make_divisible(96), last) + _EXTRAS
        per_cell = len(_ASPECTS) + 1
        self.loc = nn.ModuleList(nn.Conv2d(w, per_cell * 4, 3, padding=1) for w in widths)
        self.conf = nn.ModuleList(
            nn.Conv2d(w, per_cell * num_classes, 3, padding=1) for w in widths)

    def forward(self, x: torch.Tensor):
        x = self.stem(ingest(x, self.dtype))
        feats = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i == self.tap:
                feats.append(x)
        x = self.head(x)
        feats.append(x)
        for i in range(0, len(self.extras), 2):
            x = self.extras[i + 1](self.extras[i](x))
            feats.append(x)
        locs, confs = [], []
        for f, loc, conf in zip(feats, self.loc, self.conf):
            f = f.float()
            B = f.shape[0]
            # NHWC before the reshape: rows go cell by cell, as the priors do
            locs.append(loc(f).permute(0, 2, 3, 1).reshape(B, -1, 4))
            confs.append(conf(f).permute(0, 2, 3, 1).reshape(B, -1, self.num_classes))
        return torch.cat(locs, 1), torch.cat(confs, 1)


def build(custom_props=None):
    """Zoo entry: returns (module, in_spec, out_spec).

    module(images_u8 (N, 300, 300, 3)) -> [loc (N, P, 4), scores (N, P, C)].
    Custom props: ``dtype``, ``size`` (300 only: the priors encode the
    300x300 feature-map layout), ``classes``, ``seed``."""
    props = custom_props or {}
    refuse_int8(props)
    dtype = _DTYPES[props.get("dtype", "bfloat16")]
    size = int(props.get("size", "300"))
    if size != 300:
        raise ValueError("ssd_mobilenet_v2 supports size=300 only")
    classes = int(props.get("classes", "91"))
    seed = int(props.get("seed", "0"))
    model = init_he(SSDMobileNetV2(classes, dtype), seed)
    # the box and class heads as RetinaNet initializes them (Lin et al. 2017):
    # normal(0, 0.01) weights and a class prior of 0.01 in the class bias, so
    # random weights give spread scores, not He-normal logits that saturate
    # the sigmoid at 1.0 for most priors
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for head in (*model.loc, *model.conf):
            head.weight.copy_(torch.randn(head.weight.shape, generator=g) * 0.01)
        for head in model.conf:
            head.bias.fill_(-math.log((1 - 0.01) / 0.01))
    for part in (model.stem, model.blocks, model.head, model.extras):  # the heads stay float32
        part.to(dtype=dtype, memory_format=torch.channels_last)
    P = num_priors()
    in_spec = StreamSpec((TensorSpec((size, size, 3), np.uint8, "image"),), FORMAT_STATIC)
    out_spec = StreamSpec(
        (TensorSpec((P, 4), np.float32, "loc"), TensorSpec((P, classes), np.float32, "scores")),
        FORMAT_STATIC)
    return model, in_spec, out_spec


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's SSDMobileNetV2 variables as this module's
    ``state_dict``: ``ConvBN_1`` is the head, ``ConvBN_2``..``ConvBN_9``
    the extras in order, ``loc<i>``/``conf<i>`` the box and class heads."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    trunk_state(sd, "", params, stats)
    conv_bn_state(sd, "head", params["ConvBN_1"], stats["ConvBN_1"])
    for i in range(2 * len(_EXTRAS)):
        conv_bn_state(sd, f"extras.{i}", params[f"ConvBN_{i + 2}"], stats[f"ConvBN_{i + 2}"])
    for i in range(len(_FEATURE_MAPS)):
        conv_state(sd, f"loc.{i}", params[f"loc{i}"])
        conv_state(sd, f"conf.{i}", params[f"conf{i}"])
    return sd
