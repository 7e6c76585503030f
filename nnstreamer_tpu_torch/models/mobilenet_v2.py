"""MobileNet-v2 (PyTorch) — the headline classification model.

Port of ``nnstreamer_tpu/models/mobilenet_v2.py`` (Sandler et al. 2018):

* uint8 NHWC frames in; the ``normalize_u8`` kernel maps them to [-1, 1]
  in the compute dtype.  Its output, viewed as NCHW, is already in
  ``channels_last`` memory order, which the convolutions then keep.
* convolutions use TensorFlow's SAME padding, as flax's ``padding="SAME"``
  does: at stride 2 on an even size that pads 0 before and 1 after, which
  no symmetric ``Conv2d(padding=...)`` can express, so those layers pad
  explicitly (``_same_pads``).
* BatchNorm runs in inference mode (running statistics, eps 1e-5).
* the classifier runs in float32; output: 1001 float32 logits (class 0 =
  background, TFLite-compatible labeling).

:func:`state_dict_from_flax` converts the JAX package's ``{"params",
"batch_stats"}`` tree into this module's ``state_dict``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ..ops.preprocess import normalize_u8

# (expansion t, channels c, repeats n, stride s) — standard v2 table
_CFG: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow SAME padding (before, after) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def same_conv(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1,
              bias: bool = False, dilation: int = 1) -> nn.Conv2d:
    """A Conv2d for SAME padding: stride 1 with an odd kernel pads
    symmetrically itself; a strided one pads nothing (:func:`pad_same`)."""
    pad = 0 if stride > 1 else dilation * (kernel - 1) // 2
    return nn.Conv2d(cin, cout, kernel, stride, padding=pad, dilation=dilation,
                     groups=groups, bias=bias)


def pad_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """`x` padded for a strided `conv` as TensorFlow's SAME pads it (maybe
    asymmetrically); unchanged for stride 1."""
    (k, _), (s, _) = conv.kernel_size, conv.stride
    if s == 1:
        return x
    top, bottom = _same_pads(x.shape[2], k, s)
    left, right = _same_pads(x.shape[3], k, s)
    return F.pad(x, (left, right, top, bottom))  # keeps channels_last


class ConvBN(nn.Module):
    """Conv (no bias, SAME padding) + BatchNorm + optional relu6."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, act: bool = True):
        super().__init__()
        self.conv = same_conv(cin, cout, kernel, stride, groups)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn(self.conv(pad_same(self.conv, x)))
        return F.relu6(x) if self.act else x


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int):
        super().__init__()
        hidden = cin * expand
        layers: List[nn.Module] = [ConvBN(cin, hidden, 1)] if expand != 1 else []
        layers += [
            ConvBN(hidden, hidden, 3, stride, groups=hidden),  # depthwise
            ConvBN(hidden, cout, 1, act=False),  # linear projection
        ]
        self.layers = nn.Sequential(*layers)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.layers(x)
        return h + x if self.residual else h


def trunk(width_mult: float = 1.0, last_channels: int = 1 << 30,
          stride_cap: int = 1 << 30) -> Tuple[ConvBN, nn.ModuleList, int]:
    """The stride-2 stem and the inverted-residual stack of ``_CFG`` (the
    JAX build's ``ConvBN_0`` and ``InvertedResidual_<i>``), stopping before
    the first stage wider than `last_channels`; once the stride reaches
    `stride_cap`, later stride-2 blocks keep stride 1.  Returns the stem,
    the blocks and the output channels."""
    c = _make_divisible(32 * width_mult)
    stem, blocks, stride = ConvBN(3, c, 3, 2), [], 2
    for t, ch, n, s in _CFG:
        if ch > last_channels:
            break
        out_c = _make_divisible(ch * width_mult)
        for i in range(n):
            s_i = s if i == 0 else 1
            if stride >= stride_cap and s_i == 2:
                s_i = 1
            stride *= s_i
            blocks.append(InvertedResidual(c, out_c, s_i, t))
            c = out_c
    return stem, nn.ModuleList(blocks), c


def ingest(x: torch.Tensor, dtype: torch.dtype, scale: float = 2.0 / 255.0,
           bias: float = -1.0) -> torch.Tensor:
    """NHWC frames as NCHW in `dtype`: uint8 through the ``normalize_u8``
    kernel (``x * scale + bias``), anything else cast.  NHWC memory is
    channels_last NCHW, so the permute copies nothing."""
    if x.dtype == torch.uint8:
        x = normalize_u8(x, scale, bias, dtype=dtype)
    else:
        x = x.to(dtype)
    return x.permute(0, 3, 1, 2)


def init_he(module: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights (He-normal convs with zero biases, identity
    BatchNorm statistics, scaled-normal dense layers), drawn on the CPU
    from one ``torch.Generator`` in module order, so every device gets the
    same model."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.in_channels // m.groups * m.kernel_size[0] * m.kernel_size[1]
                w = torch.randn(m.weight.shape, generator=g) * math.sqrt(2.0 / fan_in)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, nn.Linear):
                w = torch.randn(m.weight.shape, generator=g) / math.sqrt(m.in_features)
                m.weight.copy_(w)
                m.bias.zero_()
    return module


class MobileNetV2(nn.Module):
    """NHWC uint8 (N, H, W, 3) -> float32 logits (N, num_classes)."""

    def __init__(self, num_classes: int = 1001, width_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem, self.blocks, c = trunk(width_mult)
        last = _make_divisible(1280 * max(width_mult, 1.0))
        self.head = ConvBN(c, last, 1)
        self.classifier = nn.Linear(last, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(ingest(x, self.dtype))
        for block in self.blocks:
            x = block(x)
        x = self.head(x)
        x = x.mean(dim=(2, 3))  # global average pool
        return self.classifier(x.float())


def build(custom_props=None):
    """Zoo entry: returns (module, in_spec, out_spec).

    module(images_u8 (N, size, size, 3)) -> logits (N, classes).  Custom
    props: ``dtype`` (bfloat16 | float32 | float16), ``size``, ``classes``,
    ``width``, ``seed`` — the JAX build's.  ``dtype`` defaults to bfloat16
    here; the zoo's ``build`` sets it from the device first (bfloat16 with a
    CUDA device, float32 without), as the JAX zoo does.
    """
    props = custom_props or {}
    dtype = _DTYPES[props.get("dtype", "bfloat16")]
    size = int(props.get("size", "224"))
    num_classes = int(props.get("classes", "1001"))
    model = MobileNetV2(num_classes, float(props.get("width", "1.0")), dtype)
    init_he(model, int(props.get("seed", "0")))
    for part in (model.stem, model.blocks, model.head):  # the classifier stays float32
        part.to(dtype=dtype, memory_format=torch.channels_last)
    in_spec = StreamSpec((TensorSpec((size, size, 3), np.uint8, "image"),), FORMAT_STATIC)
    out_spec = StreamSpec((TensorSpec((num_classes,), np.float32, "logits"),), FORMAT_STATIC)
    return model, in_spec, out_spec


def _np(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))  # a private, writable copy


def conv_state(sd: Dict[str, torch.Tensor], prefix: str, p) -> None:
    """A flax ``nn.Conv`` (HWIO kernel, optional bias) as the Conv2d at
    `prefix`: HWIO ``(kh, kw, in/groups, out)`` becomes OIHW (a depthwise
    ``(3, 3, 1, C)`` becomes ``(C, 1, 3, 3)``)."""
    sd[f"{prefix}.weight"] = _np(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{prefix}.bias"] = _np(p["bias"])


def conv_bn_state(sd: Dict[str, torch.Tensor], prefix: str, p, s) -> None:
    """A flax ``Conv_0`` + ``BatchNorm_0`` pair as the ``conv``/``bn``
    children at `prefix`: BatchNorm ``scale``/``bias``/``mean``/``var``
    become ``weight``/``bias``/``running_mean``/``running_var``."""
    conv_state(sd, f"{prefix}.conv", p["Conv_0"])
    sd[f"{prefix}.bn.weight"] = _np(p["BatchNorm_0"]["scale"])
    sd[f"{prefix}.bn.bias"] = _np(p["BatchNorm_0"]["bias"])
    sd[f"{prefix}.bn.running_mean"] = _np(s["BatchNorm_0"]["mean"])
    sd[f"{prefix}.bn.running_var"] = _np(s["BatchNorm_0"]["var"])
    sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(0)


def trunk_state(sd: Dict[str, torch.Tensor], prefix: str, params, stats) -> None:
    """The JAX build's ``ConvBN_0`` and ``InvertedResidual_<i>`` as the
    :func:`trunk` children ``{prefix}stem`` and ``{prefix}blocks.<i>``."""
    conv_bn_state(sd, f"{prefix}stem", params["ConvBN_0"], stats["ConvBN_0"])
    i = 0
    while f"InvertedResidual_{i}" in params:
        name = f"InvertedResidual_{i}"
        j = 0
        while f"ConvBN_{j}" in params[name]:
            conv_bn_state(sd, f"{prefix}blocks.{i}.layers.{j}", params[name][f"ConvBN_{j}"],
                          stats[name][f"ConvBN_{j}"])
            j += 1
        i += 1


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's MobileNetV2 variables ``{"params", "batch_stats"}``
    (nested dicts of arrays) as this module's ``state_dict``; ``Dense_0``
    ``(in, out)`` becomes the classifier's ``(out, in)``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    trunk_state(sd, "", params, stats)
    conv_bn_state(sd, "head", params["ConvBN_1"], stats["ConvBN_1"])
    sd["classifier.weight"] = _np(np.asarray(params["Dense_0"]["kernel"]).T)
    sd["classifier.bias"] = _np(params["Dense_0"]["bias"])
    return sd
