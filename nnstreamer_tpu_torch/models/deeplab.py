"""DeepLab-style semantic segmentation (PyTorch) — pairs with the
``image_segment`` decoder.

Port of ``nnstreamer_tpu/models/deeplab.py``: the MobileNet-v2 trunk of
:mod:`.mobilenet_v2` with its output stride capped at 16 (later stride-2
blocks keep stride 1), an ASPP-lite head (1x1, two atrous 3x3 branches at
dilations 2 and 4, image pooling), a float32 1x1 classifier and a bilinear
resize back to the input grid (half-pixel centres, as
``jax.image.resize(..., "bilinear")`` upsamples).  Output: (H, W, classes)
float32 scores, the ``tflite-deeplab`` layout (NHWC).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ._quant_flax import refuse_int8
from .mobilenet_v2 import (
    _DTYPES,
    ConvBN,
    conv_bn_state,
    conv_state,
    ingest,
    init_he,
    same_conv,
    trunk,
    trunk_state,
)


class ASPPLite(nn.Module):
    def __init__(self, cin: int, features: int = 128):
        super().__init__()
        self.b1 = ConvBN(cin, features, 1)
        # atrous branches: plain convolutions (no BatchNorm, no activation)
        self.b2 = same_conv(cin, features, 3, dilation=2)
        self.b3 = same_conv(cin, features, 3, dilation=4)
        self.pool = ConvBN(cin, features, 1)
        self.proj = ConvBN(4 * features, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2:]
        # image-level pooling branch, broadcast back to the grid
        gp = self.pool(x.mean(dim=(2, 3), keepdim=True)).expand(-1, -1, h, w)
        return self.proj(torch.cat([self.b1(x), self.b2(x), self.b3(x), gp], 1))


class DeepLabLite(nn.Module):
    """NHWC uint8 (N, H, W, 3) -> float32 class scores (N, H, W, classes)."""

    def __init__(self, num_classes: int = 21, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem, self.blocks, c = trunk(stride_cap=16)
        self.aspp = ASPPLite(c)
        self.classifier = nn.Conv2d(128, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[1:3]
        x = self.stem(ingest(x, self.dtype))
        for block in self.blocks:
            x = block(x)
        x = self.classifier(self.aspp(x).float())
        x = F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False)
        return x.permute(0, 2, 3, 1)


def build(custom_props=None):
    """Zoo entry: returns (module, in_spec, out_spec).

    module(images_u8 (N, size, size, 3)) -> scores (N, size, size, classes).
    Custom props: ``dtype`` (bfloat16 | float32 | float16), ``size``,
    ``classes``, ``seed``."""
    props = custom_props or {}
    refuse_int8(props)
    dtype = _DTYPES[props.get("dtype", "bfloat16")]
    size = int(props.get("size", "257"))
    classes = int(props.get("classes", "21"))
    model = init_he(DeepLabLite(classes, dtype), int(props.get("seed", "0")))
    for part in (model.stem, model.blocks, model.aspp):  # the classifier stays float32
        part.to(dtype=dtype, memory_format=torch.channels_last)
    in_spec = StreamSpec((TensorSpec((size, size, 3), np.uint8, "image"),), FORMAT_STATIC)
    out_spec = StreamSpec(
        (TensorSpec((size, size, classes), np.float32, "class_scores"),), FORMAT_STATIC)
    return model, in_spec, out_spec


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's DeepLabLite variables as this module's
    ``state_dict``: ``_Backbone_0`` is the trunk; in ``_ASPPLite_0``,
    ``ConvBN_0`` is b1, ``Conv_0``/``Conv_1`` the atrous b2/b3, ``ConvBN_1``
    the pooling branch and ``ConvBN_2`` the projection; the top-level
    ``Conv_0`` is the classifier."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    trunk_state(sd, "", params["_Backbone_0"], stats["_Backbone_0"])
    p, s = params["_ASPPLite_0"], stats["_ASPPLite_0"]
    for name, flax_name in (("b1", "ConvBN_0"), ("pool", "ConvBN_1"), ("proj", "ConvBN_2")):
        conv_bn_state(sd, f"aspp.{name}", p[flax_name], s[flax_name])
    conv_state(sd, "aspp.b2", p["Conv_0"])
    conv_state(sd, "aspp.b3", p["Conv_1"])
    conv_state(sd, "classifier", params["Conv_0"])
    return sd
