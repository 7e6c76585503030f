"""MNIST CNN (PyTorch), the reference training example's model.

Port of ``nnstreamer_tpu/models/mnist_cnn.py``: (N, 28, 28, 1) frames,
uint8 scaled by 1/255 in the compute dtype (float frames cast as they
are); two 3x3 SAME convolutions with bias (32 and 64 wide), each followed
by relu and a 2x2 stride-2 max pool; the (N, 7, 7, 64) activations
flattened in NHWC order, as flax flattens them; a 128-wide dense layer
with relu; and a float32 head.  Parameters live in the compute dtype but
the head's, which is float32, as the other zoo families keep them.

:func:`state_dict_from_flax` converts the JAX package's params.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ._init_util import init_seeded
from .mobilenet_v2 import _DTYPES, _np, conv_state


class MnistCNN(nn.Module):
    """NHWC (N, 28, 28, 1) uint8 or float -> float32 logits (N, classes)."""

    def __init__(self, num_classes: int = 10, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1, dtype=dtype)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1, dtype=dtype)
        self.fc = nn.Linear(7 * 7 * 64, 128, dtype=dtype)
        self.head = nn.Linear(128, num_classes)  # float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            return self(x[None])[0]
        if x.dtype == torch.uint8:
            x = x.to(self.dtype) / 255.0
        else:
            x = x.to(self.dtype)
        x = x.permute(0, 3, 1, 2)  # NCHW view for the convolutions
        x = F.max_pool2d(F.relu(self.conv1(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # NHWC order, as the flax Dense expects
        x = F.relu(self.fc(x))
        return self.head(x.float())


def build(custom_props=None):
    """Zoo entry: returns (module, in_spec, out_spec).  Props: classes
    (10), dtype, seed: the JAX build's, with its defaults."""
    props = custom_props or {}
    classes = int(props.get("classes", "10"))
    model = MnistCNN(num_classes=classes, dtype=_DTYPES[props.get("dtype", "bfloat16")])
    init_seeded(model, int(props.get("seed", "0")))
    in_spec = StreamSpec((TensorSpec((28, 28, 1), np.float32, "image"),), FORMAT_STATIC)
    out_spec = StreamSpec((TensorSpec((classes,), np.float32, "logits"),), FORMAT_STATIC)
    return model, in_spec, out_spec


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's MNIST CNN variables ``{"params": ...}`` as this
    module's ``state_dict``: the HWIO conv kernels become OIHW and the
    Dense kernels (in, out) become (out, in)."""
    p = variables["params"]
    sd: Dict[str, torch.Tensor] = {}
    conv_state(sd, "conv1", p["Conv_0"])
    conv_state(sd, "conv2", p["Conv_1"])
    for name, flax_name in (("fc", "Dense_0"), ("head", "Dense_1")):
        sd[f"{name}.weight"] = _np(np.asarray(p[flax_name]["kernel"]).T)
        sd[f"{name}.bias"] = _np(p[flax_name]["bias"])
    return sd
