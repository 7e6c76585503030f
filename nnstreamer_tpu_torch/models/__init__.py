"""Model zoo: PyTorch implementations of the model families of
``nnstreamer_tpu.models``.

``build(name, custom_props)`` returns ``(module, in_spec, out_spec)``:
``module(*inputs)`` takes batched tensors and returns a tensor or a list
of tensors — the contract the torch-cuda backend consumes
(``custom=arch:<name>``).  Without a ``dtype`` prop the compute dtype is
bfloat16 when a CUDA device is present and float32 otherwise, as the JAX
zoo picks it.
"""

from __future__ import annotations

from importlib import import_module
from typing import Dict, Optional

import torch

_ZOO = {
    "mobilenet_v2": "nnstreamer_tpu_torch.models.mobilenet_v2",
    "ssd_mobilenet_v2": "nnstreamer_tpu_torch.models.ssd_mobilenet",
    "yolov5s": "nnstreamer_tpu_torch.models.yolov5",
    "posenet": "nnstreamer_tpu_torch.models.posenet",
    "transformer": "nnstreamer_tpu_torch.models.transformer",
    "deeplab": "nnstreamer_tpu_torch.models.deeplab",
    "kws_cnn": "nnstreamer_tpu_torch.models.kws_cnn",
    "vit": "nnstreamer_tpu_torch.models.vit",
}


def build(name: str, custom_props: Optional[Dict[str, str]] = None):
    if name not in _ZOO:
        raise KeyError(f"unknown model family {name!r}; available: {sorted(_ZOO)}")
    props = dict(custom_props or {})
    if "dtype" not in props:
        # the device-probed default of the JAX zoo: bfloat16 with an
        # accelerator, float32 on a host CPU
        props["dtype"] = "bfloat16" if torch.cuda.is_available() else "float32"
    return import_module(_ZOO[name]).build(props)
