"""Model zoo: PyTorch implementations of the model families of
``nnstreamer_tpu.models``.

``build(name, custom_props)`` returns ``(module, in_spec, out_spec)``:
``module(*inputs)`` takes batched tensors and returns a tensor or a list
of tensors — the contract the torch-cuda backend consumes
(``custom=arch:<name>``).
"""

from __future__ import annotations

from importlib import import_module
from typing import Dict, Optional

_ZOO = {
    "mobilenet_v2": "nnstreamer_tpu_torch.models.mobilenet_v2",
}


def build(name: str, custom_props: Optional[Dict[str, str]] = None):
    if name not in _ZOO:
        raise KeyError(f"unknown model family {name!r}; available: {sorted(_ZOO)}")
    return import_module(_ZOO[name]).build(dict(custom_props or {}))
