"""PoseNet (PyTorch) — keypoint heatmap model for the pose decoder.

Port of ``nnstreamer_tpu/models/posenet.py``: the MobileNet-v2 trunk of
:mod:`.mobilenet_v2` truncated at stride 16 (the stages up to 96 wide),
then 1x1 float32 heads emitting what ``tensor_decoder
mode=pose_estimation`` reads, in NHWC: heatmaps (gh, gw, K) and, with the
``offsets`` prop on (the default), offsets (gh, gw, 2K) for
``option4=heatmap-offset``.  K = 17 COCO keypoints by default.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from .mobilenet_v2 import _DTYPES, conv_state, ingest, init_he, trunk, trunk_state


class PoseNet(nn.Module):
    """NHWC uint8 (N, size, size, 3) -> float32 heatmaps (N, gh, gw, K)
    [and offsets (N, gh, gw, 2K)]."""

    def __init__(self, num_keypoints: int = 17, with_offsets: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.stem, self.blocks, c = trunk(last_channels=96)  # pose wants resolution
        self.heatmap = nn.Conv2d(c, num_keypoints, 1)
        self.offsets = nn.Conv2d(c, 2 * num_keypoints, 1) if with_offsets else None

    def forward(self, x: torch.Tensor):
        x = self.stem(ingest(x, self.dtype))
        for block in self.blocks:
            x = block(x)
        x = x.float()
        heads = [self.heatmap] + ([self.offsets] if self.offsets is not None else [])
        return tuple(h(x).permute(0, 2, 3, 1) for h in heads)  # NHWC, as the reference


def build(custom_props=None):
    """Zoo entry: returns (module, in_spec, out_spec).

    module(images_u8 (N, size, size, 3)) -> [heatmap (N, gh, gw, K)[,
    offsets (N, gh, gw, 2K)]], gh = gw = ceil(size / 16).  Custom props:
    ``dtype``, ``size``, ``keypoints``, ``offsets``, ``seed``.  ``quantize``
    is not read: ``quantize:int8`` builds the float model, as the JAX build
    does."""
    props = custom_props or {}
    dtype = _DTYPES[props.get("dtype", "bfloat16")]
    size = int(props.get("size", "257"))
    kpts = int(props.get("keypoints", "17"))
    with_off = props.get("offsets", "1") not in ("0", "false")
    model = init_he(PoseNet(kpts, with_off, dtype), int(props.get("seed", "0")))
    for part in (model.stem, model.blocks):  # the heads stay float32
        part.to(dtype=dtype, memory_format=torch.channels_last)
    gh = gw = (size + 15) // 16
    in_spec = StreamSpec((TensorSpec((size, size, 3), np.uint8, "image"),), FORMAT_STATIC)
    outs = [TensorSpec((gh, gw, kpts), np.float32, "heatmap")]
    if with_off:
        outs.append(TensorSpec((gh, gw, 2 * kpts), np.float32, "offsets"))
    return model, in_spec, StreamSpec(tuple(outs), FORMAT_STATIC)


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's PoseNet variables as this module's ``state_dict``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    trunk_state(sd, "", params, stats)
    for head in ("heatmap", "offsets"):
        if head in params:
            conv_state(sd, head, params[head])
    return sd
