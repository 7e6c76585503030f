"""YOLOv5s (PyTorch) — single-stage detector for the yolov5 decoder mode.

Port of ``nnstreamer_tpu/models/yolov5.py`` (Ultralytics YOLOv5 v6 "s":
depth 0.33, width 0.50): CSP backbone, SPPF, FPN + PAN neck and a 3-scale
anchored detect head whose grid/anchor decode runs inside the model, so it
emits the decoder's [N, 5+C] tensor of normalized (cx, cy, w, h),
objectness and class scores (N = 25200 at 640).

* uint8 NHWC frames in; the ``normalize_u8`` kernel computes ``x * (1/255)``
  (the reference divides by 255: one float32 ulp apart at most).
* every strided convolution pads as TensorFlow's SAME does
  (:func:`.mobilenet_v2.pad_same`): 0 before and 1 after at stride 2 on an
  even size, 2 and 2 for the 6x6 stem.
* the detect convolutions run in float32 on features cast from the compute
  dtype; their NCHW output goes to NHWC before it is split into anchors.
* ``nms:1`` (with ``iou``, ``nms_topk``) runs ``ops.nms.batched_nms`` on the
  top-k candidates inside the model and zeroes the objectness of the
  suppressed ones.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from ._quant_flax import refuse_int8
from .mobilenet_v2 import _DTYPES, conv_bn_state, conv_state, ingest, init_he, pad_same, same_conv

# (stride, anchors (w,h) in px @ 640) — standard yolov5 anchor table
_ANCHORS: Sequence[Tuple[int, Tuple[Tuple[float, float], ...]]] = (
    (8, ((10, 13), (16, 30), (33, 23))),
    (16, ((30, 61), (62, 45), (59, 119))),
    (32, ((116, 90), (156, 198), (373, 326))),
)


class ConvBnSiLU(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1):
        super().__init__()
        self.conv = same_conv(cin, cout, kernel, stride)
        self.bn = nn.BatchNorm2d(cout, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(pad_same(self.conv, x))))


class Bottleneck(nn.Module):
    def __init__(self, c: int, shortcut: bool = True):
        super().__init__()
        self.cv1, self.cv2 = ConvBnSiLU(c, c, 1), ConvBnSiLU(c, c, 3)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.cv2(self.cv1(x))
        return x + h if self.shortcut else h


class C3(nn.Module):
    def __init__(self, cin: int, cout: int, n: int = 1, shortcut: bool = True):
        super().__init__()
        c = cout // 2
        self.a, self.b = ConvBnSiLU(cin, c, 1), ConvBnSiLU(cin, c, 1)
        self.m = nn.Sequential(*(Bottleneck(c, shortcut) for _ in range(n)))
        self.out = ConvBnSiLU(2 * c, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.cat([self.m(self.a(x)), self.b(x)], 1))


class SPPF(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.cv1, self.cv2 = ConvBnSiLU(cin, cout // 2, 1), ConvBnSiLU(4 * (cout // 2), cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        p1 = F.max_pool2d(x, 5, 1, 2)  # SAME: -inf padding, as flax's max_pool
        p2 = F.max_pool2d(p1, 5, 1, 2)
        p3 = F.max_pool2d(p2, 5, 1, 2)
        return self.cv2(torch.cat([x, p1, p2, p3], 1))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2, mode="nearest")


# the JAX build's ConvBnSiLU_<k> and C3_<k>, in the order flax names them:
# (cin, cout, kernel, stride) and (cin, cout, bottlenecks, shortcut)
_CONVS = ((3, 32, 6, 2), (32, 64, 3, 2), (64, 128, 3, 2), (128, 256, 3, 2), (256, 512, 3, 2),
          (512, 256, 1, 1), (256, 128, 1, 1), (128, 128, 3, 2), (256, 256, 3, 2))
_C3S = ((64, 64, 1, True), (128, 128, 2, True), (256, 256, 3, True), (512, 512, 1, True),
        (512, 256, 1, False), (256, 128, 1, False), (256, 256, 1, False), (512, 512, 1, False))


class YOLOv5s(nn.Module):
    """NHWC uint8 (N, size, size, 3) -> float32 (N, candidates, 5 + C)."""

    def __init__(self, num_classes: int = 80, size: int = 640,
                 dtype: torch.dtype = torch.bfloat16, nms: bool = False,
                 iou_thr: float = 0.45, nms_topk: int = 300):
        super().__init__()
        self.dtype, self.num_classes, self.size = dtype, num_classes, size
        self.nms, self.iou_thr, self.nms_topk = nms, iou_thr, nms_topk
        self.convs = nn.ModuleList(ConvBnSiLU(*c) for c in _CONVS)
        self.c3s = nn.ModuleList(C3(*c) for c in _C3S)
        self.sppf = SPPF(512, 512)
        no = 5 + num_classes
        self.detect = nn.ModuleList(
            nn.Conv2d(c, len(a) * no, 1) for c, (_, a) in zip((128, 256, 512), _ANCHORS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cv, c3 = self.convs, self.c3s
        x = ingest(x, self.dtype, 1.0 / 255.0, 0.0)
        x = c3[0](cv[1](cv[0](x)))                              # P2/4
        p3 = c3[1](cv[2](x))                                    # P3/8
        p4 = c3[2](cv[3](p3))                                   # P4/16
        p5 = self.sppf(c3[3](cv[4](p4)))                        # P5/32
        h5 = cv[5](p5)
        h4r = cv[6](c3[4](torch.cat([_upsample2(h5), p4], 1)))
        h3 = c3[5](torch.cat([_upsample2(h4r), p3], 1))         # out P3
        h4o = c3[6](torch.cat([cv[7](h3), h4r], 1))
        h5o = c3[7](torch.cat([cv[8](h4o), h5], 1))
        out = torch.cat([self._decode(i, f) for i, f in enumerate((h3, h4o, h5o))], 1)
        return self._suppress(out) if self.nms else out

    def _decode(self, i: int, feat: torch.Tensor) -> torch.Tensor:
        """One scale's raw conv -> sigmoid -> grid/anchor decode, (B, H*W*na, no)."""
        stride, anchor_list = _ANCHORS[i]
        na, no = len(anchor_list), 5 + self.num_classes
        raw = self.detect[i](feat.float())
        B, _, H, W = raw.shape
        y = torch.sigmoid(raw.permute(0, 2, 3, 1).reshape(B, H, W, na, no))
        gy, gx = torch.meshgrid(torch.arange(H, device=y.device),
                                torch.arange(W, device=y.device), indexing="ij")
        grid = torch.stack([gx, gy], -1).float()  # (H, W, 2) as x, y
        anc = torch.tensor(anchor_list, dtype=torch.float32, device=y.device)  # (na, 2) w, h
        xy = (y[..., :2] * 2.0 - 0.5 + grid[:, :, None]) * stride
        wh = (y[..., 2:4] * 2.0) ** 2 * anc[None, None]
        box = torch.cat([xy, wh], -1) / self.size  # normalized
        return torch.cat([box, y[..., 4:]], -1).reshape(B, -1, no)

    def _suppress(self, out: torch.Tensor) -> torch.Tensor:
        """In-model batched NMS (``nms:1``): the top-k candidates by
        objectness x best class, class-offset boxes (classes never overlap),
        and the suppressed candidates' objectness set to 0."""
        from ..ops.nms import batched_nms

        B, N = out.shape[:2]
        K = min(self.nms_topk, N)
        cxcy, wh = out[..., :2], out[..., 2:4]
        boxes = torch.cat([cxcy - wh / 2, cxcy + wh / 2], -1)
        best, cls = out[..., 5:].max(-1)
        boxes = boxes + (cls.to(boxes.dtype) * 2.0)[..., None]
        score = out[..., 4] * best
        # jax.lax.top_k order: the lower index first among equal scores
        topv, topi = (t[:, :K] for t in torch.sort(score, dim=1, descending=True, stable=True))
        keep_k = batched_nms(boxes.gather(1, topi[..., None].expand(-1, -1, 4)), topv,
                             iou_thr=self.iou_thr)
        mask = torch.zeros((B, N), dtype=torch.bool, device=out.device).scatter(1, topi, keep_k)
        out[..., 4] *= mask.to(out.dtype)
        return out


def num_candidates(size: int) -> int:
    return sum((size // s) * (size // s) * len(a) for s, a in _ANCHORS)


def build(custom_props=None):
    """Zoo entry: returns (module, in_spec, out_spec).

    module(images_u8 (N, size, size, 3)) -> pred (N, candidates, 5 + C), for
    ``tensor_decoder mode=bounding_boxes option1=yolov5``.  Custom props:
    ``dtype``, ``size`` (a multiple of 32), ``classes``, ``seed``, ``nms``,
    ``iou``, ``nms_topk``."""
    props = custom_props or {}
    refuse_int8(props)
    dtype = _DTYPES[props.get("dtype", "bfloat16")]
    size = int(props.get("size", "640"))
    if size % 32:
        raise ValueError("yolov5 input size must be a multiple of 32")
    classes = int(props.get("classes", "80"))
    model = YOLOv5s(classes, size, dtype, nms=props.get("nms", "0") in ("1", "true"),
                    iou_thr=float(props.get("iou", "0.45")),
                    nms_topk=int(props.get("nms_topk", "300")))
    init_he(model, int(props.get("seed", "0")))
    for part in (model.convs, model.c3s, model.sppf):  # the detect convs stay float32
        part.to(dtype=dtype, memory_format=torch.channels_last)
    in_spec = StreamSpec((TensorSpec((size, size, 3), np.uint8, "image"),), FORMAT_STATIC)
    out_spec = StreamSpec(
        (TensorSpec((num_candidates(size), 5 + classes), np.float32, "pred"),), FORMAT_STATIC)
    return model, in_spec, out_spec


def _conv_bn_silu_tree(sd: Dict[str, torch.Tensor], prefix: str, params, stats,
                       names: List[Tuple[str, str]]) -> None:
    for torch_name, flax_name in names:
        conv_bn_state(sd, f"{prefix}{torch_name}", params[flax_name], stats[flax_name])


def state_dict_from_flax(variables: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's YOLOv5s variables as this module's ``state_dict``:
    ``ConvBnSiLU_<k>`` -> ``convs.<k>``, ``C3_<k>`` -> ``c3s.<k>`` (inside:
    ``ConvBnSiLU_0/1/2`` -> ``a``/``b``/``out``, ``Bottleneck_<j>`` ->
    ``m.<j>``), ``SPPF_0`` -> ``sppf``, ``detect<i>`` -> ``detect.<i>``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    _conv_bn_silu_tree(sd, "convs.", params, stats,
                       [(str(k), f"ConvBnSiLU_{k}") for k in range(len(_CONVS))])
    for k in range(len(_C3S)):
        p, s = params[f"C3_{k}"], stats[f"C3_{k}"]
        _conv_bn_silu_tree(sd, f"c3s.{k}.", p, s,
                           [("a", "ConvBnSiLU_0"), ("b", "ConvBnSiLU_1"), ("out", "ConvBnSiLU_2")])
        for j in range(_C3S[k][2]):
            _conv_bn_silu_tree(sd, f"c3s.{k}.m.{j}.", p[f"Bottleneck_{j}"], s[f"Bottleneck_{j}"],
                               [("cv1", "ConvBnSiLU_0"), ("cv2", "ConvBnSiLU_1")])
    _conv_bn_silu_tree(sd, "sppf.", params["SPPF_0"], stats["SPPF_0"],
                       [("cv1", "ConvBnSiLU_0"), ("cv2", "ConvBnSiLU_1")])
    for i in range(len(_ANCHORS)):
        conv_state(sd, f"detect.{i}", params[f"detect{i}"])
    return sd
