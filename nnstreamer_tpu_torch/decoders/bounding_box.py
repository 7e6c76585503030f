"""bounding_boxes decoder: detection tensors -> RGBA box-overlay video.

Port of ``nnstreamer_tpu/decoders/bounding_box.py``, with the same option
contract:

- option1: box mode — ``mobilenet-ssd`` (alias ``tflite-ssd``),
  ``mobilenet-ssd-postprocess`` (alias ``tf-ssd``), ``ov-person-detection``,
  ``ov-face-detection``, ``yolov5``, ``yolov8``, ``mp-palm-detection``
- option2: label file path
- option3: mode-dependent (priors file / scales / thresholds)
- option4: video output dimension ``WIDTH:HEIGHT``
- option5: model input dimension ``WIDTH:HEIGHT``
- option6: tracking flag (carried in meta)
- option7: log flag (logs the detection count)

Output: one RGBA tensor (H, W, 4) with box outlines + label stamps, plus
``meta["boxes"]`` = list of ``{x, y, w, h, score, class, label}`` in output
coordinates.

Host path: numpy decode + per-class NMS on the host.  Device half
(``device_fn``, folded into the upstream filter's backend call by the
pipeline's fusion pass) for ``mobilenet-ssd`` with priors and
``yolov5``/``yolov8``: box decode, score threshold, top-k preselect and
batched per-class NMS (``ops/nms.py``) run where the model's outputs live,
so only the surviving top-K boxes (3 KB a frame) leave the card.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.buffer import TensorFrame, materialize
from ..core.log import get_logger
from ..core.types import FORMAT_STATIC, StreamSpec, TensorSpec
from . import util

_MODES = (
    "mobilenet-ssd", "tflite-ssd",
    "mobilenet-ssd-postprocess", "tf-ssd",
    "ov-person-detection", "ov-face-detection",
    "yolov5", "yolov8",
    "mp-palm-detection",
)

_DEFAULT_OUT = (640, 480)
_DEFAULT_IN = (300, 300)


def _floats(parts: List[str], defaults: List[float]) -> List[float]:
    out = list(defaults)
    for i, p in enumerate(parts[: len(defaults)]):
        if p:
            try:
                out[i] = float(p)
            except ValueError:
                pass
    return out


class BoundingBoxes:
    NAME = "bounding_boxes"

    def __init__(self):
        self.mode = "mobilenet-ssd"
        self.labels: Optional[List[str]] = None
        self.out_wh = _DEFAULT_OUT
        self.in_wh = _DEFAULT_IN
        self.option3 = ""
        self.tracking = False
        self.log = False
        self._priors: Optional[np.ndarray] = None
        self._anchors: Optional[np.ndarray] = None

    # -- configuration ------------------------------------------------------

    def set_options(self, options: List[str]) -> None:
        o = list(options) + [""] * 9
        if o[0]:
            mode = o[0].strip()
            if mode not in _MODES:
                raise ValueError(f"bounding_boxes: unknown mode {mode!r}")
            self.mode = mode
        if o[1]:
            self.labels = util.load_labels(o[1])
        self.option3 = o[2]
        self.out_wh = util.parse_wh(o[3], _DEFAULT_OUT)
        self.in_wh = util.parse_wh(o[4], _DEFAULT_IN)
        self.tracking = o[5].strip() in ("1", "true", "TRUE")
        self.log = o[6].strip() in ("1", "true", "TRUE")
        if self.mode in ("mobilenet-ssd", "tflite-ssd"):
            self._parse_ssd_option3()
        if self.mode == "mp-palm-detection":
            self._parse_palm_option3()

    def _parse_ssd_option3(self) -> None:
        """option3 = priors.txt[:sigmoid_thr:y_scale:x_scale:h_scale:w_scale
        [:iou_thr]]."""
        parts = self.option3.split(":") if self.option3 else [""]
        if parts[0]:
            self._priors = _load_box_priors(parts[0])
        (self.ssd_thr, self.ssd_ys, self.ssd_xs, self.ssd_hs, self.ssd_ws,
         self.ssd_iou) = _floats(parts[1:], [0.5, 10.0, 10.0, 5.0, 5.0, 0.5])

    def _parse_palm_option3(self) -> None:
        """option3 = score_thr[:num_layers:min_scale:max_scale:offset_x
        :offset_y:stride...]."""
        parts = self.option3.split(":") if self.option3 else []
        vals = _floats(parts, [0.5, 4, 1.0, 1.0, 0.5, 0.5])
        self.palm_thr = vals[0]
        self.palm_layers = int(vals[1])
        self.palm_min_scale, self.palm_max_scale = vals[2], vals[3]
        self.palm_offset = (vals[4], vals[5])
        strides = [int(float(p)) for p in parts[6:] if p]
        self.palm_strides = strides or [8, 16, 16, 16][: self.palm_layers]
        self._anchors = None  # regenerate lazily

    def _yolo_options(self) -> List[float]:
        """option3 of the yolo modes: scaled:conf_thr:iou_thr."""
        return _floats(self.option3.split(":") if self.option3 else [], [0.0, 0.25, 0.45])

    # -- decoder ABI ---------------------------------------------------------

    def get_out_spec(self, in_spec: StreamSpec) -> StreamSpec:
        w, h = self.out_wh
        return StreamSpec(
            (TensorSpec((h, w, 4), np.uint8, "video_rgba"),),
            FORMAT_STATIC,
            in_spec.framerate if in_spec else None,
        )

    def decode(self, frame: TensorFrame, in_spec) -> TensorFrame:
        dets = self._detect(materialize(frame.tensors))  # [N,6] x1,y1,x2,y2,score,cls
        dets = util.nms(dets, getattr(self, "ssd_iou", 0.5))
        return self._render(frame, dets)

    def _render(self, frame: TensorFrame, dets: np.ndarray) -> TensorFrame:
        """[N,6] detections in model-input px -> RGBA overlay + boxes meta."""
        dets = dets.reshape(-1, 6)
        if dets.size:
            dets = dets.copy()
            dets[:, :4] = util.scale_boxes(dets[:, :4], self.in_wh, self.out_wh)

        w, h = self.out_wh
        canvas = util.blank_canvas(w, h)
        boxes_meta = []
        for x1, y1, x2, y2, score, cls in dets:
            color = util.class_color(int(cls))
            util.draw_rect(canvas, x1, y1, x2, y2, color, thickness=2)
            label = (self.labels[int(cls)]
                     if self.labels and int(cls) < len(self.labels) else str(int(cls)))
            util.draw_label(canvas, x1 + 2, max(0, y1 - 8), label, color)
            boxes_meta.append({
                "x": float(x1), "y": float(y1),
                "w": float(x2 - x1), "h": float(y2 - y1),
                "score": float(score), "class": int(cls), "label": label,
            })
        out = frame.with_tensors([canvas])
        out.meta["boxes"] = boxes_meta
        out.meta["box_mode"] = self.mode
        if self.log and boxes_meta:
            get_logger("decoder.bounding_boxes").info(
                "bounding_boxes[%s]: %d detections", self.mode, len(boxes_meta))
        return out

    # -- per-mode detection -> [N,6] (x1,y1,x2,y2,score,cls) in input px -----

    def _detect(self, tensors: List[np.ndarray]) -> np.ndarray:
        if self.mode in ("mobilenet-ssd", "tflite-ssd"):
            return self._detect_mobilenet_ssd(tensors)
        if self.mode in ("mobilenet-ssd-postprocess", "tf-ssd"):
            return self._detect_postprocess(tensors)
        if self.mode.startswith("ov-"):
            return self._detect_openvino(tensors)
        if self.mode == "yolov5":
            return self._detect_yolo(tensors[0], has_objectness=True)
        if self.mode == "yolov8":
            return self._detect_yolo(tensors[0], has_objectness=False)
        if self.mode == "mp-palm-detection":
            return self._detect_palm(tensors)
        raise ValueError(self.mode)

    def _detect_mobilenet_ssd(self, tensors) -> np.ndarray:
        """tensors = [locations [P,4] (yc,xc,h,w offsets), scores [P,C]];
        priors from the option3 file."""
        loc = tensors[0].reshape(-1, 4).astype(np.float64)
        scores = tensors[1].reshape(loc.shape[0], -1).astype(np.float64)
        if self._priors is None:
            raise ValueError("mobilenet-ssd requires box-priors file (option3)")
        pri = self._priors  # [P,4] = yc, xc, h, w
        yc = loc[:, 0] / self.ssd_ys * pri[:, 2] + pri[:, 0]
        xc = loc[:, 1] / self.ssd_xs * pri[:, 3] + pri[:, 1]
        hh = np.exp(loc[:, 2] / self.ssd_hs) * pri[:, 2]
        ww = np.exp(loc[:, 3] / self.ssd_ws) * pri[:, 3]
        w_in, h_in = self.in_wh
        x1 = (xc - ww / 2) * w_in
        y1 = (yc - hh / 2) * h_in
        x2 = (xc + ww / 2) * w_in
        y2 = (yc + hh / 2) * h_in
        probs = util.sigmoid(scores)
        cls = probs.argmax(axis=1)
        best = probs.max(axis=1)
        keep = best >= self.ssd_thr
        return np.stack(
            [x1[keep], y1[keep], x2[keep], y2[keep], best[keep],
             cls[keep].astype(np.float64)], axis=1)

    def _detect_postprocess(self, tensors) -> np.ndarray:
        """Already-decoded SSD head: [boxes [N,4] (ymin,xmin,ymax,xmax, 0..1),
        classes [N], scores [N], count [1]]; option3 may remap tensor order
        as ``%i:%i:%i:%i,%i``."""
        order = [0, 1, 2, 3]
        if self.option3:
            try:
                nums = [int(n) for n in self.option3.replace(",", ":").split(":")]
                order[: len(nums[:4])] = nums[:4]  # partial lists keep defaults
            except ValueError:
                pass
        boxes = tensors[order[0]].reshape(-1, 4).astype(np.float64)
        classes = tensors[order[1]].reshape(-1).astype(np.float64)
        scores = tensors[order[2]].reshape(-1).astype(np.float64)
        n = boxes.shape[0]
        if len(tensors) > max(order[3], 3):
            n = min(n, int(np.asarray(tensors[order[3]]).reshape(-1)[0]))
        boxes, classes, scores = boxes[:n], classes[:n], scores[:n]
        keep = scores >= 0.5
        w_in, h_in = self.in_wh
        ymin, xmin, ymax, xmax = (boxes[keep, i] for i in range(4))
        return np.stack(
            [xmin * w_in, ymin * h_in, xmax * w_in, ymax * h_in,
             scores[keep], classes[keep]], axis=1)

    def _detect_openvino(self, tensors) -> np.ndarray:
        """[1,1,N,7] rows = (image_id, label, conf, xmin, ymin, xmax, ymax),
        coords normalized 0..1."""
        rows = tensors[0].reshape(-1, 7).astype(np.float64)
        keep = (rows[:, 0] >= 0) & (rows[:, 2] >= 0.5)
        rows = rows[keep]
        w_in, h_in = self.in_wh
        return np.stack(
            [rows[:, 3] * w_in, rows[:, 4] * h_in,
             rows[:, 5] * w_in, rows[:, 6] * h_in,
             rows[:, 2], rows[:, 1]], axis=1)

    def _yolo_layout(self, rows: int, cols: int) -> bool:
        """Whether a yolov8 head of (rows, cols) ships as [4+C, N] (and so
        needs transposing): by the label count when known, else assume
        candidates outnumber channels."""
        ch = 4 + len(self.labels) if self.labels else None
        return (ch is not None and rows == ch and cols != ch) or (ch is None and rows < cols)

    def _detect_yolo(self, pred: np.ndarray, has_objectness: bool) -> np.ndarray:
        """yolov5: [N, 5+C] (cx,cy,w,h,obj,cls...); yolov8: [4+C, N] or
        [N, 4+C] (no objectness).  option3 = scaled:conf_thr:iou_thr."""
        scaled_f, conf_thr, iou_thr = self._yolo_options()
        self.ssd_iou = iou_thr  # reused by the NMS stage in decode()
        pred = np.asarray(pred, dtype=np.float64)
        pred = pred.reshape(-1, pred.shape[-1]) if pred.ndim > 2 else pred
        if not has_objectness and self._yolo_layout(*pred.shape):
            pred = pred.T
        cx, cy, w, h = pred[:, 0], pred[:, 1], pred[:, 2], pred[:, 3]
        if has_objectness:
            conf = pred[:, 4:5] * pred[:, 5:]
        else:
            conf = pred[:, 4:]
        if conf.size == 0:  # no class columns: nothing to detect
            return np.zeros((0, 6))
        cls = conf.argmax(axis=1)
        score = conf.max(axis=1)
        if int(scaled_f) == 0:  # normalized 0..1 coords -> input px
            w_in, h_in = self.in_wh
            cx, w = cx * w_in, w * w_in
            cy, h = cy * h_in, h * h_in
        keep = score >= conf_thr
        return np.stack(
            [(cx - w / 2)[keep], (cy - h / 2)[keep],
             (cx + w / 2)[keep], (cy + h / 2)[keep],
             score[keep], cls[keep].astype(np.float64)], axis=1)

    def _detect_palm(self, tensors) -> np.ndarray:
        """MediaPipe palm detection: [boxes [N,18], scores [N]]; SSD anchors
        generated from the stride configuration."""
        if self._anchors is None:
            self._anchors = _generate_palm_anchors(
                self.in_wh, self.palm_strides, self.palm_min_scale,
                self.palm_max_scale, self.palm_offset)
        raw = tensors[0].reshape(-1, tensors[0].shape[-1]).astype(np.float64)
        scores = util.sigmoid(tensors[1].reshape(-1).astype(np.float64))
        anchors = self._anchors[: raw.shape[0]]
        w_in, h_in = self.in_wh
        cx = raw[:, 0] / w_in + anchors[:, 0]
        cy = raw[:, 1] / h_in + anchors[:, 1]
        ww = raw[:, 2] / w_in * anchors[:, 2]  # anchor scale from option3
        hh = raw[:, 3] / h_in * anchors[:, 3]
        keep = scores >= self.palm_thr
        return np.stack(
            [(cx - ww / 2)[keep] * w_in, (cy - hh / 2)[keep] * h_in,
             (cx + ww / 2)[keep] * w_in, (cy + hh / 2)[keep] * h_in,
             scores[keep], np.zeros(int(keep.sum()))], axis=1)

    # -- device-fused half (pipeline fusion pass) ---------------------------
    #: surviving candidates shipped to the host per frame: 128 x 6 floats
    #: (3 KB) against yolov5's 25200 x 85 float head (8.6 MB)
    FUSED_TOPK = 128

    def supports_device_fn(self) -> bool:
        """Only the modes whose decode has static shapes (and a raw head
        worth keeping on the card) have a device half."""
        if self.mode in ("mobilenet-ssd", "tflite-ssd"):
            return self._priors is not None
        return self.mode in ("yolov5", "yolov8")

    def device_fn(self, outs, device=None):
        """Device half, run inside the upstream filter's backend call on its
        device: box decode -> score threshold -> top-k preselect -> batched
        per-class NMS (``ops/nms.py``).  Returns [boxes (B,K,4) px, scores
        (B,K), classes (B,K)], float32, with suppressed and padded rows
        carrying score 0 (K = min(128, candidates))."""
        import torch

        from ..ops.nms import batched_nms

        outs = [torch.as_tensor(o) if device is None else torch.as_tensor(o).to(device)
                for o in outs]
        if self.mode in ("mobilenet-ssd", "tflite-ssd"):
            boxes, scores, classes = self._device_ssd(outs)
            thr, iou = self.ssd_thr, self.ssd_iou
        else:
            scaled_f, thr, iou = self._yolo_options()
            boxes, scores, classes = self._device_yolo(outs, scaled_f)
        scores = torch.where(scores >= thr, scores, 0.0)
        k = min(self.FUSED_TOPK, scores.shape[-1])
        # jax.lax.top_k order: the lower index first among equal scores
        top_s, idx = (t[:, :k] for t in torch.sort(scores, dim=1, descending=True, stable=True))
        top_b = boxes.gather(1, idx[..., None].expand(-1, -1, 4))
        top_c = classes.gather(1, idx)
        # per-class NMS (the host util.nms semantics) through class-offset
        # islands: each class's boxes move to a disjoint coordinate range,
        # so boxes of two classes never overlap
        island = float(4 * max(*self.in_wh, *self.out_wh))
        keep = batched_nms(top_b + top_c[..., None] * island, top_s, iou_thr=float(iou))
        top_s = torch.where(keep, top_s, 0.0)
        return [top_b, top_s, top_c]

    def _device_ssd(self, outs):
        """mobilenet-ssd decode (``_detect_mobilenet_ssd``) in float32, batched."""
        import torch

        loc = outs[0]
        if loc.ndim == 2:  # single-frame invoke path: (P, 4), no batch
            loc = loc[None]
        loc = loc.reshape(loc.shape[0], -1, 4).float()
        pri = torch.as_tensor(self._priors, dtype=torch.float32, device=loc.device)  # yc, xc, h, w
        scores = outs[1].reshape(loc.shape[0], loc.shape[1], -1).float()
        yc = loc[..., 0] / self.ssd_ys * pri[:, 2] + pri[:, 0]
        xc = loc[..., 1] / self.ssd_xs * pri[:, 3] + pri[:, 1]
        hh = torch.exp(loc[..., 2] / self.ssd_hs) * pri[:, 2]
        ww = torch.exp(loc[..., 3] / self.ssd_ws) * pri[:, 3]
        w_in, h_in = self.in_wh
        boxes = torch.stack(
            [(xc - ww / 2) * w_in, (yc - hh / 2) * h_in,
             (xc + ww / 2) * w_in, (yc + hh / 2) * h_in], dim=-1)
        best, cls = torch.sigmoid(scores).max(dim=-1)
        return boxes, best, cls.float()

    def _device_yolo(self, outs, scaled_f):
        """yolov5/yolov8 decode (``_detect_yolo``) in float32, batched; the
        layout heuristics read static shapes."""
        import torch

        pred = outs[0].float()
        if pred.ndim == 2:
            pred = pred[None]
        if pred.ndim > 3:
            pred = pred.reshape(pred.shape[0], -1, pred.shape[-1])
        has_obj = self.mode == "yolov5"
        if not has_obj and self._yolo_layout(pred.shape[1], pred.shape[2]):
            pred = pred.transpose(1, 2)
        B = pred.shape[0]
        if pred.shape[-1] <= (5 if has_obj else 4):  # no class columns
            zeros = torch.zeros((B, 1), dtype=torch.float32, device=pred.device)
            return zeros[..., None].expand(B, 1, 4), zeros, zeros
        cx, cy, w, h = (pred[..., i] for i in range(4))
        conf = pred[..., 4:5] * pred[..., 5:] if has_obj else pred[..., 4:]
        score, cls = conf.max(dim=-1)
        if int(scaled_f) == 0:  # normalized 0..1 coords -> input px
            w_in, h_in = self.in_wh
            cx, w = cx * w_in, w * w_in
            cy, h = cy * h_in, h * h_in
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
        return boxes, score, cls.float()

    def decode_fused(self, frame: TensorFrame, in_spec) -> TensorFrame:
        """Host finish after ``device_fn``: tensors are [boxes, scores,
        classes]; thresholding and NMS already ran, so this filters the
        zero rows and renders."""
        b, s, c = (t.astype(np.float64) for t in materialize(frame.tensors[:3]))
        b, s, c = b.reshape(-1, 4), s.reshape(-1), c.reshape(-1)
        keep = s > 0
        dets = np.concatenate([b[keep], s[keep, None], c[keep, None]], axis=1)
        # the top-k order is score-descending already; keep it stable
        dets = dets[np.argsort(-dets[:, 4], kind="stable")]
        return self._render(frame, dets)


def _load_box_priors(path: str) -> np.ndarray:
    """box-priors.txt: 4 whitespace-separated rows (yc, xc, h, w) x P columns."""
    rows = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if vals:
                rows.append(vals)
    if len(rows) < 4:
        raise ValueError(f"box priors file {path!r} needs 4 rows, got {len(rows)}")
    return np.asarray(rows[:4], dtype=np.float64).T  # [P,4]


def _generate_palm_anchors(in_wh: Tuple[int, int], strides, min_scale: float,
                           max_scale: float, offset) -> np.ndarray:
    """SSD anchor generation (MediaPipe ssd_anchors_calculator semantics):
    per stride layer, a grid of (W/stride x H/stride) centers, 2 anchors
    per location."""
    w_in, h_in = in_wh
    anchors = []
    n = len(strides)
    for i, stride in enumerate(strides):
        scale = (min_scale + (max_scale - min_scale) * i / max(1, n - 1))
        gw, gh = max(1, w_in // stride), max(1, h_in // stride)
        ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        cx = ((xs + offset[0]) / gw).reshape(-1)
        cy = ((ys + offset[1]) / gh).reshape(-1)
        for _ in range(2):
            anchors.append(np.stack([cx, cy,
                                     np.full_like(cx, scale),
                                     np.full_like(cy, scale)], axis=1))
    return np.concatenate(anchors, axis=0)
