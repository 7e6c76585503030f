"""Port parity: ``ops.nms.batched_nms``, the decoder helpers and the
bounding-box decoder against the JAX package, on the CPU.

* ``batched_nms``: keep masks exactly equal to JAX ``ops/nms.py`` on
  random boxes with deliberate score ties and zero-score padding, batched
  and single, plus the contracts of JAX ``tests/test_ops.py:34-57``.
* ``decoders/util.py``: the IoU matrix and host NMS equal, canvases drawn
  by the same calls byte-equal.
* every bounding-box mode's host ``decode`` on identical raw tensors: the
  RGBA canvas byte-equal, ``meta`` equal (floats within 1e-6);
* the device half (``device_fn``) of ``mobilenet-ssd``, ``yolov5`` and
  ``yolov8``: boxes within 1e-6 of the image size (the decode rounds in
  float32 at the scale of normalized coordinates, and exp and sigmoid
  differ by an ulp between XLA and PyTorch), scores within 1e-6, classes
  and the keep pattern exact; then ``decode_fused`` as above, its box
  coordinates within 1e-6 of the output size.  The raw tensors are checked to hold no
  near-tie (a score within 1e-6 of the threshold or of its neighbour in
  the sort, an IoU within 1e-6 of ``iou_thr``);
* fused equals host on the port, with the tolerances of JAX
  ``tests/test_device_fusion.py:188-196``, when fewer than K candidates
  pass the threshold.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core.buffer import TensorFrame as JaxFrame
from nnstreamer_tpu.decoders import util as jax_util
from nnstreamer_tpu.decoders.bounding_box import BoundingBoxes as JaxBoxes
from nnstreamer_tpu.ops.nms import batched_nms as jax_nms
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.decoders import util
from nnstreamer_tpu_torch.decoders.bounding_box import BoundingBoxes
from nnstreamer_tpu_torch.ops import batched_nms
from torch_parity import assert_decoded_equal, box_near_ties, px_tolerance

torch.set_num_threads(2)


# -- batched_nms ---------------------------------------------------------------

def _both_nms(boxes, scores, iou_thr):
    want = np.asarray(jax_nms(boxes, scores, iou_thr=iou_thr))
    got = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores), iou_thr=iou_thr)
    assert got.dtype == torch.bool and tuple(got.shape) == want.shape
    return got.numpy(), want


def test_nms_suppresses_overlaps():
    boxes = np.float32([[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]])
    got, want = _both_nms(boxes, np.float32([0.9, 0.8, 0.7]), 0.5)
    np.testing.assert_array_equal(got, [True, False, True])
    np.testing.assert_array_equal(got, want)


def test_nms_batched_and_padding_mask():
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[0, 0] = [0, 0, 10, 10]
    boxes[0, 1] = [20, 0, 30, 10]
    scores = np.zeros((2, 4), np.float32)
    scores[0, :2] = [0.9, 0.8]
    got, want = _both_nms(boxes, scores, 0.45)
    assert got[0, 0] and got[0, 1] and not got[0, 2:].any() and not got[1].any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("iou_thr", [0.3, 0.45, 0.7])
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("batched", [True, False], ids=["batched", "single"])
def test_nms_keep_mask_equals_jax(seed, iou_thr, batched):
    rng = np.random.default_rng(seed)
    B, N = (3, 48) if batched else (1, 48)
    xy = rng.uniform(0, 60, (B, N, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(2, 30, (B, N, 2)).astype(np.float32)], -1)
    # ties among equal scores and zero-score padding
    scores = rng.choice(np.float32([0.0, 0.0, 0.2, 0.5, 0.5, 0.5, 0.8, 0.9]), (B, N))
    boxes[:, -4:] = boxes[:, :1]  # duplicate boxes (IoU 1) with their own scores
    if not batched:
        boxes, scores = boxes[0], scores[0]
    got, want = _both_nms(boxes, scores.astype(np.float32), iou_thr)
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def test_nms_degenerate_boxes_and_ties_keep_index_order():
    # zero-area boxes (union 0 -> IoU 0) and exact ties: the lower index is
    # visited first, so of two identical boxes with equal scores it survives
    boxes = np.float32([[5, 5, 5, 5], [5, 5, 5, 5], [0, 0, 4, 4], [0, 0, 4, 4], [1, 1, 5, 5]])
    scores = np.float32([0.5, 0.5, 0.6, 0.6, 0.6])
    got, want = _both_nms(boxes, scores, 0.3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [True, True, True, False, False])  # IoU 9/23 > 0.3


# -- decoders/util.py ----------------------------------------------------------

def test_util_iou_and_host_nms_equal_jax():
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 40, (30, 2))
    dets = np.concatenate([xy, xy + rng.uniform(0, 20, (30, 2)), rng.uniform(0, 1, (30, 1)),
                           rng.integers(0, 3, (30, 1))], 1)
    np.testing.assert_array_equal(util.iou_matrix(dets[:, :4]), jax_util.iou_matrix(dets[:, :4]))
    for per_class in (True, False):
        np.testing.assert_array_equal(util.nms(dets, 0.3, per_class),
                                      jax_util.nms(dets, 0.3, per_class))
    assert util.nms(np.zeros((0, 6))).shape == (0, 6)
    assert util.parse_wh(":480", (320, 240)) == jax_util.parse_wh(":480", (320, 240)) == (320, 480)
    assert util.parse_wh("x", (3, 4)) == (3, 4)


@pytest.mark.parametrize("draw", ["rect", "dot", "line", "label"])
def test_util_drawing_is_byte_equal(draw):
    calls = {
        "rect": lambda u, c: u.draw_rect(c, -5, 3, 30.7, 12.2, u.class_color(3), thickness=2),
        "dot": lambda u, c: u.draw_dot(c, 19.9, 0.4, u.class_color(25), radius=2),
        "line": lambda u, c: u.draw_line(c, 1.2, 9.8, 18.5, 0.3, (0, 200, 0, 255)),
        "label": lambda u, c: u.draw_label(c, 2, 1, "A7 x", u.class_color(1)),
    }
    got, want = util.blank_canvas(20, 10), jax_util.blank_canvas(20, 10)
    calls[draw](util, got)
    calls[draw](jax_util, want)
    assert got.any()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(util.scale_boxes(np.float32([[1, 2, 3, 4]]), (10, 20), (30, 10)),
                                  jax_util.scale_boxes(np.float32([[1, 2, 3, 4]]), (10, 20), (30, 10)))


# -- bounding_boxes: raw tensors per mode --------------------------------------

C = 5  # classes


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("boxes")
    rng = np.random.default_rng(0)
    P = 64
    pri = np.stack([rng.uniform(0.2, 0.8, P), rng.uniform(0.2, 0.8, P),
                    rng.uniform(0.1, 0.3, P), rng.uniform(0.1, 0.3, P)])
    pri[:2, 1] = pri[:2, 0] + 0.01  # an overlapping pair of priors
    (d / "priors.txt").write_text("\n".join(" ".join(f"{v:.6f}" for v in row) for row in pri))
    (d / "labels.txt").write_text("\n".join(f"L{i}" for i in range(C - 1)))  # one class unlabelled
    return {"priors": str(d / "priors.txt"), "labels": str(d / "labels.txt"), "P": P}


def _ssd(rng, P, frames):
    return [[rng.normal(0, 0.5, (P, 4)).astype(np.float32),
             rng.normal(-1.5, 2.0, (P, C)).astype(np.float32)] for _ in range(frames)]


def _yolo(rng, N, frames, v8=False, transposed=False):
    out = []
    for _ in range(frames):
        xy = rng.uniform(0.1, 0.9, (N, 2))
        wh = rng.uniform(0.05, 0.3, (N, 2))
        cols = [xy, wh] + ([] if v8 else [rng.uniform(0, 1, (N, 1))]) + [rng.uniform(0, 1, (N, C))]
        pred = np.concatenate(cols, 1).astype(np.float32)
        out.append([pred.T.copy() if transposed else pred])
    return out


def _raw(name, files, rng):
    """(option1, option3, [frames of raw tensors]) of one mode case."""
    P = files["P"]
    if name in ("mobilenet-ssd", "tflite-ssd"):
        return name, files["priors"], _ssd(rng, P, 3)
    if name == "mobilenet-ssd-thr":
        return "mobilenet-ssd", files["priors"] + ":0.7:8:8:4:4:0.3", _ssd(rng, P, 3)
    if name in ("mobilenet-ssd-postprocess", "tf-ssd", "postprocess-remap"):
        frames = []
        for _ in range(3):
            n = 12
            lo = rng.uniform(0, 0.6, (n, 2))
            boxes = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (n, 2))], 1).astype(np.float32)
            t = [boxes, rng.integers(0, C, n).astype(np.float32),
                 rng.uniform(0, 1, n).astype(np.float32), np.float32([9])]
            frames.append([t[1], t[0], t[2], t[3]] if name == "postprocess-remap" else t)
        option3 = "1:0:2:3" if name == "postprocess-remap" else ""
        return ("mobilenet-ssd-postprocess" if name == "postprocess-remap" else name), option3, frames
    if name in ("ov-person-detection", "ov-face-detection"):
        frames = []
        for _ in range(3):
            n = 10
            lo = rng.uniform(0, 0.6, (n, 2))
            rows = np.concatenate([rng.integers(-1, 2, (n, 1)), rng.integers(0, C, (n, 1)),
                                   rng.uniform(0, 1, (n, 1)), lo,
                                   lo + rng.uniform(0.05, 0.3, (n, 2))], 1)
            frames.append([rows.astype(np.float32).reshape(1, 1, n, 7)])
        return name, "", frames
    if name == "yolov5":
        return name, "", _yolo(rng, 100, 3)
    if name == "yolov5-topk":
        return "yolov5", "0:0.3:0.5", _yolo(rng, 400, 2)
    if name == "yolov5-scaled":
        frames = _yolo(rng, 60, 2)
        for f in frames:
            f[0][:, :4] *= 300
        return "yolov5", "1:0.4:0.45", frames
    if name == "yolov8":
        return name, "0:0.6:0.45", _yolo(rng, 90, 3, v8=True, transposed=True)
    if name == "yolov8-rows":
        return "yolov8", "0:0.6:0.45", _yolo(rng, 90, 2, v8=True)
    if name == "mp-palm-detection":
        frames = []
        for _ in range(2):
            raw = np.concatenate([rng.normal(0, 5, (2016, 2)), rng.uniform(10, 40, (2016, 2)),
                                  rng.normal(0, 1, (2016, 14))], 1).astype(np.float32)
            frames.append([raw, rng.normal(-3, 2, 2016).astype(np.float32)])
        return name, "0.6", frames
    raise KeyError(name)


HOST_CASES = ["mobilenet-ssd", "tflite-ssd", "mobilenet-ssd-thr", "mobilenet-ssd-postprocess",
              "tf-ssd", "postprocess-remap", "ov-person-detection", "ov-face-detection",
              "yolov5", "yolov5-topk", "yolov5-scaled", "yolov8", "yolov8-rows",
              "mp-palm-detection"]
DEVICE_CASES = ["mobilenet-ssd", "mobilenet-ssd-thr", "yolov5", "yolov5-topk", "yolov5-scaled",
                "yolov8", "yolov8-rows"]


def _decoders(option1, option3, files, labels=True, out="600:480", inp=None):
    inp = inp or ("192:192" if option1 == "mp-palm-detection" else "300:300")
    opts = [option1, files["labels"] if labels else "", option3, out, inp, "", "", "", ""]
    port, jax = BoundingBoxes(), JaxBoxes()
    port.set_options(opts)
    jax.set_options(opts)
    return port, jax


@pytest.mark.parametrize("labels", [True, False], ids=["labels", "no-labels"])
@pytest.mark.parametrize("case", HOST_CASES)
def test_host_decode_equals_jax(case, labels, files):
    option1, option3, frames = _raw(case, files, np.random.default_rng(HOST_CASES.index(case)))
    port, jax = _decoders(option1, option3, files, labels)
    n_boxes = 0
    for i, tensors in enumerate(frames):
        got = port.decode(TensorFrame(list(tensors), pts=float(i)), None)
        want = jax.decode(JaxFrame([np.asarray(t) for t in tensors], pts=float(i)), None)
        assert_decoded_equal(got, want)
        n_boxes += len(want.meta["boxes"])
    assert n_boxes > 0  # every case draws boxes


def _fused_both(port, jax, frames):
    """Each package's device half on the batch of `frames` (JAX on jnp
    arrays, the port on CPU torch tensors), as float64 numpy."""
    import jax.numpy as jnp

    batch = [np.stack([f[i] for f in frames]) for i in range(len(frames[0]))]
    want = [np.asarray(t, np.float64) for t in jax.device_fn([jnp.asarray(t) for t in batch])]
    with torch.inference_mode():
        got = port.device_fn([torch.from_numpy(t) for t in batch])
    assert [t.dtype for t in got] == [torch.float32] * 3
    return [t.numpy().astype(np.float64) for t in got], want


def _no_near_ties(port, frames):
    """The raw tensors hold no near-tie at 1e-6 (``box_near_ties``)."""
    ssd = port.mode == "mobilenet-ssd"
    thr, iou = (port.ssd_thr, port.ssd_iou) if ssd else port._yolo_options()[1:]
    for tensors in frames:
        dets = port._detect([np.asarray(t) for t in tensors])
        if ssd:
            scores = port._device_ssd([torch.from_numpy(t)[None] for t in tensors])[1].numpy()
        else:
            scores = port._device_yolo([torch.from_numpy(t)[None] for t in tensors],
                                       port._yolo_options()[0])[1].numpy()
        assert box_near_ties(scores, thr, dets, iou, 1e-6) == 0


@pytest.mark.parametrize("case", DEVICE_CASES)
def test_device_half_and_decode_fused_equal_jax(case, files):
    option1, option3, frames = _raw(case, files, np.random.default_rng(DEVICE_CASES.index(case)))
    port, jax = _decoders(option1, option3, files)
    assert port.supports_device_fn() and jax.supports_device_fn()
    _no_near_ties(port, frames)
    got, want = _fused_both(port, jax, frames)
    k = min(BoundingBoxes.FUSED_TOPK, want[1].shape[1])
    assert [t.shape for t in got] == [t.shape for t in want] == [
        (len(frames), k, 4), (len(frames), k), (len(frames), k)]
    # boxes in px: within 1e-6 of the input size (the decode rounds in
    # float32 at the scale of normalized coordinates, then scales them)
    np.testing.assert_allclose(got[0] / 300, want[0] / 300, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[1] > 0, want[1] > 0)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2], want[2])
    assert (want[1] > 0).any(axis=1).all()
    for i in range(len(frames)):
        row = [t[i].astype(np.float32) for t in got]
        assert_decoded_equal(port.decode_fused(TensorFrame(row, pts=float(i)), None),
                             jax.decode_fused(JaxFrame([t[i] for t in want], pts=float(i)), None),
                             atol=px_tolerance(600))


def test_device_half_single_frame_and_schema(files):
    """A frame without a batch axis is a batch of one; zero rows (the fused
    schema's probe) give (K, 4), (K,), (K,) float32 with K = min(128, P)."""
    port, _ = _decoders("mobilenet-ssd", files["priors"], files)
    tensors = _raw("mobilenet-ssd", files, np.random.default_rng(0))[2][0]
    with torch.inference_mode():
        one = port.device_fn([torch.from_numpy(t) for t in tensors])
        batch = port.device_fn([torch.from_numpy(t)[None] for t in tensors])
        zero = port.device_fn([torch.zeros((1, files["P"], 4)), torch.zeros((1, files["P"], C))])
    for a, b in zip(one, batch):
        assert torch.equal(a, b)
    assert [tuple(t.shape[1:]) for t in zero] == [(64, 4), (64,), (64,)]
    assert all(t.dtype == torch.float32 for t in zero)
    port, _ = _decoders("yolov5", "", files)
    with torch.inference_mode():
        zero = port.device_fn([torch.zeros((1, 25200, 85))])
    assert [tuple(t.shape[1:]) for t in zero] == [(128, 4), (128,), (128,)]


@pytest.mark.parametrize("case", ["mobilenet-ssd", "mobilenet-ssd-thr", "yolov5", "yolov5-scaled",
                                  "yolov8", "yolov8-rows"])
def test_port_fused_equals_port_host(case, files):
    """JAX ``tests/test_device_fusion.py``'s contract on the port: with
    fewer candidates than K over the threshold, the fused boxes are the
    host path's (abs 0.1 px, score rel 1e-4, classes and labels exact)."""
    option1, option3, frames = _raw(case, files, np.random.default_rng(DEVICE_CASES.index(case)))
    port, _ = _decoders(option1, option3, files)
    with torch.inference_mode():
        fused = port.device_fn([torch.from_numpy(np.stack([f[i] for f in frames]))
                                for i in range(len(frames[0]))])
    for i, tensors in enumerate(frames):
        host = port.decode(TensorFrame(list(tensors), pts=float(i)), None).meta["boxes"]
        got = port.decode_fused(TensorFrame([t[i] for t in fused], pts=float(i)), None).meta["boxes"]
        assert 0 < len(got) == len(host)
        for g, w in zip(got, host):
            assert g["class"] == w["class"] and g["label"] == w["label"]
            for key in ("x", "y", "w", "h"):
                assert g[key] == pytest.approx(w[key], abs=0.1)
            assert g["score"] == pytest.approx(w["score"], rel=1e-4)


def test_modes_without_device_half_stay_on_host(files):
    for option1, option3 in (("mobilenet-ssd", ""), ("tf-ssd", ""), ("ov-face-detection", ""),
                             ("mp-palm-detection", "")):
        port, jax = _decoders(option1, option3, files)
        assert port.supports_device_fn() is jax.supports_device_fn() is False
    port, _ = _decoders("mobilenet-ssd", "", files)
    with pytest.raises(ValueError, match="priors"):
        port.decode(TensorFrame([np.zeros((4, 4)), np.zeros((4, 2))]), None)
    with pytest.raises(ValueError, match="unknown mode"):
        BoundingBoxes().set_options(["not-a-mode"])


class _Passthru(torch.nn.Module):
    def forward(self, *xs):
        return list(xs)


@pytest.mark.parametrize("option1,fuses", [("yolov5", True), ("tf-ssd", False)])
def test_pipeline_fuses_only_modes_with_a_device_half(option1, fuses, files):
    """The fusion pass asks the subplugin (``supports_device_fn``), as the
    JAX decoder element does: ``tf-ssd`` has a dynamic count and stays on
    the host; ``yolov5`` fuses, and both decode the same frames as JAX."""
    from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
    from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
    from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
    from nnstreamer_tpu_torch.pipeline import parse_pipeline
    from torch_parity import decoder_pipeline

    _, option3, frames = _raw("yolov5" if fuses else "tf-ssd", files, np.random.default_rng(5))
    register_torch_model("torch_parity_passthru", _Passthru())
    register_jax_model("torch_parity_passthru", lambda params, xs: list(xs), {})
    options = f"option1={option1} option2={files['labels']} option4=320:240 option5=300:300"
    try:
        got = decoder_pipeline(parse_pipeline, "framework=torch-cuda model=torch_parity_passthru "
                               "accelerator=cpu", "bounding_boxes", options,
                               [f if len(f) > 1 else f[0] for f in frames], batch=2)
        want = decoder_pipeline(jax_parse, "framework=jax-xla model=torch_parity_passthru",
                                "bounding_boxes", options,
                                [f if len(f) > 1 else f[0] for f in frames], batch=2)
    finally:
        unregister_torch_model("torch_parity_passthru")
        unregister_jax_model("torch_parity_passthru")
    assert got[0] is want[0] is fuses
    assert_decoded_equal(got[1], want[1], atol=px_tolerance(320))
