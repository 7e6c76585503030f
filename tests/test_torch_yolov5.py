"""Port parity: YOLOv5s, its in-model NMS and its bounding-box pipeline
against the JAX package, on the CPU.

Both packages build ``yolov5s`` in float32 with 3 classes at 64 and 96
(every stride-2 convolution pads 0 before and 1 after on these even sizes,
the 6x6 stem 2 and 2); the flax tree (BatchNorm seeded) is converted by
``state_dict_from_flax``.  Outputs must be within rtol = atol = 1e-4 (the
tolerance of ``tests/test_torch_mobilenet.py``; the port's ``x * (1/255)``
is at most one float32 ulp from the reference's ``x / 255``).  ``nms:1``
(JAX ``tests/test_ops.py:59-72``) must zero exactly the same objectness
entries.  The pipeline ``appsrc ! tensor_filter ! tensor_decoder
mode=bounding_boxes option1=yolov5 ! tensor_sink`` runs fused and
``device-fused=never`` in both packages; its canvases are a function of
the boxes meta, rendered byte-equal on identical detections in
``tests/test_torch_box_decoder.py``.
"""

import numpy as np
import pytest
import torch
from torch import nn

from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.models import yolov5 as jax_yolo
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.backends.torch_cuda import (
    TorchCuda,
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.decoders.bounding_box import BoundingBoxes
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models import yolov5
from nnstreamer_tpu_torch.models._quant_flax import QuantConv2d
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from torch_parity import (
    assert_meta_close,
    box_near_ties,
    decoder_pipeline,
    midway_threshold,
    model_pair,
    run_both,
    spec_tuple,
)

torch.set_num_threads(2)

MODEL, CLASSES = "torch_parity_yolov5", 3


@pytest.fixture(scope="module", params=[64, 96], ids=["64", "96"])
def pair(request):
    size = request.param
    fn, variables, module, specs = model_pair(
        "yolov5s", yolov5, {"classes": str(CLASSES), "size": str(size)}, seed=size)
    return size, fn, variables, module, specs


@pytest.fixture(scope="module")
def nms_pair():
    return model_pair("yolov5s", yolov5, {"classes": str(CLASSES), "size": "64", "nms": "1"},
                      seed=5)


def test_outputs_match_jax(pair):
    size, fn, variables, module, _ = pair
    x = np.random.default_rng(size).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    (got,), (want,) = run_both(fn, variables, module, x)
    n = yolov5.num_candidates(size)
    assert got.shape == want.shape == (3, n, 5 + CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_single_frame_without_batch_axis(pair):
    size, fn, variables, module, specs = pair
    name = f"{MODEL}_{size}"
    register_torch_model(name, module, specs[2], specs[3])
    try:
        be = TorchCuda()
        be.open(name, {"accelerators": ["cpu"]})
        x = np.random.default_rng(size + 1).integers(0, 256, (size, size, 3), dtype=np.uint8)
        (got,) = be.invoke([x])
    finally:
        unregister_torch_model(name)
    (want,) = fn(variables, [x])
    assert tuple(got.shape) == np.asarray(want).shape == (yolov5.num_candidates(size), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_specs_and_state_dict(pair):
    size, _, variables, module, (jax_in, jax_out, port_in, port_out) = pair
    assert spec_tuple(port_in) == spec_tuple(jax_in) and spec_tuple(port_out) == spec_tuple(jax_out)
    assert yolov5.num_candidates(size) == jax_yolo.num_candidates(size)
    assert yolov5.num_candidates(640) == 25200
    assert set(yolov5.state_dict_from_flax(variables)) == set(module.state_dict())


def test_in_model_nms_zeroes_the_same_objectness(nms_pair):
    fn, variables, module, _ = nms_pair
    x = np.random.default_rng(9).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    (got,), (want,) = run_both(fn, variables, module, x)
    np.testing.assert_array_equal(got[..., 4] > 0, want[..., 4] > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # NMS zeroes suppressed objectness: fewer positives than candidates
    assert 0 < (got[..., 4] > 0).sum() < got[..., 4].size


def test_build_bf16_seeded_and_refusals():
    props = {"dtype": "bfloat16", "classes": "3", "size": "64", "seed": "2"}
    a, _, _ = torch_build("yolov5s", props)
    b, _, _ = torch_build("yolov5s", props)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert a.convs[0].conv.weight.dtype == torch.bfloat16
    assert a.detect[0].weight.dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), np.uint8))
    with torch.inference_mode():
        out = a.eval()(x)
    assert out.dtype == torch.float32 and out.shape == (2, 252, 8) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="multiple of 32"):
        torch_build("yolov5s", {"size": "65"})
    int8, _, _ = torch_build("yolov5s", dict(props, quantize="int8"))
    assert isinstance(int8.convs[0].conv, QuantConv2d)
    assert isinstance(int8.sppf.cv2.conv, QuantConv2d)
    assert type(int8.detect[0]) is nn.Conv2d


@pytest.mark.parametrize("pair", [64], indirect=True, ids=["64"])
def test_pipeline_fused_and_unfused_equal_jax(pair, tmp_path):
    size, fn, variables, module, specs = pair
    register_jax_model(MODEL, fn, variables, specs[0], specs[1])
    register_torch_model(MODEL, module, specs[2], specs[3])
    labels = tmp_path / "labels.txt"
    labels.write_text("a\nb\nc\n")
    frames = np.random.default_rng(11).integers(0, 256, (5, size, size, 3), dtype=np.uint8)
    got, want = run_both(fn, variables, module, frames)
    score = [(o[..., 4:5].astype(np.float64) * o[..., 5:]).max(-1) for o in (got[0], want[0])]
    thr = midway_threshold(score[1], 10)  # the fused top-128 holds every candidate
    tie = max(1e-6, 2 * float(np.abs(score[0] - score[1]).max()))
    boxes = BoundingBoxes()
    option3 = f"0:{thr!r}:0.45"
    boxes.set_options(["yolov5", "", option3, "320:240", f"{size}:{size}"])
    for i in range(len(frames)):
        dets = boxes._detect([want[0][i]])
        assert box_near_ties(score[1][i], thr, dets, 0.45, tie) == 0  # no near-tie
    options = f"option1=yolov5 option2={labels} option3={option3} option4=320:240 option5={size}:{size}"
    runs = {}
    try:
        for name, parse, props in (
                ("port", parse_pipeline, f"framework=torch-cuda model={MODEL} accelerator=cpu"),
                ("jax", jax_parse, f"framework=jax-xla model={MODEL}")):
            for extra in ("", "device-fused=never"):
                fused, out = decoder_pipeline(parse, props, "bounding_boxes", options, frames, extra)
                assert fused is (extra == "") and [f.pts for f in out] == [0.0, 1.0, 2.0, 3.0, 4.0]
                runs[name, extra] = out
    finally:
        unregister_jax_model(MODEL)
        unregister_torch_model(MODEL)
    coords = {None: 1e-5, "x": 1e-3, "y": 1e-3, "w": 1e-3, "h": 1e-3}
    for extra in ("", "device-fused=never"):
        for g, w in zip(runs["port", extra], runs["jax", extra]):
            assert g.tensors[0].shape == w.tensors[0].shape == (240, 320, 4)
            assert_meta_close(g.meta["boxes"], w.meta["boxes"], rtol=0, atol=coords)
    host, fused = runs["port", "device-fused=never"], runs["port", ""]
    counts = [len(f.meta["boxes"]) for f in host]
    assert all(0 < n for n in counts) and sum(counts) < (score[1] > thr).sum()  # NMS dropped some
    for h, f in zip(host, fused):
        assert_meta_close(f.meta["boxes"], h.meta["boxes"], rtol=1e-4,
                          atol={None: 0.0, "x": 0.1, "y": 0.1, "w": 0.1, "h": 0.1})
