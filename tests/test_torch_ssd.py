"""Port parity: SSD-MobileNet-v2 and its bounding-box pipeline against the
JAX package, on the CPU.

Both packages build ``ssd_mobilenet_v2`` in float32 at 300x300 (its only
size) with 4 classes; the flax tree (BatchNorm seeded) is converted by
``state_dict_from_flax``.  Outputs must be within rtol = atol = 1e-4 (the
tolerance of ``tests/test_torch_mobilenet.py``: XLA's and PyTorch's
convolutions sum in different orders).  The pipeline
``appsrc ! tensor_filter ! tensor_decoder mode=bounding_boxes
option1=mobilenet-ssd ! tensor_sink`` runs fused and ``device-fused=never``
in both packages on the same frames.
"""

import numpy as np
import pytest
import torch
from torch import nn

from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.models import ssd_mobilenet as jax_ssd
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.backends.torch_cuda import (
    TorchCuda,
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.decoders.bounding_box import BoundingBoxes
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models import ssd_mobilenet
from nnstreamer_tpu_torch.models._quant_flax import QuantConv2d
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from torch_parity import (
    assert_meta_close,
    decoder_pipeline,
    box_near_ties,
    midway_threshold,
    model_pair,
    run_both,
    spec_tuple,
)

torch.set_num_threads(2)

MODEL, CLASSES = "torch_parity_ssd", 4


@pytest.fixture(scope="module")
def pair():
    fn, variables, module, specs = model_pair("ssd_mobilenet_v2", ssd_mobilenet,
                                              {"classes": str(CLASSES)}, seed=1)
    register_jax_model(MODEL, fn, variables, specs[0], specs[1])
    register_torch_model(MODEL, module, specs[2], specs[3])
    yield fn, variables, module, specs
    unregister_jax_model(MODEL)
    unregister_torch_model(MODEL)


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).integers(0, 256, (5, 300, 300, 3), dtype=np.uint8)


def test_outputs_match_jax(pair, frames):
    fn, variables, module, _ = pair
    got, want = run_both(fn, variables, module, frames[:2])
    assert [g.shape for g in got] == [w.shape for w in want] == [(2, 2000, 4), (2, 2000, CLASSES)]
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_single_frame_without_batch_axis(pair, frames):
    """The filter's per-frame invoke (no batch axis) against the JAX fn
    called on one (300, 300, 3) frame."""
    fn, variables, _, _ = pair
    be = TorchCuda()
    be.open(MODEL, {"accelerators": ["cpu"]})
    got = be.invoke([frames[3]])
    want = fn(variables, [frames[3]])
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_specs_priors_and_state_dict(pair, tmp_path):
    _, variables, module, (jax_in, jax_out, port_in, port_out) = pair
    assert spec_tuple(port_in) == spec_tuple(jax_in) and spec_tuple(port_out) == spec_tuple(jax_out)
    np.testing.assert_array_equal(ssd_mobilenet.anchors(), jax_ssd.anchors())
    assert ssd_mobilenet.num_priors() == jax_ssd.num_priors() == 2000
    a = ssd_mobilenet.write_box_priors(str(tmp_path / "a.txt"))
    b = jax_ssd.write_box_priors(str(tmp_path / "b.txt"))
    assert open(a).read() == open(b).read()
    assert set(ssd_mobilenet.state_dict_from_flax(variables)) == set(module.state_dict())


def test_build_bf16_seeded_heads_float32_and_refusals():
    props = {"dtype": "bfloat16", "classes": "3", "seed": "2"}
    a, _, _ = torch_build("ssd_mobilenet_v2", props)
    b, _, _ = torch_build("ssd_mobilenet_v2", props)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert a.stem.conv.weight.dtype == torch.bfloat16 and a.loc[0].weight.dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 300, 300, 3), np.uint8))
    with torch.inference_mode():
        loc, conf = a.eval()(x)
    assert loc.dtype == conf.dtype == torch.float32 and conf.shape == (1, 2000, 3)
    assert torch.isfinite(loc).all() and torch.isfinite(conf).all()
    with pytest.raises(ValueError, match="size=300"):
        torch_build("ssd_mobilenet_v2", {"size": "320"})
    int8, _, _ = torch_build("ssd_mobilenet_v2", dict(props, quantize="int8"))
    assert isinstance(int8.stem.conv, QuantConv2d) and isinstance(int8.extras[7].conv, QuantConv2d)
    assert type(int8.loc[0]) is nn.Conv2d and int8.stem.conv.weight.dtype == torch.float32


def _boxes_close(got, want):
    """Two runs' boxes meta: the same boxes, classes and labels; coordinates
    within 1e-3 px and scores within 1e-5 (model outputs of the two
    packages differ by about 1e-5)."""
    for g, w in zip(got, want):
        assert_meta_close(g.meta["boxes"], w.meta["boxes"], rtol=0,
                          atol={None: 1e-5, "x": 1e-3, "y": 1e-3, "w": 1e-3, "h": 1e-3})


def test_pipeline_fused_and_unfused_equal_jax(pair, frames, tmp_path):
    fn, variables, module, _ = pair
    priors = ssd_mobilenet.write_box_priors(str(tmp_path / "priors.txt"))
    labels = tmp_path / "labels.txt"
    labels.write_text("bg\nperson\ncar\n")
    got, want = run_both(fn, variables, module, frames)
    best = [(1 / (1 + np.exp(-w.astype(np.float64)))).max(-1) for w in (got[1], want[1])]
    # about 20 candidates a frame: the fused top-128 holds every one
    thr = midway_threshold(best[1], 20)
    # no frame sits at a near-tie that twice the packages' largest score
    # difference could resolve either way
    tie = max(1e-6, 2 * float(np.abs(best[0] - best[1]).max()))
    boxes = BoundingBoxes()
    boxes.set_options(["mobilenet-ssd", "", f"{priors}:{thr!r}", "600:480", "300:300"])
    for i in range(len(frames)):
        dets = boxes._detect([want[0][i], want[1][i]])
        assert box_near_ties(best[1][i], thr, dets, boxes.ssd_iou, tie) == 0
    options = (f"option1=mobilenet-ssd option2={labels} option3={priors}:{thr!r} "
               "option4=600:480 option5=300:300")
    runs = {}
    for name, parse, props in (
            ("port", parse_pipeline, f"framework=torch-cuda model={MODEL} accelerator=cpu"),
            ("jax", jax_parse, f"framework=jax-xla model={MODEL}")):
        for extra in ("", "device-fused=never"):
            fused, out = decoder_pipeline(parse, props, "bounding_boxes", options, frames, extra)
            assert fused is (extra == "") and [f.pts for f in out] == [0.0, 1.0, 2.0, 3.0, 4.0]
            runs[name, extra] = out
    for extra in ("", "device-fused=never"):
        _boxes_close(runs["port", extra], runs["jax", extra])
    host, fused = runs["port", "device-fused=never"], runs["port", ""]
    counts = [len(f.meta["boxes"]) for f in host]
    assert all(0 < n < 128 for n in counts) and sum(counts) < (best[1] > thr).sum()  # NMS dropped some
    for h, f in zip(host, fused):
        assert [b["class"] for b in f.meta["boxes"]] == [b["class"] for b in h.meta["boxes"]]
        assert f.tensors[0].shape == (480, 600, 4)
        assert_meta_close(f.meta["boxes"], h.meta["boxes"], rtol=1e-4,
                          atol={None: 0.0, "x": 0.1, "y": 0.1, "w": 0.1, "h": 0.1})
