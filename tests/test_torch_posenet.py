"""Port parity: PoseNet, the pose decoder and its pipeline against the JAX
package, on the CPU.

* PoseNet in float32 at 65 (odd: SAME pads 1 and 1 at stride 2) and 64
  (even: 0 and 1), 17 keypoints, with offsets and without; outputs within
  rtol = atol = 1e-4 (the tolerance of ``tests/test_torch_mobilenet.py``).
* ``pose_estimation``, both modes: the host ``decode`` and the device half
  plus ``decode_fused`` on identical raw tensors give byte-equal canvases
  and ``meta`` within 1e-6 (keypoint coordinates within 1e-6 of the
  output size: the device half rounds in float32); fused equals host.
  The contracts of JAX ``tests/test_decoders.py:180-215`` hold on the port.
* the pipeline ``appsrc ! tensor_filter ! tensor_decoder
  mode=pose_estimation option4=heatmap-offset ! tensor_sink``, fused and
  ``device-fused=never``, in both packages on the same frames, with no
  keypoint at a near-tie of its heatmap argmax.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.core.buffer import TensorFrame as JaxFrame
from nnstreamer_tpu.decoders.pose import PoseEstimation as JaxPose
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.backends.torch_cuda import (
    TorchCuda,
    register_torch_model,
    unregister_torch_model,
)
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.decoders.pose import PoseEstimation
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models import posenet
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from torch_parity import (
    assert_decoded_equal,
    assert_meta_close,
    decoder_pipeline,
    model_pair,
    run_both,
    spec_tuple,
)

torch.set_num_threads(2)

MODEL = "torch_parity_posenet"


@pytest.fixture(scope="module", params=[65, 64], ids=["odd", "even"])
def pair(request):
    size = request.param
    return (size,) + model_pair("posenet", posenet, {"size": str(size)}, seed=size)


def test_outputs_match_jax(pair):
    size, fn, variables, module, _ = pair
    x = np.random.default_rng(size).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    got, want = run_both(fn, variables, module, x)
    g = (size + 15) // 16
    assert [o.shape for o in got] == [o.shape for o in want] == [(3, g, g, 17), (3, g, g, 34)]
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_single_frame_without_batch_axis(pair):
    size, fn, variables, module, specs = pair
    name = f"{MODEL}_{size}"
    register_torch_model(name, module, specs[2], specs[3])
    try:
        be = TorchCuda()
        be.open(name, {"accelerators": ["cpu"]})
        x = np.random.default_rng(size + 1).integers(0, 256, (size, size, 3), dtype=np.uint8)
        got = be.invoke([x])
    finally:
        unregister_torch_model(name)
    for a, b in zip(got, fn(variables, [x])):
        assert tuple(a.shape) == np.asarray(b).shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_specs_and_state_dict(pair):
    size, _, variables, module, (jax_in, jax_out, port_in, port_out) = pair
    assert spec_tuple(port_in) == spec_tuple(jax_in) and spec_tuple(port_out) == spec_tuple(jax_out)
    assert set(posenet.state_dict_from_flax(variables)) == set(module.state_dict())


def test_heatmap_only_build_and_refusals():
    fn, variables, module, specs = model_pair("posenet", posenet,
                                              {"size": "33", "offsets": "0", "keypoints": "5"})
    x = np.random.default_rng(0).integers(0, 256, (2, 33, 33, 3), dtype=np.uint8)
    got, want = run_both(fn, variables, module, x)
    assert len(got) == len(want) == 1 and got[0].shape == (2, 3, 3, 5)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
    assert len(specs[3].tensors) == 1
    a, _, _ = torch_build("posenet", {"dtype": "bfloat16", "size": "33", "seed": "1"})
    assert a.stem.conv.weight.dtype == torch.bfloat16 and a.heatmap.weight.dtype == torch.float32
    with torch.inference_mode():
        heat, off = a.eval()(torch.from_numpy(x))
    assert heat.dtype == off.dtype == torch.float32 and heat.shape == (2, 3, 3, 17)
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        torch_build("posenet", {"quantize": "int8"})


# -- pose_estimation decoder -----------------------------------------------------

def _decoders(options):
    port, jax = PoseEstimation(), JaxPose()
    port.set_options(options)
    jax.set_options(options)
    return port, jax


def _raw(k, mode, rng, frames=3, g=9):
    out = []
    for _ in range(frames):
        heat = rng.normal(0, 2, (g, g, k)).astype(np.float32)
        t = [heat] + ([rng.normal(0, 4, (g, g, 2 * k)).astype(np.float32)]
                      if mode == "heatmap-offset" else [])
        out.append(t)
    return out


CASES = {
    "coco-only": (17, ["200:150", "257:257", "", ""]),
    "coco-offset": (17, ["200:150", "257:257", "", "heatmap-offset"]),
    "mpii-offset": (14, ["90:90", "90:90", "", "heatmap-offset"]),
    "k3-only": (3, ["", "", "", "heatmap-only"]),
}


@pytest.mark.parametrize("case", CASES)
def test_decode_host_and_fused_equal_jax(case, tmp_path):
    k, options = CASES[case]
    labels = tmp_path / "kp.txt"
    labels.write_text("\n".join(f"kp{i}" for i in range(k)))
    options = options[:2] + [str(labels)] + options[3:]
    port, jax = _decoders(options)
    frames = _raw(k, options[3] or "heatmap-only", np.random.default_rng(k))
    for i, tensors in enumerate(frames):
        assert_decoded_equal(port.decode(TensorFrame(list(tensors), pts=float(i)), None),
                             jax.decode(JaxFrame(list(tensors), pts=float(i)), None))
    import jax.numpy as jnp

    batch = [np.stack([f[j] for f in frames]) for j in range(len(frames[0]))]
    with torch.inference_mode():
        (got,) = port.device_fn([torch.from_numpy(t) for t in batch])
    (want,) = jax.device_fn([jnp.asarray(t) for t in batch])
    want = np.asarray(want)
    assert got.shape == want.shape == (len(frames), k, 3) and got.dtype == torch.float32
    size = max(port.in_wh)
    np.testing.assert_allclose(got[..., :2].numpy() / size, want[..., :2] / size, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[..., 2].numpy(), want[..., 2], rtol=1e-6, atol=1e-6)
    tol = {None: 1e-6, "keypoints": 1e-6 * max(port.out_wh)}
    for i in range(len(frames)):
        fused = port.decode_fused(TensorFrame([got[i]], pts=float(i)), None)
        assert_decoded_equal(fused, jax.decode_fused(JaxFrame([want[i]], pts=float(i)), None),
                             atol=tol)
        host = port.decode(TensorFrame(list(frames[i]), pts=float(i)), None)
        assert_meta_close(fused.meta, host.meta, atol=tol)


def test_decode_contracts_of_the_reference():
    k = 17
    heat = np.full((9, 9, k), -10.0, np.float32)
    for i in range(k):
        heat[i % 9, (i * 2) % 9, i] = 10.0
    port, _ = _decoders(["90:90", "90:90", "", "", "", "", "", "", ""])
    out = port.decode(TensorFrame([heat], pts=0.0), None)
    kps = out.meta["keypoints"]
    assert out.tensors[0].shape == (90, 90, 4) and len(kps) == k
    assert kps[0][0] == pytest.approx(5, abs=1) and all(s > 0.9 for _, _, s in kps)
    heat = np.full((5, 5, 3), -10.0, np.float32)
    heat[2, 2, :] = 10.0
    off = np.zeros((5, 5, 6), np.float32)
    off[2, 2, :3], off[2, 2, 3:] = 7.0, -3.0
    port, _ = _decoders(["100:100", "100:100", "", "heatmap-offset"])
    x, y, _ = port.decode(TensorFrame([heat, off], pts=0.0), None).meta["keypoints"][0]
    assert y == pytest.approx(2 / 4 * 100 + 7.0, abs=1) and x == pytest.approx(2 / 4 * 100 - 3.0, abs=1)
    with torch.inference_mode():
        (fused,) = port.device_fn([torch.from_numpy(heat), torch.from_numpy(off)])  # no batch axis
    assert tuple(fused.shape) == (1, 3, 3)
    with pytest.raises(ValueError):
        _decoders(["", "", "", "nope"])


def test_pipeline_fused_and_unfused_equal_jax(pair):
    size, fn, variables, module, specs = pair
    register_jax_model(MODEL, fn, variables, specs[0], specs[1])
    register_torch_model(MODEL, module, specs[2], specs[3])
    frames = np.random.default_rng(13).integers(0, 256, (5, size, size, 3), dtype=np.uint8)
    got, want = run_both(fn, variables, module, frames)
    # no keypoint's heatmap argmax at a near-tie: its top two cells differ by
    # more than twice the packages' largest heatmap difference
    top2 = np.sort(want[0].reshape(5, -1, 17), axis=1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > 2 * np.abs(got[0] - want[0]).max()
    options = f"option1=200:150 option2={size}:{size} option4=heatmap-offset"
    runs = {}
    try:
        for name, parse, props in (
                ("port", parse_pipeline, f"framework=torch-cuda model={MODEL} accelerator=cpu"),
                ("jax", jax_parse, f"framework=jax-xla model={MODEL}")):
            for extra in ("", "device-fused=never"):
                fused, out = decoder_pipeline(parse, props, "pose_estimation", options, frames, extra)
                assert fused is (extra == "") and [f.pts for f in out] == [0.0, 1.0, 2.0, 3.0, 4.0]
                runs[name, extra] = out
    finally:
        unregister_jax_model(MODEL)
        unregister_torch_model(MODEL)
    # coordinates carry the offsets (model outputs, 1e-5 apart between the
    # packages) scaled to 200 px; scores their sigmoid
    tol = {None: 1e-5, "keypoints": 1e-3}
    for extra in ("", "device-fused=never"):
        for g, w in zip(runs["port", extra], runs["jax", extra]):
            assert g.tensors[0].shape == w.tensors[0].shape == (150, 200, 4)
            assert_meta_close(g.meta, w.meta, rtol=0, atol=tol)
    for f, h in zip(runs["port", ""], runs["port", "device-fused=never"]):
        assert_meta_close(f.meta, h.meta, rtol=0, atol={None: 1e-6, "keypoints": 1e-3})
