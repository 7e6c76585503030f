"""Port parity: the PyTorch MobileNet-v2 against the flax one.

The JAX model is built with ``dtype:float32,pallas:1`` (the Pallas
normalize's numerics: float32 arithmetic, then the cast — the port always
runs its normalize kernel), its BatchNorm statistics and affine params are
overwritten with seeded values (flax init leaves them trivial), and the
tree is converted by ``state_dict_from_flax``.  Two input sizes, even and
odd, cover both cases of TensorFlow SAME padding at stride 2.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models.mobilenet_v2 import _same_pads, state_dict_from_flax

torch.set_num_threads(2)

_PROPS = {"dtype": "float32", "pallas": "1", "classes": "10", "width": "0.35"}


def randomize_batchnorm(variables, seed=0):
    """A copy of a flax MobileNet tree with seeded BatchNorm statistics,
    scales and biases (as numpy arrays)."""
    rng = np.random.default_rng(seed)

    def walk(params, stats):
        for k in params:
            if k == "BatchNorm_0":
                c = np.asarray(params[k]["scale"]).shape
                params[k] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                             "bias": rng.normal(0, 0.1, c).astype(np.float32)}
                stats[k] = {"mean": rng.normal(0, 0.1, c).astype(np.float32),
                            "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            elif isinstance(params[k], dict) and k in stats:
                walk(params[k], stats[k])

    def copy(tree):
        return {k: copy(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}

    out = copy(variables)
    walk(out["params"], out["batch_stats"])
    return out


@pytest.fixture(scope="module", params=[32, 35], ids=["even", "odd"])
def models(request):
    size = request.param
    fn, variables, jax_in, jax_out = jax_build("mobilenet_v2", dict(_PROPS, size=str(size)))
    variables = randomize_batchnorm(variables, seed=size)
    module, in_spec, out_spec = torch_build("mobilenet_v2", dict(_PROPS, size=str(size)))
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    specs = [(s.tensors[0].shape, s.tensors[0].dtype) for s in (jax_in, jax_out, in_spec, out_spec)]
    return size, fn, variables, module.eval(), specs


def test_logits_match_jax(models):
    size, fn, variables, module, _ = models
    x = np.random.default_rng(size).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    ref = np.asarray(fn(variables, [x])[0])
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (3, 10) and got.dtype == np.float32
    # summation order differs between XLA's and PyTorch's convolutions
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(1), ref.argmax(1))


def test_specs_match_jax(models):
    size, _, _, _, (jax_in, jax_out, port_in, port_out) = models
    assert port_in == jax_in == ((size, size, 3), np.uint8)
    assert port_out == jax_out == ((10,), np.float32)


def test_state_dict_covers_every_parameter(models):
    _, _, variables, module, _ = models
    sd = state_dict_from_flax(variables)
    assert set(sd) == set(module.state_dict())
    # depthwise HWIO (3, 3, 1, C) -> OIHW (C, 1, 3, 3)
    dw = np.asarray(variables["params"]["InvertedResidual_1"]["ConvBN_1"]["Conv_0"]["kernel"])
    got = sd["blocks.1.layers.1.conv.weight"].numpy()
    assert got.shape == (dw.shape[3], 1, 3, 3)
    np.testing.assert_array_equal(got[5, 0], dw[:, :, 0, 5])


@pytest.mark.parametrize("size,stride,want", [
    (32, 2, (0, 1)), (35, 2, (1, 1)), (16, 1, (1, 1)), (7, 2, (1, 1)), (8, 2, (0, 1))])
def test_same_pads_follow_tensorflow(size, stride, want):
    assert _same_pads(size, 3, stride) == want
    assert _same_pads(size, 1, stride) == (0, 0)


def test_build_is_seeded_and_keeps_classifier_float32():
    a, _, _ = torch_build("mobilenet_v2", {"dtype": "bfloat16", "size": "32", "width": "0.35",
                                           "classes": "10", "seed": "3"})
    b, _, _ = torch_build("mobilenet_v2", {"dtype": "bfloat16", "size": "32", "width": "0.35",
                                           "classes": "10", "seed": "3"})
    c, _, _ = torch_build("mobilenet_v2", {"dtype": "bfloat16", "size": "32", "width": "0.35",
                                           "classes": "10", "seed": "4"})
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert not torch.equal(a.stem.conv.weight, c.stem.conv.weight)
    assert a.stem.conv.weight.dtype == torch.bfloat16
    assert a.classifier.weight.dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    with torch.inference_mode():
        out = a(x)
    assert out.dtype == torch.float32 and out.shape == (2, 10) and torch.isfinite(out).all()


def test_zoo_default_dtype_follows_the_device(models, monkeypatch):
    # no dtype prop: the JAX zoo takes core/hw.py's probe, float32 on a host
    # CPU, so its model here is the float32 one of the `models` fixture; the
    # port's zoo probes torch.cuda.is_available() and must agree with it
    from nnstreamer_tpu.core.hw import preferred_dtype

    size, fn, variables, _, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert preferred_dtype() == "float32" == _PROPS["dtype"]
    props = {k: v for k, v in _PROPS.items() if k != "dtype"}
    module, _, _ = torch_build("mobilenet_v2", dict(props, size=str(size)))
    module.load_state_dict(state_dict_from_flax(variables), strict=True)
    assert module.stem.conv.weight.dtype == torch.float32
    x = np.random.default_rng(size + 1).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    with torch.inference_mode():
        got = module.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fn(variables, [x])[0]), rtol=1e-4, atol=1e-4)
    # with a card: bfloat16, for every family
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    module, _, _ = torch_build("mobilenet_v2", dict(props, size=str(size)))
    assert module.stem.conv.weight.dtype == torch.bfloat16
