"""Port parity: the keyword-spotting CNN (``models/kws_cnn.py``) against the
JAX package's, on the CPU, and ``audiofilesrc -> tensor_converter ->
tensor_filter -> tensor_decoder`` in both packages.

The JAX tests' small size (``samples:4000,classes:4``,
``tests/test_model_families_new.py:58``), float32, the flax params
converted by ``state_dict_from_flax``.  Tolerances: logits within rtol =
atol = 1e-4 (float32, as the other port model tests); labels exact.
"""

import jax
import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.media.wav import write_wav
from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.models import build, kws_cnn
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from torch_parity import run

torch.set_num_threads(2)

PROPS = {"dtype": "float32", "samples": "4000", "classes": "4", "seed": "2"}
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pair():
    fn, params, jax_in, jax_out = jax_build("kws_cnn", PROPS)
    module, port_in, port_out = build("kws_cnn", PROPS)
    module.load_state_dict(kws_cnn.state_dict_from_flax(params), strict=True)
    assert [(t.shape, t.dtype) for t in port_in.tensors] == \
        [(t.shape, t.dtype) for t in jax_in.tensors]
    assert [(t.shape, t.dtype) for t in port_out.tensors] == \
        [(t.shape, t.dtype) for t in jax_out.tensors]
    return jax.jit(fn), params, module.eval(), (jax_in, jax_out, port_in, port_out)


def _pcm(n, channels, dtype, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(4000, dtype=np.float32)
    tone = np.sin(t[None, :, None] / rng.uniform(3, 12, (n, 1, channels)))
    noise = rng.normal(0, 0.2, (n, 4000, channels))
    x = (tone * 0.5 + noise).astype(np.float32)
    return (x * 12000).astype(np.int16) if dtype == np.int16 else x


@pytest.mark.parametrize("dtype,channels", [(np.int16, 1), (np.float32, 1), (np.int16, 2)])
def test_logits_equal_jax(pair, dtype, channels):
    fn, params, module, _ = pair
    x = _pcm(3, channels, dtype)
    want = np.asarray(fn(params, [x])[0])
    with torch.inference_mode():
        got = module(torch.from_numpy(x)).numpy()
    assert got.shape == (3, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    single = np.asarray(fn(params, [x[0]])[0])  # the JAX entry's per-frame form
    np.testing.assert_allclose(got[0], single, **TOL)


def test_bf16_build_and_the_front_end():
    module, _, out_spec = build("kws_cnn", {"samples": "16000", "dtype": "bfloat16"})
    assert {p.dtype for p in module.convs.parameters()} == {torch.bfloat16}
    assert module.dense.weight.dtype == module.mel.dtype == torch.float32
    assert module.mel.shape == (201, 40) and not any("mel" in k for k in module.state_dict())
    np.testing.assert_array_equal(module.window.numpy(), np.hanning(400).astype(np.float32))
    with torch.inference_mode():
        out = module(torch.zeros((2, 16000, 1), dtype=torch.int16))
    assert out.shape == (2, 12) and out.dtype == torch.float32 and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="samples >= n_fft"):
        build("kws_cnn", {"samples": "100"})


def test_wav_to_keyword_labels_equal_jax(pair, tmp_path):
    fn, params, module, (jax_in, jax_out, port_in, port_out) = pair
    clips = _pcm(6, 1, np.int16, seed=5)
    path = tmp_path / "kw.wav"
    write_wav(str(path), clips.reshape(-1, 1), 16000)
    register_jax_model("kws_parity", fn, params, jax_in, jax_out)
    register_torch_model("kws_parity", module, port_in, port_out)
    text = (f"audiofilesrc location={path} samples-per-buffer=4000 ! tensor_converter ! "
            "tensor_filter name=f {fw} model=kws_parity max-batch=4 batch-timeout=100 ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=out")
    try:
        got = run(parse_pipeline, text.format(fw="framework=torch-cuda accelerator=cpu"))
        want = run(jax_parse, text.format(fw="framework=jax-xla"))
    finally:
        unregister_jax_model("kws_parity")
        unregister_torch_model("kws_parity")
    labels = [f.meta["label_index"] for f in got["out"].frames]
    assert labels == [f.meta["label_index"] for f in want["out"].frames] and len(labels) == 6
    with torch.inference_mode():
        direct = module(torch.from_numpy(clips)).argmax(-1).tolist()
    assert labels == direct
