"""Port parity: the converter subplugins (``converters/``: tokenizer,
python3, and through ``test_torch_wire.py`` the serialize trio) and the
host decoders (``detokenizer``, ``direct_video``, ``octet_stream``,
``tensor_region``, ``python3``) against the JAX package's, on the CPU.

Mirrors ``tests/test_vit_and_text.py``'s text-in/text-out pipeline
(tokenizer -> ``generate:8`` on the small transformer -> detokenizer,
float32, the flax params converted, every reference step's top-2 logit
margin above 1e-4) and the decoder cases of ``tests/test_decoders.py``.
Tolerance: exact (token ids, text, regions, bytes and the script
outputs); host decoders fed torch tensors must give what they give for
the same numpy arrays.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu.converters  # noqa: F401 — registers the JAX subplugins
import nnstreamer_tpu.decoders  # noqa: F401
from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.core import registry as jax_registry
from nnstreamer_tpu.core.buffer import TensorFrame as JaxFrame
from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.core import registry
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.models import ssd_mobilenet
from nnstreamer_tpu_torch.models import transformer as tr
from nnstreamer_tpu_torch.pipeline import parse_pipeline
from torch_parity import assert_frames_equal, both, host, run

import nnstreamer_tpu_torch.converters  # noqa: F401,E402 — registers the port's
import nnstreamer_tpu_torch.decoders  # noqa: F401,E402

torch.set_num_threads(2)

LM = {"dtype": "float32", "vocab": "300", "d_model": "32", "heads": "2", "layers": "2",
      "d_ff": "64", "seq": "64", "seed": "5"}
N = 8


def _pair(kind, name):
    """A fresh instance of subplugin `name` from each package."""
    objs = (registry.get(kind, name), jax_registry.get(kind, name))
    return [o() if isinstance(o, type) else o for o in objs]


def test_every_jax_converter_and_decoder_mode_resolves():
    for kind, n in ((registry.KIND_CONVERTER, 5), (registry.KIND_DECODER, 12)):
        names = registry.get_all(kind)
        assert names == jax_registry.get_all(kind) and len(names) == n
        for name in names:
            assert type(registry.get(kind, name)).__module__ != "nnstreamer_tpu"
            assert registry.get(kind, name).__module__.startswith("nnstreamer_tpu_torch.")


def test_text_in_text_out_equals_jax():
    logits_fn, params, _, _ = jax_build("transformer", LM)
    gen_fn, gen_params, jax_in, jax_out = jax_build("transformer", dict(LM, generate=str(N)))
    lm = tr.lm_from_props(LM)
    lm.load_state_dict(tr.state_dict_from_flax(params), strict=True)
    _, port_in, port_out = tr.build(dict(LM, generate=str(N)))
    prompts = [b"hello tpu", b"abcdefgh1", b"x\xc3\xa9zxyzxy", b"hello abc"]
    ids = np.stack([np.frombuffer(p, np.uint8).astype(np.int32) for p in prompts])
    want_ids = np.asarray(gen_fn(gen_params, [ids])[0])
    steps = np.asarray(logits_fn(params, [want_ids])[0])[:, 8:-1]
    top = np.sort(steps, axis=-1)
    assert (top[..., -1] - top[..., -2]).min() > 1e-4  # no near-tie decides a token
    register_jax_model("text_parity", gen_fn, gen_params, jax_in, jax_out)
    register_torch_model("text_parity", tr.GenerateLM(lm, N), port_in, port_out)
    text = ("appsrc name=src ! tensor_converter mode=custom:tokenizer ! tensor_filter name=f "
            "{fw} model=text_parity max-batch=4 batch-timeout=500 ! tensor_decoder "
            "mode=detokenizer ! tensor_sink name=out")
    pushes = [(np.frombuffer(p, np.uint8), float(i)) for i, p in enumerate(prompts)]
    try:
        got = run(parse_pipeline, text.format(fw="framework=torch-cuda accelerator=cpu"), pushes)
        want = run(jax_parse, text.format(fw="framework=jax-xla"), pushes)
    finally:
        unregister_jax_model("text_parity")
        unregister_torch_model("text_parity")
    assert_frames_equal(got["out"].frames, want["out"].frames)
    assert got["f"].invokes == 1  # four equal-length prompts, one micro-batch
    for f, w, ids_w in zip(got["out"].frames, want["out"].frames, want_ids):
        assert f.meta["text"] == w.meta["text"] and f.meta["media_type"] == "text"
        assert bytes(f.tensors[0]) == bytes(np.where(ids_w < 256, ids_w, ord("?")).astype(np.uint8))
    assert (want_ids[:, 9:] >= 256).any()  # some ids print as '?'


def test_tokenizer_detokenizer_round_trip_on_torch_tensors():
    tok, jax_tok = _pair(registry.KIND_CONVERTER, "tokenizer")
    detok, _ = _pair(registry.KIND_DECODER, "detokenizer")
    msg = "round-trip é".encode()
    got = tok.convert(TensorFrame([torch.from_numpy(np.frombuffer(msg, np.uint8).copy())]))
    want = jax_tok.convert(JaxFrame([np.frombuffer(msg, np.uint8)]))
    np.testing.assert_array_equal(got.tensors[0], want.tensors[0])
    assert got.tensors[0].dtype == np.int32
    back = detok.decode(got.with_tensors([torch.from_numpy(got.tensors[0])]), None)
    assert back.meta["text"] == msg.decode() and isinstance(back.tensors[0], np.ndarray)


@pytest.mark.parametrize("as_torch", [False, True])
def test_tensor_region_on_the_same_ssd_heads(tmp_path, as_torch):
    priors = ssd_mobilenet.write_box_priors(str(tmp_path / "priors.txt"))
    rng = np.random.default_rng(7)
    frames = [(rng.normal(0, 1, (2000, 4)).astype(np.float32),
               rng.normal(-3, 1.5, (2000, 91)).astype(np.float32)) for _ in range(4)]
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"c{i}" for i in range(91)))
    opts = ["3", str(labels), f"{priors}:0.97", "300:300"] + [""] * 5
    dec, jax_dec = _pair(registry.KIND_DECODER, "tensor_region")
    dec.set_options(opts)
    jax_dec.set_options(opts)
    counts = []
    for loc, scores in frames:
        payload = [torch.from_numpy(loc), torch.from_numpy(scores)] if as_torch else [loc, scores]
        got, want = dec.decode(TensorFrame(payload), None), jax_dec.decode(JaxFrame([loc, scores]), None)
        assert got.tensors[0].dtype == np.int32
        np.testing.assert_array_equal(got.tensors[0], want.tensors[0])
        assert got.meta["region_labels"] == want.meta["region_labels"]
        counts.append(len(got.tensors[0]))
    assert sorted(counts) == [0, 1, 2, 3]  # empty, partial and full region lists


@pytest.mark.parametrize("as_torch", [False, True])
def test_direct_video_and_octet_stream(as_torch):
    img = np.random.default_rng(1).integers(0, 256, (1, 4, 6, 3), dtype=np.uint8)
    extra = np.int16([1, -2, 3])
    wrap = torch.from_numpy if as_torch else (lambda a: a)
    for mode, payload in (("direct_video", [img]), ("octet_stream", [img, extra])):
        dec, jax_dec = _pair(registry.KIND_DECODER, mode)
        got = dec.decode(TensorFrame([wrap(a) for a in payload]), None)
        want = jax_dec.decode(JaxFrame(payload), None)
        assert isinstance(got.tensors[0], np.ndarray)
        np.testing.assert_array_equal(got.tensors[0], want.tensors[0])
        assert got.meta == want.meta
    with pytest.raises(ValueError, match="uint8"):
        dec, _ = _pair(registry.KIND_DECODER, "direct_video")
        dec.decode(TensorFrame([wrap(extra.reshape(1, 1, 3, 1))]), None)


CONVERTER_SCRIPTS = {
    "class": ("import numpy as np\n"
              "class CustomConverter:\n"
              "    def convert(self, payload, meta):\n"
              "        x = np.asarray(payload, np.float32)\n"
              "        return [x * 2, np.int32([len(meta)])]\n"),
    "function": "import numpy as np\ndef convert(payload):\n    return np.asarray(payload) + 1\n",
}


@pytest.mark.parametrize("form", sorted(CONVERTER_SCRIPTS))
@pytest.mark.parametrize("mode", ["path", "env"])
def test_python3_converter_scripts(tmp_path, monkeypatch, form, mode):
    script = tmp_path / f"conv_{form}.py"
    script.write_text(CONVERTER_SCRIPTS[form])
    monkeypatch.setenv("NNS_TPU_CONVERTER_SCRIPT", str(script))
    sub = f"custom-script:{script}" if mode == "path" else "custom-script:python3"
    x = np.arange(6, dtype=np.uint8).reshape(2, 3)
    (got, _), = both(f"appsrc name=src ! tensor_converter mode={sub} set-timestamp=false "
                     "! tensor_sink name=out", [(x, 0.0), (x + 1, 1.0)]).values()
    np.testing.assert_array_equal(got[1].tensors[0], (x + 1) * 2 if form == "class" else x + 2)


DECODER_SCRIPTS = {
    "class": ("class CustomDecoder:\n"
              "    def set_options(self, options):\n"
              "        self.k = int(options[0] or 3)\n"
              "    def decode(self, tensors, meta):\n"
              "        return {'tensors': [tensors[0] * self.k], 'meta': {'scaled': self.k}}\n"),
    "function": "def decode(tensors):\n    return [t + 1 for t in tensors]\n",
}


@pytest.mark.parametrize("form", sorted(DECODER_SCRIPTS))
def test_python3_decoder_scripts(tmp_path, form):
    script = tmp_path / f"dec_{form}.py"
    script.write_text(DECODER_SCRIPTS[form])
    x = np.arange(4, dtype=np.float32)
    out = both(f"appsrc name=src ! tensor_decoder mode=python3 option1={script} option2=5 "
               "! tensor_sink name=out", [(x, 0.0)])["out"][0]
    np.testing.assert_array_equal(out[0].tensors[0], x * 5 if form == "class" else x + 1)
    dec, _ = _pair(registry.KIND_DECODER, "python3")
    dec.set_options([str(script), "5"])
    got = dec.decode(TensorFrame([torch.from_numpy(x)]), None)
    np.testing.assert_array_equal(host(got.tensors[0]), host(out[0].tensors[0]))
    with pytest.raises((FileNotFoundError, ValueError)):
        dec.set_options([str(tmp_path / "missing.py")])


def test_unknown_converter_modes_raise():
    for mode in ("custom:nosuch", "bogus:tokenizer"):
        with pytest.raises(Exception, match="unknown converter"):
            parse_pipeline(f"appsrc ! tensor_converter mode={mode} ! tensor_sink").start()
