"""Port parity for the whole slice: the image-labeling pipeline.

The JAX pipeline (``framework=jax-xla``) and the port's
(``framework=torch-cuda accelerator=cpu``) run the same MobileNet-v2
weights (the flax tree, converted) on the same 10 frames with
``max-batch=4``: micro-batches of 4, 4 and 2 — the last partial one goes
through bucket padding — and a device-fused decoder in both.  Plus the
port-only behaviour of its pipeline runtime.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
from nnstreamer_tpu.models import build as jax_build
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse_pipeline
from nnstreamer_tpu_torch.backends.torch_cuda import register_torch_model, unregister_torch_model
from nnstreamer_tpu_torch.models import build as torch_build
from nnstreamer_tpu_torch.models.mobilenet_v2 import state_dict_from_flax
from nnstreamer_tpu_torch.pipeline import ElementError, make_element, parse_pipeline

torch.set_num_threads(2)

SIZE, N_FRAMES, MODEL = 32, 10, "torch_parity_mobilenet"
_PROPS = {"dtype": "float32", "pallas": "1", "classes": "10", "width": "0.35",
          "size": str(SIZE)}


def _randomized(variables, seed=0):
    """The flax tree as numpy, with seeded BatchNorm params and stats."""
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


@pytest.fixture(scope="module")
def registered():
    fn, variables, in_spec, out_spec = jax_build("mobilenet_v2", _PROPS)
    variables = _randomized(variables)
    register_jax_model(MODEL, fn, variables, in_spec, out_spec)
    module, t_in, t_out = torch_build("mobilenet_v2", _PROPS)
    module.load_state_dict(state_dict_from_flax(variables))
    register_torch_model(MODEL, module, t_in, t_out)
    yield
    unregister_jax_model(MODEL)
    unregister_torch_model(MODEL)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, (SIZE, SIZE, 3), dtype=np.uint8) for _ in range(N_FRAMES)]


def _labels(parse, framework, frames, extra="", block=False):
    pipe = parse(
        f"appsrc name=src ! tensor_filter name=f framework={framework} model={MODEL} "
        f"max-batch=4 batch-timeout=200 {extra} ! tensor_decoder name=dec mode=image_labeling "
        "! tensor_sink name=out")
    pipe.start()
    try:
        if block:
            pipe["src"].push_block(np.stack(frames), pts=list(range(len(frames))))
        else:
            for i, f in enumerate(frames):
                pipe["src"].push(f, pts=float(i))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=120)
    finally:
        pipe.stop()
    out = pipe["out"].frames
    assert [f.pts for f in out] == list(range(len(frames)))
    return (np.array([f.meta["label_index"] for f in out]),
            np.array([f.meta["label_score"] for f in out]))


@pytest.fixture(scope="module")
def jax_labels(registered, frames):
    return _labels(jax_parse_pipeline, "jax-xla", frames)


@pytest.mark.parametrize("variant", ["fused", "unfused", "block"])
def test_pipeline_labels_match_jax(registered, frames, jax_labels, variant):
    extra = "accelerator=cpu"
    parse = parse_pipeline
    if variant == "unfused":
        def parse(text):  # the decoder decodes on the host from full logits
            return parse_pipeline(text.replace("mode=", "device-fused=never mode="))
    idx, score = _labels(parse, "torch-cuda", frames, extra, block=variant == "block")
    np.testing.assert_array_equal(idx, jax_labels[0])
    np.testing.assert_allclose(score, jax_labels[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("decoder", ["", "device-fused=never"])
def test_labels_match_jax_with_the_feed_on(registered, frames, jax_labels, decoder):
    """The slice as a whole: the ingest lane stages every micro-batch (4, 4
    and 2 frames) and, with the decoder on the host, the dispatch window
    reaps every invoke; labels equal the JAX package's."""
    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_filter name=f model={MODEL} accelerator=cpu max-batch=4 "
        f"batch-timeout=200 ingest-lane=on dispatch-depth=4 ! tensor_decoder {decoder} "
        "mode=image_labeling ! tensor_sink name=out")
    pipe.start()
    try:
        for i, f in enumerate(frames):
            pipe["src"].push(f, pts=float(i))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=120)
        f = pipe["f"]
        staged, reaped, invokes = f._lane.staged, f._inflight.reaped, f.invokes
    finally:
        pipe.stop()
    out = pipe["out"].frames
    assert [f.pts for f in out] == list(range(N_FRAMES))
    assert staged == invokes == 3
    assert reaped == (0 if decoder == "" else 3)  # batch-through parks nothing
    np.testing.assert_array_equal([f.meta["label_index"] for f in out], jax_labels[0])
    np.testing.assert_allclose([f.meta["label_score"] for f in out], jax_labels[1],
                               rtol=1e-4, atol=1e-4)


BF16_MODEL, BF16_CLASSES = "torch_parity_bf16_head", 1001


class _Bf16Head(torch.nn.Module):
    """A model whose head emits bfloat16 logits: its float32 input, cast."""

    def forward(self, x):
        return x.to(torch.bfloat16)


@pytest.fixture(scope="module")
def bf16_head():
    import jax.numpy as jnp

    register_jax_model(BF16_MODEL, lambda p, xs: [xs[0].astype(jnp.bfloat16)], None)
    register_torch_model(BF16_MODEL, _Bf16Head())
    rng = np.random.default_rng(13)
    logits = [rng.standard_normal(BF16_CLASSES).astype(np.float32) for _ in range(6)]
    logits[1][[40, 700]] = 8.0  # a tie: the first index wins
    logits[2][[3, 4]] = 8.01, 8.02  # both 8.0 in bfloat16: a tie float32 would not have
    yield logits
    unregister_jax_model(BF16_MODEL)
    unregister_torch_model(BF16_MODEL)


def _bf16_labels(parse, framework, frames, decoder=""):
    pipe = parse(
        f"appsrc name=src ! tensor_filter framework={framework} model={BF16_MODEL} "
        f"accelerator=cpu max-batch=4 batch-timeout=200 ! tensor_decoder name=dec {decoder} "
        "mode=image_labeling ! tensor_sink name=out")
    pipe.start()
    try:
        for i, f in enumerate(frames):
            pipe["src"].push(f, pts=float(i))
        pipe["src"].end_of_stream()
        pipe.wait(timeout=120)
        fused = pipe["dec"]._fused
    finally:
        pipe.stop()
    out = pipe["out"].frames
    assert [f.pts for f in out] == list(range(len(frames)))
    return fused, [(f.meta["label_index"], f.meta["label_score"]) for f in out]


@pytest.mark.parametrize("decoder", ["", "device-fused=never"])
def test_bf16_head_labels_match_jax(bf16_head, decoder):
    fused, want = _bf16_labels(jax_parse_pipeline, "jax-xla", bf16_head)
    assert fused
    fused, got = _bf16_labels(parse_pipeline, "torch-cuda", bf16_head, decoder)
    assert fused == (decoder == "")
    assert got == want  # index and score exact
    assert want[1][0] == 40 and want[2][0] == 3


def test_fusion_pass_switches_decoder_to_fused(registered):
    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_filter name=f model={MODEL} accelerator=cpu max-batch=4 "
        "! tensor_decoder name=dec mode=image_labeling ! tensor_sink name=out")
    pipe.start()
    try:
        assert pipe["dec"]._fused and pipe["f"].batch_through_active
        assert len(pipe["f"].backend._posts) == 1
    finally:
        pipe["src"].end_of_stream()
        pipe.wait(timeout=30)
        pipe.stop()


def test_fusion_respects_device_fused_never(registered):
    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_filter name=f model={MODEL} accelerator=cpu max-batch=4 "
        "! tensor_decoder name=dec device-fused=never mode=image_labeling ! tensor_sink")
    pipe.start()
    try:
        assert not pipe["dec"]._fused and not pipe["f"].batch_through_active
    finally:
        pipe.stop()


def test_per_frame_invoke_matches_batched(registered, frames):
    # max-batch=1: one backend.invoke per frame, the fused postprocess on a
    # batch of one
    idx, score = _labels(
        lambda text: parse_pipeline(text.replace("max-batch=4", "max-batch=1")),
        "torch-cuda", frames[:3], "accelerator=cpu")
    ref_idx, ref_score = _labels(parse_pipeline, "torch-cuda", frames[:3], "accelerator=cpu")
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(score, ref_score, rtol=1e-5, atol=1e-5)


def test_unknown_property_raises():
    with pytest.raises(ElementError, match="unknown property"):
        make_element("tensor_filter").set_property("no-such-prop", "1")
    with pytest.raises(ElementError, match="unknown property"):
        parse_pipeline("appsrc ! tensor_filter bogus=1 ! tensor_sink")


def test_filter_without_cpu_wish_refuses_to_start_without_cuda(registered, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pipe = parse_pipeline(f"appsrc ! tensor_filter framework=torch-cuda model={MODEL} ! tensor_sink")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.start()
    assert not pipe._threads  # nothing left running


def test_cpu_placement_is_explicit(registered):
    pipe = parse_pipeline(f"appsrc ! tensor_filter name=f model={MODEL} accelerator=cpu ! tensor_sink")
    pipe.start()
    try:
        assert pipe["f"].backend.device == torch.device("cpu")
    finally:
        pipe.stop()


def test_element_error_stops_pipeline_and_wait_reraises():
    pipe = parse_pipeline("appsrc name=src ! tensor_filter model=unregistered accelerator=cpu "
                          "! tensor_sink")
    with pytest.raises(FileNotFoundError):
        pipe.start()
    pipe = parse_pipeline("appsrc name=src ! tensor_decoder mode=image_labeling ! tensor_sink")
    pipe.start()
    pipe["src"].push(np.zeros(3, np.float32))
    pipe["src"].push(np.zeros(0, np.float32))  # decode() fails: argmax of nothing
    pipe["src"].end_of_stream()
    with pytest.raises(ValueError):
        pipe.wait(timeout=30)
    threads = list(pipe._threads)
    pipe.stop()
    assert threads and not any(t.is_alive() for t in threads)


def test_parser_rejects_malformed_text():
    from nnstreamer_tpu_torch.pipeline import ParseError

    for text in ["", "appsrc !", "! tensor_sink", "no_such_element"]:
        with pytest.raises(ParseError):
            parse_pipeline(text)


def test_declared_source_schema_negotiates_fused_output(registered):
    from nnstreamer_tpu_torch.core.types import FORMAT_STATIC, StreamSpec, TensorSpec

    frame = StreamSpec((TensorSpec((SIZE, SIZE, 3), np.uint8),), FORMAT_STATIC)
    pipe = parse_pipeline(
        f"appsrc name=src ! tensor_filter name=f model={MODEL} accelerator=cpu max-batch=4 "
        "! tensor_decoder name=dec mode=image_labeling ! tensor_sink")
    pipe["src"].set_spec(frame)
    pipe.start()
    try:
        # the fused filter derives its output from the model + device half
        fused = pipe["f"].derive_spec()
        assert [(t.shape, t.dtype) for t in fused.tensors] == [((2,), np.float32)]
        assert pipe["dec"].derive_spec().tensors[0].shape == (1,)
    finally:
        pipe.stop()
    wrong = StreamSpec((TensorSpec((SIZE + 1, SIZE, 3), np.uint8),), FORMAT_STATIC)
    pipe = parse_pipeline(f"appsrc name=src ! tensor_filter model={MODEL} accelerator=cpu "
                          "! tensor_sink")
    pipe["src"].set_spec(wrong)
    with pytest.raises(ElementError, match="does not match model input"):
        pipe.start()
