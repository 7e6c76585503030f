"""Port parity for the filter's remaining properties (ROADMAP A4.3b).

Every property against the JAX ``tensor_filter`` on the same pipeline:
``input-combination`` / ``output-combination`` (per frame, micro-batched
and on a pushed block), ``invoke-dynamic``, ``latency`` / ``throughput`` /
``latency-report``, the manual model info (the declared schemas, and the
same ``ElementError`` texts for every refusal), ``config-file``; the start
rules (``batch-through`` with ``output-combination`` refused, the device
fusion pass skipping a filter with ``output-combination`` or
``invoke-dynamic``); ``mesh`` raising with its ROADMAP item; and
``output-combination=i0`` under the ingest lane through the ``async-sim``
backend, where the staging buffers the lane recycles must not reach an
emitted ``i0``.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core.types import StreamSpec as JSpec
from nnstreamer_tpu.elements.filter import TensorFilter as JFilter
from nnstreamer_tpu.pipeline import parse_pipeline as jax_parse
from nnstreamer_tpu_torch.core.types import StreamSpec as TSpec
from nnstreamer_tpu_torch.elements.filter import TensorFilter
from nnstreamer_tpu_torch.pipeline import parse_pipeline as torch_parse
from nnstreamer_tpu_torch.pipeline.element import ElementError

torch.set_num_threads(2)

PKGS = {"port": (torch_parse, TSpec), "jax": (jax_parse, JSpec)}
TWO = "tensors,format=static,num=2,dimensions=3.2,types=float32.float32"
ONE = "tensors,format=static,num=1,dimensions=3,types=float32"


def _frames(n: int):
    return [[np.arange(3, dtype=np.float32) + 10 * i, np.array([i, -i], np.float32)]
            for i in range(n)]


def _run(pkg: str, props: str, caps: str = TWO, n: int = 6, block: bool = False):
    """``appsrc ! tensor_filter framework=scaler custom=factor:2 <props> !
    tensor_sink``: the outputs as lists, the filter's negotiated output
    schema, its declared input and output, and the bus's element
    messages."""
    parse, spec_cls = PKGS[pkg]
    pipe = parse(f"appsrc name=src ! tensor_filter name=f framework=scaler custom=factor:2 "
                 f"{props} ! tensor_sink name=out")
    pipe["src"].set_spec(spec_cls.from_string(caps))
    bus = []
    pipe.add_bus_watcher(lambda m: bus.append(m.data) if m.kind == "element" else None)
    pipe.start()
    try:
        frames = _frames(n) if caps == TWO else [[f[0]] for f in _frames(n)]
        if block:
            pipe["src"].push_block([np.stack([f[i] for f in frames])
                                    for i in range(len(frames[0]))])
        else:
            for f in frames:
                pipe["src"].push(f)
        pipe["src"].end_of_stream()
        pipe.wait(timeout=20)
        f = pipe["f"]
        declared = tuple(s.to_string() if s is not None else None
                         for s in (f._model_in, f._model_out))
        out_spec = f.srcpads[0].spec.to_string()
    finally:
        pipe.stop()
    outs = [[np.asarray(t).tolist() for t in fr.tensors] for fr in pipe["out"].frames]
    return outs, out_spec, declared, bus, pipe


COMBINATIONS = [("", ""), ("1", ""), ("1,0", "o1,o0"), ("0", "i1,o0,i0"), ("", "i0,o1"),
                ("", "o1"), ("1", "i0")]


@pytest.mark.parametrize("feed", ["frames", "microbatch", "block"])
@pytest.mark.parametrize("in_comb,out_comb", COMBINATIONS)
def test_combinations_equal_to_jax(in_comb, out_comb, feed):
    props = (f"input-combination={in_comb} " if in_comb else "") + (
        f"output-combination={out_comb} " if out_comb else "")
    if feed != "frames":
        props += "max-batch=4"
    got = _run("port", props, block=feed == "block")
    want = _run("jax", props, block=feed == "block")
    assert got[:2] == want[:2]
    assert len(got[0]) == 6


def test_invoke_dynamic_equal_to_jax():
    got = _run("port", "invoke-dynamic=true")
    want = _run("jax", "invoke-dynamic=true")
    assert got[:2] == want[:2]
    assert got[1].startswith("tensors,format=flexible")


def test_latency_throughput_and_reports_like_jax():
    got = _run("port", "latency=1 throughput=1 latency-report=1", n=8)
    want = _run("jax", "latency=1 throughput=1 latency-report=1", n=8)
    assert got[0] == want[0]
    reports = [m for m in got[3] if "latency-us" in m]
    assert len(reports) == len([m for m in want[3] if "latency-us" in m]) == 8
    assert all(m["batch"] == 1 and m["latency-us"] > 0 for m in reports)
    f = got[4]["f"]
    assert f.latency_us > 0 and f.throughput_fps > 0 and f.invokes == 8
    quiet = _run("port", "", n=3)
    assert not quiet[3] and quiet[4]["f"].latency_us == 0.0
    assert quiet[4]["f"].throughput_fps == 0.0


@pytest.mark.parametrize("props,caps", [
    ("input=3 input-type=float32", ONE),
    ("input=3 input-type=float32 inputname=x output=3 output-type=float32 outputname=y", ONE),
    ("input=3,2 input-type=float32,float32 inputranks=1,1", TWO),
    ("output=5 output-type=float32", ONE),
    ("inputlayout=NHWC outputlayout=any,NCHW", ONE),
])
def test_manual_model_info_accepted_like_jax(props, caps):
    got = _run("port", props, caps=caps)
    want = _run("jax", props, caps=caps)
    assert got[:3] == want[:3]


REFUSALS = [
    ("input=3", ONE),
    ("output-type=float32", ONE),
    ("input=3,2 input-type=float32", TWO),
    ("input=3 input-type=float33", ONE),
    ("input=3:2 input-type=float32 inputranks=1", ONE),
    ("input=4 input-type=float32", ONE),
    ("input=3 input-type=float32 output=5 output-type=float32", ONE),
    ("input=3 input-type=float32 shared-tensor-filter-key=k", ONE),
    ("batch-through=true output-combination=o0", ONE),
    ("invoke-dynamic=true max-batch=2", ONE),
    ("inputlayout=NCWH", ONE),
]


def _error(pkg: str, props: str, caps: str) -> str:
    with pytest.raises(Exception) as e:
        _run(pkg, props, caps=caps, n=1)
    return f"{type(e.value).__name__}: {e.value}"


@pytest.mark.parametrize("props,caps", REFUSALS)
def test_refusals_raise_the_jax_text(props, caps):
    got, want = _error("port", props, caps), _error("jax", props, caps)
    if "layout" in props:
        # the note after the choices names the runtime that owns layout
        got, want = got.split(";")[0], want.split(";")[0]
    assert got == want
    assert got.startswith("ElementError: f:")


def test_every_jax_property_with_the_jax_default():
    """``framework`` keeps the port's default, ``torch-cuda`` (the JAX
    package's ``auto`` picks among backends the port does not have)."""
    for key, prop in JFilter.PROPERTIES.items():
        assert key in TensorFilter.PROPERTIES, key
        if key != "framework":
            assert TensorFilter.PROPERTIES[key].default == prop.default, key
    assert set(TensorFilter.PROPERTIES) <= set(JFilter.PROPERTIES)


def test_mesh_raises_naming_its_roadmap_item():
    with pytest.raises(ElementError, match="ROADMAP A11"):
        _run("port", "mesh=tp:2", caps=ONE, n=1)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_config_file_explicit_properties_win(pkg, tmp_path):
    cfg = tmp_path / "f.conf"
    cfg.write_text("# a comment\ncustom=factor:3\noutput_combination=i0,o0\n\n")
    parse, spec_cls = PKGS[pkg]
    pipe = parse(f"appsrc name=src ! tensor_filter name=f framework=scaler custom=factor:5 "
                 f"config-file={cfg} ! tensor_sink name=out")
    pipe["src"].set_spec(spec_cls.from_string(ONE))
    pipe.start()
    try:
        pipe["src"].push([np.ones(3, np.float32)])
        pipe["src"].end_of_stream()
        pipe.wait(timeout=10)
    finally:
        pipe.stop()
    out = pipe["out"].frames[0].tensors
    assert [np.asarray(t).tolist() for t in out] == [[1.0] * 3, [5.0] * 3]


@pytest.mark.parametrize("text", ["no equals sign", "config-file=/x", "no-such-key=1"])
def test_config_file_refusals_like_jax(text, tmp_path):
    cfg = tmp_path / "bad.conf"
    cfg.write_text(text + "\n")
    errs = []
    for pkg in ("port", "jax"):
        errs.append(_error(pkg, f"config-file={cfg}", ONE))
    assert errs[0] == errs[1] and f"{cfg}:1" in errs[0]


def test_decoder_config_file_like_jax(tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("a\nb\nc\n")
    cfg = tmp_path / "dec.conf"
    cfg.write_text(f"mode=image_labeling\noption1={labels}\n")
    got = []
    for parse, spec_cls in PKGS.values():
        pipe = parse(f"appsrc name=src ! tensor_decoder name=d config-file={cfg} ! "
                     "tensor_sink name=out")
        pipe["src"].set_spec(spec_cls.from_string(ONE))
        pipe.start()
        try:
            pipe["src"].push([np.array([0.1, 0.9, 0.3], np.float32)])
            pipe["src"].end_of_stream()
            pipe.wait(timeout=10)
        finally:
            pipe.stop()
        got.append(pipe["out"].frames[0].meta["label"])
    assert got == ["b", "b"]


# ---------------------------------------------------------------------------
# Device fusion is skipped for a composed or dynamic output
# ---------------------------------------------------------------------------
@pytest.fixture
def registered():
    from nnstreamer_tpu.backends.jax_xla import register_jax_model, unregister_jax_model
    from nnstreamer_tpu_torch.backends.torch_cuda import (
        register_torch_model,
        unregister_torch_model,
    )

    class Double(torch.nn.Module):
        def forward(self, x):
            return x * 2

    register_torch_model("props_double", Double())
    register_jax_model("props_double", lambda params, xs: [xs[0] * 2], {})
    yield
    unregister_torch_model("props_double")
    unregister_jax_model("props_double")


@pytest.mark.parametrize("props", ["", "output-combination=o0", "invoke-dynamic=true",
                                   "output-combination=i0,o0"])
def test_fusion_skipped_like_jax(props, registered, tmp_path):
    labels = tmp_path / "labels.txt"
    labels.write_text("a\nb\nc\n")
    fused, outs = [], []
    for pkg, fw in (("port", "framework=torch-cuda accelerator=cpu"), ("jax", "framework=jax-xla")):
        parse, spec_cls = PKGS[pkg]
        pipe = parse(f"appsrc name=src ! tensor_filter name=f {fw} model=props_double {props} "
                     f"! tensor_decoder name=d mode=image_labeling option1={labels} ! "
                     "tensor_sink name=out")
        pipe["src"].set_spec(spec_cls.from_string(ONE))
        pipe.start()
        try:
            fused.append(pipe["d"]._fused)
            pipe["src"].push([np.array([0.1, 0.9, 0.3], np.float32)])
            pipe["src"].end_of_stream()
            pipe.wait(timeout=20)
        finally:
            pipe.stop()
        outs.append(pipe["out"].frames[0].meta["label"])
    assert fused[0] == fused[1] == (props == "")
    assert outs == ["b", "b"]


# ---------------------------------------------------------------------------
# output-combination=iN under the ingest lane
# ---------------------------------------------------------------------------
def test_output_combination_input_never_a_staging_buffer():
    rng = np.random.default_rng(7)
    pushed = [rng.integers(0, 255, (4, 4, 3)).astype(np.float32) for _ in range(40)]
    outs = {}
    for pkg in ("port", "jax"):
        parse, _ = PKGS[pkg]
        pipe = parse("appsrc name=src ! tensor_filter name=f framework=async-sim "
                     "max-batch=4 ingest-lane=on output-combination=i0,o0 ! "
                     "tensor_sink name=out")
        pipe.start()
        try:
            for a in pushed:
                pipe["src"].push(a)
            pipe["src"].end_of_stream()
            pipe.wait(timeout=20)
            if pkg == "port":
                lane = pipe["f"]._lane
                assert lane is not None and lane.staged >= 10
                reused = lane.pool.reused
        finally:
            pipe.stop()
        outs[pkg] = [[np.asarray(t).copy() for t in f.tensors] for f in pipe["out"].frames]
    assert reused > 0  # the lane recycled staging buffers meanwhile
    assert len(outs["port"]) == len(pushed)
    for (i0, o0), (ji0, jo0), a in zip(outs["port"], outs["jax"], pushed):
        assert np.array_equal(i0, a) and np.array_equal(o0, a * 2 + 1)
        assert np.array_equal(i0, ji0) and np.array_equal(o0, jo0)
