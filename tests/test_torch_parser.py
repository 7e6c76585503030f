"""Port parity: ``parse_pipeline`` (branch references, forward references,
bare caps strings and their errors) and the stream utilities it builds
(``videotestsrc``, ``queue``, ``tee``, ``capsfilter``, ``identity``,
``join``) against the JAX package's, on the CPU.

"The same graph" is checked directly.  Both packages must have the same
elements in the same order, with the same factories and the same
user-given names.  Auto-names embed an object id, so only their factory
is compared.  Each element must have the same src pads, each with the
same links in the same order, to the same sink pads.  Errors must be the
same ``ParseError`` message.  Pipelines that run hold the port to the
contracts of ``tests/test_pipeline.py:96-140``.
"""

import re

import numpy as np
import pytest
import torch

from nnstreamer_tpu.pipeline import ElementError as JaxElementError
from nnstreamer_tpu.pipeline import ParseError as JaxParseError
from nnstreamer_tpu.pipeline import Pipeline as JaxPipeline
from nnstreamer_tpu.pipeline import make_element as jax_make
from nnstreamer_tpu_torch.pipeline import (
    ElementError,
    ParseError,
    Pipeline,
    make_element,
    parse_pipeline,
)
from torch_parity import both, jax_parse, run

torch.set_num_threads(2)


def label(e):
    """A user-given name, or the factory of an auto-named element."""
    auto = re.fullmatch(rf"{re.escape(e.FACTORY_NAME)}\d+(_\d+)?", e.name)
    return f"<{e.FACTORY_NAME}>" if auto else e.name


def graph(pipe):
    els = list(pipe.elements.values())
    index = {id(e): i for i, e in enumerate(els)}
    return [(e.FACTORY_NAME, label(e),
             [[(index[id(d)], sp) for d, sp in pad.links] for pad in e.srcpads]) for e in els]


TEXTS = {
    "linear": "videotestsrc num-buffers=3 width=16 height=16 ! queue ! tensor_sink name=out",
    "tee": "videotestsrc num-buffers=2 width=4 height=4 ! tee name=t "
           "t. ! queue ! tensor_sink name=a  t. ! queue ! tensor_sink name=b",
    "caps": "videotestsrc num-buffers=2 width=8 height=8 ! "
            "tensors,format=static,num=1,dimensions=3:8:8,types=uint8 ! tensor_sink name=out",
    "two-caps": "appsrc ! tensors,format=flexible ! identity ! other/tensors,format=flexible "
                "! tensor_sink",
    "mux-forward": "appsrc name=a ! mux.  appsrc name=b ! mux.  "
                   "tensor_mux name=mux ! tensor_sink name=out",
    "demux": "appsrc name=src ! tensor_demux name=d tensorpick=1,0 "
             "d. ! tensor_sink name=o1  d. ! tensor_sink name=o2",
    "crop": "appsrc name=raw ! c.  appsrc name=info ! c.  tensor_crop name=c ! tensor_sink",
    "branch-into-forward": "appsrc name=src ! tee name=t  t. ! queue ! m.  "
                           "t. ! queue ! tensor_transform mode=typecast option=float32 ! m.  "
                           "tensor_mux name=m ! tensor_demux name=d  d. ! tensor_sink name=x  "
                           "d. ! tensor_sink name=y",
    "split-into-merge": "appsrc name=src ! tensor_split name=s tensorseg=1,2 "
                        "s. ! j.  s. ! j.  join name=j ! tensor_sink",
    "fanout-plain-pad": "appsrc name=s ! tensor_sink name=a  s. ! tensor_sink name=b",
    "unnamed-twins": "appsrc ! queue ! queue ! tensor_sink",
    "juxtaposed": "appsrc name=a ! queue tensor_sink name=b  appsrc ! tensor_sink",
    "if": "appsrc name=src ! tensor_if name=i compared-value=a_value supplied-value=5 "
          "i. ! tensor_sink name=t  i. ! tensor_sink name=e",
}


@pytest.mark.parametrize("text", TEXTS.values(), ids=TEXTS.keys())
def test_same_graph_as_jax(text):
    assert graph(parse_pipeline(text)) == graph(jax_parse(text))


ERRORS = [
    "", "videotestsrc !", "! tensor_sink", "nonexistent_element_xyz",
    "videotestsrc ! nosuch. ! tensor_sink", "t. ! tensor_sink", "name=x",
    "appsrc name=x ! tensor_sink name=x", "appsrc ! 'unclosed",
]


@pytest.mark.parametrize("text", ERRORS)
def test_same_parse_errors_as_jax(text):
    with pytest.raises(JaxParseError) as want:
        jax_parse(text)
    with pytest.raises(ParseError) as got:
        parse_pipeline(text)
    assert str(got.value) == str(want.value)


def test_juxtaposed_elements_are_an_error_here():
    """An element that follows another with no '!' or reference starts a
    second, unlinked chain, in both parsers: the same two elements and no
    link (its name predates the repair, when the port raised here)."""
    got, want = graph(parse_pipeline("appsrc tensor_sink")), graph(jax_parse("appsrc tensor_sink"))
    assert got == want == [("appsrc", "<appsrc>", [[]]), ("tensor_sink", "<tensor_sink>", [])]


def test_unknown_property():
    for parse, err in ((jax_parse, JaxElementError), (parse_pipeline, ElementError)):
        with pytest.raises(err, match="unknown property"):
            parse("videotestsrc bogus-prop=3 ! tensor_sink")


@pytest.mark.parametrize("name", ["linear", "tee", "caps"])
def test_parsed_pipelines_run_as_jax(name):
    sinks = ("a", "b") if name == "tee" else ("out",)
    out = both(TEXTS[name], sinks=sinks, timeout=20)
    for got, _ in out.values():
        assert len(got) == (2 if name != "linear" else 3)


@pytest.mark.parametrize("pattern", ["gradient", "solid", "random"])
def test_videotestsrc_frames_byte_equal(pattern):
    (got, _), = both(f"videotestsrc num-buffers=4 width=6 height=5 pattern={pattern} seed=7 "
                     "framerate=25/1 ! tensor_sink name=out").values()
    assert got[0].tensors[0].shape == (5, 6, 3) and got[0].tensors[0].dtype == np.uint8
    assert [f.pts for f in got] == [i / 25 for i in range(4)]


def test_caps_negotiation_failure():
    for pipe_cls, make, err in ((JaxPipeline, jax_make, JaxElementError),
                                (Pipeline, make_element, ElementError)):
        pipe = pipe_cls("t")
        src = make("videotestsrc", width=8, height=8)
        cf = make("capsfilter",
                  caps="tensors,format=static,num=1,dimensions=3:16:16,types=uint8")
        pipe.chain(src, cf, make("tensor_sink"))
        with pytest.raises(err, match="does not satisfy"):
            pipe.start()
        pipe.stop()


def test_capsfilter_refines_the_schema():
    from nnstreamer_tpu_torch.core.types import StreamSpec

    pipe = parse_pipeline("appsrc name=src ! "
                          "tensors,format=static,num=1,dimensions=3:0,types=float32 ! "
                          "tensor_sink name=out")
    pipe["src"].set_spec(StreamSpec.from_string(
        "tensors,format=static,num=1,dimensions=0:4,types=float32,framerate=30/1"))
    pipe.start()
    try:
        spec = pipe["capsfilter1"].derive_spec()
        assert spec.tensors[0].shape == (4, 3) and spec.framerate == 30
        assert spec.to_string() == ("tensors,format=static,num=1,dimensions=3:4,"
                                    "types=float32,framerate=30/1")
    finally:
        pipe.stop()


def test_join_forwards_both_inputs_and_ends_after_both():
    text = "appsrc name=a ! j.  appsrc name=b ! j.  join name=j ! tensor_sink name=out"
    pushes = {"a": [(np.int32([1]), 0.0)], "b": [(np.int32([2]), 1.0)]}
    for parse in (jax_parse, parse_pipeline):
        got = run(parse, text, pushes)["out"].frames
        assert sorted(int(f.tensors[0][0]) for f in got) == [1, 2]


def test_tee_shares_torch_payloads_on_every_branch():
    x = torch.arange(6).reshape(2, 3)
    pipe = run(parse_pipeline, "appsrc name=src ! tee name=t  t. ! queue ! tensor_sink name=a "
               "to-host=false  t. ! tensor_sink name=b to-host=false  t. ! identity ! "
               "tensor_sink name=c to-host=false", [(x, 0.0)])
    assert all(pipe[s].frames[0].tensors[0] is x for s in "abc")


def test_run_with_timeout_returns_the_finished_pipeline():
    pipe = parse_pipeline("videotestsrc num-buffers=2 width=4 height=4 ! tensor_sink name=out")
    pipe.run(timeout=20)
    assert len(pipe["out"].frames) == 2 and not pipe._threads


@pytest.mark.parametrize("name", ["tee", "branch-into-forward", "fanout-plain-pad"])
def test_branches_get_their_own_streaming_threads_as_jax(name):
    """The fusion pass gives every branch of a fan-out, and every input of
    an N:1 element, a head of its own: the same segments as the JAX
    package's (auto-names compared by factory)."""
    def segs(pipe):
        pipe.start()
        try:
            return sorted([label(e) for e in seg.chain] for seg in pipe._segments)
        finally:
            pipe.stop()

    assert segs(parse_pipeline(TEXTS[name])) == segs(jax_parse(TEXTS[name]))


#: sinks that take a micro-batch whole where the JAX ones take its frames: a
#: card micro-batch reaches the host in one copy per tensor before a
#: transport thread sees it (ROADMAP C5)
WHOLE_BATCH_SINKS = {"edgesink", "mqttsink", "tensor_sink_grpc"}


def test_element_classes_match_jax():
    """41 of the JAX package's element classes (the three tensor_query
    elements, the edge, MQTT and gRPC-stream pairs and tensor_src_iio
    among them), each with
    the JAX class's factory aliases, pad counts and BATCH_AWARE contract
    (the pub/sub sinks take a micro-batch whole)."""
    from nnstreamer_tpu.pipeline.element import ELEMENT_TYPES as JAX_TYPES
    from nnstreamer_tpu_torch.pipeline.element import ELEMENT_TYPES

    ours = {f: c for f, c in ELEMENT_TYPES.items()  # not classes other tests register
            if c.__module__.startswith("nnstreamer_tpu_torch.elements.")}
    assert len(set(ours.values())) == 41
    for factory, cls in ours.items():
        ref = JAX_TYPES[factory]
        batch_aware = ref.BATCH_AWARE or factory in WHOLE_BATCH_SINKS
        assert (cls.FACTORY_NAME, cls.NUM_SINK_PADS, cls.NUM_SRC_PADS, cls.BATCH_AWARE) == \
            (ref.FACTORY_NAME, ref.NUM_SINK_PADS, ref.NUM_SRC_PADS, batch_aware), factory
