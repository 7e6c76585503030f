"""Port parity: the stream-shaping elements (tensor_transform, mux/demux,
merge/split, aggregator, if, crop, rate, repo, sparse, debug and the leaky
queue) against the JAX package's, on the CPU.

Each case pushes the same seeded numpy inputs through the JAX element and
the port's and holds the port to the contracts of
``tests/test_flow_elements.py`` and ``tests/test_flow_truth_tables.py``.
Ints, bools, shapes, dtypes and counters must be equal, and float outputs
of the numpy route bit for bit.  The port's torch route (a torch tensor
in; here on the CPU) is held to the JAX numpy route.  The dtype must be
exact.  Values are bit for bit for the elementwise ops.  ``stand``, whose
reduction order differs, is held within rtol 1e-5 and atol 1e-5; its
outputs are standardized, so of order 1.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.core.buffer import TensorFrame as JaxFrame
from nnstreamer_tpu.elements import flow as jax_flow
from nnstreamer_tpu.elements.repo import reset_repo as jax_reset_repo
from nnstreamer_tpu.pipeline import ElementError as JaxElementError
from nnstreamer_tpu.pipeline import make_element as jax_make
from nnstreamer_tpu_torch.core.buffer import TensorFrame
from nnstreamer_tpu_torch.elements import flow
from nnstreamer_tpu_torch.elements.repo import reset_repo
from nnstreamer_tpu_torch.pipeline import ElementError, make_element, parse_pipeline
from torch_parity import assert_frames_equal, both, host, jax_parse, run

torch.set_num_threads(2)

DTYPES = ["uint8", "int32", "float32"]


def _input(dtype, shape=(2, 4, 5, 3), seed=0):
    rng = np.random.default_rng(seed)
    if dtype == "float32":
        return rng.uniform(-300, 300, shape).astype(np.float32)
    return rng.integers(0, 256, shape).astype(dtype)


# -- tensor_transform ---------------------------------------------------------

MODES = [
    ("typecast", "float32"),
    ("typecast", "int32"),
    ("arithmetic", "typecast:float32,add:-127.5,div:127.5"),
    ("arithmetic", "add:-127.5"),
    ("arithmetic", "mul:2,sub:3"),
    ("arithmetic", "div:3.3"),
    ("arithmetic", "add:1|10|100"),
    ("transpose", "1:0:2:3"),
    ("dimchg", "0:2"),
    ("stand", "default"),
    ("stand", "dc-average"),
    ("clamp", "0:1"),
    ("clamp", "-1:100"),
]


def _transform(make, mode, option, x, apply=""):
    el = make("tensor_transform", mode=mode, option=option)
    if apply:
        el.set_property("apply", apply)
    el.start()
    return el, el.transform


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,option", MODES, ids=[f"{m}-{o}" for m, o in MODES])
@pytest.mark.parametrize("route", ["numpy", "torch"])
def test_transform_matches_jax(route, mode, option, dtype):
    x = _input(dtype)
    _, jax_fn = _transform(jax_make, mode, option, x)
    want = jax_fn(JaxFrame([x])).tensors[0]
    el, fn = _transform(make_element, mode, option, x)
    got = fn(TensorFrame([torch.from_numpy(x.copy()) if route == "torch" else x])).tensors[0]
    assert isinstance(got, torch.Tensor) == (route == "torch")
    assert el.torch_applied == (route == "torch")
    got = host(got)
    assert got.dtype == want.dtype and got.shape == want.shape
    if route == "torch" and mode == "stand":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,option", MODES, ids=[f"{m}-{o}" for m, o in MODES])
def test_transform_declares_the_jax_spec(mode, option, dtype):
    from nnstreamer_tpu.core.types import StreamSpec as JaxSpec
    from nnstreamer_tpu.core.types import TensorSpec as JaxTensor
    from nnstreamer_tpu_torch.core.types import StreamSpec, TensorSpec

    shape = (2, 4, 5, 3)
    jel, _ = _transform(jax_make, mode, option, None)
    jel.set_sink_spec(0, JaxSpec((JaxTensor(shape, np.dtype(dtype)),)))
    el, _ = _transform(make_element, mode, option, None)
    el.set_sink_spec(0, StreamSpec((TensorSpec(shape, np.dtype(dtype)),)))
    (want,), (got,) = jel.derive_spec().tensors, el.derive_spec().tensors
    assert (got.shape, got.dtype) == (want.shape, want.dtype)


@pytest.mark.parametrize("dtype", ["uint8", "int32"])
def test_clamp_declares_the_input_dtype_but_gives_float64(dtype):
    """ROADMAP C7, pinned as the JAX package has it: clamp's spec keeps an
    integer input dtype while numpy's clip with float bounds (the numpy
    route, and the torch route that reproduces it) gives float64."""
    from nnstreamer_tpu_torch.core.types import StreamSpec, TensorSpec

    x = _input(dtype)
    for make, frame in ((jax_make, JaxFrame), (make_element, TensorFrame)):
        el, fn = _transform(make, "clamp", "0:1", x)
        assert fn(frame([x])).tensors[0].dtype == np.float64
    el.set_sink_spec(0, StreamSpec((TensorSpec(x.shape, x.dtype),)))
    assert el.derive_spec().tensors[0].dtype == np.dtype(dtype)
    assert host(fn(TensorFrame([torch.from_numpy(x)])).tensors[0]).dtype == np.float64


@pytest.mark.parametrize("route", ["numpy", "torch"])
def test_transform_apply_subset(route):
    a, b = _input("uint8", (4, 3)), _input("float32", (4, 3), seed=1)
    jel, jfn = _transform(jax_make, "arithmetic", "mul:2", None, apply="1")
    want = jfn(JaxFrame([a, b])).tensors
    _, fn = _transform(make_element, "arithmetic", "mul:2", None, apply="1")
    wrap = torch.from_numpy if route == "torch" else (lambda v: v)
    got = fn(TensorFrame([wrap(a), wrap(b)])).tensors
    for g, w in zip(got, want):
        assert host(g).dtype == w.dtype
        np.testing.assert_array_equal(host(g), w)


def test_transform_rejects_bad_mode_and_apply():
    for make, err in ((jax_make, JaxElementError), (make_element, ElementError)):
        with pytest.raises(err, match="unknown transform mode"):
            make("tensor_transform", mode="nope").start()
        with pytest.raises(err, match="apply indices must be >= 0"):
            make("tensor_transform", mode="typecast", option="float32", apply="-1").start()


def test_transform_without_a_torch_route_raises():
    """A dtype with no torch counterpart raises on a torch tensor: it does
    not fall back to numpy."""
    _, fn = _transform(make_element, "typecast", "uint16", None)
    assert fn(TensorFrame([np.ones(3, np.float32)])).tensors[0].dtype == np.uint16
    with pytest.raises(ElementError, match="no torch route for dtype uint16"):
        fn(TensorFrame([torch.ones(3)]))


def test_transform_keeps_torch_payloads_in_the_pipeline():
    pipe = run(parse_pipeline, "appsrc name=src ! tensor_transform name=t mode=arithmetic "
               "option=mul:2 ! tensor_sink name=out to-host=false",
               [(torch.ones(4), 0.0)])
    out = pipe["out"].frames[0].tensors[0]
    assert isinstance(out, torch.Tensor) and out.dtype == torch.float32
    assert out.tolist() == [2.0] * 4 and pipe["t"].torch_applied == 1


@pytest.mark.parametrize("text,x", [
    ("tensor_transform mode=typecast option=float32", np.array([1, 2], np.uint8)),
    ("tensor_transform mode=arithmetic option=typecast:float32,add:-127.5,div:127.5",
     np.array([0, 127.5, 255], np.float32)),
    ("tensor_transform mode=arithmetic option=add:1|10|100", np.zeros((2, 3), np.float32)),
    ("tensor_transform mode=stand option=default", np.array([1, 2, 3, 4], np.float32)),
    ("tensor_transform mode=clamp option=0:1", np.array([-5, 0.5, 7], np.float32)),
], ids=["typecast", "chain", "per-channel", "stand", "clamp"])
def test_transform_pipelines_match_jax(text, x):
    both(f"appsrc name=src ! {text} ! tensor_sink name=out", [(x, 0.0)])


# -- mux / demux / merge / split ------------------------------------------------


def test_mux_combines():
    (got, _), = both("appsrc name=a ! mux.  appsrc name=b ! mux.  "
                     "tensor_mux name=mux ! tensor_sink name=out",
                     {"a": [(np.int32([1]), 0.0)], "b": [(np.int32([2]), 0.0)]}).values()
    assert [int(t[0]) for t in got[0].tensors] == [1, 2]


def test_demux_tensorpick():
    out = both("appsrc name=src ! tensor_demux name=d tensorpick=1,0 "
               "d. ! tensor_sink name=o1  d. ! tensor_sink name=o2",
               [([np.int32([10]), np.int32([20])], None)], sinks=("o1", "o2"))
    assert int(out["o1"][0][0].tensors[0][0]) == 20
    assert int(out["o2"][0][0].tensors[0][0]) == 10


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_concat_dim(dtype):
    a, b = _input(dtype, (2, 3)), _input(dtype, (2, 2), seed=1)
    (got, _), = both("appsrc name=a ! m.  appsrc name=b ! m.  "
                     "tensor_merge name=m mode=linear option=0 ! tensor_sink name=out",
                     {"a": [(a, None)], "b": [(b, None)]}).values()
    assert got[0].tensors[0].shape == (2, 5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_split_sizes(dtype):
    x = _input(dtype, (5,))
    out = both("appsrc name=src ! tensor_split name=s tensorseg=3,2 option=0 "
               "s. ! tensor_sink name=o1  s. ! tensor_sink name=o2", [(x, None)],
               sinks=("o1", "o2"))
    np.testing.assert_array_equal(out["o1"][0][0].tensors[0], x[:3])
    np.testing.assert_array_equal(out["o2"][0][0].tensors[0], x[3:])


def test_split_tensorpick_range_checked():
    for make, err in ((jax_make, JaxElementError), (make_element, ElementError)):
        el = make("tensor_split", tensorseg="3,2", tensorpick="0,2")
        with pytest.raises(err, match=r"tensorpick \[2\] out of range for 2 segments"):
            el.start()


@pytest.mark.parametrize("dtype", DTYPES)
def test_merge_and_split_keep_torch_payloads(dtype):
    """Torch payloads are concatenated and sliced as torch tensors, equal
    to the numpy route's arrays."""
    a, b = _input(dtype, (2, 4, 3)), _input(dtype, (2, 4, 3), seed=1)
    merged = run(parse_pipeline, "appsrc name=a ! m.  appsrc name=b ! m.  tensor_merge name=m "
                 "option=1 ! tensor_sink name=out to-host=false",
                 {"a": [(torch.from_numpy(a), 0.0)], "b": [(torch.from_numpy(b), 0.0)]})
    got = merged["out"].frames[0].tensors[0]
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(host(got), np.concatenate([a, b], axis=1))
    split = run(parse_pipeline, "appsrc name=src ! tensor_split name=s tensorseg=1,3 option=1 "
                "s. ! tensor_sink name=o1 to-host=false  s. ! tensor_sink name=o2 to-host=false",
                [(torch.from_numpy(a), 0.0)])
    for sink, want in (("o1", a[:, :1]), ("o2", a[:, 1:])):
        t = split[sink].frames[0].tensors[0]
        assert isinstance(t, torch.Tensor)
        np.testing.assert_array_equal(host(t), want)


def test_mux_slowest_sync():
    (got, _), = both("appsrc name=a ! mux.  appsrc name=b ! mux.  "
                     "tensor_mux name=mux sync-mode=slowest ! tensor_sink name=out",
                     {"a": [(np.int32([i]), p) for i, p in enumerate([0.0, 0.1, 0.2])],
                      "b": [(np.int32([100]), 0.2)]}).values()
    assert int(got[0].tensors[0][0]) == 2


# -- tensor_aggregator ----------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_aggregator_concat_frames(dtype):
    xs = [np.full((1, 4, 4), i, dtype) for i in range(4)]
    (got, _), = both("appsrc name=src ! tensor_aggregator frames-out=2 frames-dim=2 ! "
                     "tensor_sink name=out", [(x, None) for x in xs]).values()
    assert len(got) == 2 and got[0].tensors[0].shape == (2, 4, 4)
    assert got[0].tensors[0][0, 0, 0] == 0 and got[0].tensors[0][1, 0, 0] == 1


def test_aggregator_overlapping_window():
    (got, _), = both("appsrc name=src ! tensor_aggregator frames-out=2 frames-flush=1 "
                     "frames-dim=1 ! tensor_sink name=out",
                     [(np.full((1, 2), i, np.float32), None) for i in range(3)]).values()
    assert len(got) == 2
    np.testing.assert_array_equal(got[1].tensors[0], [[1, 1], [2, 2]])


@pytest.mark.parametrize("concat", ["true", "false"])
def test_aggregator_keeps_torch_payloads(concat):
    xs = [_input("float32", (2, 3), seed=i) for i in range(4)]
    text = (f"appsrc name=src ! tensor_aggregator frames-in=2 frames-out=3 frames-flush=2 "
            f"frames-dim=1 concat={concat} ! tensor_sink name=out to-host=false")
    want = run(jax_parse, text, [(x, None) for x in xs])["out"].frames
    got = run(parse_pipeline, text, [(torch.from_numpy(x), None) for x in xs])["out"].frames
    assert all(isinstance(t, torch.Tensor) for f in got for t in f.tensors)
    assert_frames_equal(got, want)


# -- tensor_if --------------------------------------------------------------------


def test_if_average_gt_routes():
    (got, _), = both("appsrc name=src ! tensor_if compared-value=tensor_average_value "
                     "compared-value-option=0 supplied-value=0.5 operator=gt "
                     "then=passthrough else=skip ! tensor_sink name=out",
                     [(np.float32([0.9, 0.9]), None), (np.float32([0.1, 0.1]), None)]).values()
    assert len(got) == 1 and got[0].meta["tensor_if"] == "then"


def test_if_then_else_branches():
    out = both("appsrc name=src ! tensor_if name=i compared-value=a_value "
               "compared-value-option=0,0 supplied-value=5 operator=ge "
               "then=passthrough else=passthrough "
               "i. ! tensor_sink name=t  i. ! tensor_sink name=e",
               [(np.float32([7]), None), (np.float32([1]), None)], sinks=("t", "e"))
    assert len(out["t"][0]) == 1 and len(out["e"][0]) == 1
    assert float(out["t"][0][0].tensors[0][0]) == 7


def test_if_custom_predicate():
    jax_flow.register_if_custom("always_no", lambda f: 0.0)
    flow.register_if_custom("always_no", lambda f: 0.0)
    try:
        (got, _), = both("appsrc name=src ! tensor_if compared-value=custom "
                         "compared-value-option=always_no supplied-value=0.5 operator=gt "
                         "then=passthrough else=skip ! tensor_sink name=out",
                         [(np.float32([1.0]), None)]).values()
        assert got == []
    finally:
        jax_flow.unregister_if_custom("always_no")
        assert flow.unregister_if_custom("always_no")


def test_if_tensorpick_behavior():
    (got, _), = both("appsrc name=src ! tensor_if compared-value=tensor_average_value "
                     "compared-value-option=0 supplied-value=0 operator=ge "
                     "then=tensorpick then-option=1 else=skip ! tensor_sink name=out",
                     [([np.float32([1]), np.float32([42])], None)]).values()
    assert len(got[0].tensors) == 1 and float(got[0].tensors[0][0]) == 42


def test_if_fill_values_in_pipeline():
    (got, _), = both("appsrc name=src ! tensor_if compared-value=tensor_average_value "
                     "compared-value-option=0 operator=ge supplied-value=100 "
                     "then=fill_values then-option=255 else=passthrough ! tensor_sink name=out",
                     [(np.full((2, 2), 200, np.uint8), None),
                      (np.full((2, 2), 3, np.uint8), None)]).values()
    assert (got[0].tensors[0] == 255).all() and (got[1].tensors[0] == 3).all()


def _if_pair(**props):
    els = []
    for cls in (jax_flow.TensorIf, flow.TensorIf):
        el = cls("tif")
        for k, v in props.items():
            el.props[k.replace("_", "-")] = v
        el.srcpad(0)
        el.start()
        els.append(el)
    return els


def _if_run(els, arrays, wrap=lambda a: a):
    """One frame through the JAX and the port element; returns the port's
    output (None = skipped) after checking it equals the JAX one."""
    jo = els[0].handle_frame(0, JaxFrame(list(arrays)))
    to = els[1].handle_frame(0, TensorFrame([wrap(a) for a in arrays]))
    assert len(jo) == len(to)
    if not to:
        return None
    (jp, jf), (tp, tf) = jo[0], to[0]
    assert jp == tp and jf.meta["tensor_if"] == tf.meta["tensor_if"]
    assert_frames_equal([tf], [jf])
    return tf


OPERATORS = [
    ("eq", "5", 5.0, True), ("eq", "5", 4.0, False),
    ("ne", "5", 4.0, True), ("ne", "5", 5.0, False),
    ("gt", "5", 6.0, True), ("gt", "5", 5.0, False),
    ("ge", "5", 5.0, True), ("ge", "5", 4.9, False),
    ("lt", "5", 4.0, True), ("lt", "5", 5.0, False),
    ("le", "5", 5.0, True), ("le", "5", 5.1, False),
    ("range_inclusive", "2,5", 2.0, True), ("range_inclusive", "2,5", 5.0, True),
    ("range_inclusive", "2,5", 5.5, False), ("range_exclusive", "2,5", 2.0, False),
    ("range_exclusive", "2,5", 3.0, True), ("range_exclusive", "2,5", 5.0, False),
    ("not_in_range_inclusive", "2,5", 2.0, False), ("not_in_range_inclusive", "2,5", 1.0, True),
    ("not_in_range_exclusive", "2,5", 2.0, True), ("not_in_range_exclusive", "2,5", 3.0, False),
]


@pytest.mark.parametrize("op,supplied,value,expect", OPERATORS)
def test_if_operator_truth_table(op, supplied, value, expect):
    els = _if_pair(operator=op, supplied_value=supplied, then="passthrough", **{"else": "skip"})
    out = _if_run(els, [np.float64([value])])
    assert (out is not None) == expect


@pytest.mark.parametrize("route", ["numpy", "torch"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_if_compared_values(route, dtype):
    """Every compared-value mode gives the JAX decision on the same frame,
    on numpy arrays and on torch tensors."""
    wrap = torch.from_numpy if route == "torch" else (lambda a: a)
    a, b = _input(dtype, (3, 4)), _input(dtype, (2, 2), seed=1)
    cases = [
        ("a_value", "1:2,0", float(a[2, 1])),
        ("tensor_total_value", "1", float(b.astype(np.float64).sum())),
        ("tensor_average_value", "0", float(a.astype(np.float64).mean())),
        ("all_tensors_total_value", "", float(a.astype(np.float64).sum() + b.sum())),
        ("all_tensors_average_value", "0,1", float((a.astype(np.float64).sum() + b.sum()) / 16)),
    ]
    for mode, opt, value in cases:
        for supplied, expect in ((value - 0.5, True), (value + 0.5, False)):
            els = _if_pair(compared_value=mode, compared_value_option=opt, operator="gt",
                           supplied_value=str(supplied))
            out = _if_run(els, [a, b], wrap)
            assert (out is not None) == expect, (mode, supplied)
            if out is not None and route == "torch":
                assert all(isinstance(t, torch.Tensor) for t in out.tensors)


def test_if_custom_callback():
    fn = lambda f: int(np.asarray(f.tensors[0]).sum()) % 2 == 1  # noqa: E731
    jax_flow.register_if_custom("odd_sum", fn)
    flow.register_if_custom("odd_sum", fn)
    try:
        els = _if_pair(compared_value="custom", compared_value_option="odd_sum",
                       operator="eq", supplied_value="1")
        assert _if_run(els, [np.int32([1, 2])]) is not None
        assert _if_run(els, [np.int32([1, 3])]) is None
    finally:
        jax_flow.unregister_if_custom("odd_sum")
        flow.unregister_if_custom("odd_sum")


def _behaviour_frame(fill=7):
    return [np.full((2, 2), fill, np.int32), np.full((3,), fill, np.uint8)]


@pytest.mark.parametrize("route", ["numpy", "torch"])
@pytest.mark.parametrize("then,option", [
    ("fill_zero", ""), ("fill_values", "3,250"), ("fill_values", "9"),
    ("fill_with_file", "FILE:11,22"), ("fill_with_file_rpt", "FILE:1,2"), ("tensorpick", "1"),
], ids=["zero", "values", "broadcast", "file", "file-rpt", "tensorpick"])
def test_if_behaviors(route, then, option, tmp_path):
    if option.startswith("FILE:"):
        path = tmp_path / "fill.raw"
        vals = [int(v) for v in option[5:].split(",")]
        path.write_bytes(np.int32(vals).tobytes() if then == "fill_with_file" else bytes(vals))
        option = str(path)
    wrap = torch.from_numpy if route == "torch" else (lambda a: a)
    els = _if_pair(operator="gt", supplied_value="0", then=then, then_option=option)
    out = _if_run(els, _behaviour_frame(), wrap)
    assert all(isinstance(t, torch.Tensor) == (route == "torch") for t in out.tensors)
    if then == "fill_with_file":
        np.testing.assert_array_equal(host(out.tensors[0]).reshape(-1), [11, 22, 0, 0])
    if then == "fill_with_file_rpt":
        np.testing.assert_array_equal(host(out.tensors[1]), [1, 2, 1])


def test_if_repeat_previous_frame():
    els = _if_pair(operator="gt", supplied_value="0", then="repeat_previous_frame")
    assert (_if_run(els, _behaviour_frame(5)).tensors[0] == 0).all()  # first: zeros
    assert (_if_run(els, _behaviour_frame(6)).tensors[0] == 0).all()  # previous output
    for el in els:
        el.start()  # restart clears the per-pad cache
    assert (_if_run(els, _behaviour_frame(7)).tensors[0] == 0).all()
    els = _if_pair(operator="gt", supplied_value="10", then="passthrough",
                   **{"else": "repeat_previous_frame"})
    assert (_if_run(els, _behaviour_frame(20)).tensors[0] == 20).all()
    assert (_if_run(els, _behaviour_frame(1)).tensors[0] == 20).all()
    _if_run(els, _behaviour_frame(30))
    assert (_if_run(els, _behaviour_frame(2)).tensors[0] == 30).all()


def test_if_unknown_behavior_rejected_at_start():
    for cls in (jax_flow.TensorIf, flow.TensorIf):
        el = cls("bad")
        el.props["then"] = "explode"
        el.srcpad(0)
        with pytest.raises(Exception, match="unknown behavior"):
            el.start()


# -- tensor_crop ------------------------------------------------------------------


@pytest.mark.parametrize("route", ["numpy", "torch"])
def test_crop_regions(route):
    img = np.arange(64, dtype=np.uint8).reshape(8, 8)
    regions = np.int32([[1, 2, 3, 4], [0, 0, 2, 2], [7, 7, 5, 5], [9, 9, 1, 1]])
    text = ("appsrc name=raw ! c.  appsrc name=info ! c.  tensor_crop name=c ! "
            "tensor_sink name=out to-host=false")
    want = run(jax_parse, text, {"raw": [(img, 0.0)], "info": [(regions, 0.0)]})["out"].frames
    raw = torch.from_numpy(img) if route == "torch" else img
    got = run(parse_pipeline, text, {"raw": [(raw, 0.0)], "info": [(regions, 0.0)]})
    got = got["out"].frames
    assert_frames_equal(got, want, meta=("crop_regions",))
    assert len(got[0].tensors) == 3
    assert all(isinstance(t, torch.Tensor) == (route == "torch") for t in got[0].tensors)
    np.testing.assert_array_equal(host(got[0].tensors[0]), img[2:6, 1:4])
    np.testing.assert_array_equal(host(got[0].tensors[2]), img[7:8, 7:8])


# -- tensor_rate ------------------------------------------------------------------


def test_rate_downsample_drops():
    (got, _), = both("appsrc name=src ! tensor_rate framerate=10/1 throttle=true ! "
                     "tensor_sink name=out", [(np.int32([i]), i / 30) for i in range(30)]).values()
    assert 9 <= len(got) <= 11


def test_rate_upsample_duplicates():
    (got, _), = both("appsrc name=src ! tensor_rate framerate=20/1 throttle=false ! "
                     "tensor_sink name=out", [(np.int32([i]), i / 10) for i in range(10)]).values()
    assert len(got) >= 18


def _rate_pair(framerate, throttle=True):
    els = []
    for cls in (jax_flow.TensorRate, flow.TensorRate):
        el = cls("r")
        el.props["framerate"] = framerate
        el.props["throttle"] = throttle
        el.start()
        els.append(el)
    return els


def _counters(el):
    return (el.in_frames, el.out_frames, el.dropped, el.duplicated)


@pytest.mark.parametrize("framerate,throttle,pts,want", [
    ("1/1", True, [0.0, 0.5, 1.0, 1.5], (4, 2, 2, 0)),
    ("2/1", False, [0.0, 1.0, 2.0], (3, 5, 0, 2)),
], ids=["drop", "duplicate"])
def test_rate_counters(framerate, throttle, pts, want):
    els = _rate_pair(framerate, throttle)
    for p in pts:
        jo = els[0].handle_frame(0, JaxFrame([np.float32([1.0])], pts=p))
        to = els[1].handle_frame(0, TensorFrame([np.float32([1.0])], pts=p))
        assert [f.pts for _, f in to] == [f.pts for _, f in jo]
    assert _counters(els[1]) == _counters(els[0]) == want
    assert [els[1].get_property(k) for k in ("in", "out", "drop", "duplicate")] == \
        [want[0], want[1], want[2], want[3]]
    with pytest.raises(ElementError, match="read-only"):
        els[1].set_property("in", 3)
    els[1].start()
    assert _counters(els[1]) == (0, 0, 0, 0)


@pytest.mark.parametrize("qos", [True, False])
def test_rate_qos_raises_naming_the_roadmap(qos):
    """``qos`` (on by default in both packages) sheds frames up to a
    reported late pts plus its lateness, counted in drop and qos-dropped;
    with qos=false a report changes nothing.  Only the scheduler's
    reports are left to ROADMAP A4.3: in a pipeline nothing sheds yet."""
    assert flow.TensorRate("r").props["qos"] == jax_flow.TensorRate("r").props["qos"] is True
    els = _rate_pair("4/1")
    for el in els:
        el.props["qos"] = qos
        el.note_qos(0.5, 0.25)
        el.note_qos(0.25, 0.0)  # an earlier report never shortens the window
        el.note_qos(None, 5.0)
    for p in [0.0, 0.25, 0.5, 0.75, 1.0, 1.25]:
        jo = els[0].handle_frame(0, JaxFrame([np.float32([p])], pts=p))
        to = els[1].handle_frame(0, TensorFrame([np.float32([p])], pts=p))
        assert [f.pts for _, f in to] == [f.pts for _, f in jo]
    assert _counters(els[1]) == _counters(els[0]) == ((6, 2, 4, 0) if qos else (6, 6, 0, 0))
    assert els[1].get_property("qos-dropped") == els[0].get_property("qos-dropped") \
        == (4 if qos else 0)
    with pytest.raises(ElementError, match="read-only"):
        els[1].set_property("qos-dropped", 1)
    make_element("tensor_rate", framerate="10/1", qos="true").start()


# -- repo / sparse / debug --------------------------------------------------------


def test_repo_loop_roundtrip():
    got = {}
    for name, parse, reset in (("jax", jax_parse, jax_reset_repo),
                               ("torch", parse_pipeline, reset_repo)):
        reset()
        w = parse("appsrc name=src ! tensor_reposink slot-index=7")
        r = parse("tensor_reposrc slot-index=7 ! tensor_sink name=out")
        w.start()
        r.start()
        for i in range(3):
            w["src"].push(np.int32([i]))
        w["src"].end_of_stream()
        w.wait(timeout=10)
        r.wait(timeout=10)
        w.stop()
        r.stop()
        got[name] = [int(f.tensors[0][0]) for f in r["out"].frames]
    assert got["torch"] == got["jax"] == [0, 1, 2]


@pytest.mark.parametrize("dtype", DTYPES)
def test_sparse_roundtrip(dtype):
    dense = np.zeros((4, 4), dtype)
    dense[1, 2], dense[3, 3] = 5, 7
    text = "appsrc name=src ! tensor_sparse_enc ! tensor_sink name=out"
    (enc, jenc), = both(text, [(dense, None)]).values()
    assert enc[0].meta["sparse_specs"] == jenc[0].meta["sparse_specs"]
    (got, _), = both("appsrc name=src ! tensor_sparse_enc ! tensor_sparse_dec ! "
                     "tensor_sink name=out", [(dense, None)]).values()
    np.testing.assert_array_equal(got[0].tensors[0], dense)


def test_sparse_dec_without_meta_fails():
    for parse, err in ((jax_parse, JaxElementError), (parse_pipeline, ElementError)):
        with pytest.raises(err, match="sparse_specs"):
            run(parse, "appsrc name=src ! tensor_sparse_dec ! tensor_sink name=out",
                [(np.float32([1]), None)], timeout=10)


@pytest.mark.parametrize("method", ["off", "console-info"])
def test_debug_passthrough_and_counts(method):
    text = (f"appsrc name=src ! tensor_debug name=d output-method={method} ! "
            "tensor_sink name=out")
    pushes = [(np.float32([1]), None), (torch.tensor([2.0]), None)]
    pipe = run(parse_pipeline, text, pushes)
    assert [f.tensors[0].tolist() for f in pipe["out"].frames] == [[1.0], [2.0]]
    assert pipe["d"].seen == 2 == run(jax_parse, text, pushes[:1] * 2)["d"].seen


# -- leaky queue ------------------------------------------------------------------


def _leaky(parse, leaky, n=40):
    pipe = run(parse, "appsrc name=src max-buffers=64 ! "
               f"queue max-buffers=2 leaky={leaky} ! identity sleep=0.02 ! tensor_sink name=out",
               [(np.int32([i]), None) for i in range(n)], timeout=60)
    return [int(f.tensors[0][0]) for f in pipe["out"].frames]


@pytest.mark.parametrize("leaky", ["upstream", "downstream", "no"])
def test_leaky_queue(leaky):
    """upstream drops the newest frames, downstream the oldest; no leak
    keeps everything.  Which frames are lost depends on timing, so the
    port is held to the contract, not to the JAX run's exact list."""
    got = _leaky(parse_pipeline, leaky)
    assert got == sorted(got)
    if leaky == "no":
        assert got == list(range(40)) == _leaky(jax_parse, leaky)
    else:
        assert 0 < len(got) < 40
        assert got[0] == 0 if leaky == "upstream" else got[-1] == 39


def test_leaky_bad_mode_rejected():
    for parse in (jax_parse, parse_pipeline):
        pipe = parse("appsrc name=src ! queue leaky=sideways ! tensor_sink")
        with pytest.raises(Exception, match="leaky"):
            pipe.start()
        pipe.stop()
