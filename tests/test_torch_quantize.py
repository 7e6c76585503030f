"""Port parity: ``nnstreamer_tpu_torch.ops.quantize`` against the JAX
package's ``ops/quantize.py`` on the CPU.

Inputs are made from a numpy seed and handed to both.  The int8 values,
the float32 scales and the int32 accumulators must be bit-equal, and so
must the outputs in float32 and bfloat16: every float32 step of the port
is the IEEE operation the reference does, in the same order (measured
here: no ulp of difference on any case).  Layouts follow each package:
NHWC x HWIO in JAX, NCHW (channels_last) x OIHW in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.ops import quantize as jq
from nnstreamer_tpu_torch.ops import quantize as tq

torch.set_num_threads(2)

_JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as comparable integers (floats by their bits)."""
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}.get(t.dtype)
    return (t.view(view) if view is not None else t).numpy()


def _jax_bits(a, dtype: torch.dtype) -> np.ndarray:
    a = np.asarray(a)
    return _bits(torch.from_numpy(a.astype(np.float32)).to(dtype) if a.dtype != np.int8
                 and a.dtype != np.int32 else torch.from_numpy(a))


def _normal(rng, shape, dtype=torch.float32) -> np.ndarray:
    """Seeded normal values representable in `dtype`, as float32."""
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype).float().numpy()


def _nchw(x_nhwc: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).to(dtype).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


# -- quantize_symmetric --------------------------------------------------------

def _tie_rows() -> np.ndarray:
    """A row of zeros (the eps floor) and a row whose amax is 127, so the
    scale is exactly 1 and every x / scale ending in .5 is an exact tie."""
    ties = np.array([127.0, 0.5, 1.5, 2.5, -2.5, -0.5, 126.5, -3.5], np.float32)
    return np.stack([np.zeros(8, np.float32), ties, ties / 4])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["tensor", "row", "channel", "ties"])
def test_quantize_symmetric_bit_equal(case, dtype):
    rng = np.random.default_rng(1)
    x, axes = {
        "tensor": (_normal(rng, (4, 7, 5), dtype) * 3, None),
        "row": (_normal(rng, (6, 33), dtype), (1,)),
        "channel": (_normal(rng, (3, 3, 8, 16), dtype), (0, 1, 2)),  # HWIO per output channel
        "ties": (_tie_rows(), (1,)),
    }[case]
    qj, sj = jq.quantize_symmetric(jnp.asarray(x, _JAX_DTYPES[dtype]), axes)
    qt, st = tq.quantize_symmetric(torch.from_numpy(x).to(dtype), axes)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert tuple(st.shape) == np.asarray(sj).shape
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st), _jax_bits(sj, torch.float32))
    if case == "ties":
        assert st[0].item() == np.float32(1e-8) / np.float32(127)  # the eps floor
        np.testing.assert_array_equal(qt[1].numpy(), [127, 0, 2, 2, -2, -0, 126, -4])


def test_quantize_rows_and_weights_match_the_reference_layouts():
    rng = np.random.default_rng(2)
    x = _normal(rng, (5, 40))
    q, s = tq.quantize_rows(torch.from_numpy(x))
    qj, sj = jq.quantize_symmetric(jnp.asarray(x), (1,))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj).reshape(-1))
    # an HWIO kernel quantized per output channel is the port's OHWI rows
    w = _normal(rng, (3, 3, 4, 6))
    wq, ws = tq.quantize_weight(torch.from_numpy(w).permute(3, 2, 0, 1))
    wqj, wsj = jq.quantize_symmetric(jnp.asarray(w), (0, 1, 2))
    assert tuple(wq.shape) == (6, 3, 3, 4)
    np.testing.assert_array_equal(wq.numpy(), np.asarray(wqj).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(ws.numpy(), np.asarray(wsj).reshape(-1))
    # a dense (in, out) kernel per output column is the port's (out, in) rows
    d = _normal(rng, (12, 5))
    dq, ds = tq.quantize_weight(torch.from_numpy(d.T.copy()))
    dqj, dsj = jq.quantize_symmetric(jnp.asarray(d), (0,))
    np.testing.assert_array_equal(dq.numpy(), np.asarray(dqj).T)
    np.testing.assert_array_equal(ds.numpy(), np.asarray(dsj).reshape(-1))


# -- int8_conv -----------------------------------------------------------------

# (n, h, w, c, o, kernel, stride, groups): kernels 1, 3 and 6, strides 1 and
# 2, odd and even sizes, K = 27 (MobileNet-v2's stem), YOLOv5s's 6x6 stem,
# depthwise at both strides
CONVS = [
    (2, 9, 9, 3, 8, 3, 2, 1),
    (2, 8, 8, 3, 8, 3, 2, 1),
    (2, 10, 10, 3, 8, 6, 2, 1),
    (2, 7, 6, 12, 16, 1, 1, 1),
    (1, 5, 5, 8, 12, 3, 1, 1),
    (2, 9, 8, 16, 16, 3, 2, 16),
    (2, 7, 7, 24, 24, 3, 1, 24),
]


def _conv_case(case, dtype, seed):
    n, h, w, c, o, k, s, g = case
    rng = np.random.default_rng(seed)
    return _normal(rng, (n, h, w, c), dtype), _normal(rng, (k, k, c // g, o)), s, g


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CONVS, ids=lambda c: "x".join(map(str, c)))
def test_int8_conv_bit_equal(case, out):
    x, w, stride, groups = _conv_case(case, out, seed=sum(case))
    want = jq.int8_conv(jnp.asarray(x, _JAX_DTYPES[out]), jnp.asarray(w), (stride, stride),
                        "SAME", groups, _JAX_DTYPES[out])
    got = tq.int8_conv(_nchw(x, out), torch.from_numpy(w).permute(3, 2, 0, 1), stride, groups,
                       out)
    assert got.dtype == out and got.is_contiguous(memory_format=torch.channels_last)
    got = got.permute(0, 2, 3, 1).contiguous()
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got), _jax_bits(want, out))


@pytest.mark.parametrize("case", CONVS, ids=lambda c: "x".join(map(str, c)))
def test_int8_conv_accumulator_exact(case):
    """JAX's int32 accumulator of its own int8 operands against the port's
    helper on the same operands (``conv_i8_plain`` with an int32 output)."""
    x, w, stride, groups = _conv_case(case, torch.float32, seed=sum(case) + 1)
    xq, _ = jq.quantize_symmetric(jnp.asarray(x), (1, 2, 3))
    wq, _ = jq.quantize_symmetric(jnp.asarray(w), (0, 1, 2))
    want = jax.lax.conv_general_dilated(
        xq, wq, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=groups, preferred_element_type=jnp.int32)
    n, o = x.shape[0], w.shape[-1]
    got = tq.conv_i8_plain(torch.from_numpy(np.array(xq)), torch.ones(n),
                           torch.from_numpy(np.asarray(wq).transpose(3, 0, 1, 2).copy()),
                           torch.ones(o), stride, groups, torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_other_groups_run_plain_and_raise_off_the_cpu():
    """groups neither 1 nor C: the plain version computes it as JAX does;
    a tensor off the CPU raises before any launch."""
    x, w, _, _ = _conv_case((2, 6, 6, 8, 8, 3, 1, 2), torch.float32, seed=5)
    want = jq.int8_conv(jnp.asarray(x), jnp.asarray(w), (1, 1), "SAME", 2, jnp.float32)
    got = tq.int8_conv(_nchw(x, torch.float32), torch.from_numpy(w).permute(3, 2, 0, 1), 1, 2,
                       torch.float32)
    np.testing.assert_array_equal(_bits(got.permute(0, 2, 3, 1).contiguous()),
                                  _jax_bits(want, torch.float32))
    meta = dict(device="meta")
    xq = torch.empty(2, 6, 6, 8, dtype=torch.int8, **meta)
    sx, sw = torch.empty(2, **meta), torch.empty(8, **meta)
    grouped, whole = (torch.empty(8, 3, 3, c, dtype=torch.int8, **meta) for c in (4, 8))
    with pytest.raises(ValueError, match="groups 1 or groups == C == O"):
        tq.conv_i8(xq, sx, grouped, sw, 1, 2)
    with pytest.raises(TypeError, match="int8 operands"):
        tq.conv_i8(xq.float(), sx, whole, sw)
    with pytest.raises(ValueError, match="contiguous"):
        tq.conv_i8(xq.transpose(1, 2), sx, whole, sw)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tq.conv_i8(xq, sx, whole, sw)
    with pytest.raises(ValueError, match="channels_last"):
        tq.int8_conv(torch.empty(2, 8, 6, 6, **meta), torch.empty(8, 8, 3, 3, **meta))


# -- int8_dense ----------------------------------------------------------------

@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 32), (5, 32), (2, 3, 48), (1, 1, 27)],
                         ids=["M1", "2d", "3d", "K27"])
def test_int8_dense_bit_equal(shape, out):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    x, w = _normal(rng, shape, out), _normal(rng, (shape[-1], 10))
    want = jq.int8_dense(jnp.asarray(x, _JAX_DTYPES[out]), jnp.asarray(w), _JAX_DTYPES[out])
    got = tq.int8_dense(torch.from_numpy(x).to(out), torch.from_numpy(w.T.copy()), out)
    assert got.dtype == out and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bits(got), _jax_bits(want, out))
    # the accumulator: JAX's int8 operands through the port's helper
    xq, _ = jq.quantize_symmetric(jnp.asarray(x).reshape(-1, shape[-1]), (1,))
    wq, _ = jq.quantize_symmetric(jnp.asarray(w), (0,))
    acc = tq.dense_i8_plain(torch.from_numpy(np.array(xq)), torch.ones(xq.shape[0]),
                            torch.from_numpy(np.asarray(wq).T.copy()), torch.ones(10), torch.int32)
    want_acc = jax.lax.dot_general(xq, wq, (((1,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))


def test_quantize_rows_checks_before_any_launch():
    meta = torch.empty(4, 10, device="meta")
    with pytest.raises(ValueError, match="each row contiguous"):
        tq.quantize_rows(meta.T)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tq.quantize_rows(meta)
    with pytest.raises(TypeError, match="float32/float16/bfloat16"):
        tq.quantize_rows(torch.zeros(2, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="trailing axes"):
        tq.quantize_symmetric(torch.empty(3, 3, 4, 6, device="meta"), (0, 1, 2))


# -- the kernels' routes (chosen by shape before any launch) ------------------

_FULL_WIDTH = {  # family: (props, reckoned int8_conv launches per call by route)
    "mobilenet_v2": ({}, {"gemm": 32, "gather": 3, "depthwise": 17}),
    "ssd_mobilenet_v2": ({"classes": "91"}, {"gemm": 36, "gather": 7, "depthwise": 17}),
    "yolov5s": ({"size": "640", "classes": "80"}, {"gemm": 39, "gather": 18}),
    "vit": ({"size": "224", "patch": "16", "d_model": "768", "heads": "12", "layers": "12",
             "d_ff": "3072", "classes": "1001"}, {"gemm": 48}),
    "transformer": ({"vocab": "50257", "d_model": "768", "heads": "12", "layers": "12",
                     "d_ff": "3072", "seq": "1024"}, {"gemm": 48}),
}


@pytest.mark.parametrize("family", list(_FULL_WIDTH))
def test_int8_conv_route_at_every_layer_of_the_int8_families(family):
    """Every int8 layer of the five int8 builds at full width (built on the
    meta device: shapes only), routed by ``int8_conv_route`` with aligned
    operands as the fresh activations and weights are: MobileNet-v2 runs 32
    of its 35 groups-1 layers on the GEMM route (the stem, K = 27, and the
    two expansions of 24 channels gather), ViT-B/16 and GPT-2 small all 48."""
    from nnstreamer_tpu_torch.models import build
    from nnstreamer_tpu_torch.models._quant_flax import QuantConv2d, QuantLinear

    props, want = _FULL_WIDTH[family]
    with torch.device("meta"):
        module, _, _ = build(family, dict(props, dtype="float32", quantize="int8"))
    routes = {}
    for m in module.modules():
        if isinstance(m, QuantLinear):
            route = tq.int8_conv_route(m.in_features, 1, 1, 1, 0, 0)
        elif isinstance(m, QuantConv2d):
            route = "depthwise" if m.groups > 1 else tq.int8_conv_route(
                m.in_channels, *m.kernel_size, m.stride[0], 0, 0)
        else:
            continue
        routes[route] = routes.get(route, 0) + 1
    assert routes == want


@pytest.mark.parametrize("case,route", [
    ((16, 1, 1, 1, 0, 0), "gemm"),  # K = 16
    ((3072, 1, 1, 1, 4096, 512), "gemm"),  # K = 3072, aligned bases
    ((24, 1, 1, 1, 0, 0), "gather"),  # K % 16 = 8: no 16-byte global stride
    ((27, 1, 1, 1, 0, 0), "gather"),
    ((64, 3, 3, 1, 0, 0), "gather"),  # k x k: the activation is no [M, K] matrix
    ((64, 1, 1, 2, 0, 0), "gather"),  # 1 x 1 stride 2: neither
    ((64, 1, 1, 1, 8, 0), "gather"),  # activation 8 bytes off alignment
    ((64, 1, 1, 1, 0, 4), "gather"),  # weight 4 bytes off
], ids=["K16", "K3072", "K24", "K27", "3x3", "stride2", "x_off8", "w_off4"])
def test_int8_conv_route_edges(case, route):
    assert tq.int8_conv_route(*case) == route


def _waves(plan, rows, cols, itemsize):
    """The one-pass kernel's partition (``wave_slice`` in
    ``csrc/quantize_i8.cu``): per wave, each block's flat [c0, c1)."""
    vec = 16 // itemsize
    for r0 in range(0, rows, plan.rows_per_wave):
        e = min(plan.rows_per_wave, rows - r0) * cols
        chunk = -(-(-(-e // plan.grid)) // vec) * vec
        yield r0, [(min(e, b * chunk), min(e, b * chunk + chunk)) for b in range(plan.grid)], e


@pytest.mark.parametrize("rows,cols,itemsize", [
    (128, 112 * 112 * 96, 2),  # MobileNet-v2's largest activation, 128 frames
    (16, 320 * 320 * 32, 2),  # the largest on any path: YOLOv5s 640 after its stem
    (8192, 768, 2),  # GPT-2 small's tokens
    (1, 768, 4), (3, 16, 2), (1001, 1280, 4),  # one decode slot, tiny rows, weight rows
    (7, 48, 4),
], ids=["mobilenet", "yolov5s640", "gpt2", "slot", "tiny", "head_weight", "odd"])
def test_quantize_plan_waves_hold_whole_rows_once(rows, cols, itemsize):
    plan = tq.quantize_plan(rows, cols, itemsize, cols, 0, sms=132)
    assert plan.route == "one-pass" and 1 <= plan.grid <= 132 and plan.rows_per_wave >= 1
    covered = []
    for r0, slices, e in _waves(plan, rows, cols, itemsize):
        assert slices[0][0] == 0 and slices[-1][1] == e  # the wave's rows, whole
        assert all(a == b for (_, a), (b, _) in zip(slices, slices[1:]))  # in order, no overlap
        assert all((c1 - c0) * itemsize <= tq.QUANTIZE_BUF_BYTES for c0, c1 in slices)
        assert all(c0 * itemsize % 16 == 0 for c0, _ in slices)  # bulk copies 16-byte aligned
        covered += range(r0, r0 + e // cols)
    assert covered == list(range(rows))  # every row once
    if rows * cols * itemsize < 132 * tq.QUANTIZE_BLOCK_BYTES:
        assert plan.grid < 132  # a small input takes few blocks


def test_quantize_plan_takes_two_passes_where_one_cannot():
    wave = 132 * tq.QUANTIZE_BUF_BYTES
    assert tq.quantize_plan(1, wave // 2 + 8, 2, 0, 0, 132).route == "two-pass"  # longer than a wave
    assert tq.quantize_plan(1, wave // 2 - 8 * 132, 2, 0, 0, 132).route == "one-pass"
    # YOLOv5s 640's largest row fits in bf16, not in float32
    assert tq.quantize_plan(16, 320 * 320 * 32, 4, 320 * 320 * 32, 0, 132).route == "two-pass"
    for args in ((4, 40, 4, 40, 8), (4, 36, 2, 36, 0), (4, 40, 4, 41, 0), (1, 9, 4, 9, 0)):
        assert tq.quantize_plan(*args, 132).route == "two-pass", args  # unaligned


def test_new_routes_check_before_any_launch(monkeypatch):
    """Meta tensors and views the kernels cannot take raise before any
    library is built or loaded, on both routes of both kernels."""
    from nnstreamer_tpu_torch.ops import _build

    def no_load(*args):
        raise AssertionError("a kernel library was loaded")

    monkeypatch.setattr(_build, "load", no_load)
    meta = dict(device="meta")
    xq = torch.empty(65, 1, 1, 64, dtype=torch.int8, **meta)  # a GEMM-route shape
    wq = torch.empty(96, 1, 1, 64, dtype=torch.int8, **meta)
    sx, sw = torch.empty(65, **meta), torch.empty(96, **meta)
    strided = torch.empty(5, 64, 13, 1, dtype=torch.int8, **meta).permute(0, 3, 2, 1)
    for route, plan in (("gemm", "one-pass"), ("gather", "two-pass")):
        monkeypatch.setattr(tq, "int8_conv_route", lambda *args, r=route: r)
        monkeypatch.setattr(tq, "quantize_plan", lambda *args, r=plan: tq.QuantizePlan(r, 1, 1))
        with pytest.raises(ValueError, match="unsupported device meta"):
            tq.conv_i8(xq, sx, wq, sw)
        with pytest.raises(ValueError, match="unsupported device meta"):
            tq.dense_i8(xq.reshape(65, 64), sx, wq.reshape(96, 64), sw)
        with pytest.raises(ValueError, match="contiguous"):
            tq.conv_i8(strided, sx[:5], wq, sw)
        with pytest.raises(ValueError, match="unsupported device meta"):
            tq.quantize_rows(torch.empty(4, 64, **meta))
        with pytest.raises(ValueError, match="each row contiguous"):
            tq.quantize_rows(torch.empty(64, 4, **meta).T)


@pytest.mark.parametrize("m,k,n", [(1, 16, 24), (65, 64, 96), (3, 1280, 1001)],
                         ids=["M1_K16_N24", "M65", "N1001"])
def test_plain_versions_bit_equal_to_jax_at_gemm_route_edges(m, k, n):
    """``dense_i8_plain`` and ``conv_i8_plain`` (a 1 x 1 convolution) at the
    GEMM route's edge shapes against the JAX ops, bf16 out and the int32
    accumulator."""
    rng = np.random.default_rng(m + k + n)
    x, w = _normal(rng, (m, k), torch.bfloat16), _normal(rng, (k, n))
    want = jq.int8_dense(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.bfloat16)
    got = tq.int8_dense(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w.T.copy()),
                        torch.bfloat16)
    np.testing.assert_array_equal(_bits(got), _jax_bits(want, torch.bfloat16))
    conv = tq.int8_conv(_nchw(x.reshape(m, 1, 1, k), torch.bfloat16),
                        torch.from_numpy(w.T.copy()).reshape(n, k, 1, 1), 1, 1, torch.bfloat16)
    np.testing.assert_array_equal(_bits(conv.reshape(m, n)), _jax_bits(want, torch.bfloat16))
    xq, sx = tq.quantize_rows_plain(torch.from_numpy(x))
    wq, sw = tq.quantize_weight_plain(torch.from_numpy(w.T.copy()))
    acc = tq.dense_i8_plain(xq, sx, wq, sw, torch.int32)
    jx, _ = jq.quantize_symmetric(jnp.asarray(x), (1,))
    jw, _ = jq.quantize_symmetric(jnp.asarray(w), (0,))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jax.lax.dot_general(
        jx, jw, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)))
