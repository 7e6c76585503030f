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
