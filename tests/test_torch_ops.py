"""Port parity: the CUDA-kernel ops' plain versions against the JAX ops.

``normalize_u8_plain`` and ``top1_plain`` are what the port's wrappers run
on CPU tensors and what ``chip_smoke.py`` holds the CUDA kernels against
on the card; here they are held against ``nnstreamer_tpu.ops`` on the CPU
(where the JAX ops take their jnp path, the Pallas kernels' reference).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.decoders.image_label import ImageLabeling as JaxImageLabeling
from nnstreamer_tpu.ops import normalize_u8 as jax_normalize_u8
from nnstreamer_tpu.ops.labeling import top1 as jax_top1
from nnstreamer_tpu_torch.core import buffer
from nnstreamer_tpu_torch.decoders.image_label import ImageLabeling
from nnstreamer_tpu_torch.ops import _build, labeling, normalize_u8, normalize_u8_plain, top1, top1_plain
from nnstreamer_tpu_torch.ops import preprocess, top1_packed, top1_packed_plain

torch.set_num_threads(2)

_BITS = {torch.float32: (torch.int32, np.int32), torch.bfloat16: (torch.int16, np.int16),
         torch.float16: (torch.int16, np.int16)}
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", [(2, 7, 9, 3), (1000,), (4099,), (1, 32, 32, 3)])
def test_normalize_u8_plain_matches_jax(shape, dtype):
    # XLA's CPU code may contract x*scale+bias into one FMA (one rounding
    # instead of two), so the tolerance is 1 ulp of the output type
    x = np.random.default_rng(len(shape)).integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(jax_normalize_u8(x, dtype=_JNP[dtype], use_pallas=True))
    got = normalize_u8_plain(torch.from_numpy(x), dtype=dtype)
    assert tuple(got.shape) == shape and got.dtype == dtype
    ibits, nbits = _BITS[dtype]
    ulps = got.view(ibits).numpy().astype(np.int64) - ref.view(nbits).astype(np.int64)
    assert np.abs(ulps).max() <= 1


def test_normalize_u8_plain_custom_scale_bias():
    x = np.arange(256, dtype=np.uint8)
    ref = np.asarray(jax_normalize_u8(x, scale=0.5, bias=3.0, dtype=jnp.float32))
    got = normalize_u8_plain(torch.from_numpy(x), 0.5, 3.0, torch.float32).numpy()
    np.testing.assert_array_equal(got, ref)  # exact: both products are exact here


def _logit_cases():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((9, 1001)).astype(np.float32)
    x[1, [5, 600, 999]] = 50.0  # ties: the first index wins
    x[2, :] = -np.inf  # all -inf: index 0
    x[3, [10, 20]] = np.nan  # NaN is the maximum: the first NaN wins
    x[4, 0] = np.nan
    x[5, :] = 3.0  # all tied
    x[6, 1000] = np.inf
    x[7, [3, 4]] = np.inf
    x[8, :] = np.nan
    return {
        "planted": x,
        "narrow": rng.standard_normal((5, 7)).astype(np.float32),
        "one_column": rng.standard_normal((3, 1)).astype(np.float32),
        "tied_rows": np.zeros((4, 130), np.float32),
    }


@pytest.mark.parametrize("case", sorted(_logit_cases()))
def test_top1_plain_matches_jax(case):
    x = _logit_cases()[case]
    ref_idx, ref_val = (np.asarray(a) for a in jax_top1(x))
    idx, val = top1_plain(torch.from_numpy(x))
    assert idx.dtype == torch.int32 and val.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    np.testing.assert_array_equal(val.numpy(), ref_val)  # NaN positions included


def test_top1_one_dim_matches_jax():
    x = np.random.default_rng(3).standard_normal(1001).astype(np.float32)
    x[[17, 400]] = 9.0
    ref_idx, ref_val = jax_top1(x)
    idx, val = top1(torch.from_numpy(x))
    assert idx.shape == () and int(idx) == int(ref_idx) == 17
    assert float(val) == float(ref_val)


@pytest.fixture
def no_kernel_build(monkeypatch):
    """Any attempt to build or load a CUDA kernel fails the test."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor must not reach the CUDA kernel")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def test_wrappers_take_the_plain_version_on_cpu(no_kernel_build):
    x = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 5, 5, 3), dtype=np.uint8))
    launches = (preprocess.LAUNCHES, labeling.LAUNCHES)
    assert torch.equal(normalize_u8(x), normalize_u8_plain(x))
    logits = torch.randn(4, 11, generator=torch.Generator().manual_seed(0))
    for a, b in zip(top1(logits), top1_plain(logits)):
        assert torch.equal(a, b)
    assert (preprocess.LAUNCHES, labeling.LAUNCHES) == launches


def test_wrappers_refuse_other_devices_and_bad_inputs(no_kernel_build):
    # a non-CPU tensor must reach a kernel or raise, never the plain version
    with pytest.raises(ValueError, match="unsupported device"):
        normalize_u8(torch.empty(4, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        top1(torch.empty(2, 3, device="meta"))
    with pytest.raises(TypeError):
        normalize_u8(torch.zeros(4))  # not uint8
    with pytest.raises(TypeError):
        normalize_u8(torch.zeros(4, dtype=torch.uint8), dtype=torch.int32)
    with pytest.raises(TypeError):
        top1(torch.zeros(2, 3, dtype=torch.float64))
    with pytest.raises(ValueError):
        top1(torch.zeros(2, 0))
    with pytest.raises(ValueError):
        top1(torch.zeros(2, 3, 4))


def _typed(x, dtype):
    """float32 numpy logits cast with numpy to `dtype`: (the numpy array
    JAX takes, the torch tensor holding the same bits)."""
    a = x.astype(_JNP[dtype])
    if dtype == torch.float32:
        return a, torch.from_numpy(a)
    return a, torch.from_numpy(a.view(np.int16)).view(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(_logit_cases()))
def test_top1_half_types_match_jax(case, dtype):
    # argmax in the input type, max cast to float32, as jax_top1 does
    a, x = _typed(_logit_cases()[case], dtype)
    ref_idx, ref_val = (np.asarray(r) for r in jax_top1(a))
    for idx, val in (top1_plain(x), top1(x)):
        assert idx.dtype == torch.int32 and val.dtype == torch.float32
        np.testing.assert_array_equal(idx.numpy(), ref_idx)
        np.testing.assert_array_equal(val.numpy(), ref_val)  # NaN positions included


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", sorted(_logit_cases()))
def test_top1_packed_matches_jax_device_fn(case, dtype):
    a, x = _typed(_logit_cases()[case], dtype)
    (ref,) = JaxImageLabeling().device_fn([a], platform="cpu")
    ref = np.asarray(ref)
    for got in (top1_packed_plain(x), top1_packed(x), ImageLabeling().device_fn([x])[0]):
        assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
        np.testing.assert_array_equal(got.numpy(), ref)  # exact, NaN positions included


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("view", ["narrow_columns", "odd_offset", "transposed"])
def test_top1_strided_rows_match_contiguous(view, dtype):
    rng = np.random.default_rng(5)
    wide = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32)).to(dtype)
    wide[2, [3, 17]] = 9.0  # a tie
    x = {"narrow_columns": wide[:, :37],  # row stride 40, 37 columns
         "odd_offset": wide.view(-1)[3:3 + 5 * 33].view(5, 33),  # storage offset 3
         "transposed": wide[:, :6].t()}[view]  # column stride 40: copied once
    dense = x.contiguous()
    for a, b in zip(top1(x), top1(dense)):
        assert torch.equal(a, b)
    assert torch.equal(top1_packed(x), top1_packed(dense))


@pytest.fixture
def fake_kernel(monkeypatch):
    """The wrapper's CUDA branch on CPU tensors, with the kernel library
    replaced by a recorder of the entry point's arguments."""
    calls = []

    class Lib:
        def nns_top1(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "load", lambda name, signatures: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 7})())
    return calls


def test_top1_launch_reads_views_in_place(fake_kernel, monkeypatch):
    monkeypatch.setattr(labeling, "LAUNCHES", labeling.LAUNCHES)  # restored after the test
    wide = torch.zeros(4, 1024, dtype=torch.bfloat16)
    launches = labeling.LAUNCHES
    x = wide[:, :1001]  # unit-stride columns: read in place with its row stride
    packed = torch.empty(4, 2)
    labeling._launch(x, packed=packed)
    (ptr, dtype, rows, cols, row_stride, idx, val, out, stream), = fake_kernel
    assert (ptr, dtype, rows, cols, row_stride) == (x.data_ptr(), 1, 4, 1001, 1024)
    assert (idx, val, out, stream) == (None, None, packed.data_ptr(), 7)
    odd = wide.view(-1)[3:3 + 2 * 1001].view(2, 1001)  # starts 3 elements in
    idx, val = torch.empty(2, dtype=torch.int32), torch.empty(2)
    labeling._launch(odd, idx=idx, val=val)
    assert fake_kernel[1][:5] == (odd.data_ptr(), 1, 2, 1001, 1001)
    assert fake_kernel[1][5:8] == (idx.data_ptr(), val.data_ptr(), None)
    labeling._launch(torch.zeros(8, 3).t(), packed=torch.empty(3, 2))  # columns not unit stride
    assert fake_kernel[2][2:5] == (3, 8, 8)  # a contiguous copy
    labeling._launch(torch.zeros(0, 5), packed=torch.empty(0, 2))  # no rows: no launch
    assert len(fake_kernel) == 3 and labeling.LAUNCHES == launches + 3


def test_top1_refusals_without_a_launch(no_kernel_build):
    launches = labeling.LAUNCHES
    for fn in (top1, top1_packed):
        with pytest.raises(TypeError):
            fn(torch.zeros(2, 3, dtype=torch.float64))
        with pytest.raises(ValueError, match="unsupported device"):
            fn(torch.empty(2, 3, device="meta"))
    # float32 holds every index exactly only below 2**24 columns (meta: nothing allocated)
    with pytest.raises(ValueError, match="0 < C < 16777216"):
        top1_packed(torch.empty(2, 2**24, device="meta"))
    with pytest.raises(ValueError, match="0 < C < 16777216"):
        top1_packed(torch.empty(2**24, dtype=torch.bfloat16, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        top1(torch.empty(2, 2**24, device="meta"))  # the split form holds any int32 index
    assert labeling.LAUNCHES == launches


def test_bf16_materializes_through_ml_dtypes(monkeypatch):
    x = torch.tensor([[1.5, -2.0, 3.0e38], [0.0, float("nan"), -1.0]]).to(torch.bfloat16)
    (host,) = buffer.materialize([x[:, 1:]])
    assert host.dtype == jnp.bfloat16 and host.shape == (2, 2)
    np.testing.assert_array_equal(host.astype(np.float32), x[:, 1:].float().numpy())
    monkeypatch.setattr(buffer, "BFLOAT16", None)
    with pytest.raises(TypeError, match="ml_dtypes"):
        buffer.materialize([x])
    (f32,) = buffer.materialize([x.float()])  # other types need no ml_dtypes
    assert f32.dtype == np.float32


def test_kernel_library_name_tracks_source_and_flags(monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    first = _build._lib_path("top1")
    assert first == _build._lib_path("top1") and first.parent == _build.BUILD_DIR
    assert first != _build._lib_path("normalize_u8")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._lib_path("top1") != first  # other flags: another library
