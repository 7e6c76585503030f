"""Port parity: the CUDA-kernel ops' plain versions against the JAX ops.

``normalize_u8_plain`` and ``top1_plain`` are what the port's wrappers run
on CPU tensors and what ``chip_smoke.py`` holds the CUDA kernels against
on the card; here they are held against ``nnstreamer_tpu.ops`` on the CPU
(where the JAX ops take their jnp path, the Pallas kernels' reference).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.ops import normalize_u8 as jax_normalize_u8
from nnstreamer_tpu.ops.labeling import top1 as jax_top1
from nnstreamer_tpu_torch.ops import _build, labeling, normalize_u8, normalize_u8_plain, top1, top1_plain
from nnstreamer_tpu_torch.ops import preprocess

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


def test_kernel_library_name_tracks_source_and_flags(monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    first = _build._lib_path("top1")
    assert first == _build._lib_path("top1") and first.parent == _build.BUILD_DIR
    assert first != _build._lib_path("normalize_u8")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._lib_path("top1") != first  # other flags: another library
