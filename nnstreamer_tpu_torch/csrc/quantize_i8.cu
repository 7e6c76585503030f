// quantize_i8: symmetric int8 quantization with one scale per row of a
// (rows, cols) view.
//
// Stands for nnstreamer_tpu/ops/quantize.py quantize_symmetric (plain XLA,
// no Pallas kernel): the activations of every int8 layer (a row is one
// sample of a convolution's NHWC input, or one token of a dense layer) and
// the weights (a row is one output channel of the OHWI or (out, in) weight).
// Per row:  scale = max(amax, eps) / 127,  q = clip(rint(x / scale), -127, 127).
//
// Bound by memory: x is read twice (once for the abs-max, once to quantize)
// and the int8 values written once.  A row can be long: 112 x 112 x 96 =
// 1.2 M elements per sample after MobileNet-v2's first expansion at 224, so
// one block per row would leave most of the card idle at a small batch.  A
// grid of blocks per row works instead: pass 1 reduces each chunk's abs-max
// and folds it into the row's slot with atomicMax on the float's bits (a
// non-negative float orders like its bits as an unsigned int); pass 2
// re-reads the chunk and quantizes.  Loads are 16 bytes a thread where the
// row stride and the base allow it.
//
// Numerics: the division is IEEE float32 (no fast math: an approximate
// reciprocal would change the scale and the values), rintf rounds half to
// even as jnp.round and torch.round do, and bf16/fp16 inputs widen to
// float32 exactly.  The kernel is bit-exact against its plain version.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 8192;  // elements of one row per block

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC elements of T from 16 / (VEC * sizeof(T)) aligned memory.
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = widen(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "one 16-byte load");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = widen(e[i]);
  }
}

__device__ __forceinline__ float row_scale(const unsigned* amax_bits, int64_t row, float eps) {
  return fmaxf(__uint_as_float(amax_bits[row]), eps) / 127.0f;
}

// Pass 1: block b covers chunk b % chunks of row b / chunks.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, int64_t cols, int64_t row_stride, int64_t chunks,
              unsigned* __restrict__ amax_bits) {
  const int64_t row = blockIdx.x / chunks;
  const int64_t start = (blockIdx.x % chunks) * kChunk;
  const int64_t end = min(cols, start + kChunk);
  const T* base = x + row * row_stride;
  float m = 0.0f;
  for (int64_t i = start + static_cast<int64_t>(threadIdx.x) * VEC; i < end;
       i += static_cast<int64_t>(kThreads) * VEC) {
    float v[VEC];
    load<T, VEC>(base + i, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) m = fmaxf(m, fabsf(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(amax_bits + row, __float_as_uint(m));
  }
}

// Pass 2: the same blocks quantize their chunk; chunk 0 writes the scale.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int64_t cols, int64_t row_stride, int64_t chunks,
                const unsigned* __restrict__ amax_bits, float eps, int8_t* __restrict__ q,
                float* __restrict__ scales) {
  const int64_t row = blockIdx.x / chunks;
  const int64_t start = (blockIdx.x % chunks) * kChunk;
  const int64_t end = min(cols, start + kChunk);
  const float scale = row_scale(amax_bits, row, eps);
  if (start == 0 && threadIdx.x == 0) scales[row] = scale;
  const T* base = x + row * row_stride;
  int8_t* out = q + row * cols;
  for (int64_t i = start + static_cast<int64_t>(threadIdx.x) * VEC; i < end;
       i += static_cast<int64_t>(kThreads) * VEC) {
    float v[VEC];
    load<T, VEC>(base + i, v);
    int8_t r[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      r[k] = static_cast<int8_t>(fminf(fmaxf(rintf(v[k] / scale), -127.0f), 127.0f));
    }
    if constexpr (VEC == 4) {
      *reinterpret_cast<char4*>(out + i) = make_char4(r[0], r[1], r[2], r[3]);
    } else if constexpr (VEC == 8) {
      *reinterpret_cast<uint2*>(out + i) = *reinterpret_cast<const uint2*>(r);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) out[i + k] = r[k];
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, int64_t rows, int64_t cols, int64_t row_stride, int8_t* q,
           float* scales, unsigned* amax_bits, float eps, cudaStream_t s) {
  const int64_t chunks = (cols + kChunk - 1) / kChunk;
  const int64_t blocks = rows * chunks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaMemsetAsync(amax_bits, 0, rows * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* xt = static_cast<const T*>(x);
  absmax_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      xt, cols, row_stride, chunks, amax_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      xt, cols, row_stride, chunks, amax_bits, eps, q, scales);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte loads where every row starts 16-byte aligned and holds whole vectors.
template <typename T>
int dispatch(const void* x, int64_t rows, int64_t cols, int64_t row_stride, int8_t* q,
             float* scales, unsigned* amax_bits, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && cols % kVec == 0 &&
                       row_stride % kVec == 0;
  return aligned ? launch<T, kVec>(x, rows, cols, row_stride, q, scales, amax_bits, eps, s)
                 : launch<T, 1>(x, rows, cols, row_stride, q, scales, amax_bits, eps, s);
}

}  // namespace

// in_dtype: 0 = float32, 1 = float16, 2 = bfloat16.  x holds `rows` rows of
// `cols` contiguous elements, `row_stride` elements apart; q is (rows, cols)
// int8, scales (rows,) float32, scratch (rows,) 32-bit words (zeroed here).
// Returns the CUDA error of the launches (0 = launched).
NNS_EXPORT int nns_quantize_i8(const void* x, int in_dtype, int64_t rows, int64_t cols,
                               int64_t row_stride, void* q, void* scales, void* scratch,
                               float eps, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qi = static_cast<int8_t*>(q);
  auto* sc = static_cast<float*>(scales);
  auto* bits = static_cast<unsigned*>(scratch);
  switch (in_dtype) {
    case 0: return dispatch<float>(x, rows, cols, row_stride, qi, sc, bits, eps, s);
    case 1: return dispatch<__half>(x, rows, cols, row_stride, qi, sc, bits, eps, s);
    case 2: return dispatch<__nv_bfloat16>(x, rows, cols, row_stride, qi, sc, bits, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
