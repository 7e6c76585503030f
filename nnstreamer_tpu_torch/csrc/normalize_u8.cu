// normalize_u8: out = cast(float32(x) * scale + bias) for uint8 x of any length.
//
// Replaces the Pallas kernel nnstreamer_tpu/ops/preprocess.py _pallas_normalize
// (body _kernel), the MobileNet ingest transform (uint8 [0, 255] -> [-1, 1]).
//
// Bound by memory: it reads 1 byte and writes 2 (bf16/f16) or 4 (f32) per
// element and does 2 flops on them.  At the main path's (128, 224, 224, 3)
// batch that is 19.3 MB read + 38.5 MB written in bf16.  So each thread moves
// 16 bytes in (one uint4 load) and 16 outputs out (two or four uint4 stores),
// neighbouring threads on neighbouring addresses.  The Pallas kernel padded
// the array to (rows, 128) tiles in a copy; here the kernel masks the ragged
// ends itself: a scalar head up to the first 16-byte-aligned input byte
// (views may start anywhere) and a scalar tail for the last n % 16 elements.
// Where the output is not 16-byte aligned at the same element, the vector
// loads stay and the stores go element by element.
//
// Numerics: __fmul_rn/__fadd_rn are never contracted into an FMA, so the
// float32 value rounds twice, exactly as the plain PyTorch expression
// x.float() * scale + bias does; the cast is round-to-nearest-even, as
// Tensor.to() is.  The kernel is bit-exact against its plain version.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Output element type -> its bit pattern.
template <typename T> struct Out;
template <> struct Out<float> {
  using Bits = uint32_t;
  static __device__ __forceinline__ Bits bits(float v) { return __float_as_uint(v); }
};
template <> struct Out<__half> {
  using Bits = uint16_t;
  static __device__ __forceinline__ Bits bits(float v) { return __half_as_ushort(__float2half_rn(v)); }
};
template <> struct Out<__nv_bfloat16> {
  using Bits = uint16_t;
  static __device__ __forceinline__ Bits bits(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ float affine(uint32_t b, float scale, float bias) {
  return __fadd_rn(__fmul_rn(static_cast<float>(b), scale), bias);
}

// Threads [0, chunks) each convert 16 elements starting at head + 16 * t;
// the threads after them convert one element each: first the head
// [0, head), then the tail [head + 16 * chunks, n).
template <typename T>
__global__ void __launch_bounds__(kThreads)
normalize_u8_kernel(const uint8_t* __restrict__ x, typename Out<T>::Bits* __restrict__ out,
                    int64_t n, int64_t head, int64_t chunks, bool out_aligned,
                    float scale, float bias) {
  using Bits = typename Out<T>::Bits;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t < chunks) {
    const int64_t base = head + 16 * t;
    const uint4 in = *reinterpret_cast<const uint4*>(x + base);
    const uint32_t words[4] = {in.x, in.y, in.z, in.w};
    Bits v[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      v[i] = Out<T>::bits(affine((words[i / 4] >> (8 * (i % 4))) & 0xffu, scale, bias));
    }
    if (out_aligned) {
      constexpr int kWords = 16 * sizeof(Bits) / 4;
      uint32_t w[kWords];
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        if constexpr (sizeof(Bits) == 4) {
          w[k] = v[k];
        } else {  // little-endian: the lower address holds the low half
          w[k] = static_cast<uint32_t>(v[2 * k]) | (static_cast<uint32_t>(v[2 * k + 1]) << 16);
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(out + base);
#pragma unroll
      for (int k = 0; k < kWords / 4; ++k) {
        dst[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) out[base + i] = v[i];
    }
    return;
  }
  const int64_t s = t - chunks;
  const int64_t i = s < head ? s : head + 16 * chunks + (s - head);
  if (i < n) out[i] = Out<T>::bits(affine(x[i], scale, bias));
}

template <typename T>
int launch(const void* x, void* out, int64_t n, float scale, float bias, cudaStream_t stream) {
  using Bits = typename Out<T>::Bits;
  const auto xa = reinterpret_cast<uintptr_t>(x);
  int64_t head = static_cast<int64_t>((16 - xa % 16) % 16);
  if (head > n) head = n;
  const int64_t chunks = (n - head) / 16;
  const int64_t threads = chunks + (n - 16 * chunks);  // vector threads + scalar elements
  const bool out_aligned =
      (reinterpret_cast<uintptr_t>(out) + static_cast<uintptr_t>(head) * sizeof(Bits)) % 16 == 0;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  normalize_u8_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<Bits*>(out), n, head, chunks, out_aligned,
      scale, bias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out_dtype: 0 = float32, 1 = float16, 2 = bfloat16.  Returns the CUDA error
// of the launch (0 = launched).
NNS_EXPORT int nns_normalize_u8(const void* x, void* out, int64_t n, int out_dtype,
                                float scale, float bias, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch<float>(x, out, n, scale, bias, s);
    case 1: return launch<__half>(x, out, n, scale, bias, s);
    case 2: return launch<__nv_bfloat16>(x, out, n, scale, bias, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
