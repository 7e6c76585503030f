// int8_dwconv: direct depthwise int8 convolution (groups == C == O), int32
// accumulation, with the int8 path's rescale epilogue.
//
// Stands for nnstreamer_tpu/ops/quantize.py int8_conv with
// feature_group_count == C (plain XLA, no Pallas kernel): the 3 x 3
// depthwise layers of MobileNet-v2 (17) and of SSD-MobileNet-v2's trunk.
//
// Bound by memory: each output reads kh * kw int8 inputs that its
// neighbours share (the L1 and L2 caches serve the re-reads) and does
// 2 * kh * kw integer operations, far under the card's 295 operations per
// byte, so the kernel only has to stream the NHWC input once and write the
// output once.  One thread computes 4 neighbouring channels of one output
// pixel (char4 loads where C % 4 == 0, else 1 channel), neighbouring threads
// on neighbouring channels, so each warp reads 128 contiguous bytes of a
// tap.  The (C, kh, kw) weights and scales are read through the read-only
// cache.
//
// Numerics: the accumulator is exact; the epilogue is the one of
// int8_conv.cu (rescale = s_x * s_w, then float(acc) * rescale, each
// rounded once, then a round-to-nearest-even cast); out code 3 writes the
// raw int32 accumulator.  Bit-exact against the plain version.
#include <cstdint>

#include "common.cuh"
#include "int8_epilogue.cuh"

namespace {

constexpr int kThreads = 256;

struct Shape {
  int n, h, w, c, kh, kw, stride, ho, wo, pad_top, pad_left;
};

// Thread idx: channel group idx % (C / VEC), then output pixel idx / (C / VEC)
// in NHWC order.
template <int VEC, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_dwconv_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                   const int8_t* __restrict__ w, const float* __restrict__ sw,
                   OutT* __restrict__ out, Shape s, int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const int groups = s.c / VEC;
  const int c0 = static_cast<int>(idx % groups) * VEC;
  const int64_t pix = idx / groups;
  const int wo = static_cast<int>(pix % s.wo);
  const int64_t t = pix / s.wo;
  const int ho = static_cast<int>(t % s.ho);
  const int64_t img = t / s.ho;
  const int hi0 = ho * s.stride - s.pad_top, wi0 = wo * s.stride - s.pad_left;
  const int taps = s.kh * s.kw;
  int acc[VEC] = {};
  for (int i = 0; i < s.kh; ++i) {
    const int hi = hi0 + i;
    if (hi < 0 || hi >= s.h) continue;
    for (int j = 0; j < s.kw; ++j) {
      const int wi = wi0 + j;
      if (wi < 0 || wi >= s.w) continue;
      const int8_t* px = x + ((img * s.h + hi) * s.w + wi) * s.c + c0;
      int8_t v[VEC];
      if constexpr (VEC == 4) {
        const char4 q = *reinterpret_cast<const char4*>(px);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
        v[0] = *px;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int8_t wv = __ldg(w + (c0 + e) * taps + i * s.kw + j);
        acc[e] += static_cast<int>(v[e]) * static_cast<int>(wv);
      }
    }
  }
  const float sxr = sx[img];
  OutT* dst = out + pix * s.c + c0;
#pragma unroll
  for (int e = 0; e < VEC; ++e) dst[e] = rescaled<OutT>(acc[e], sxr, __ldg(sw + c0 + e));
}

template <int VEC, typename OutT>
int launch(const void* x, const void* sx, const void* w, const void* sw, void* out,
           const Shape& s, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(s.n) * s.ho * s.wo * (s.c / VEC);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  int8_dwconv_kernel<VEC, OutT><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w), static_cast<const float*>(sw), static_cast<OutT*>(out), s,
      total);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int by_vec(const void* x, const void* sx, const void* w, const void* sw, void* out,
           const Shape& s, cudaStream_t stream) {
  if (s.c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0) {
    return launch<4, OutT>(x, sx, w, sw, out, s, stream);
  }
  return launch<1, OutT>(x, sx, w, sw, out, s, stream);
}

}  // namespace

// x: (n, h, w, c) int8 NHWC; sx: (n,) float32; w: (c, kh, kw, 1) int8;
// sw: (c,) float32; out: (n, ho, wo, c) NHWC; o must equal c.  out_dtype:
// 0 = float32, 1 = float16, 2 = bfloat16, 3 = int32 (the accumulator).
// The argument list is nns_int8_conv's.  Returns the CUDA error of the
// launch (0 = launched).
NNS_EXPORT int nns_int8_dwconv(const void* x, const void* sx, const void* w, const void* sw,
                               void* out, int out_dtype, int n, int h, int wd, int c, int o,
                               int kh, int kw, int stride, int ho, int wo, int pad_top,
                               int pad_left, void* stream) {
  if (o != c) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<int64_t>(n) * ho * wo * c == 0) return 0;
  Shape s{n, h, wd, c, kh, kw, stride, ho, wo, pad_top, pad_left};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return by_vec<float>(x, sx, w, sw, out, s, st);
    case 1: return by_vec<__half>(x, sx, w, sw, out, s, st);
    case 2: return by_vec<__nv_bfloat16>(x, sx, w, sw, out, s, st);
    case 3: return by_vec<int32_t>(x, sx, w, sw, out, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
