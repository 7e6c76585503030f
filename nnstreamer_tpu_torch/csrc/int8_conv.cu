// int8_conv: implicit-GEMM int8 convolution, int8 x int8 -> int32 on the
// tensor cores, with the int8 path's rescale epilogue.
//
// Stands for nnstreamer_tpu/ops/quantize.py int8_conv with
// feature_group_count 1 and int8_dense (plain XLA, no Pallas kernel):
// lax.conv_general_dilated / dot_general on int8 operands with
// preferred_element_type int32, then (float32(acc) * (s_x * s_w)) cast to the
// output dtype.  A dense layer is this kernel with H = W = 1 and a 1 x 1
// kernel (rows = tokens), so per-sample and per-row scales coincide.
//
// The GEMM: M = N * Ho * Wo output pixels (NHWC order), Ngemm = O output
// channels, K = kh * kw * C.  A[m][k] is the input pixel under tap (i, j) of
// channel c for k = (i * kw + j) * C + c, zero outside the image (TensorFlow
// SAME padding, pad_top / pad_left before, the rest after); B[o][k] is the
// OHWI weight row o.  So both operands are read along k in memory order, and
// where C is a multiple of 16, 8 or 4 a run of k never leaves one tap:
// 16-, 8- or 4-byte loads.  Any K works (MobileNet-v2's stem has K = 27):
// the last tile is zero-filled.
//
// Bound by operations at the main path's shapes (1,979 TOP/s of dense int8
// against 3.35 TB/s; a 1 x 1 convolution of 96 -> 576 channels at 28 x 28 and
// batch 128 does 2 * 100 k * 576 * 96 = 11 G int8 operations on 17 MB), but
// this first kernel is simple, not fast: 64 x 64 output tiles, 4 warps of
// mma.sync.m16n8k32 each computing 32 x 32, one 32-deep k-slice in shared
// memory at a time, loaded by all threads through registers.  wgmma on s8,
// TMA and a pipelined ring are the redesign (ROADMAP).
//
// Numerics: the int32 accumulator is exact, so equal to XLA's whatever the
// summation order.  The epilogue rounds as the reference: rescale =
// __fmul_rn(s_x[n], s_w[o]), then __fmul_rn(float(acc), rescale), then a
// round-to-nearest-even cast.  Out code 3 writes the raw int32 accumulator.
#include <cstdint>

#include "common.cuh"
#include "int8_epilogue.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
// Shared rows of 32 k-bytes padded to 48: the fragment reads of 8 rows x 4
// words then fall on 32 distinct banks.
constexpr int kRow = kBK + 16;

struct Shape {
  int n, h, w, c, o, kh, kw, stride, ho, wo, pad_top, pad_left;
  int64_t m;  // n * ho * wo
  int k;      // kh * kw * c
};

// VEC bytes from global memory (VEC-aligned) into shared memory.
template <int VEC>
__device__ __forceinline__ void copy_vec(int8_t* dst, const int8_t* src) {
  if constexpr (VEC == 16) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
  } else {
    *dst = *src;
  }
}

template <int VEC>
__device__ __forceinline__ void zero_vec(int8_t* dst) {
  if constexpr (VEC == 16) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  } else if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(0, 0);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint32_t*>(dst) = 0;
  } else {
    *dst = 0;
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One block: output pixels [m0, m0 + 64) x channels [o0, o0 + 64).  Each
// thread fills 16 bytes of the A tile and 16 of the B tile per k-slice: row
// tid / 2, bytes (tid % 2) * 16 .. + 15, in pieces of VEC.
template <int VEC, typename OutT>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                 const int8_t* __restrict__ w, const float* __restrict__ sw,
                 OutT* __restrict__ out, Shape s) {
  __shared__ __align__(16) int8_t As[kBM * kRow];
  __shared__ __align__(16) int8_t Bs[kBN * kRow];
  const int tid = threadIdx.x;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * kBM;
  const int o0 = blockIdx.y * kBN;

  // this thread's A row: its output pixel's image and top-left input tap
  const int lrow = tid / 2, lk = (tid % 2) * 16;
  const int64_t m = m0 + lrow;
  const bool m_ok = m < s.m;
  int64_t img = 0;
  int hi0 = 0, wi0 = 0;
  if (m_ok) {
    const int64_t hw = static_cast<int64_t>(s.ho) * s.wo;
    img = m / hw;
    const int rem = static_cast<int>(m - img * hw);
    hi0 = (rem / s.wo) * s.stride - s.pad_top;
    wi0 = (rem % s.wo) * s.stride - s.pad_left;
  }
  const int8_t* ximg = x + img * s.h * s.w * s.c;
  const int orow = o0 + lrow;
  const bool o_ok = orow < s.o;
  const int8_t* wrow = w + static_cast<int64_t>(orow) * s.k;

  const int warp = tid / 32, lane = tid % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane / 4, t = lane % 4;
  int acc[2][4][4] = {};

  for (int k0 = 0; k0 < s.k; k0 += kBK) {
#pragma unroll
    for (int p = 0; p < 16; p += VEC) {
      const int k = k0 + lk + p;
      int8_t* adst = As + lrow * kRow + lk + p;
      bool loaded = false;
      if (m_ok && k < s.k) {
        const int c = k % s.c, tap = k / s.c;
        const int hi = hi0 + tap / s.kw, wi = wi0 + tap % s.kw;
        if (hi >= 0 && hi < s.h && wi >= 0 && wi < s.w) {
          copy_vec<VEC>(adst, ximg + (static_cast<int64_t>(hi) * s.w + wi) * s.c + c);
          loaded = true;
        }
      }
      if (!loaded) zero_vec<VEC>(adst);
      int8_t* bdst = Bs + lrow * kRow + lk + p;
      if (o_ok && k < s.k) {
        copy_vec<VEC>(bdst, wrow + k);
      } else {
        zero_vec<VEC>(bdst);
      }
    }
    __syncthreads();
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* r0 = As + (wm + mi * 16 + g) * kRow + t * 4;
      const int8_t* r8 = r0 + 8 * kRow;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(r8);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(r8 + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int8_t* col = Bs + (wn + ni * 8 + g) * kRow + t * 4;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(col);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(col + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  // epilogue: fragment element (mi, ni, e) is row wm + mi*16 + g (+8 for
  // e >= 2), channel wn + ni*8 + 2t + (e & 1)
  const int64_t hw = static_cast<int64_t>(s.ho) * s.wo;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t row = m0 + wm + mi * 16 + g + half * 8;
      if (row >= s.m) continue;
      const float sxr = sx[row / hw];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = o0 + wn + ni * 8 + 2 * t + e;
          if (o >= s.o) continue;
          out[row * s.o + o] = rescaled<OutT>(acc[mi][ni][half * 2 + e], sxr, sw[o]);
        }
      }
    }
  }
}

template <int VEC, typename OutT>
int launch(const void* x, const void* sx, const void* w, const void* sw, void* out,
           const Shape& s, cudaStream_t stream) {
  const int64_t mt = (s.m + kBM - 1) / kBM;
  const int64_t nt = (s.o + kBN - 1) / kBN;
  if (mt > 0x7fffffff || nt > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(mt), static_cast<unsigned>(nt));
  int8_conv_kernel<VEC, OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w), static_cast<const float*>(sw), static_cast<OutT*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int by_vec(const void* x, const void* sx, const void* w, const void* sw, void* out,
           const Shape& s, cudaStream_t stream) {
  const auto aligned = [&](int v) {
    return s.c % v == 0 && reinterpret_cast<uintptr_t>(x) % v == 0 &&
           reinterpret_cast<uintptr_t>(w) % v == 0;
  };
  if (aligned(16)) return launch<16, OutT>(x, sx, w, sw, out, s, stream);
  if (aligned(8)) return launch<8, OutT>(x, sx, w, sw, out, s, stream);
  if (aligned(4)) return launch<4, OutT>(x, sx, w, sw, out, s, stream);
  return launch<1, OutT>(x, sx, w, sw, out, s, stream);
}

}  // namespace

// x: (n, h, w, c) int8 NHWC; sx: (n,) float32; w: (o, kh, kw, c) int8 OHWI;
// sw: (o,) float32; out: (n, ho, wo, o) NHWC.  out_dtype: 0 = float32,
// 1 = float16, 2 = bfloat16, 3 = int32 (the accumulator, no epilogue).
// Returns the CUDA error of the launch (0 = launched).
NNS_EXPORT int nns_int8_conv(const void* x, const void* sx, const void* w, const void* sw,
                             void* out, int out_dtype, int n, int h, int wd, int c, int o,
                             int kh, int kw, int stride, int ho, int wo, int pad_top,
                             int pad_left, void* stream) {
  Shape s{n, h, wd, c, o, kh, kw, stride, ho, wo, pad_top, pad_left,
          static_cast<int64_t>(n) * ho * wo, kh * kw * c};
  if (s.m == 0 || o == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return by_vec<float>(x, sx, w, sw, out, s, st);
    case 1: return by_vec<__half>(x, sx, w, sw, out, s, st);
    case 2: return by_vec<__nv_bfloat16>(x, sx, w, sw, out, s, st);
    case 3: return by_vec<int32_t>(x, sx, w, sw, out, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
