// int8_conv: int8 x int8 -> int32 products on the tensor cores, with the
// int8 path's rescale epilogue, by two routes.
//
// Stands for nnstreamer_tpu/ops/quantize.py int8_conv with
// feature_group_count 1 and int8_dense (plain XLA, no Pallas kernel):
// lax.conv_general_dilated / dot_general on int8 operands with
// preferred_element_type int32, then (float32(acc) * (s_x * s_w)) cast to the
// output dtype.
//
// The GEMM: M = N * Ho * Wo output pixels (NHWC order) or rows of a dense
// layer, Ngemm = O output channels, K = kh * kw * C.  B[o][k] is the OHWI
// weight row o.  Bound by operations at the main path's larger shapes
// (1,979 TOP/s of dense int8 against 3.35 TB/s: GPT-2 small's qkv over 8192
// tokens does 29 G int8 operations on 8 MB), by the bytes of the output at
// the narrow ones (a 1 x 1 convolution of 96 -> 576 channels at 14 x 14 and
// batch 128 writes 29 MB of bf16 for 5.5 G operations).  ops/quantize.py
// int8_conv_route picks the route from the shape and the operands' bases,
// before any launch; neither route falls back to the other.
//
// * GEMM route (nns_int8_gemm): the activation is a plain row-major [M, K]
//   int8 matrix: dense layers, and 1 x 1 stride-1 convolutions on NHWC
//   input (SAME padding is 0 there), with K % 16 == 0 and both bases 16-byte
//   aligned, as a TMA tensor map needs.  What bounded the first kernel was
//   how its operands reached the tensor cores: every thread loaded 32-deep
//   k-slices through registers, with two __syncthreads a slice and no
//   overlap of loads with products.  Here s8 wgmma (m64n128k32) reads both
//   operands K-major from 128-byte-swizzled shared tiles, which is already
//   the layout of A [M, K] and of the OHWI rows B [N, K], so nothing is
//   transposed; one producer warp keeps a ring of 4 stages of 128 k-bytes
//   full by TMA, completion through mbarriers, while two consumer
//   warpgroups each run 64 rows x 128 columns into int32 registers and
//   release a stage when its products are done.  Blocks are persistent and
//   walk 128 x 128 output tiles, so the next tile's loads overlap this
//   tile's epilogue.  The epilogue stages each warpgroup's outputs in shared
//   memory and writes whole 16-byte runs of a row: stored straight from the
//   fragments (4 bytes over 8 rows a warp instruction) they held the
//   output-bound shapes at half the library's speed.  TMA zero-fills past
//   the M, N and K edges: M = 1 (a decode slot), N = 24 or K = 16 need no
//   path of their own.
// * gather route (nns_int8_conv): the first kernel, unchanged, for k x k
//   kernels, strides 2 and unaligned K or bases: implicit GEMM, A[m][k] the
//   input pixel under tap (i, j) of channel c for k = (i * kw + j) * C + c,
//   zero outside the image (TensorFlow SAME padding, pad_top / pad_left
//   before, the rest after), so both operands are read along k in memory
//   order, and where C is a multiple of 16, 8 or 4 a run of k never leaves
//   one tap: 16-, 8- or 4-byte loads.  Any K works (MobileNet-v2's stem has
//   K = 27): the last tile is zero-filled.  64 x 64 output tiles, 4 warps of
//   mma.sync.m16n8k32 each computing 32 x 32, one 32-deep k-slice in shared
//   memory at a time, loaded by all threads through registers.  YOLOv5s's
//   3 x 3 layers run here; wgmma over gathered tiles is its redesign
//   (ROADMAP).
//
// Numerics: the int32 accumulator is exact, so equal to XLA's whatever the
// summation order, on both routes.  The epilogue rounds as the reference:
// rescale = __fmul_rn(s_x[n], s_w[o]), then __fmul_rn(float(acc), rescale),
// then a round-to-nearest-even cast.  Out code 3 writes the raw int32
// accumulator.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "int8_epilogue.cuh"
#include "sm90.cuh"

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


// ---------------------------------------------------------------------------
// GEMM route: s8 wgmma fed by TMA (sm_90a)
// ---------------------------------------------------------------------------

constexpr int kGemmBM = 128;                      // tile rows: two consumer warpgroups of 64
constexpr int kGemmBN = 128;                      // tile columns: one m64n128k32 wide
constexpr int kGemmBK = 128;                      // k-bytes a stage: one 128-byte swizzle atom
constexpr int kGemmStages = 4;
constexpr int kGemmConsumers = 256;               // warpgroups 0, 1 consume
constexpr int kGemmThreads = kGemmConsumers + 32;  // warp 8 produces
constexpr int kGemmTile = kGemmBM * kGemmBK;      // bytes of an A (and of a B) stage tile
constexpr int kGemmStage = 2 * kGemmTile;
static_assert(kGemmBM == kGemmBN, "A and B stage tiles share one size");
// The epilogue stages each warpgroup's 64 x 128 outputs in shared memory,
// rows padded by 16 bytes (the fragment's pair stores then fall on distinct
// banks), and writes them out as whole 16-byte runs of a row.
template <typename OutT>
struct GemmOut {
  static constexpr int kPitch = kGemmBN + 16 / sizeof(OutT);  // elements a staged row
  static constexpr int kBytes = 2 * 64 * kPitch * sizeof(OutT);  // both warpgroups
  static constexpr int kSmem = 1024 /* alignment slack */ + kGemmStages * kGemmStage + kBytes +
                               16 * kGemmStages /* barriers */;
};

struct GemmShape {
  int64_t m;               // rows of A and of the output
  int n, k;                // output columns; depth in bytes
  int64_t rows_per_scale;  // output rows sharing one activation scale (Ho * Wo, or 1)
  int m_tiles, k_tiles, items;
};

// one box of a 2-D (k, rows) tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int k0, int row0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0), "r"(row0)
      : "memory");
}

// d (64x128 s32) += A (64x32 s8, shared, K-major) * B (32x128 s8, shared, K-major)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1;\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db));
}

// the 128 threads of warpgroup-sized barrier `id` (0 is __syncthreads's)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// two neighbouring outputs in one store
template <typename T>
__device__ __forceinline__ void store_pair(T* p, T a, T b) {
  struct alignas(2 * sizeof(T)) Pair {
    T a, b;
  };
  *reinterpret_cast<Pair*>(p) = Pair{a, b};
}

// Persistent: block x walks output tiles x, x + gridDim.x, ... (tile i is
// row tile i % m_tiles of column tile i / m_tiles).  The producer warp runs
// ahead through the same sequence of (tile, k-stage) loads into the ring.
template <typename OutT>
__global__ void __launch_bounds__(kGemmThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap a_map,
                 const __grid_constant__ CUtensorMap b_map, const float* __restrict__ sx,
                 const float* __restrict__ sw, OutT* __restrict__ out, GemmShape s) {
  using Out = GemmOut<OutT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzled tiles: 1024-aligned
  const uint32_t staged = base + kGemmStages * kGemmStage;
  const uint32_t bars = staged + Out::kBytes;
  auto stage = [&](int st) { return base + st * kGemmStage; };  // A tile, then B tile
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kGemmStages + st); };

  if (threadIdx.x == 0) {
    for (int st = 0; st < kGemmStages; ++st) {
      mbar_init(full(st), 1);
      mbar_init(empty(st), kGemmConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kGemmConsumers) {  // producer: one lane keeps the ring full
    if (threadIdx.x == kGemmConsumers) {
      int it = 0;  // k-stages loaded by this block
      for (int item = blockIdx.x; item < s.items; item += gridDim.x) {
        const int row0 = (item % s.m_tiles) * kGemmBM, col0 = (item / s.m_tiles) * kGemmBN;
        for (int kt = 0; kt < s.k_tiles; ++kt, ++it) {
          const int st = it % kGemmStages;
          if (it >= kGemmStages) mbar_wait(empty(st), ((it / kGemmStages) - 1) & 1);
          mbar_expect_tx(full(st), kGemmStage);  // zero-filled bytes count too
          tma_load_2d(stage(st), &a_map, full(st), kt * kGemmBK, row0);
          tma_load_2d(stage(st) + kGemmTile, &b_map, full(st), kt * kGemmBK, col0);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4, wt = threadIdx.x % 128;
  OutT* c = reinterpret_cast<OutT*>(smem_raw + (staged - smem_u32(smem_raw))) + wg * 64 * Out::kPitch;
  constexpr int kVec = 16 / sizeof(OutT), kRowVecs = kGemmBN / kVec;
  const bool vec_rows = s.n * sizeof(OutT) % 16 == 0;  // every row of out starts 16-byte aligned
  int it = 0;
  for (int item = blockIdx.x; item < s.items; item += gridDim.x) {
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    int prev = 0;
    for (int kt = 0; kt < s.k_tiles; ++kt, ++it) {
      const int st = it % kGemmStages;
      mbar_wait(full(st), (it / kGemmStages) & 1);
      const uint32_t a = stage(st) + wg * 64 * kGemmBK, b = stage(st) + kGemmTile;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 32; ++kk)  // 32 k-bytes into the atom each
        wgmma_s8(acc, sw128_desc(a + kk * 32), sw128_desc(b + kk * 32));
      wg_commit();
      if (kt > 0) {  // the previous stage's products are done: release it
        wg_wait<1>();
        mbar_arrive(empty(prev));
      }
      prev = st;
    }
    wg_wait<0>();
    mbar_arrive(empty(prev));
    fence_acc(acc);

    // fragment element 4 nt + 2 r + e: row 16 w + g + 8 r, column 8 nt + 2 t4 + e
    const int64_t row0 = static_cast<int64_t>(item % s.m_tiles) * kGemmBM + 64 * wg;
    const int col0 = (item / s.m_tiles) * kGemmBN;
    named_sync(1 + wg);  // this warpgroup's previous tile has left the staging rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = 16 * w + g + 8 * r;
      const int64_t row = row0 + lr;
      const float sxr = row < s.m ? sx[row / s.rows_per_scale] : 0.0f;
#pragma unroll
      for (int nt = 0; nt < kGemmBN / 8; ++nt) {
        const int lc = 8 * nt + 2 * t4, col = col0 + lc;
        const float sw0 = col < s.n ? sw[col] : 0.0f, sw1 = col + 1 < s.n ? sw[col + 1] : 0.0f;
        store_pair(c + lr * Out::kPitch + lc, rescaled<OutT>(acc[4 * nt + 2 * r], sxr, sw0),
                   rescaled<OutT>(acc[4 * nt + 2 * r + 1], sxr, sw1));
      }
    }
    named_sync(1 + wg);
    for (int i = wt; i < 64 * kRowVecs; i += 128) {
      const int lr = i / kRowVecs, lc = (i % kRowVecs) * kVec;
      const int64_t row = row0 + lr;
      const int col = col0 + lc;
      if (row >= s.m || col >= s.n) continue;
      const OutT* src = c + lr * Out::kPitch + lc;
      OutT* dst = out + row * s.n + col;
      if (vec_rows && col + kVec <= s.n) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int j = 0; j < kVec && col + j < s.n; ++j) dst[j] = src[j];
      }
    }
  }
}

// A 2-D (k, rows) tensor map of a row-major [rows, k] int8 matrix: boxes of
// 128 k-bytes x 128 rows, 128-byte swizzled, zero fill past every edge
bool make_map_2d(CUtensorMap* map, const void* ptr, int64_t rows, int k) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kGemmBK, kGemmBM};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
int launch_gemm(const void* a, const void* sa, const void* b, const void* sb, void* out,
                const GemmShape& s, cudaStream_t stream) {
  CUtensorMap am, bm;
  if (!make_map_2d(&am, a, s.m, s.k) || !make_map_2d(&bm, b, s.n, s.k))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kSmem = GemmOut<OutT>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int8_gemm_kernel<OutT>,
                                                        kGemmThreads, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = std::min(s.items, sms * per_sm);
  int8_gemm_kernel<OutT><<<blocks, kGemmThreads, kSmem, stream>>>(
      am, bm, static_cast<const float*>(sa), static_cast<const float*>(sb),
      static_cast<OutT*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The gather route.  x: (n, h, w, c) int8 NHWC; sx: (n,) float32; w: (o, kh, kw, c) int8 OHWI;
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

// The GEMM route: out[i][j] = epilogue(sum_k a[i][k] * b[j][k]) for a: (m, k)
// int8 row-major, b: (n, k) int8 row-major (OHWI rows), sa: (ceil(m /
// rows_per_scale),) float32 (row i takes sa[i / rows_per_scale]), sb: (n,)
// float32, out: (m, n) row-major in out_dtype (codes as above).  k must be
// a multiple of 16 and a, b 16-byte aligned; m below 2^31.  Returns the
// CUDA error of the launch (0 = launched).
NNS_EXPORT int nns_int8_gemm(const void* a, const void* sa, const void* b, const void* sb,
                             void* out, int out_dtype, int64_t m, int n, int k,
                             int64_t rows_per_scale, void* stream) {
  if (m < 0 || m > 0x7fffffff || n < 0 || k <= 0 || k % 16 != 0 || rows_per_scale < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (m == 0 || n == 0) return 0;
  GemmShape s{m, n, k, rows_per_scale, static_cast<int>((m + kGemmBM - 1) / kGemmBM),
              (k + kGemmBK - 1) / kGemmBK, 0};
  const int64_t items = static_cast<int64_t>(s.m_tiles) * ((n + kGemmBN - 1) / kGemmBN);
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  s.items = static_cast<int>(items);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return launch_gemm<float>(a, sa, b, sb, out, s, st);
    case 1: return launch_gemm<__half>(a, sa, b, sb, out, s, st);
    case 2: return launch_gemm<__nv_bfloat16>(a, sa, b, sb, out, s, st);
    case 3: return launch_gemm<int32_t>(a, sa, b, sb, out, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
