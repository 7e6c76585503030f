// int8_conv: int8 x int8 -> int32 products on Hopper's s8 tensor cores,
// with the int8 path's rescale epilogue, by two routes of one kernel.
//
// Stands for nnstreamer_tpu/ops/quantize.py int8_conv with
// feature_group_count 1 and int8_dense (plain XLA, no Pallas kernel):
// lax.conv_general_dilated / dot_general on int8 operands with
// preferred_element_type int32, then (float32(acc) * (s_x * s_w)) cast to the
// output dtype.
//
// The GEMM: M = N * Ho * Wo output pixels (NHWC order) or rows of a dense
// layer, Ngemm = O output channels, K = kh * kw * C.  B[o][k] is the OHWI
// weight row o; A[m][k] is the input pixel under tap (i, j) of channel c for
// k = (i * kw + j) * C + c, zero outside the image (TensorFlow SAME padding:
// pad_top / pad_left before, the rest after).  Bound by operations at the
// main path's deep shapes (1,979 TOP/s of dense int8 against 3.35 TB/s:
// GPT-2 small's qkv over 8192 tokens does 29 G int8 operations on 8 MB), by
// bytes at the wide, shallow ones (YOLOv5s's second convolution reads 419 MB
// and writes 419 MB of bf16 for 121 G operations).  ops/quantize.py
// int8_conv_plan picks the route, the tile width and the copy width from
// the shape and the operands' bases before any launch; neither route falls
// back to the other.
//
// One kernel, int8_mma_kernel: persistent blocks walk 128-row output tiles
// (the tile's column tiles first, so blocks that run together share their
// A rows in L2); a ring of stages of 128 k-bytes, completion and release
// through mbarriers; two consumer warpgroups each run s8 wgmma (m64nNk32,
// N = 32, 64 or 128 from O: narrow layers leave no half-empty tile) on
// 128-byte-swizzled K-major tiles into int32 registers, then stage their
// outputs in shared memory and write whole 16-byte runs of a row (stored
// from the fragments they held output-bound shapes at half the library's
// speed).  What differs is how the A tile is filled:
//
// * GEMM route (kTmaA): the activation is a plain row-major [M, K] matrix
//   (dense layers; 1 x 1 stride-1 convolutions with K % 16 == 0 and 16-byte
//   aligned bases), so one producer thread loads A and B by TMA, which
//   zero-fills past every edge.
// * gather route: an implicit GEMM for every other shape, A gathered by a
//   producer warpgroup.  kGather16 and kGatherN: thread p owns 16-byte
//   chunk p % 8 of rows p / 8 + 16u (u < 8), so a warp reads 4 rows x 128
//   contiguous k-bytes.  Each row's output pixel is decoded once a tile (one
//   division, then steps of 16 pixels); its k walks kernel rows, each a run
//   of kw * C contiguous bytes in NHWC, by steps with no division: a chunk
//   is valid where its kernel row is inside the image and its byte of the
//   run is between the first and last tap inside it.  With C % 16 == 0 and
//   16-byte aligned bases (kGather16) a chunk is one cp.async of 16 bytes
//   (src-size 0 fills the SAME padding and the M and K edges with zeros)
//   and B comes by TMA; otherwise (kGatherN: C = 24 or 40, bases 8 bytes
//   off) both come in copies of 8 or 4 bytes, or of 1 byte through
//   registers, at the same swizzled places.  A producer never waits for
//   its copies: cp.async.mbarrier.arrive.noinc arrives on the stage's
//   mbarrier once they land, and each consumer thread runs
//   fence.proxy.async after its wait, so that wgmma (the async proxy) sees
//   the bytes (the 1-byte path stores through registers, fences and
//   arrives itself).  kGatherRows, the stems (C = 3: copies of 1
//   byte, K <= 128, O in one tile): thread p stages row p's kernel-row runs
//   as the aligned 4-byte words around them (cp.async of 4 bytes) and
//   arrives through cp.async.mbarrier.arrive.noinc, never blocking; the
//   consumers, two threads a row, repack them 4 bytes a step (one funnel
//   shift a run) to k = i * S, S the run rounded up to 4 bytes, with B's k
//   laid out the same way (zeros between runs) and resident in shared
//   memory; then fence.proxy.async and a warpgroup barrier before wgmma.
//   Its 32-wide tiles take two blocks an SM.  Byte loads through registers
//   serialise on their latency: the parent kernel's stem of YOLOv5s took
//   7.3 ms at 128 frames, this path 1.5 (NVIDIA H100 80GB HBM3, 700.00 W).
//
// Numerics: the int32 accumulator is exact, so equal to XLA's whatever the
// summation order.  The epilogue rounds as the reference: rescale =
// __fmul_rn(s_x[n], s_w[o]), then __fmul_rn(float(acc), rescale), then a
// round-to-nearest-even cast.  Out code 3 writes the raw int32 accumulator.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "int8_epilogue.cuh"
#include "sm90.cuh"

namespace {

constexpr int kBM = 128;         // tile rows: two consumer warpgroups of 64
constexpr int kBK = 128;         // k-bytes a stage: one 128-byte swizzle atom
constexpr int kATile = kBM * kBK;
constexpr int kConsumers = 256;  // warpgroups 0, 1 consume
constexpr int kSmemLimit = 232448;  // shared memory a block may use on sm_90

enum Mode { kTmaA, kGather16, kGatherN, kGatherRows };

// kGatherRows: staging bytes of a tile row (41 words: rows fall on distinct
// banks), and of a stage's 128 rows (whole 1024-byte blocks: the next
// stage's swizzled A tile stays aligned)
constexpr int kRowSlot = 164;
constexpr int kRowStaging = (kBM * kRowSlot + 1023) / 1024 * 1024;

// kGatherRows lays kernel row i's run of kw * C bytes at k = i * S, S the
// run rounded up to 4 bytes (B's k the same way, zeros between runs), and
// takes a shape whose kh runs fit one stage, whose staged words fit a
// row's slot, and whose O fits one tile (its B tile then stays resident)
__host__ __device__ constexpr int run_stride(int kw, int c) { return (kw * c + 3) / 4 * 4; }
__host__ __device__ constexpr bool rows_fit(int kh, int kw, int c, int o, int tile_n) {
  return kh * run_stride(kw, c) <= kBK && o <= tile_n && kh * ((kw * c + 6) / 4) * 4 <= kRowSlot;
}

template <int kMode, int BN, typename OutT>
struct Cfg {
  static constexpr int kProducers = kMode == kTmaA ? 32 : 128;
  static constexpr int kThreads = kConsumers + kProducers;
  // the A tile, then the B tile (kGatherRows: the A rows' staging; its B
  // tile is resident after the ring)
  static constexpr int kStage = kATile + (kMode == kGatherRows ? kRowStaging : BN * kBK);
  static constexpr int kResident = kMode == kGatherRows ? BN * kBK : 0;
  // each warpgroup's 64 x BN outputs staged in shared memory, rows padded
  // by 16 bytes (the fragment's pair stores then fall on distinct banks)
  static constexpr int kPitch = BN + 16 / static_cast<int>(sizeof(OutT));
  static constexpr int kOutBytes = 2 * 64 * kPitch * static_cast<int>(sizeof(OutT));
  // narrow tiles (the 16-byte gather at 32 or 64 columns, the stems at 32)
  // take two blocks an SM, so that one block's consumers run their
  // epilogue (and repack) while the other's wait: shallow stages leave
  // them little else to overlap
  static constexpr int kBlocksPerSm =
      (kMode == kGather16 && BN <= 64) || (kMode == kGatherRows && BN == 32) ? 2 : 1;
  static constexpr int kStages = std::min(
      8, (kSmemLimit / kBlocksPerSm - 1024 - kOutBytes - kResident - 128) / kStage);
  static constexpr int kSmem = 1024 /* alignment slack */ + kStages * kStage + kResident +
                               kOutBytes + 16 * kStages /* barriers */;
};

struct MmaShape {
  int64_t m;               // rows of A and of the output
  int n, k;                // output columns; depth in bytes
  int64_t rows_per_scale;  // output rows sharing one activation scale (Ho * Wo, or 1)
  int m_tiles, n_tiles, k_tiles, items;
  // the gather route's convolution (NHWC input, OHWI weight)
  int h, w, c, kh, kw, stride, ho, wo, pad_top, pad_left;
  int vec;  // kGatherN: bytes a copy (8, 4 or 1)
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

// BYTES (16, 8 or 4) from global src to shared dst, or zeros where !valid
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(n)
                 : "memory");
  }
}
// this thread's earlier writes to shared memory made visible to the async proxy (wgmma)
// an arrival on bar once this thread's earlier cp.asyncs have landed (the
// barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t src) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(src) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_u32(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared_v4(uint32_t dst, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v[0]), "r"(v[1]),
               "r"(v[2]), "r"(v[3])
               : "memory");
}

#define D8(i)                                                                             \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), "+r"(d[i + 5]), \
      "+r"(d[i + 6]), "+r"(d[i + 7])

// d (64 x N s32) += A (64 x 32 s8, shared, K-major) * B (32 x N s8, shared, K-major)
__device__ __forceinline__ void wgmma_s8(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, 1;\n"
      : D8(0), D8(8)
      : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1;\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "l"(da), "l"(db));
}
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1;\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db));
}

#undef D8

// the 128 threads of warpgroup-sized barrier `id` (0 is __syncthreads's)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// two neighbouring outputs in one store
template <typename T>
__device__ __forceinline__ void store_pair(T* p, T a, T b) {
  struct alignas(2 * sizeof(T)) Pair {
    T a, b;
  };
  *reinterpret_cast<Pair*>(p) = Pair{a, b};
}

// The gather producers' rows of one output tile: thread p owns rows r0 +
// 16u of the tile.  Per row, the byte offset in x of its output pixel's
// top-left tap (hi0, wi0), hi0 itself (far out of range past the M edge),
// and [lo, hi): the bytes of a kernel row's run of kw * C whose taps fall
// inside the image.
struct GatherRows {
  int64_t off[8];
  int hi0[8], lo[8], hi[8];
};

__device__ __forceinline__ void gather_rows(GatherRows& g, const MmaShape& s, int64_t m0) {
  const uint32_t hw = static_cast<uint32_t>(s.ho) * s.wo;
  uint32_t m = static_cast<uint32_t>(m0);  // m < 2^31
  uint32_t img = m / hw;
  const uint32_t rem = m - img * hw;
  int oh = static_cast<int>(rem / s.wo), ow = static_cast<int>(rem % s.wo);
  const int64_t row_bytes = static_cast<int64_t>(s.w) * s.c;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int hi0 = oh * s.stride - s.pad_top, wi0 = ow * s.stride - s.pad_left;
    const bool ok = static_cast<int64_t>(m) + 16 * u < s.m;
    g.hi0[u] = ok ? hi0 : -(1 << 28);
    g.lo[u] = max(0, -wi0) * s.c;
    g.hi[u] = min(s.kw, s.w - wi0) * s.c;
    g.off[u] = ok ? (static_cast<int64_t>(img) * s.h + hi0) * row_bytes +
                        static_cast<int64_t>(wi0) * s.c
                  : 0;
    ow += 16;  // the next row of this thread: 16 output pixels on
    while (ow >= s.wo) {
      ow -= s.wo;
      if (++oh == s.ho) {
        oh = 0;
        ++img;
      }
    }
  }
}

// kGatherN: one stage's A and B chunks of this thread in copies of VEC bytes
// (8 or 4 by cp.async; 1 by byte loads through registers).  The chunk's
// first byte is byte kp of kernel row ki's run; C % VEC == 0 keeps every
// copy inside one tap.
template <int VEC, int BN>
__device__ __forceinline__ void gather_narrow(const GatherRows& g, const MmaShape& s,
                                              const int8_t* __restrict__ x,
                                              const int8_t* __restrict__ wt, uint32_t a_dst,
                                              uint32_t b_dst, int ki, int kp, int k0, int col0,
                                              int r0) {
  const int run = s.kw * s.c;
  const int64_t row_bytes = static_cast<int64_t>(s.w) * s.c;
  uint32_t av[8][4] = {}, bv[BN / 16][4] = {};
#pragma unroll
  for (int e = 0; e < 16; e += VEC) {
    const bool k_ok = ki < s.kh;
    const int64_t koff = static_cast<int64_t>(ki) * row_bytes + kp;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool ok = k_ok && static_cast<unsigned>(g.hi0[u] + ki) < static_cast<unsigned>(s.h) &&
                      kp >= g.lo[u] && kp < g.hi[u];
      const int8_t* src = ok ? x + g.off[u] + koff : x;
      if constexpr (VEC == 1) {
        if (ok) av[u][e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(*src)) << (8 * (e % 4));
      } else {
        cp_async<VEC>(a_dst + u * 16 * kBK + e, src, ok);
      }
    }
    const int k = k0 + e;  // B: byte k of weight rows col0 + r0 + 16v
#pragma unroll
    for (int v = 0; v < BN / 16; ++v) {
      const int o = col0 + r0 + 16 * v;
      const bool ok = o < s.n && k < s.k;
      const int8_t* src = ok ? wt + static_cast<int64_t>(o) * s.k + k : wt;
      if constexpr (VEC == 1) {
        if (ok) bv[v][e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(*src)) << (8 * (e % 4));
      } else {
        cp_async<VEC>(b_dst + v * 16 * kBK + e, src, ok);
      }
    }
    kp += VEC;
    if (kp >= run) {
      kp -= run;
      ++ki;
    }
  }
  if constexpr (VEC == 1) {
#pragma unroll
    for (int u = 0; u < 8; ++u) st_shared_v4(a_dst + u * 16 * kBK, av[u]);
#pragma unroll
    for (int v = 0; v < BN / 16; ++v) st_shared_v4(b_dst + v * 16 * kBK, bv[v]);
  }
}

// kGatherRows: one tile row's output pixel.  off: the byte offset in x of
// its top-left tap; [lo, hi): the bytes of a kernel row's run of kw * C
// whose taps fall inside the image.
struct RowTap {
  int64_t off = 0;
  int hi0 = 0, lo = 0, hi = 0;
  bool ok = false;  // a row of the output (not past the M edge)
};

__device__ __forceinline__ RowTap row_tap(const MmaShape& s, int64_t m) {
  RowTap t;
  if (m >= s.m) return t;
  const uint32_t hw = static_cast<uint32_t>(s.ho) * s.wo, mm = static_cast<uint32_t>(m);
  const uint32_t img = mm / hw, rem = mm - img * hw;
  const int oh = static_cast<int>(rem / s.wo), ow = static_cast<int>(rem % s.wo);
  const int wi0 = ow * s.stride - s.pad_left;
  t.hi0 = oh * s.stride - s.pad_top;
  t.lo = max(0, -wi0) * s.c;
  t.hi = min(s.kw, s.w - wi0) * s.c;
  t.off = (static_cast<int64_t>(img) * s.h + t.hi0) * s.w * s.c + static_cast<int64_t>(wi0) * s.c;
  t.ok = true;
  return t;
}

// kGatherRows: tile row r of one stage.  Staging: the aligned 4-byte words
// around each kernel row's bytes [lo, hi), slot i at i * wpr words (cp.async
// of aligned words: a run of kw * C bytes starts at any byte).  Repack: run
// i to k = i * S in the swizzled A tile, 4 bytes a step by a funnel shift
// of two staged words (one shift for the whole run), zeros where a tap is
// outside the image.  Bytes between runs and past kh * S are left as they
// are: B is zero there.
__device__ __forceinline__ void stage_row(const MmaShape& s, const int8_t* x, uint32_t slot,
                                          const RowTap& t) {
  if (!t.ok || t.lo >= t.hi) return;
  const int wpr = (s.kw * s.c + 6) / 4;
  const int64_t row_bytes = static_cast<int64_t>(s.w) * s.c;
  for (int i = 0; i < s.kh; ++i) {
    if (static_cast<unsigned>(t.hi0 + i) >= static_cast<unsigned>(s.h)) continue;
    const uintptr_t first = reinterpret_cast<uintptr_t>(x + t.off + i * row_bytes + t.lo);
    const uintptr_t w0 = first & ~static_cast<uintptr_t>(3);
    const int words = static_cast<int>(((first + (t.hi - t.lo) - 1) >> 2) - (w0 >> 2)) + 1;
    for (int j = 0; j < words; ++j)
      cp_async<4>(slot + (i * wpr + j) * 4, reinterpret_cast<const void*>(w0 + 4 * j), true);
  }
}

__device__ __forceinline__ void repack_row(const MmaShape& s, const int8_t* x, uint32_t slot,
                                           const RowTap& t, uint32_t a_row, int r, int first,
                                           int step) {
  const int run = s.kw * s.c, words = (run + 3) / 4, wpr = (run + 6) / 4;
  const int64_t row_bytes = static_cast<int64_t>(s.w) * s.c;
  const bool edge = t.lo > 0 || t.hi < run;
  for (int i = first; i < s.kh; i += step) {
    const bool ok = t.ok && t.lo < t.hi &&
                    static_cast<unsigned>(t.hi0 + i) < static_cast<unsigned>(s.h);
    // run byte p sits at staged byte e + p - lo
    const int e = static_cast<int>(reinterpret_cast<uintptr_t>(x + t.off + i * row_bytes + t.lo) & 3);
    const uint32_t src = slot + i * wpr * 4;
    const int k0 = i * run_stride(s.kw, s.c);
#pragma unroll 4
    for (int w = 0; w < words; ++w) {
      uint32_t v = 0;
      if (ok) {
        const int o = e + 4 * w - t.lo;  // may be negative at a left edge: masked below
        const uint32_t at = src + (o >> 2) * 4;
        v = __funnelshift_r(ld_shared_u32(at), ld_shared_u32(at + 4), 8 * (o & 3));
        if (edge) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int p = 4 * w + b;
            if (p < t.lo || p >= t.hi) v &= ~(0xffu << (8 * b));
          }
        }
      }
      const int k = k0 + 4 * w;
      st_shared_u32(a_row + (((k >> 4) ^ (r & 7)) << 4) + (k & 15), v);
    }
  }
}

// Persistent: block x walks output tiles x, x + gridDim.x, ... (tile i is
// column tile i % n_tiles of row tile i / n_tiles).  The producers run ahead
// through the same sequence of (tile, k-stage) loads into the ring.
template <int kMode, int BN, typename OutT>
__global__ void __launch_bounds__(Cfg<kMode, BN, OutT>::kThreads,
                                  Cfg<kMode, BN, OutT>::kBlocksPerSm)
int8_mma_kernel(const __grid_constant__ CUtensorMap a_map,
                const __grid_constant__ CUtensorMap b_map, const int8_t* __restrict__ x,
                const int8_t* __restrict__ wt, const float* __restrict__ sx,
                const float* __restrict__ sw, OutT* __restrict__ out, MmaShape s) {
  using C = Cfg<kMode, BN, OutT>;
  constexpr int kStages = C::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzled tiles: 1024-aligned
  const uint32_t resident = base + kStages * C::kStage;  // kGatherRows's B tile
  const uint32_t staged = resident + C::kResident;
  const uint32_t bars = staged + C::kOutBytes;
  auto stage = [&](int st) { return base + st * C::kStage; };
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (kStages + st); };

  if (threadIdx.x == 0) {
    // arrivals a stage needs: the TMA thread's, or every gather producer's
    // (plus the B load's expect_tx in kGather16)
    const int producers = kMode == kTmaA ? 1 : (kMode == kGather16 ? 129 : 128);
    static_assert(kMode != kGatherRows || C::kStage % 1024 == 0, "the resident B tile's alignment");
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), producers);
      mbar_init(empty(st), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    const int p = threadIdx.x - kConsumers;
    if constexpr (kMode == kTmaA) {  // one lane keeps the ring full by TMA
      if (p == 0) {
        int it = 0;  // k-stages loaded by this block
        for (int item = blockIdx.x; item < s.items; item += gridDim.x) {
          const int row0 = (item / s.n_tiles) * kBM, col0 = (item % s.n_tiles) * BN;
          for (int kt = 0; kt < s.k_tiles; ++kt, ++it) {
            const int st = it % kStages;
            if (it >= kStages) mbar_wait(empty(st), ((it / kStages) - 1) & 1);
            mbar_expect_tx(full(st), C::kStage);  // zero-filled bytes count too
            tma_load_2d(stage(st), &a_map, full(st), kt * kBK, row0);
            tma_load_2d(stage(st) + kATile, &b_map, full(st), kt * kBK, col0);
          }
        }
      }
    } else if constexpr (kMode == kGatherRows) {
      // thread p stages row p of every tile, one k-stage an item, and
      // arrives once its copies land; the consumers repack them
      int it = 0;
      for (int item = blockIdx.x; item < s.items; item += gridDim.x, ++it) {
        const int st = it % kStages;
        if (it >= kStages) mbar_wait(empty(st), ((it / kStages) - 1) & 1);
        stage_row(s, x, stage(st) + kATile + p * kRowSlot,
                  row_tap(s, static_cast<int64_t>(item) * kBM + p));
        cp_async_arrive(full(st));
      }
      cp_async_wait_all();
    } else {  // the producer warpgroup gathers A (and, in kGatherN, B)
      const int q = p % 8, r0 = p / 8;
      const uint32_t swz = r0 * kBK + ((q ^ (r0 & 7)) * 16);  // row r0's chunk q, swizzled
      const int run = s.kw * s.c;
      const int64_t row_bytes = static_cast<int64_t>(s.w) * s.c;
      GatherRows g;
      int it = 0;
      for (int item = blockIdx.x; item < s.items; item += gridDim.x) {
        const int col0 = (item % s.n_tiles) * BN;
        gather_rows(g, s, static_cast<int64_t>(item / s.n_tiles) * kBM + r0);
        int ki = (16 * q) / run, kp = 16 * q - ki * run;  // this chunk's kernel row and byte
        for (int kt = 0; kt < s.k_tiles; ++kt, ++it) {
          const int st = it % kStages;
          if (it >= kStages) mbar_wait(empty(st), ((it / kStages) - 1) & 1);
          const uint32_t a_dst = stage(st) + swz, b_dst = stage(st) + kATile + swz;
          if constexpr (kMode == kGather16) {
            if (p == 0) {
              mbar_expect_tx(full(st), BN * kBK);
              tma_load_2d(stage(st) + kATile, &b_map, full(st), kt * kBK, col0);
            }
            const bool k_ok = ki < s.kh;
            const int64_t koff = static_cast<int64_t>(ki) * row_bytes + kp;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const bool ok = k_ok &&
                              static_cast<unsigned>(g.hi0[u] + ki) < static_cast<unsigned>(s.h) &&
                              kp >= g.lo[u] && kp < g.hi[u];
              cp_async<16>(a_dst + u * 16 * kBK, ok ? x + g.off[u] + koff : x, ok);
            }
          } else {
            const int k0 = kt * kBK + 16 * q;
            if (s.vec == 8) {
              gather_narrow<8, BN>(g, s, x, wt, a_dst, b_dst, ki, kp, k0, col0, r0);
            } else if (s.vec == 4) {
              gather_narrow<4, BN>(g, s, x, wt, a_dst, b_dst, ki, kp, k0, col0, r0);
            } else {
              gather_narrow<1, BN>(g, s, x, wt, a_dst, b_dst, ki, kp, k0, col0, r0);
            }
          }
          if (kMode == kGatherN && s.vec == 1) {  // stored through registers: done
            fence_proxy_async();
            mbar_arrive(full(st));
          } else {  // an arrival once the copies land (the consumers fence)
            cp_async_arrive(full(st));
          }
          kp += kBK;  // the next stage: 128 bytes on along k
          while (kp >= run) {
            kp -= run;
            ++ki;
          }
        }
      }
      cp_async_wait_all();
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each tile
  const int wg = threadIdx.x / 128, w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4, wt_ = threadIdx.x % 128;
  OutT* c = reinterpret_cast<OutT*>(smem_raw + (staged - smem_u32(smem_raw))) + wg * 64 * C::kPitch;
  constexpr int kVec = 16 / sizeof(OutT), kRowVecs = BN / kVec;
  const bool vec_rows = s.n * sizeof(OutT) % 16 == 0;  // every row of out starts 16-byte aligned
  if constexpr (kMode == kGatherRows) {
    // the resident B tile: weight rows 0 .. O - 1 (O fits one tile), kernel
    // row i's run at k = i * S, zeros between runs and past kh * S
    const int run = s.kw * s.c, stride_k = run_stride(s.kw, s.c);
    for (int i = threadIdx.x; i < BN * 8; i += kConsumers) {
      const int o = i / 8, q = i % 8;
      uint32_t v[4] = {};
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int k = 16 * q + e, ki = k / stride_k, kp = k - ki * stride_k;
        if (o < s.n && ki < s.kh && kp < run)
          v[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(wt[o * s.k + ki * run + kp]))
                      << (8 * (e % 4));
      }
      st_shared_v4(resident + o * kBK + ((q ^ (o & 7)) * 16), v);
    }
    fence_proxy_async();
    asm volatile("bar.sync 3, %0;\n" ::"n"(kConsumers) : "memory");  // both warpgroups
  }
  int it = 0;
  for (int item = blockIdx.x; item < s.items; item += gridDim.x) {
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    int prev = 0;
    for (int kt = 0; kt < s.k_tiles; ++kt, ++it) {
      const int st = it % kStages;
      mbar_wait(full(st), (it / kStages) & 1);
      // bytes the producers' cp.asyncs wrote (the generic proxy), made
      // visible to wgmma (the async proxy)
      if constexpr (kMode == kGather16 || kMode == kGatherN) fence_proxy_async();
      const uint32_t a = stage(st) + wg * 64 * kBK;
      const uint32_t b = kMode == kGatherRows ? resident : stage(st) + kATile;
      if constexpr (kMode == kGatherRows) {  // two threads a row, alternate kernel rows
        const int r = 64 * wg + wt_ % 64;
        repack_row(s, x, stage(st) + kATile + r * kRowSlot,
                   row_tap(s, static_cast<int64_t>(item) * kBM + r), stage(st) + r * kBK, r,
                   wt_ / 64, 2);
        fence_proxy_async();  // this thread's A bytes, visible to wgmma
        named_sync(1 + wg);
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)  // 32 k-bytes into the atom each
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
    const int64_t row0 = static_cast<int64_t>(item / s.n_tiles) * kBM + 64 * wg;
    const int col0 = (item % s.n_tiles) * BN;
    named_sync(1 + wg);  // this warpgroup's previous tile has left the staging rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lr = 16 * w + g + 8 * r;
      const int64_t row = row0 + lr;
      const float sxr =  // row < m < 2^31: a 32-bit division
          row < s.m ? sx[static_cast<uint32_t>(row) / static_cast<uint32_t>(s.rows_per_scale)]
                    : 0.0f;
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int lc = 8 * nt + 2 * t4, col = col0 + lc;
        const float sw0 = col < s.n ? sw[col] : 0.0f, sw1 = col + 1 < s.n ? sw[col + 1] : 0.0f;
        store_pair(c + lr * C::kPitch + lc, rescaled<OutT>(acc[4 * nt + 2 * r], sxr, sw0),
                   rescaled<OutT>(acc[4 * nt + 2 * r + 1], sxr, sw1));
      }
    }
    named_sync(1 + wg);
    for (int i = wt_; i < 64 * kRowVecs; i += 128) {
      const int lr = i / kRowVecs, lc = (i % kRowVecs) * kVec;
      const int64_t row = row0 + lr;
      const int col = col0 + lc;
      if (row >= s.m || col >= s.n) continue;
      const OutT* src = c + lr * C::kPitch + lc;
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
// 128 k-bytes x box_rows rows, 128-byte swizzled, zero fill past every edge
bool make_map_2d(CUtensorMap* map, const void* ptr, int64_t rows, int k, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(k)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kMode, int BN, typename OutT>
int launch(const CUtensorMap& am, const CUtensorMap& bm, const void* x, const void* w,
           const void* sx, const void* sw, void* out, const MmaShape& s, cudaStream_t stream) {
  using C = Cfg<kMode, BN, OutT>;
  const auto kernel = int8_mma_kernel<kMode, BN, OutT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::kThreads, C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = std::min(s.items, sms * per_sm);
  int8_mma_kernel<kMode, BN, OutT><<<blocks, C::kThreads, C::kSmem, stream>>>(
      am, bm, static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw), static_cast<OutT*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

template <int kMode, typename OutT>
int by_tile(int tile_n, const CUtensorMap& am, const CUtensorMap& bm, const void* x,
            const void* w, const void* sx, const void* sw, void* out, const MmaShape& s,
            cudaStream_t stream) {
  switch (tile_n) {
    case 32: return launch<kMode, 32, OutT>(am, bm, x, w, sx, sw, out, s, stream);
    case 64: return launch<kMode, 64, OutT>(am, bm, x, w, sx, sw, out, s, stream);
    default: return launch<kMode, 128, OutT>(am, bm, x, w, sx, sw, out, s, stream);
  }
}

template <int kMode>
int by_out(int out_dtype, int tile_n, const CUtensorMap& am, const CUtensorMap& bm,
           const void* x, const void* w, const void* sx, const void* sw, void* out,
           const MmaShape& s, cudaStream_t stream) {
  switch (out_dtype) {
    case 0: return by_tile<kMode, float>(tile_n, am, bm, x, w, sx, sw, out, s, stream);
    case 1: return by_tile<kMode, __half>(tile_n, am, bm, x, w, sx, sw, out, s, stream);
    case 2: return by_tile<kMode, __nv_bfloat16>(tile_n, am, bm, x, w, sx, sw, out, s, stream);
    case 3: return by_tile<kMode, int32_t>(tile_n, am, bm, x, w, sx, sw, out, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// tiles of the shape; false where a count leaves int range
bool tile(MmaShape& s, int tile_n) {
  if (s.m > 0x7fffffff) return false;
  s.m_tiles = static_cast<int>((s.m + kBM - 1) / kBM);
  s.n_tiles = (s.n + tile_n - 1) / tile_n;
  s.k_tiles = (s.k + kBK - 1) / kBK;
  const int64_t items = static_cast<int64_t>(s.m_tiles) * s.n_tiles;
  s.items = static_cast<int>(items);
  return items <= 0x7fffffff;
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// The gather route.  x: (n, h, w, c) int8 NHWC; sx: (n,) float32; w: (o, kh, kw, c) int8 OHWI;
// sw: (o,) float32; out: (n, ho, wo, o) NHWC.  out_dtype: 0 = float32,
// 1 = float16, 2 = bfloat16, 3 = int32 (the accumulator, no epilogue).
// tile_n: output channels a tile (32, 64 or 128); chunk: bytes a copy (16:
// A by 16-byte cp.async and B by TMA; 8, 4 or 1), which must divide c and
// both bases' alignment; staged (chunk 1 only, where rows_fit): kGatherRows
// instead of byte loads.  The plan is ops/quantize.py int8_conv_plan's.
// Returns the CUDA error of the launch (0 = launched).
NNS_EXPORT int nns_int8_conv(const void* x, const void* sx, const void* w, const void* sw,
                             void* out, int out_dtype, int n, int h, int wd, int c, int o,
                             int kh, int kw, int stride, int ho, int wo, int pad_top,
                             int pad_left, int tile_n, int chunk, int staged, void* stream) {
  if ((tile_n != 32 && tile_n != 64 && tile_n != 128) ||
      (chunk != 16 && chunk != 8 && chunk != 4 && chunk != 1) || c % chunk != 0 ||
      (staged && (chunk != 1 || !rows_fit(kh, kw, c, o, tile_n))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(x, chunk) || !aligned(w, chunk)) return static_cast<int>(cudaErrorMisalignedAddress);
  MmaShape s{};
  s.m = static_cast<int64_t>(n) * ho * wo;
  s.n = o;
  s.k = kh * kw * c;
  s.rows_per_scale = static_cast<int64_t>(ho) * wo;
  s.h = h, s.w = wd, s.c = c, s.kh = kh, s.kw = kw, s.stride = stride, s.ho = ho, s.wo = wo;
  s.pad_top = pad_top, s.pad_left = pad_left, s.vec = chunk;
  if (s.m == 0 || o == 0) return 0;
  if (!tile(s, tile_n)) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap am{}, bm{};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk == 16) {
    if (!make_map_2d(&bm, w, o, s.k, tile_n)) return static_cast<int>(cudaErrorInvalidValue);
    return by_out<kGather16>(out_dtype, tile_n, am, bm, x, w, sx, sw, out, s, st);
  }
  if (staged)
    return by_out<kGatherRows>(out_dtype, tile_n, am, bm, x, w, sx, sw, out, s, st);
  return by_out<kGatherN>(out_dtype, tile_n, am, bm, x, w, sx, sw, out, s, st);
}

// The GEMM route: out[i][j] = epilogue(sum_k a[i][k] * b[j][k]) for a: (m, k)
// int8 row-major, b: (n, k) int8 row-major (OHWI rows), sa: (ceil(m /
// rows_per_scale),) float32 (row i takes sa[i / rows_per_scale]), sb: (n,)
// float32, out: (m, n) row-major in out_dtype (codes as above), tile_n as
// above.  k must be a multiple of 16 and a, b 16-byte aligned; m below 2^31.
// Returns the CUDA error of the launch (0 = launched).
NNS_EXPORT int nns_int8_gemm(const void* a, const void* sa, const void* b, const void* sb,
                             void* out, int out_dtype, int64_t m, int n, int k,
                             int64_t rows_per_scale, int tile_n, void* stream) {
  if (m < 0 || n < 0 || k <= 0 || k % 16 != 0 || rows_per_scale < 1 ||
      (tile_n != 32 && tile_n != 64 && tile_n != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(a, 16) || !aligned(b, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (m == 0 || n == 0) return 0;
  MmaShape s{};
  s.m = m, s.n = n, s.k = k, s.rows_per_scale = rows_per_scale;
  if (!tile(s, tile_n)) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap am, bm;
  if (!make_map_2d(&am, a, m, k, kBM) || !make_map_2d(&bm, b, n, k, tile_n))
    return static_cast<int>(cudaErrorInvalidValue);
  return by_out<kTmaA>(out_dtype, tile_n, am, bm, a, b, sa, sb, out, s,
                       static_cast<cudaStream_t>(stream));
}
