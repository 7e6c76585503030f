// flash_attention: exact attention, softmax(q k^T / sqrt(D)) v, with an online
// softmax over key tiles, optional causal masking and an optional per-row
// log-sum-exp.  Inputs are (B, T, H, D) views with batch, token and head
// strides given in elements (D contiguous); the output is a contiguous
// (B, Tq, H, D) tensor of the input type, the lse a contiguous (B, H, Tq)
// float32 tensor.
//
// Replaces the Pallas kernel nnstreamer_tpu/ops/flash_attention.py _flash_bh
// (body _flash_kernel), and computes what it computes: float32 scores scaled
// by 1/sqrt(D), masked scores -1e30 (causal keeps q_pos >= k_pos; keys at or
// past Tk are masked), a running max m and sum l per row, each key tile
// rescaling the accumulator by exp(m_prev - m_new), out = acc / max(l, 1e-30),
// lse = m + log(l) where l > 0, else -1e30.  Fully masked rows (unreachable
// here: causal rows always see key 0) follow the Pallas kernel:
// exp(-1e30 - -1e30) = 1, not 0.
//
// What bounds it on an H100: at the ViT-B/16 and GPT-2-small shapes (T of 197
// and 1024, D = 64) reading q, k, v once and writing out once takes longer
// than the products take on the tensor cores, so the bound is bytes.
//
// Two routes, chosen by dtype:
//
// * bfloat16: flash_fwd_wgmma, on the tensor cores.  What it does about the
//   four things that held the first (CUDA-core, float32) version back:
//   1. both products are wgmma with bf16 operands and float32 accumulation
//      (a bf16 x bf16 product is exact in float32): S = Q K^T with Q and K
//      read from shared memory, O += P V with V read from shared memory
//      through a descriptor with the transpose bit, so no transposed copy is
//      made.  1/sqrt(D) is applied to the float32 scores after Q K^T, never
//      to q before it, folded with log2(e) into one ex2 per score;
//   2. P stays in registers: the m64n64 accumulator fragments of S are the
//      register A fragments of P V, converted to bf16 in place; l is summed
//      in float32 from the unrounded p;
//   3. tiles are bf16 in shared memory, 128-byte swizzled (so wgmma reads
//      them free of bank conflicts), brought in by TMA from one 4-D tensor map
//      over (D, H, T, B) built from the given strides.  One producer warp
//      keeps two q buffers and a ring of two K/V stages full;
//      completion goes through mbarriers, and two consumer warpgroups release
//      a stage when they are done with it.  TMA fills rows past T and columns
//      past D with zeros: the ragged tile and the padding of D to 64 or 128
//      need no staging code;
//   4. a work item is 128 query rows (64 per consumer warpgroup) of one
//      (batch, head); blocks are persistent, one per SM slot, walking the
//      items so that the next item's tiles load while this one's are in use.
//      Causal items never visit a key tile wholly above the diagonal, mask
//      only the tiles that cross it, and the heaviest items come first;
//      non-causal, a (batch, head)'s items are neighbours and share its K/V in
//      L2.  A ragged key tile issues S per 16-key block (m64n16) and P V only
//      over the live blocks, and a warpgroup whose rows are past Tq, or
//      (causal) wholly before the tile, skips it.
//   TMA needs 16-byte aligned bases and batch, token and head strides that
//   are multiples of 16 bytes (8 elements): the entry point refuses
//   anything else.
// * float32: flash_fwd, the CUDA-core kernel (float32 products, 64-row tiles
//   staged through shared memory as float32).  TF32 on the tensor cores
//   would keep about three decimal digits, which breaks the float32
//   contract (2e-5 against the plain version), so float32 stays there.
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr float kMasked = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // null: no lse
  int heads, tq, tk, d;
  int64_t q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh;  // element strides
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;           // query rows per block
constexpr int kBlockK = 64;           // keys per shared-memory tile
constexpr int kThreads = 128;         // 16 row groups x 8 lanes
constexpr int kRows = 4;              // query rows per thread
constexpr int kKeys = kBlockK / 8;    // keys per thread: lane + 8 * j
constexpr int kLdP = kBlockK + 4;     // row stride of the probability tile
static_assert(kBlockQ == kBlockK, "stage() fills 64-row tiles of q and of k, v alike");

// Rows t0 .. t0 + 63 of one (batch, head): row t at src + t * stride, d
// contiguous elements; stored times `scale`, zeros past `end`.
__device__ __forceinline__ void stage(float* dst, int ld, const float* src, int64_t stride, int t0,
                                      int end, int d, float scale) {
  for (int idx = threadIdx.x; idx < kBlockK * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int t = t0 + r;
    dst[r * ld + c] = t < end ? src[t * stride + c] * scale : 0.f;
  }
}

__device__ __forceinline__ float group_max(float x) {  // over the 8 lanes of a row group
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// NG: float4 column groups of the output per thread (lane + 8 * g), so
// D <= 32 * NG.  One block of 128 threads owns 64 query rows of one (batch,
// head); each thread 4 query rows x 8 keys strided by 8, so the 16-byte
// shared-memory reads are free of bank conflicts.  q is staged times
// 1/sqrt(D).
template <int NG>
__global__ void __launch_bounds__(kThreads) flash_fwd(Params p) {
  extern __shared__ float4 smem4[];
  const int d = p.d, ld = d + 4;  // d % 8 == 0: rows stay 16-byte aligned
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBlockQ * ld;
  float* vs = ks + kBlockK * ld;
  float* ps = vs + kBlockK * ld;

  const int bh = blockIdx.x;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int q0 = blockIdx.y * kBlockQ;
  const int lane = threadIdx.x & 7;
  const int r0 = (threadIdx.x >> 3) * kRows;

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  stage(qs, ld, q, p.q_st, q0, p.tq, d, p.scale);

  float m[kRows], l[kRows], acc[kRows][NG][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
  }

  const int n_kv = (p.tk + kBlockK - 1) / kBlockK;
  // causal: tiles past the query tile's last row contribute nothing
  const int n_eff = p.causal ? min(n_kv, (q0 + kBlockQ + kBlockK - 1) / kBlockK) : n_kv;
  for (int j = 0; j < n_eff; ++j) {
    const int k0 = j * kBlockK;
    __syncthreads();  // the previous tile's reads of ks, vs and ps are done
    stage(ks, ld, k, p.k_st, k0, p.tk, d, 1.f);
    stage(vs, ld, v, p.v_st, k0, p.tk, d, 1.f);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) s[i][jj] = 0.f;
    for (int c = 0; c < d; c += 4) {
      float4 qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * ld + c);
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(ks + (lane + 8 * jj) * ld + c);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int jj = 0; jj < kKeys; ++jj)
          s[i][jj] += qv[i].x * kv[jj].x + qv[i].y * kv[jj].y + qv[i].z * kv[jj].z +
                      qv[i].w * kv[jj].w;
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_pos = q0 + r0 + i;
      float m_cur = kMasked;
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        const int k_pos = k0 + lane + 8 * jj;
        if (k_pos >= p.tk || (p.causal && q_pos < k_pos)) s[i][jj] = kMasked;
        m_cur = fmaxf(m_cur, s[i][jj]);
      }
      const float m_new = fmaxf(m[i], group_max(m_cur));
      const float alpha = expf(m[i] - m_new);
      float row = 0.f;
#pragma unroll
      for (int jj = 0; jj < kKeys; ++jj) {
        s[i][jj] = expf(s[i][jj] - m_new);
        row += s[i][jj];
        ps[(r0 + i) * kLdP + lane + 8 * jj] = s[i][jj];
      }
      l[i] = l[i] * alpha + group_sum(row);
      m[i] = m_new;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
    }
    __syncthreads();

    // acc += p @ v over this tile's keys (past Tk: p is 0 and v is 0)
    const int kn = min(kBlockK, (p.tk - k0 + 3) & ~3);
    for (int kk = 0; kk < kn; kk += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = *reinterpret_cast<const float4*>(ps + (r0 + i) * kLdP + kk);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int col = (lane + 8 * g) * 4;
        if (col < d) {
          const float4 v0 = *reinterpret_cast<const float4*>(vs + (kk + 0) * ld + col);
          const float4 v1 = *reinterpret_cast<const float4*>(vs + (kk + 1) * ld + col);
          const float4 v2 = *reinterpret_cast<const float4*>(vs + (kk + 2) * ld + col);
          const float4 v3 = *reinterpret_cast<const float4*>(vs + (kk + 3) * ld + col);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc[i][g][0] += pv[i].x * v0.x + pv[i].y * v1.x + pv[i].z * v2.x + pv[i].w * v3.x;
            acc[i][g][1] += pv[i].x * v0.y + pv[i].y * v1.y + pv[i].z * v2.y + pv[i].w * v3.y;
            acc[i][g][2] += pv[i].x * v0.z + pv[i].y * v1.z + pv[i].z * v2.z + pv[i].w * v3.z;
            acc[i][g][3] += pv[i].x * v0.w + pv[i].y * v1.w + pv[i].z * v2.w + pv[i].w * v3.w;
          }
        }
      }
    }
  }

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + r0 + i;
    if (t >= p.tq) continue;  // rows of the ragged last query tile
    const float den = fmaxf(l[i], 1e-30f);
    float* row = out + ((static_cast<int64_t>(b) * p.tq + t) * p.heads + h) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = (lane + 8 * g) * 4;
      if (col < d) {
#pragma unroll
        for (int e = 0; e < 4; ++e) row[col + e] = acc[i][g][e] / den;
      }
    }
    if (p.lse != nullptr && lane == 0)
      p.lse[static_cast<int64_t>(bh) * p.tq + t] = l[i] > 0.f ? m[i] + logf(den) : kMasked;
  }
}

template <int NG>
int launch_f32(const Params& p, int bh, cudaStream_t stream) {
  const int ld = p.d + 4;
  const int smem = (3 * kBlockK * ld + kBlockQ * kLdP) * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd<NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((p.tq + kBlockQ - 1) / kBlockQ));
  flash_fwd<NG><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel (wgmma, TMA, mbarriers; sm_90a)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op; -> 0 far below
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr int kWgRows = 128;  // query rows per work item: two consumer warpgroups of 64
constexpr int kWgKeys = 64;   // keys per K/V tile
constexpr int kWgConsumers = 256;                // warpgroups 0, 1 consume
constexpr int kWgThreads = kWgConsumers + 32;  // warp 8 produces

template <int kD>  // 64 or 128: chunks of 64 columns, one 128-byte swizzle atom wide
struct WgCfg {
  static constexpr int kChunks = kD / 64;
  // K/V ring: on the card 3 and 4 stages at D = 64 timed no better than 2
  static constexpr int kStages = 2;
  // two blocks per SM at D = 64 (the launch bounds hold registers to 96; on
  // the card this timed well ahead of one block); at D = 128 the same cap
  // spills heavily, so one
  static constexpr int kMinBlocks = kD == 64 ? 2 : 1;
  static constexpr int kQChunk = kWgRows * 128, kTileChunk = kWgKeys * 128;
  static constexpr int kQBytes = kQChunk * kChunks;        // one q tile; two are kept
  static constexpr int kTileBytes = kTileChunk * kChunks;  // one K or V tile
  static constexpr int kSmemBytes = 1024 /* alignment slack */ + 2 * kQBytes +
                                    2 * kStages * kTileBytes + 128 /* barriers */;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// one box of the 4-D (D, H, T, B) tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int d0,
                                         int h, int t0, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h), "r"(t0), "r"(b)
      : "memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64x64 f32) (+)= A (64x16 bf16, shared, K-major) * B (16x64 bf16, shared, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64x16 f32) (+)= A (64x16 bf16, shared, K-major) * B (16x16 bf16, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64x64 f32) += A (64x16 bf16, registers) * B (16x64 bf16, shared, N-major: the
// last immediate sets the transpose bit)
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// Work item i of a launch: (batch x head, query tile).  Causal: the last
// query tiles see the most keys, so all of them come first; otherwise a
// (batch, head)'s query tiles are neighbours and share its K/V in L2.
struct WgItem {
  int b, h, bh, q0, n_eff;
};

__device__ __forceinline__ WgItem wg_item(const Params& p, int i, int n_qt, int n_bh) {
  WgItem it;
  it.bh = p.causal ? i % n_bh : i / n_qt;
  const int qt = p.causal ? n_qt - 1 - i / n_bh : i % n_qt;
  it.b = it.bh / p.heads;
  it.h = it.bh - it.b * p.heads;
  it.q0 = qt * kWgRows;
  const int n_kv = (p.tk + kWgKeys - 1) / kWgKeys;
  // causal: tiles past the item's last row contribute nothing
  it.n_eff = p.causal ? min(n_kv, (it.q0 + kWgRows + kWgKeys - 1) / kWgKeys) : n_kv;
  return it;
}

// One K/V tile for one consumer warpgroup's 64 rows, given that only the
// first kN16 16-key blocks hold keys a real row may see (the rest are past
// Tk): S = Q K^T by wgmma from shared memory (m64n64, or m64n16 per block of
// a ragged tile), mask and online softmax in registers, then O += P V by
// wgmma with P from registers and V transposed by the descriptor.
template <int kD, int kN16>
__device__ __forceinline__ void wg_tile(const Params& p, float (&o)[kD / 64][32], float (&m)[2],
                                        float (&l)[2], uint32_t qa, uint32_t ka, uint32_t va,
                                        uint32_t v_bar, int ph, int k0, int row_first, bool mask) {
  using Cfg = WgCfg<kD>;
  constexpr int kC = Cfg::kChunks, kN = 8 * kN16;  // live accumulator registers of S
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4, g = lane / 4, t4 = lane % 4;
  const float sl2 = p.scale * kLog2e, masked = kMasked / p.scale;
  float s[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 columns into the atom
    const uint64_t da = sw128_desc(qa + (kk / 4) * Cfg::kQChunk + off);
    if (kN16 == 4) {
      wgmma_ss(s, da, sw128_desc(ka + (kk / 4) * Cfg::kTileChunk + off), kk > 0);
    } else {
#pragma unroll
      for (int np = 0; np < kN16; ++np)
        wgmma_ss_n16(s + 8 * np, da,
                     sw128_desc(ka + (kk / 4) * Cfg::kTileChunk + np * 16 * 128 + off), kk > 0);
    }
  }
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int e = 0; e < kN; ++e) asm volatile("" : "+f"(s[e])::"memory");

  if (mask) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int q_pos = row_first + 16 * w + g + ((e >> 1) & 1) * 8;
      const int k_pos = k0 + (e >> 2) * 8 + t4 * 2 + (e & 1);
      if (k_pos >= p.tk || (p.causal && k_pos > q_pos)) s[e] = masked;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int nt = 0; nt < 2 * kN16; ++nt)
      mx = fmaxf(mx, fmaxf(s[4 * nt + 2 * r], s[4 * nt + 2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = ex2((m[r] - mx) * sl2), ml = mx * sl2;
    float rs = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * kN16; ++nt)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        s[4 * nt + e] = ex2(fmaf(s[4 * nt + e], sl2, -ml));
        rs += s[4 * nt + e];
      }
    l[r] = l[r] * alpha + rs;  // this lane's share; the quad sums at the end
    m[r] = mx;
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        o[c][4 * nt + 2 * r] *= alpha;
        o[c][4 * nt + 2 * r + 1] *= alpha;
      }
  }

  // S's accumulator fragments are P's A fragments
  uint32_t pa[kN16][4];
#pragma unroll
  for (int kk = 0; kk < kN16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
  mbar_wait(v_bar, ph);
#pragma unroll
  for (int c = 0; c < kC; ++c) fence_regs(o[c]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kN16; ++kk)
#pragma unroll
    for (int c = 0; c < kC; ++c)
      wgmma_rs_t(o[c], pa[kk], sw128_desc(va + c * Cfg::kTileChunk + kk * 16 * 128));
  wg_commit();
  wg_wait0();
#pragma unroll
  for (int c = 0; c < kC; ++c) fence_regs(o[c]);
}

// Persistent: block x walks items x, x + gridDim.x, ...  The producer warp
// runs ahead through the same sequence, into two q buffers and a ring of
// K/V stages, so the next item's tiles load while this one's are in use.
template <int kD>
__global__ void __launch_bounds__(kWgThreads, WgCfg<kD>::kMinBlocks)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap k_map,
                    const __grid_constant__ CUtensorMap v_map, Params p, int n_items) {
  using Cfg = WgCfg<kD>;
  constexpr int kC = Cfg::kChunks, kS = Cfg::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // swizzled tiles start on 1024-byte boundaries
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;  // buffer qb, chunk c at + qb kQBytes + c kQChunk
  // K and V: stage st, chunk c at + st kTileBytes + c kTileChunk
  const uint32_t k_s = q_s + 2 * Cfg::kQBytes;
  const uint32_t v_s = k_s + kS * Cfg::kTileBytes;
  const uint32_t bars = v_s + kS * Cfg::kTileBytes;
  auto q_full = [&](int qb) { return bars + 8 * qb; };
  auto q_empty = [&](int qb) { return bars + 8 * (2 + qb); };
  auto k_full = [&](int st) { return bars + 8 * (4 + st); };
  auto v_full = [&](int st) { return bars + 8 * (4 + kS + st); };
  auto empty = [&](int st) { return bars + 8 * (4 + 2 * kS + st); };

  const int n_qt = (p.tq + kWgRows - 1) / kWgRows, n_bh = n_items / n_qt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      mbar_init(q_full(qb), 1);
      mbar_init(q_empty(qb), kWgConsumers);
    }
    for (int st = 0; st < kS; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), kWgConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWgConsumers / 32) {  // producer: one lane keeps the buffers full
    if (lane == 0) {
      int n = 0, tile = 0;  // items and K/V tiles this block has loaded
      for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
        const WgItem it = wg_item(p, i, n_qt, n_bh);
        const int qb = n & 1;
        if (n >= 2) mbar_wait(q_empty(qb), ((n >> 1) - 1) & 1);
        mbar_expect_tx(q_full(qb), Cfg::kQBytes);
        for (int c = 0; c < kC; ++c)
          tma_load(q_s + qb * Cfg::kQBytes + c * Cfg::kQChunk, &q_map, q_full(qb), 64 * c, it.h,
                   it.q0, it.b);
        for (int j = 0; j < it.n_eff; ++j, ++tile) {
          const int st = tile % kS;
          if (tile >= kS) mbar_wait(empty(st), ((tile / kS) - 1) & 1);
          mbar_expect_tx(k_full(st), Cfg::kTileBytes);
          for (int c = 0; c < kC; ++c)
            tma_load(k_s + st * Cfg::kTileBytes + c * Cfg::kTileChunk, &k_map, k_full(st), 64 * c,
                     it.h, j * kWgKeys, it.b);
          mbar_expect_tx(v_full(st), Cfg::kTileBytes);
          for (int c = 0; c < kC; ++c)
            tma_load(v_s + st * Cfg::kTileBytes + c * Cfg::kTileChunk, &v_map, v_full(st), 64 * c,
                     it.h, j * kWgKeys, it.b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each item
  const int wg = threadIdx.x / 128, w = warp % 4;
  const int g = lane / 4, t4 = lane % 4;
  const float masked = kMasked / p.scale;
  bf16* out = static_cast<bf16*>(p.out);
  int n = 0, tile = 0;
  for (int i = blockIdx.x; i < n_items; i += gridDim.x, ++n) {
    const WgItem it = wg_item(p, i, n_qt, n_bh);
    const int qb = n & 1;
    const int row_first = it.q0 + 64 * wg;
    const int row_last = min(row_first + 64, p.tq) - 1;
    float o[kC][32], m[2] = {masked, masked}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.f;

    mbar_wait(q_full(qb), (n >> 1) & 1);
    for (int j = 0; j < it.n_eff; ++j, ++tile) {
      const int st = tile % kS, ph = (tile / kS) & 1;
      const int k0 = j * kWgKeys;
      // 16-key blocks of this tile that a real row of this warpgroup may see
      // (warpgroup-uniform); 0: rows past Tq, or all keys above the rows
      const int key_end = min(p.tk, p.causal ? row_last + 1 : p.tk);
      const int n16 = row_first < p.tq ? min(kWgKeys / 16, (key_end - k0 + 15) / 16) : 0;
      const bool mask = k0 + kWgKeys > p.tk || (p.causal && k0 + kWgKeys - 1 > row_first);
      const uint32_t qa = q_s + qb * Cfg::kQBytes + 64 * wg * 128;
      const uint32_t ka = k_s + st * Cfg::kTileBytes, va = v_s + st * Cfg::kTileBytes;
      mbar_wait(k_full(st), ph);
      switch (n16) {
        case 4: wg_tile<kD, 4>(p, o, m, l, qa, ka, va, v_full(st), ph, k0, row_first, mask); break;
        case 3: wg_tile<kD, 3>(p, o, m, l, qa, ka, va, v_full(st), ph, k0, row_first, mask); break;
        case 2: wg_tile<kD, 2>(p, o, m, l, qa, ka, va, v_full(st), ph, k0, row_first, mask); break;
        case 1: wg_tile<kD, 1>(p, o, m, l, qa, ka, va, v_full(st), ph, k0, row_first, mask); break;
        default: mbar_wait(v_full(st), ph); break;
      }
      mbar_arrive(empty(st));
    }
    mbar_arrive(q_empty(qb));  // this item's last read of its q tile is done

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lsum = l[r];
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 1);
      lsum += __shfl_xor_sync(0xffffffffu, lsum, 2);
      const int t = row_first + 16 * w + g + 8 * r;
      if (t >= p.tq) continue;
      const float den = fmaxf(lsum, 1e-30f);
      bf16* row = out + ((static_cast<int64_t>(it.b) * p.tq + t) * p.heads + it.h) * p.d;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = 64 * c + 8 * nt + 2 * t4;
          if (col < p.d)
            *reinterpret_cast<__nv_bfloat162*>(row + col) =
                __floats2bfloat162_rn(o[c][4 * nt + 2 * r] / den, o[c][4 * nt + 2 * r + 1] / den);
        }
      if (p.lse != nullptr && t4 == 0)
        p.lse[static_cast<int64_t>(it.bh) * p.tq + t] =
            lsum > 0.f ? m[r] * p.scale + logf(den) : kMasked;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime: no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      ptr = nullptr;
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// (D, H, T, B) view of a (B, T, H, D) tensor; boxes of 64 columns x `rows` tokens
bool make_map(CUtensorMap* map, const void* ptr, int d, int heads, int t, int batch, int64_t st,
              int64_t sh, int64_t sb, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(t), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD>
int launch_wgmma(const Params& p, int batch, int bh, cudaStream_t stream) {
  using Cfg = WgCfg<kD>;
  CUtensorMap qm, km, vm;
  if (!make_map(&qm, p.q, p.d, p.heads, p.tq, batch, p.q_st, p.q_sh, p.q_sb, kWgRows) ||
      !make_map(&km, p.k, p.d, p.heads, p.tk, batch, p.k_st, p.k_sh, p.k_sb, kWgKeys) ||
      !make_map(&vm, p.v, p.d, p.heads, p.tk, batch, p.v_st, p.v_sh, p.v_sb, kWgKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma<kD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg::kSmemBytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_fwd_wgmma<kD>, kWgThreads,
                                                        Cfg::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t items = static_cast<int64_t>(bh) * ((p.tq + kWgRows - 1) / kWgRows);
  const int blocks = static_cast<int>(min(items, static_cast<int64_t>(sms) * max(per_sm, 1)));
  flash_fwd_wgmma<kD><<<blocks, kWgThreads, Cfg::kSmemBytes, stream>>>(qm, km, vm, p,
                                                                      static_cast<int>(items));
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// q, k, v: (batch, t, heads, d) with element strides *_sb, *_st, *_sh and
// d contiguous; out: contiguous (batch, tq, heads, d); lse: contiguous
// (batch, heads, tq) float32, or null.  dtype: 0 float32 (CUDA cores), 2
// bfloat16 (tensor cores: q, k, v 16-byte aligned and every stride a
// multiple of 8).  d is a multiple of 8 in [8, 128]; causal needs tq == tk.
// Returns the CUDA error of the launch (0 = launched).
NNS_EXPORT int nns_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int dtype, int batch, int heads, int tq, int tk,
                                   int d, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
                                   int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                                   int64_t v_sh, float scale, int causal, void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || tk < 1 || (causal && tq != tk) || batch < 0 ||
      heads < 0 || tq < 0 || (dtype != 0 && dtype != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bh = static_cast<int64_t>(batch) * heads;
  if (bh == 0 || tq == 0) return 0;
  // bfloat16: (batch x head) x query tiles work items; float32: a 2-D grid
  if (dtype == 2 ? bh * ((tq + kWgRows - 1) / kWgRows) > 0x7fffffff
                 : bh > 0x7fffffff || (tq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Params p{q,    k,    v,    out,  static_cast<float*>(lse),
                 heads, tq,  tk,   d,    q_sb,
                 q_st, q_sh, k_sb, k_st, k_sh,
                 v_sb, v_st, v_sh, scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = static_cast<int>(bh);
  if (dtype == 0) {
    if (d <= 32) return launch_f32<1>(p, n, s);
    if (d <= 64) return launch_f32<2>(p, n, s);
    return launch_f32<4>(p, n, s);
  }
  const int64_t strides[] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh};
  for (int64_t st : strides)
    if (st % 8 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  if (!aligned16(q) || !aligned16(k) || !aligned16(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (d <= 64) return launch_wgmma<64>(p, batch, n, s);
  return launch_wgmma<128>(p, batch, n, s);
}
