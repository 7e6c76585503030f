// flash_attention: exact attention, softmax(q k^T / sqrt(D)) v, with an online
// softmax over key tiles, optional causal masking and an optional per-row
// log-sum-exp.  Inputs are (B, T, H, D) views of bf16 or float32 data with any
// batch, token and head strides (D contiguous); the output is a contiguous
// (B, Tq, H, D) tensor of the input type, the lse a contiguous (B, H, Tq)
// float32 tensor.
//
// Replaces the Pallas kernel nnstreamer_tpu/ops/flash_attention.py _flash_bh
// (body _flash_kernel), and computes what it computes: q scaled by 1/sqrt(D)
// in float32, float32 scores, masked scores -1e30 (causal keeps
// q_pos >= k_pos; keys at or past Tk are masked), a running max m and sum l
// per row, each key tile rescaling the accumulator by exp(m_prev - m_new),
// out = acc / max(l, 1e-30), lse = m + log(l) where l > 0, else -1e30.
//
// What bounds it on an H100: at the ViT-B/16 and GPT-2-small shapes (T of 197
// and 1024, D = 64) the bytes (q, k, v read once, out written once) take
// longer than the products would on the tensor cores, so the bound is memory.
// This first version is far from that bound by design: the products run on
// the CUDA cores in float32.  One block of 128 threads owns 64 query rows of
// one (batch, head); key and value tiles of 64 rows are staged through shared
// memory as float32, so each K/V element is read from device memory once per
// query tile; the 64x64 score tile, m, l and the D-wide accumulator stay in
// registers (each thread: 4 query rows x 8 keys, strided by 8 so the 16-byte
// shared-memory reads are free of bank conflicts).  Causal key tiles wholly
// above the diagonal are never visited; the ragged last tile is masked by
// the true Tk, with zeros staged past it, so no padded copy is made.
// mma.sync/wgmma, TMA and double buffering are the later redesign.
//
// Fully masked rows (unreachable here: causal rows always see key 0) follow
// the Pallas kernel: exp(-1e30 - -1e30) = 1, not 0.
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBlockQ = 64;           // query rows per block
constexpr int kBlockK = 64;           // keys per shared-memory tile
constexpr int kThreads = 128;         // 16 row groups x 8 lanes
constexpr int kRows = 4;              // query rows per thread
constexpr int kKeys = kBlockK / 8;    // keys per thread: lane + 8 * j
constexpr int kLdP = kBlockK + 4;     // row stride of the probability tile
constexpr float kMasked = -1e30f;
static_assert(kBlockQ == kBlockK, "stage() fills 64-row tiles of q and of k, v alike");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

// Rows t0 .. t0 + 63 of one (batch, head): row t at src + t * stride, d
// contiguous elements; stored as float32 times `scale`, zeros past `end`.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src, int64_t stride, int t0,
                                      int end, int d, float scale) {
  for (int idx = threadIdx.x; idx < kBlockK * d; idx += kThreads) {
    const int r = idx / d, c = idx - r * d;
    const int t = t0 + r;
    dst[r * ld + c] = t < end ? to_float(src[t * stride + c]) * scale : 0.f;
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
// D <= 32 * NG.
template <typename T, int NG>
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

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
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

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int t = q0 + r0 + i;
    if (t >= p.tq) continue;  // rows of the ragged last query tile
    const float den = fmaxf(l[i], 1e-30f);
    T* row = out + ((static_cast<int64_t>(b) * p.tq + t) * p.heads + h) * d;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int col = (lane + 8 * g) * 4;
      if (col < d) {
#pragma unroll
        for (int e = 0; e < 4; ++e) row[col + e] = from_float<T>(acc[i][g][e] / den);
      }
    }
    if (p.lse != nullptr && lane == 0)
      p.lse[static_cast<int64_t>(bh) * p.tq + t] = l[i] > 0.f ? m[i] + logf(den) : kMasked;
  }
}

template <typename T, int NG>
int launch(const Params& p, int bh, cudaStream_t stream) {
  const int ld = p.d + 4;
  const int smem = (3 * kBlockK * ld + kBlockQ * kLdP) * static_cast<int>(sizeof(float));
  cudaError_t err =
      cudaFuncSetAttribute(flash_fwd<T, NG>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh), static_cast<unsigned>((p.tq + kBlockQ - 1) / kBlockQ));
  flash_fwd<T, NG><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const Params& p, int bh, cudaStream_t stream) {
  if (p.d <= 32) return launch<T, 1>(p, bh, stream);
  if (p.d <= 64) return launch<T, 2>(p, bh, stream);
  return launch<T, 4>(p, bh, stream);
}

}  // namespace

// q, k, v: (batch, t, heads, d) with element strides *_sb, *_st, *_sh and
// d contiguous; out: contiguous (batch, tq, heads, d); lse: contiguous
// (batch, heads, tq) float32, or null.  dtype: 0 float32, 2 bfloat16.
// d is a multiple of 8 in [8, 128]; causal needs tq == tk.  Returns the CUDA
// error of the launch (0 = launched).
NNS_EXPORT int nns_flash_attention(const void* q, const void* k, const void* v, void* out,
                                   void* lse, int dtype, int batch, int heads, int tq, int tk,
                                   int d, int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t k_sb,
                                   int64_t k_st, int64_t k_sh, int64_t v_sb, int64_t v_st,
                                   int64_t v_sh, float scale, int causal, void* stream) {
  if (d < 8 || d > 128 || d % 8 != 0 || tk < 1 || (causal && tq != tk) || batch < 0 ||
      heads < 0 || tq < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bh = static_cast<int64_t>(batch) * heads;
  if (bh == 0 || tq == 0) return 0;
  if (bh > 0x7fffffff || (tq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const Params p{q,    k,    v,    out,  static_cast<float*>(lse),
                 heads, tq,  tk,   d,    q_sb,
                 q_st, q_sh, k_sb, k_st, k_sh,
                 v_sb, v_st, v_sh, scale, causal};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, static_cast<int>(bh), s);
  if (dtype == 2) return dispatch<__nv_bfloat16>(p, static_cast<int>(bh), s);
  return static_cast<int>(cudaErrorInvalidValue);
}
