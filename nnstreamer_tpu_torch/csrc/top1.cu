// top1: per-row argmax and max of a (rows, cols) float32, bf16 or fp16 matrix,
// written either as (idx int32, val float32) or packed as (rows, 2) float32
// [float(idx), val] -- the image-labeling decoder's whole device half in one
// launch.
//
// Replaces the Pallas kernel nnstreamer_tpu/ops/labeling.py _pallas_top1 (body
// _kernel) and, for the packed form, the jnp.stack of the decoder's device_fn
// (nnstreamer_tpu/decoders/image_label.py) that XLA fuses into the same program.
//
// What bounds it: at the paths' (128, 1001) float32 logits it reads 512 KB and
// writes 1 KB, about 0.15 us at 3.35 TB/s -- far shorter than one kernel
// launch.  So the design aims at the launch floor: (1) one row per block of
// 128 threads (four warps), so 128 rows land on 128 of the 132 SMs; (2) each
// thread issues all of its loads for a chunk of the row (an unrolled register
// tile of kUnroll 16-byte vectors: 4 float32 or 8 bf16/fp16 each) before its
// first compare, so a 4 KB row costs about one memory latency, a shuffle
// butterfly and one barrier, not a chain of dependent loads; longer rows loop
// over such chunks; (3) the packed output comes from the same launch, where a
// split kernel needs two more (.to(float32) and torch.stack).  On the H100,
// 1, 2 and 8 warps per row timed 7%, 2% and 0% slower than 4 at (128, 1001)
// float32 (tools/torch_top1_ab.py).
//
// Rows: the row stride is given in elements, columns are unit stride and a
// row may start at any element.  Each row is read as a scalar head up to its
// first 16-byte boundary, a body of 16-byte vectors and a scalar tail (a
// 1001-wide float32 row is 4004 bytes, so every second row starts off a
// 16-byte boundary).  Every value converts to float32 in registers (exact for
// all three types) and every compare is in float32; the value written is the
// float32 of the winning element, as jnp.max(x.astype(float32)) gives.
//
// Semantics are jnp.argmax / jnp.max: the first maximal index wins ties; NaN
// counts as the maximum (the first NaN's index, value NaN); a row of all -inf
// gives index 0.  `better` is a strict total order on (value, index) pairs
// (indices are distinct), so the row's winner is the same whichever way its
// elements are split among threads and combined: the head, body and tail
// split, the per-thread pairs, the shuffle butterflies and the cross-warp step
// below all give the winner a sequential scan gives.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;    // warps per row: one row per block
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 2;   // 16-byte vectors in flight per thread: a chunk of 256
constexpr int kAcc = 4;      // running (value, index) pairs per thread

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  const bool an = av != av, bn = bv != bv;  // NaN tests (IEEE compares: no fast-math)
  if (an || bn) return an && (!bn || ai < bi);
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
}

// take() for an element whose index is above every index the pair has seen:
// it wins by a greater value, or as the first NaN.
__device__ __forceinline__ void take_later(float v, int i, float& bv, int& bi) {
  if (!(v <= bv) && bv == bv) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// Element e (a constant once unrolled) of a 16-byte vector of 16 / sizeof(T)
// values of type T, as float32, taken from the vector's 32-bit words.
template <typename T>
__device__ __forceinline__ float vec_value(const uint4& v, int e) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else {
    const unsigned word = w[e / 2];
    const unsigned short bits = static_cast<unsigned short>(e % 2 ? word >> 16 : word & 0xffffu);
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return __uint_as_float(static_cast<unsigned>(bits) << 16);  // exact
    } else {
      return __half2float(__ushort_as_half(bits));  // exact
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
top1_kernel(const T* __restrict__ x, int64_t rows, int cols, int64_t row_stride,
            int* __restrict__ idx, float* __restrict__ val, float2* __restrict__ packed) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte vector
  const float kNegInf = __uint_as_float(0xff800000u);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* r = x + row * row_stride;
    // head: elements before the first 16-byte boundary (fewer than kVec)
    const int misalign = static_cast<int>((reinterpret_cast<uintptr_t>(r) & 15) / sizeof(T));
    const int head = min((kVec - misalign) % kVec, cols);
    const int nvec = (cols - head) / kVec;
    const int body_end = head + nvec * kVec;
    const uint4* body = reinterpret_cast<const uint4*>(r + head);

    // kAcc independent (value, index) pairs per thread, so the compares of a
    // chunk form kAcc short chains instead of one long one
    float bv[kAcc];
    int bi[kAcc];
#pragma unroll
    for (int a = 0; a < kAcc; ++a) {
      bv[a] = kNegInf;
      bi[a] = INT_MAX;  // "no element yet": loses every comparison on index
    }
    // the scalar head and tail (tid < head, tid < cols - body_end): loaded
    // now, compared after the body, so their latency overlaps the body's
    const float hv = tid < head ? to_float(r[tid]) : 0.0f;
    const int tc = body_end + tid;
    const float tv = tc < cols ? to_float(r[tc]) : 0.0f;
    // body: chunks of kThreads * kUnroll vectors, neighbouring threads on
    // neighbouring vectors; every load of a chunk is issued before its first
    // compare.  Each pair sees its elements in increasing index order, so a
    // later element wins only by a greater value or by the first NaN
    // (take_later).  No -inf element is ever recorded (it cannot win unless
    // all are -inf), so a pair still at (-inf, INT_MAX) at the end means the
    // whole row is -inf, and then the first element, index 0, wins.
    for (int base = 0; base < nvec; base += kThreads * kUnroll) {
      uint4 tile[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kThreads + tid;
        if (j < nvec) tile[u] = __ldg(body + j);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = base + u * kThreads + tid;
        if (j < nvec) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            take_later(vec_value<T>(tile[u], e), head + j * kVec + e, bv[e % kAcc], bi[e % kAcc]);
          }
        }
      }
    }
    if (tid < head && hv != kNegInf) take(hv, tid, bv[0], bi[0]);
    if (tc < cols && tv != kNegInf) take(tv, tc, bv[1], bi[1]);
#pragma unroll
    for (int a = 1; a < kAcc; ++a) take(bv[a], bi[a], bv[0], bi[0]);
    float v = bv[0];
    int i = bi[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      take(__shfl_xor_sync(0xffffffffu, v, off), __shfl_xor_sync(0xffffffffu, i, off), v, i);
    }
    // combine the warps' winners in warp 0
    if (lane == 0) {
      warp_v[warp] = v;
      warp_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < kWarps ? warp_v[lane] : kNegInf;
      i = lane < kWarps ? warp_i[lane] : INT_MAX;
#pragma unroll
      for (int off = kWarps / 2; off > 0; off >>= 1) {
        take(__shfl_xor_sync(0xffffffffu, v, off), __shfl_xor_sync(0xffffffffu, i, off), v, i);
      }
    }
    __syncthreads();  // warp_v/warp_i are free for the next row
    if (tid == 0) {
      if (i == INT_MAX) i = 0;  // every element -inf: the first one
      if (packed != nullptr) {
        packed[row] = make_float2(static_cast<float>(i), v);  // exact: cols < 2**24
      } else {
        idx[row] = i;
        val[row] = v;
      }
    }
  }
}

template <typename T>
int launch(const void* x, int64_t rows, int cols, int64_t row_stride, void* idx, void* val,
           void* packed, void* stream) {
  if (rows <= 0) return 0;
  const unsigned grid = static_cast<unsigned>(rows < INT_MAX ? rows : INT_MAX);
  top1_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), rows, cols, row_stride, static_cast<int*>(idx),
      static_cast<float*>(val), static_cast<float2*>(packed));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (rows, cols) of dtype 0 = float32, 1 = bfloat16, 2 = float16, columns
// unit stride, row r at x + r * row_stride elements (any element alignment).
// Writes either idx (rows,) int32 and val (rows,) float32, when packed is
// null, or packed (rows, 2) float32 [float(idx), val] (cols < 2**24 there).
// Returns the CUDA error of the launch (0 = launched).
NNS_EXPORT int nns_top1(const void* x, int dtype, int64_t rows, int cols, int64_t row_stride,
                        void* idx, void* val, void* packed, void* stream) {
  switch (dtype) {
    case 0: return launch<float>(x, rows, cols, row_stride, idx, val, packed, stream);
    case 1: return launch<__nv_bfloat16>(x, rows, cols, row_stride, idx, val, packed, stream);
    case 2: return launch<__half>(x, rows, cols, row_stride, idx, val, packed, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
