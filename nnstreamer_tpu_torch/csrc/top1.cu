// top1: per-row argmax (int32) and max (float32) of a (rows, cols) float32 matrix.
//
// Replaces the Pallas kernel nnstreamer_tpu/ops/labeling.py _pallas_top1 (body
// _kernel), the image-labeling decoder's device half.
//
// At the main path's (128, 1001) logits it reads 512 KB and writes 1 KB: a
// few hundred nanoseconds of memory time, so launch latency, not bytes,
// bounds it.  The design is the simplest that keeps every lane busy: one warp
// per row, 8 rows per block; lanes stride over the columns (neighbouring lanes
// on neighbouring addresses), each keeping a (value, index) pair, and a
// __shfl_xor_sync butterfly combines the 32 pairs.  The Pallas kernel padded
// the classes to a multiple of 128 with -inf in a copy; here the loop bound
// masks the ragged tail (1001 = 31 * 32 + 9).
//
// Semantics are jnp.argmax / jnp.max: the first maximal index wins ties; NaN
// counts as the maximum (the first NaN's index, value NaN); a row of all -inf
// gives index 0.  `better` is a strict total order on (value, index) pairs,
// so the butterfly leaves every lane with the same winner.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  const bool an = av != av, bn = bv != bv;  // NaN tests (IEEE compares: no fast-math)
  if (an || bn) return an && (!bn || ai < bi);
  return av > bv || (av == bv && ai < bi);
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
top1_kernel(const float* __restrict__ x, int64_t rows, int cols, int* __restrict__ idx,
            float* __restrict__ val) {
  const int lane = threadIdx.x % 32;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / 32;
  if (row >= rows) return;  // the whole warp leaves together
  const float* r = x + row * cols;
  float bv = __uint_as_float(0xff800000u);  // -inf
  int bi = INT_MAX;  // "no element yet": loses every comparison on index
  for (int c = lane; c < cols; c += 32) {
    const float v = __ldg(r + c);
    if (better(v, c, bv, bi)) {
      bv = v;
      bi = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    idx[row] = bi;
    val[row] = bv;
  }
}

}  // namespace

// x: (rows, cols) float32, rows contiguous; idx: (rows,) int32; val: (rows,)
// float32.  Returns the CUDA error of the launch (0 = launched).
NNS_EXPORT int nns_top1_f32(const void* x, int64_t rows, int cols, void* idx, void* val,
                            void* stream) {
  if (rows <= 0) return 0;
  const int64_t blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  top1_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), rows, cols, static_cast<int*>(idx), static_cast<float*>(val));
  return static_cast<int>(cudaGetLastError());
}
