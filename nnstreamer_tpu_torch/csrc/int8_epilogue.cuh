// The int8 path's epilogue, shared by int8_conv.cu and int8_dwconv.cu:
// out = cast(float32(acc) * (s_x * s_w)), each product rounded once
// (__fmul_rn is never contracted), the cast round-to-nearest-even, as
// nnstreamer_tpu/ops/quantize.py computes it; an int32 output takes the
// raw accumulator.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <typename T>
__device__ __forceinline__ T cast_out(float v) {
  if constexpr (std::is_same<T, __half>::value) {
    return __float2half_rn(v);
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

template <typename T>
__device__ __forceinline__ T rescaled(int acc, float s_x, float s_w) {
  if constexpr (std::is_same<T, int32_t>::value) {
    return acc;
  } else {
    return cast_out<T>(__fmul_rn(__int2float_rn(acc), __fmul_rn(s_x, s_w)));
  }
}
