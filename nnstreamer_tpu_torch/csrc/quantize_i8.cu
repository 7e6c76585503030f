// quantize_i8: symmetric int8 quantization with one scale per row of a
// (rows, cols) view.
//
// Stands for nnstreamer_tpu/ops/quantize.py quantize_symmetric (plain XLA,
// no Pallas kernel): the activations of every int8 layer (a row is one
// sample of a convolution's NHWC input, or one token of a dense layer) and
// the weights (a row is one output channel of the OHWI or (out, in) weight).
// Per row:  scale = max(amax, eps) / 127,  q = clip(rint(x / scale), -127, 127).
//
// Bound by memory: the least it can do is read x once and write the int8
// values once (3 bytes an element from bf16).  A row can be long: 112 x 112
// x 96 = 1.2 M elements per sample after MobileNet-v2's first expansion at
// 224, so one block per row would leave most of the card idle at a small
// batch, and the row's scale must be known before any of its values.  Two
// routes, chosen by ops/quantize.py quantize_plan from the shape and base:
//
// * one pass (nns_quantize_i8_onepass): one cooperative launch, one block
//   per SM (fewer for a small input) with three 72 KB buffers of shared
//   memory.  The rows are cut into waves of whole rows that fit one buffer
//   of every block (132 x 72 KB = 9.7 MB on an H100); each block takes an
//   equal slice of a wave in flat order.  A producer warp brings a wave
//   into shared memory by bulk async copies (cp.async.bulk, completion on
//   an mbarrier); reducer warps fold each row's abs-max into the row's
//   slot (atomicMax on the float's bits: a non-negative float orders like
//   its bits as an unsigned int) and count the wave on its grid counter;
//   quantizer warps wait for the counter to reach the grid, then quantize
//   from shared memory and write the int8 values and the scale.  What
//   bounded the first one-pass designs was not the memory but each block
//   serialising its own latencies: the grid-wide wait, the fence before a
//   count, a scale's load from L2, and the quantize arithmetic, with too
//   few warps in flight to hide them.  The roles are separate warps,
//   pipelined three buffers deep (wave w + 2 loading, w + 1 being reduced,
//   w being quantized), so each role's waits overlap the others' work, and
//   the quantizers, with most of the arithmetic, get most of the warps.  x
//   is read once; the slots and counters are zeroed inside the kernel (one
//   grid sync at the start, no memset).  Needs 16-byte aligned rows (base,
//   row bytes and row stride) and one row in a wave: the largest on the
//   path, YOLOv5s's 320 x 320 x 32 at 640, is 6.5 MB in bf16.
// * two passes (nns_quantize_i8): a grid of blocks per row; pass 1 reduces
//   each chunk's abs-max and folds it into the row's slot, pass 2 re-reads
//   the chunk and quantizes, after a memset of the slots: three operations
//   and 5 bytes an element.  It takes any row: longer than a wave, or
//   unaligned.  Loads are 16 bytes a thread where the row stride and the
//   base allow it.
//
// Numerics, both routes: the scale is an IEEE float32 division and every
// quotient the IEEE float32 quotient (no fast math: an approximate
// reciprocal would change the scale and the values; Divisor below gets the
// exact quotient without dividing each element), rounding is half to even
// as jnp.round and torch.round do, and bf16/fp16 inputs widen to float32
// exactly.  Bit-exact against the plain version.
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kChunk = 8192;  // elements of one row per block

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC elements of T from 16 / (VEC * sizeof(T)) aligned memory.
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = widen(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "one 16-byte load");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = widen(e[i]);
  }
}

__device__ __forceinline__ float scale_of(unsigned amax_bits, float eps) {
  return fmaxf(__uint_as_float(amax_bits), eps) / 127.0f;
}

__device__ __forceinline__ float row_scale(const unsigned* amax_bits, int64_t row, float eps) {
  return scale_of(amax_bits[row], eps);
}

// A row's divisor.  The quotient v / scale is the IEEE float32 quotient,
// computed from the row's correctly rounded reciprocal r by Markstein's
// correction: q = v r, e = v - scale q (exact, by fma), q + e r rounds to
// the IEEE quotient for every finite scale, and a zero stays a zero of its
// sign.  An infinite scale (a row holding an infinity) divides directly.
// So no element pays a division: its fast path is about eight instructions
// and its slow path takes every zero dividend, half the values after a
// ReLU.
struct Divisor {
  float scale, recip;
  bool direct;
};

__device__ __forceinline__ Divisor divisor(float scale) {
  return {scale, 1.0f / scale, isinf(scale)};
}

__device__ __forceinline__ float quotient(float v, const Divisor& d) {
  if (d.direct) return v / d.scale;
  const float q = __fmul_rn(v, d.recip);
  return __fmaf_rn(__fmaf_rn(-d.scale, q, v), d.recip, q);
}

// clip(rint(v / scale), -127, 127) as int8.  The clip comes first (it
// commutes with rint: its bounds are integers, and a NaN quotient clips to
// -127 either way), then rint is one float add of 1.5 * 2^23, which rounds
// to the nearest integer, ties to even, and leaves it in the low mantissa
// bits: exact for |v| <= 127, and no conversion instruction (those issue at
// a quarter of the float rate).
__device__ __forceinline__ int8_t quantized(float v, const Divisor& d) {
  const float clipped = fminf(fmaxf(quotient(v, d), -127.0f), 127.0f);
  return static_cast<int8_t>(__float_as_int(__fadd_rn(clipped, 12582912.0f)) - 0x4B400000);
}

// VEC int8 values to VEC-aligned global memory
template <int VEC>
__device__ __forceinline__ void store_q(int8_t* out, const int8_t (&r)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<char4*>(out) = make_char4(r[0], r[1], r[2], r[3]);
  } else if constexpr (VEC == 8) {
    *reinterpret_cast<uint2*>(out) = *reinterpret_cast<const uint2*>(r);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = r[k];
  }
}

// Pass 1: block b covers chunk b % chunks of row b / chunks.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const T* __restrict__ x, int64_t cols, int64_t row_stride, int64_t chunks,
              unsigned* __restrict__ amax_bits) {
  const int64_t row = blockIdx.x / chunks;
  const int64_t start = (blockIdx.x % chunks) * kChunk;
  const int64_t end = min(cols, start + kChunk);
  const T* base = x + row * row_stride;
  float m = 0.0f;
  for (int64_t i = start + static_cast<int64_t>(threadIdx.x) * VEC; i < end;
       i += static_cast<int64_t>(kThreads) * VEC) {
    float v[VEC];
    load<T, VEC>(base + i, v);
#pragma unroll
    for (int k = 0; k < VEC; ++k) m = fmaxf(m, fabsf(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kThreads / 32];
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(amax_bits + row, __float_as_uint(m));
  }
}

// Pass 2: the same blocks quantize their chunk; chunk 0 writes the scale.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
quantize_kernel(const T* __restrict__ x, int64_t cols, int64_t row_stride, int64_t chunks,
                const unsigned* __restrict__ amax_bits, float eps, int8_t* __restrict__ q,
                float* __restrict__ scales) {
  const int64_t row = blockIdx.x / chunks;
  const int64_t start = (blockIdx.x % chunks) * kChunk;
  const int64_t end = min(cols, start + kChunk);
  const float scale = row_scale(amax_bits, row, eps);
  const Divisor d = divisor(scale);
  if (start == 0 && threadIdx.x == 0) scales[row] = scale;
  const T* base = x + row * row_stride;
  int8_t* out = q + row * cols;
  for (int64_t i = start + static_cast<int64_t>(threadIdx.x) * VEC; i < end;
       i += static_cast<int64_t>(kThreads) * VEC) {
    float v[VEC];
    load<T, VEC>(base + i, v);
    int8_t r[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) r[k] = quantized(v[k], d);
    store_q<VEC>(out + i, r);
  }
}

template <typename T, int VEC>
int launch(const void* x, int64_t rows, int64_t cols, int64_t row_stride, int8_t* q,
           float* scales, unsigned* amax_bits, float eps, cudaStream_t s) {
  const int64_t chunks = (cols + kChunk - 1) / kChunk;
  const int64_t blocks = rows * chunks;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaMemsetAsync(amax_bits, 0, rows * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* xt = static_cast<const T*>(x);
  absmax_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      xt, cols, row_stride, chunks, amax_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      xt, cols, row_stride, chunks, amax_bits, eps, q, scales);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte loads where every row starts 16-byte aligned and holds whole vectors.
template <typename T>
int dispatch(const void* x, int64_t rows, int64_t cols, int64_t row_stride, int8_t* q,
             float* scales, unsigned* amax_bits, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && cols % kVec == 0 &&
                       row_stride % kVec == 0;
  return aligned ? launch<T, kVec>(x, rows, cols, row_stride, q, scales, amax_bits, eps, s)
                 : launch<T, 1>(x, rows, cols, row_stride, q, scales, amax_bits, eps, s);
}

// ---------------------------------------------------------------------------
// One pass: a cooperative launch, waves of whole rows through shared memory
// ---------------------------------------------------------------------------

constexpr int kReducers = 128;    // threads folding the abs-max
constexpr int kQuantizers = 512;  // threads quantizing: the larger share of the work
constexpr int kOneThreads = kReducers + kQuantizers + 32;  // and one producer warp
constexpr int kBufs = 3;                         // wave buffers of a block
constexpr int kBufBytes = 72 * 1024;             // each
constexpr int kOneSmem = kBufs * kBufBytes + 16 * kBufs /* full and empty mbarriers */;

struct Waves {
  int64_t rows, cols, row_stride, rows_per_wave, count;
};

// This block's slice [c0, c1) of wave w, in the wave's flat element order
// (rows r0 .. r0 + rows_per_wave - 1 one after another); slices are equal
// multiples of VEC, so every piece of a row is 16-byte aligned.
template <int VEC>
__device__ __forceinline__ void wave_slice(const Waves& p, int64_t w, int64_t& r0, int64_t& c0,
                                           int64_t& c1) {
  r0 = w * p.rows_per_wave;
  const int64_t e = min(p.rows_per_wave, p.rows - r0) * p.cols;
  const int64_t chunk = ((e + gridDim.x - 1) / gridDim.x + VEC - 1) / VEC * VEC;
  c0 = min(e, blockIdx.x * chunk);
  c1 = min(e, c0 + chunk);
}

// The block's slice of wave w into buffer w % kBufs, one bulk copy per row
// piece, completing on that buffer's full barrier; issued by the lanes of
// the producer warp (lane 0 arrives with the slice's bytes).
template <typename T, int VEC>
__device__ __forceinline__ void load_wave(const T* x, const Waves& p, int64_t w, uint32_t dst,
                                          uint32_t full, int lane) {
  int64_t r0, c0, c1;
  wave_slice<VEC>(p, w, r0, c0, c1);
  if (lane == 0) mbar_expect_tx(full, static_cast<int>((c1 - c0) * sizeof(T)));
  if (c1 <= c0) return;
  const int64_t first = c0 / p.cols, last = (c1 - 1) / p.cols;
  for (int64_t rr = first + lane; rr <= last; rr += 32) {
    const int64_t a = max(c0, rr * p.cols), e = min(c1, (rr + 1) * p.cols);
    const T* src = x + (r0 + rr) * p.row_stride + (a - rr * p.cols);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(dst + static_cast<uint32_t>((a - c0) * sizeof(T))),
        "l"(reinterpret_cast<uint64_t>(src)), "r"(static_cast<uint32_t>((e - a) * sizeof(T))),
        "r"(full)
        : "memory");
  }
}

// For each piece of a row in this block's slice: fn(row within the wave,
// first and end element of the piece in the buffer, first element of the
// row in the buffer, the thread's lane in its group, the group's size),
// over the N threads of one role (`t` is the thread's index there).  A
// piece is walked by a group: the whole role where rows are long, a warp
// where they are short, so every warp is in one group and takes its pieces
// in step.
template <int VEC, int N, typename Fn>
__device__ __forceinline__ void for_pieces(const Waves& p, int64_t c0, int64_t c1, int t, Fn fn) {
  if (c1 <= c0) return;
  const int group = p.cols / VEC >= N ? N : 32;
  const int64_t first = c0 / p.cols, pieces = (c1 - 1) / p.cols - first + 1;
  for (int64_t k = t / group; k < pieces; k += N / group) {
    const int64_t rr = first + k;
    const int64_t row_start = rr * p.cols - c0;
    fn(rr, static_cast<int>(max(row_start, int64_t{0})),
       static_cast<int>(min(c1 - c0, row_start + p.cols)), row_start, t % group, group);
  }
}

// the N threads of one role (named barrier `id`; 0 is __syncthreads's)
template <int N>
__device__ __forceinline__ void role_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N) : "memory");
}

// Warp-specialized and software-pipelined over waves of whole rows, three
// buffers deep: the producer warp loads wave w + 2 while the reducers fold
// wave w + 1's abs-max into the row slots and count it on the wave's grid
// counter, and the quantizers quantize wave w, whose counter every block
// reached a step earlier, so no role waits on another's latencies (the
// grid-wide wait, the fence before a count, a scale's load from L2).
template <typename T, int VEC>
__global__ void __launch_bounds__(kOneThreads, 1)
quantize_onepass_kernel(const T* __restrict__ x, Waves p, unsigned* __restrict__ amax_bits,
                        float eps, int8_t* __restrict__ q, float* __restrict__ scales) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bufs = smem_u32(smem), bars = bufs + kBufs * kBufBytes;
  auto full = [&](int64_t w) { return bars + 8 * static_cast<uint32_t>(w % kBufs); };
  auto empty = [&](int64_t w) { return bars + 8 * static_cast<uint32_t>(kBufs + w % kBufs); };
  auto buffer = [&](int64_t w) { return reinterpret_cast<const T*>(smem + (w % kBufs) * kBufBytes); };
  unsigned* arrived = amax_bits + p.rows;  // one grid counter a wave, after the row slots

  if (threadIdx.x == 0) {
    for (int b = 0; b < kBufs; ++b) {
      mbar_init(full(b), 1);
      mbar_init(empty(b), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < p.rows + p.count; i += static_cast<int64_t>(gridDim.x) * blockDim.x)
    amax_bits[i] = 0u;
  cooperative_groups::this_grid().sync();  // barriers set up; slots and counters zeroed everywhere

  if (threadIdx.x >= kReducers + kQuantizers) {  // producer: keep the three buffers loading
    const int lane = threadIdx.x % 32;
    for (int64_t w = 0; w < p.count; ++w) {
      if (w >= kBufs) mbar_wait(empty(w), static_cast<int>((w / kBufs - 1) & 1));
      load_wave<T, VEC>(x, p, w, bufs + static_cast<uint32_t>(w % kBufs) * kBufBytes, full(w),
                        lane);
    }
  } else if (threadIdx.x < kReducers) {  // reducers: each wave's abs-max folded, then counted
    const int t = threadIdx.x;
    for (int64_t w = 0; w < p.count; ++w) {
      int64_t r0, c0, c1;
      wave_slice<VEC>(p, w, r0, c0, c1);
      const T* s = buffer(w);
      mbar_wait(full(w), static_cast<int>((w / kBufs) & 1));
      for_pieces<VEC, kReducers>(p, c0, c1, t, [&](int64_t rr, int a, int e, int64_t, int lane,
                                                   int group) {
        float m = 0.0f;
        for (int i = a + lane * VEC; i < e; i += group * VEC) {
          float v[VEC];
          load<T, VEC>(s + i, v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) m = fmaxf(m, fabsf(v[k]));
        }
        const unsigned bits = __reduce_max_sync(0xffffffffu, __float_as_uint(m));
        if (t % 32 == 0 && bits != 0u) atomicMax(amax_bits + r0 + rr, bits);
      });
      role_sync<kReducers>(1);  // every fold of this block is issued
      if (t == 0) {
        __threadfence();
        atomicAdd(arrived + w, 1u);
      }
    }
  } else {  // quantizers: each wave once every block has counted it
    const int t = threadIdx.x - kReducers;
    for (int64_t w = 0; w < p.count; ++w) {
      if (t == 0) {
        unsigned seen;
        do {
          asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                       : "=r"(seen) : "l"(arrived + w) : "memory");
        } while (seen < gridDim.x);
      }
      role_sync<kQuantizers>(2);
      mbar_wait(full(w), static_cast<int>((w / kBufs) & 1));  // the copy's writes, seen here too
      int64_t r0, c0, c1;
      wave_slice<VEC>(p, w, r0, c0, c1);
      const T* s = buffer(w);
      int8_t* qw = q + r0 * p.cols + c0;  // the wave's rows are contiguous in q
      for_pieces<VEC, kQuantizers>(p, c0, c1, t, [&](int64_t rr, int a, int e,
                                                     int64_t row_start, int lane, int group) {
        const float scale = scale_of(__ldcg(amax_bits + r0 + rr), eps);  // L2: folded by atomics
        const Divisor d = divisor(scale);
        if (lane == 0 && row_start >= 0) scales[r0 + rr] = scale;
        for (int i = a + lane * VEC; i < e; i += group * VEC) {
          float v[VEC];
          load<T, VEC>(s + i, v);
          int8_t r[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) r[k] = quantized(v[k], d);
          store_q<VEC>(qw + i, r);
        }
      });
      role_sync<kQuantizers>(2);  // buffer w % kBufs is read for the last time
      if (t == 0) mbar_arrive(empty(w));
    }
  }
}

template <typename T>
int launch_onepass(const void* x, const Waves& p, int grid, int8_t* q, float* scales,
                   unsigned* scratch, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t row_bytes = p.cols * static_cast<int64_t>(sizeof(T));
  const int64_t chunk = ((p.rows_per_wave * p.cols + grid - 1) / grid + kVec - 1) / kVec * kVec;
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 || row_bytes % 16 != 0 ||
      (p.rows > 1 && p.row_stride * static_cast<int64_t>(sizeof(T)) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (grid < 1 || p.rows_per_wave < 1 || chunk * static_cast<int64_t>(sizeof(T)) > kBufBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = quantize_onepass_kernel<T, kVec>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kOneSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kOneThreads, kOneSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid > sms * per_sm) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const T* xt = static_cast<const T*>(x);
  Waves pw = p;
  void* args[] = {&xt, &pw, &scratch, &eps, &q, &scales};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                                      dim3(grid), dim3(kOneThreads), args,
                                                      kOneSmem, s));
}

}  // namespace

// Two passes.  in_dtype: 0 = float32, 1 = float16, 2 = bfloat16.  x holds `rows` rows of
// `cols` contiguous elements, `row_stride` elements apart; q is (rows, cols)
// int8, scales (rows,) float32, scratch (rows,) 32-bit words (zeroed here).
// Returns the CUDA error of the launches (0 = launched).
NNS_EXPORT int nns_quantize_i8(const void* x, int in_dtype, int64_t rows, int64_t cols,
                               int64_t row_stride, void* q, void* scales, void* scratch,
                               float eps, void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qi = static_cast<int8_t*>(q);
  auto* sc = static_cast<float*>(scales);
  auto* bits = static_cast<unsigned*>(scratch);
  switch (in_dtype) {
    case 0: return dispatch<float>(x, rows, cols, row_stride, qi, sc, bits, eps, s);
    case 1: return dispatch<__half>(x, rows, cols, row_stride, qi, sc, bits, eps, s);
    case 2: return dispatch<__nv_bfloat16>(x, rows, cols, row_stride, qi, sc, bits, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One pass: the arguments of nns_quantize_i8, and the plan of
// ops/quantize.py quantize_plan: waves of `rows_per_wave` rows over `grid`
// co-resident blocks; scratch holds rows + ceil(rows / rows_per_wave)
// 32-bit words (zeroed here).  x's base, row bytes and row stride in bytes
// must be multiples of 16, and a block's slice of a wave must fit its
// buffer.  Returns the CUDA error of the launch (0 = launched).
NNS_EXPORT int nns_quantize_i8_onepass(const void* x, int in_dtype, int64_t rows, int64_t cols,
                                       int64_t row_stride, int64_t rows_per_wave, int grid,
                                       void* q, void* scales, void* scratch, float eps,
                                       void* stream) {
  if (rows <= 0) return 0;
  if (rows_per_wave < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Waves p{rows, cols, row_stride, rows_per_wave, (rows + rows_per_wave - 1) / rows_per_wave};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* qi = static_cast<int8_t*>(q);
  auto* sc = static_cast<float*>(scales);
  auto* bits = static_cast<unsigned*>(scratch);
  switch (in_dtype) {
    case 0: return launch_onepass<float>(x, p, grid, qi, sc, bits, eps, s);
    case 1: return launch_onepass<__half>(x, p, grid, qi, sc, bits, eps, s);
    case 2: return launch_onepass<__nv_bfloat16>(x, p, grid, qi, sc, bits, eps, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
