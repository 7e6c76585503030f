// int8_dwconv: direct depthwise int8 convolution (groups == C == O), int32
// accumulation, with the int8 path's rescale epilogue.
//
// Stands for nnstreamer_tpu/ops/quantize.py int8_conv with
// feature_group_count == C (plain XLA, no Pallas kernel): the 3 x 3
// depthwise layers of MobileNet-v2 (17) and of SSD-MobileNet-v2's trunk.
//
// Bound by memory: each output reads kh * kw int8 inputs that its
// neighbours share and does 2 * kh * kw integer operations, far under the
// card's 295 operations per byte, so the kernel only has to read the NHWC
// input from device memory once and write the output once.  Work items are
// (channel tile of 16..128 channels, image, band of output rows, band of
// output columns), chosen by ops/quantize.py int8_dwconv_plan before the
// launch; persistent blocks walk them.  A block stages an item's input rows
// and columns, halo included, in shared memory: with C % 16 == 0 and a
// 16-byte aligned base by one TMA load of a 4-D (C, W, H, N) box whose
// corner is (c0, wo0 * stride - pad_left, ho0 * stride - pad_top, n) (TMA
// fills coordinates outside the tensor, negative ones too, with zeros:
// exactly the SAME padding), otherwise by copies of 8, 4 or 1 bytes with
// the padding zero-filled.  Two boxes: the next item's load is issued
// before this item's products.  The weights of a channel tile sit in shared
// memory as words of 4 taps of one channel (zero past kw and past C).  Each
// thread computes 16 channels of 4 neighbouring output pixels of a row from
// 16-byte vectors: a 4 x 4 byte transpose (8 byte permutes) turns 4 taps'
// vectors into a word of 4 taps per channel, and dp4a multiplies and adds
// it, so an instruction does a product.  The outputs go out as 16-byte runs
// of a pixel's channels.
//
// Numerics: the accumulator is exact; the epilogue is the one of
// int8_conv.cu (rescale = s_x * s_w, then float(acc) * rescale, each
// rounded once, then a round-to-nearest-even cast); out code 3 writes the
// raw int32 accumulator.  Bit-exact against the plain version.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "int8_epilogue.cuh"
#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;  // output pixels along W a thread computes

struct Shape {
  int n, h, w, c, kh, kw, stride, ho, wo, pad_top, pad_left;
  int tile_c, rows, tile_w;  // an item: channels, output rows, output columns
  int in_rows, in_cols;      // its input box, halo included
  int groups4;               // words of 4 taps a kernel row: ceil(kw / 4)
  int c_tiles, bands, w_tiles, items;
  int chunk;  // 16: the box by TMA; 8, 4 or 1: copies of that many bytes
  int buf_bytes;
};

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int w0, int h0, int n0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, "
      "%4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(w0), "r"(h0), "r"(n0)
      : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src), "n"(BYTES),
               "r"(valid ? BYTES : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct Item {
  int ct, img, band, wt;
};

// item -> (channel tile, column band, row band, image), the channel tile
// fastest: blocks running together read neighbouring channels of the same
// pixels, so a DRAM sector split between two tiles is read once
__device__ __forceinline__ Item decode(const Shape& s, int item) {
  Item it;
  int rest = item / s.c_tiles;
  it.ct = item - rest * s.c_tiles;
  int next = rest / s.w_tiles;
  it.wt = rest - next * s.w_tiles;
  rest = next / s.bands;
  it.band = next - rest * s.bands;
  it.img = rest;
  return it;
}

// Without TMA: every thread copies pieces of the item's box, [row][col][c]
// with tile_c bytes a pixel, zeros outside the image and past C.
template <int CHUNK>
__device__ __forceinline__ void copy_box(const Shape& s, const int8_t* __restrict__ x,
                                         unsigned char* buf, const Item& it) {
  const int hi0 = it.band * s.rows * s.stride - s.pad_top;
  const int wi0 = it.wt * s.tile_w * s.stride - s.pad_left, c0 = it.ct * s.tile_c;
  const int vecs = s.tile_c / CHUNK, total = s.in_rows * s.in_cols * vecs;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int v = i % vecs, pix = i / vecs;
    const int col = pix % s.in_cols, row = pix / s.in_cols;
    const int hi = hi0 + row, wi = wi0 + col, c = c0 + v * CHUNK;
    const bool ok = static_cast<unsigned>(hi) < static_cast<unsigned>(s.h) &&
                    static_cast<unsigned>(wi) < static_cast<unsigned>(s.w) && c < s.c;
    const int8_t* src =
        ok ? x + ((static_cast<int64_t>(it.img) * s.h + hi) * s.w + wi) * s.c + c : x;
    unsigned char* dst = buf + pix * s.tile_c + v * CHUNK;
    if constexpr (CHUNK == 1) {
      *dst = ok ? static_cast<unsigned char>(*src) : 0;
    } else {
      cp_async<CHUNK>(smem_u32(dst), src, ok);
    }
  }
}

template <bool kTma, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks an SM: 128 registers a thread
int8_dwconv_kernel(const __grid_constant__ CUtensorMap x_map, const int8_t* __restrict__ x,
                   const float* __restrict__ sx, const int8_t* __restrict__ w,
                   const float* __restrict__ sw, OutT* __restrict__ out, Shape s) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // two boxes of buf_bytes (a multiple of 128), 128-byte aligned for TMA
  unsigned char* bufs = smem_raw + (128 - smem_u32(smem_raw) % 128) % 128;
  // every channel's weights as words of 4 taps, [kh][groups4][cp], then
  // the scales [cp], cp = c_tiles * tile_c: loaded once a block
  const int cp = s.c_tiles * s.tile_c;
  int* wsm = reinterpret_cast<int*>(bufs + 2 * s.buf_bytes);
  float* ssm = reinterpret_cast<float*>(wsm + s.kh * s.groups4 * cp);
  // the weights as they are, (C, kh, kw) bytes, copied in 16-byte vectors
  // where they allow it: then packed from shared memory
  const int wbytes = s.c * s.kh * s.kw;
  unsigned char* wraw = reinterpret_cast<unsigned char*>(ssm + cp);
  const uint32_t bars = (smem_u32(wraw + (wbytes + 15) / 16 * 16) + 7) & ~7u;
  auto buf = [&](int b) { return bufs + b * s.buf_bytes; };
  const int box_bytes = s.in_rows * s.in_cols * s.tile_c;

  auto fill = [&](int item, int b) {
    const Item it = decode(s, item);
    if constexpr (kTma) {
      if (threadIdx.x == 0) {
        mbar_expect_tx(bars + 8 * b, box_bytes);  // zero-filled bytes count too
        tma_load_4d(smem_u32(buf(b)), &x_map, bars + 8 * b, it.ct * s.tile_c,
                    it.wt * s.tile_w * s.stride - s.pad_left,
                    it.band * s.rows * s.stride - s.pad_top, it.img);
      }
    } else {
      if (s.chunk == 8) {
        copy_box<8>(s, x, buf(b), it);
      } else if (s.chunk == 4) {
        copy_box<4>(s, x, buf(b), it);
      } else {
        copy_box<1>(s, x, buf(b), it);
      }
      cp_async_commit();
    }
  };

  if (blockIdx.x >= s.items) return;
  if (kTma && threadIdx.x == 0) {
    mbar_init(bars, 1);
    mbar_init(bars + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  fill(blockIdx.x, 0);
  if (reinterpret_cast<uintptr_t>(w) % 16 == 0 && wbytes % 16 == 0) {
    for (int i = threadIdx.x; i < wbytes / 16; i += kThreads)
      reinterpret_cast<uint4*>(wraw)[i] = reinterpret_cast<const uint4*>(w)[i];
  } else {
    for (int i = threadIdx.x; i < wbytes; i += kThreads) wraw[i] = static_cast<unsigned char>(w[i]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s.kh * s.groups4 * cp; i += kThreads) {
    const int c = i % cp, t = i / cp, g = t % s.groups4, ki = t / s.groups4;
    uint32_t word = 0;
    if (c < s.c) {
      const unsigned char* wr = wraw + (c * s.kh + ki) * s.kw;
      for (int j = 0; j < 4 && 4 * g + j < s.kw; ++j)
        word |= static_cast<uint32_t>(wr[4 * g + j]) << (8 * j);
    }
    wsm[i] = static_cast<int>(word);
  }
  for (int i = threadIdx.x; i < cp; i += kThreads) ssm[i] = i < s.c ? sw[i] : 0.0f;

  const int cgs = s.tile_c / 16, pws = (s.tile_w + kPix - 1) / kPix;
  const int units = s.rows * pws * cgs;
  const bool vec_out = s.c * sizeof(OutT) % 16 == 0;
  for (int item = blockIdx.x, n = 0; item < s.items; item += gridDim.x, ++n) {
    const int b = n & 1;
    const bool more = item + static_cast<int>(gridDim.x) < s.items;
    if (more) fill(item + gridDim.x, b ^ 1);  // its box was freed by the last sync
    const Item it = decode(s, item);
    const int c0 = it.ct * s.tile_c;
    if constexpr (kTma) {
      mbar_wait(bars + 8 * b, (n >> 1) & 1);
    } else if (more) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of the box (and, first, the weights)

    const unsigned char* box = buf(b);
    const float sxi = sx[it.img];
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const int cg = u % cgs, t = u / cgs, pw = t % pws, r = t / pws;
      const int oh = it.band * s.rows + r;
      if (oh >= s.ho) continue;
      int acc[kPix][16];
#pragma unroll
      for (int p = 0; p < kPix; ++p)
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[p][e] = 0;
      for (int i = 0; i < s.kh; ++i) {
        const unsigned char* row = box + (r * s.stride + i) * s.in_cols * s.tile_c + cg * 16;
        for (int g = 0; g < s.groups4; ++g) {
          int wv[16];
          const int4* wp =
              reinterpret_cast<const int4*>(wsm + (i * s.groups4 + g) * cp + c0 + cg * 16);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int4 v = wp[q];
            wv[4 * q] = v.x, wv[4 * q + 1] = v.y, wv[4 * q + 2] = v.z, wv[4 * q + 3] = v.w;
          }
          const int taps = min(4, s.kw - 4 * g);
#pragma unroll
          for (int p = 0; p < kPix; ++p) {
            const unsigned char* px = row + ((pw * kPix + p) * s.stride + 4 * g) * s.tile_c;
            uint4 v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = j < taps ? *reinterpret_cast<const uint4*>(px + j * s.tile_c)
                              : make_uint4(0, 0, 0, 0);
            const uint32_t xs[4][4] = {{v[0].x, v[1].x, v[2].x, v[3].x},
                                       {v[0].y, v[1].y, v[2].y, v[3].y},
                                       {v[0].z, v[1].z, v[2].z, v[3].z},
                                       {v[0].w, v[1].w, v[2].w, v[3].w}};
#pragma unroll
            for (int a = 0; a < 4; ++a) {  // channels 4a .. 4a + 3: taps as bytes of a word
              const uint32_t t0 = __byte_perm(xs[a][0], xs[a][1], 0x5140);
              const uint32_t t1 = __byte_perm(xs[a][0], xs[a][1], 0x7362);
              const uint32_t t2 = __byte_perm(xs[a][2], xs[a][3], 0x5140);
              const uint32_t t3 = __byte_perm(xs[a][2], xs[a][3], 0x7362);
              acc[p][4 * a] = __dp4a(static_cast<int>(__byte_perm(t0, t2, 0x5410)), wv[4 * a],
                                     acc[p][4 * a]);
              acc[p][4 * a + 1] = __dp4a(static_cast<int>(__byte_perm(t0, t2, 0x7632)),
                                         wv[4 * a + 1], acc[p][4 * a + 1]);
              acc[p][4 * a + 2] = __dp4a(static_cast<int>(__byte_perm(t1, t3, 0x5410)),
                                         wv[4 * a + 2], acc[p][4 * a + 2]);
              acc[p][4 * a + 3] = __dp4a(static_cast<int>(__byte_perm(t1, t3, 0x7632)),
                                         wv[4 * a + 3], acc[p][4 * a + 3]);
            }
          }
        }
      }
      const int cbase = c0 + cg * 16;
      const float* swp = ssm + cbase;
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        const int col = pw * kPix + p, ow = it.wt * s.tile_w + col;
        if (col >= s.tile_w || ow >= s.wo) continue;
        __align__(16) OutT v[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) v[e] = rescaled<OutT>(acc[p][e], sxi, swp[e]);
        OutT* dst = out + ((static_cast<int64_t>(it.img) * s.ho + oh) * s.wo + ow) * s.c + cbase;
        if (vec_out && cbase + 16 <= s.c) {
#pragma unroll
          for (int q = 0; q < static_cast<int>(sizeof(v) / 16); ++q)
            reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(v)[q];
        } else {
          for (int e = 0; e < 16 && cbase + e < s.c; ++e) dst[e] = v[e];
        }
      }
    }
    __syncthreads();  // the box is free for the next item but one
  }
}

// A 4-D (C, W, H, N) tensor map of an NHWC int8 tensor: boxes of tile_c x
// in_cols x in_rows x 1, no swizzle, zero fill outside the tensor
bool make_map_4d(CUtensorMap* map, const void* ptr, const Shape& s) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(s.c), static_cast<cuuint64_t>(s.w),
                              static_cast<cuuint64_t>(s.h), static_cast<cuuint64_t>(s.n)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.c),
                                 static_cast<cuuint64_t>(s.w) * s.c,
                                 static_cast<cuuint64_t>(s.h) * s.w * s.c};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(s.tile_c), static_cast<cuuint32_t>(s.in_cols),
                             static_cast<cuuint32_t>(s.in_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int dwconv_smem(const Shape& s) {
  const int cp = s.c_tiles * s.tile_c;
  return 128 /* alignment slack */ + 2 * s.buf_bytes + (s.kh * s.groups4 + 1) * cp * 4 +
         (s.c * s.kh * s.kw + 15) / 16 * 16 + 24 /* barriers */;
}

template <bool kTma, typename OutT>
int launch(const CUtensorMap& map, const void* x, const void* sx, const void* w, const void* sw,
           void* out, const Shape& s, cudaStream_t stream) {
  const auto kernel = int8_dwconv_kernel<kTma, OutT>;
  const int smem = dwconv_smem(s);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = std::min(s.items, sms * per_sm);
  int8_dwconv_kernel<kTma, OutT><<<blocks, kThreads, smem, stream>>>(
      map, static_cast<const int8_t*>(x), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w), static_cast<const float*>(sw), static_cast<OutT*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int by_load(const CUtensorMap& map, const void* x, const void* sx, const void* w, const void* sw,
            void* out, const Shape& s, cudaStream_t stream) {
  return s.chunk == 16 ? launch<true, OutT>(map, x, sx, w, sw, out, s, stream)
                       : launch<false, OutT>(map, x, sx, w, sw, out, s, stream);
}

}  // namespace

// x: (n, h, w, c) int8 NHWC; sx: (n,) float32; w: (c, kh, kw, 1) int8;
// sw: (c,) float32; out: (n, ho, wo, c) NHWC; o must equal c.  out_dtype:
// 0 = float32, 1 = float16, 2 = bfloat16, 3 = int32 (the accumulator).
// The plan (ops/quantize.py int8_dwconv_plan): chunk (16: TMA, needing
// c % 16 == 0 and a 16-byte aligned x; 8, 4 or 1, dividing c and x's
// alignment), tile_c (a multiple of 16 up to 128), rows and tile_w output
// rows and columns an item, in_rows = (rows - 1) * stride + kh and in_cols
// = (ceil(tile_w / 4) * 4 - 1) * stride + kw (at most 256 each).  Returns
// the CUDA error of the launch (0 = launched).
NNS_EXPORT int nns_int8_dwconv(const void* x, const void* sx, const void* w, const void* sw,
                               void* out, int out_dtype, int n, int h, int wd, int c, int o,
                               int kh, int kw, int stride, int ho, int wo, int pad_top,
                               int pad_left, int chunk, int tile_c, int rows, int tile_w,
                               void* stream) {
  if (o != c || tile_c < 16 || tile_c > 128 || tile_c % 16 != 0 || rows < 1 || tile_w < 1 ||
      (chunk != 16 && chunk != 8 && chunk != 4 && chunk != 1) || c % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(x) % chunk != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (static_cast<int64_t>(n) * ho * wo * c == 0) return 0;
  Shape s{};
  s.n = n, s.h = h, s.w = wd, s.c = c, s.kh = kh, s.kw = kw, s.stride = stride;
  s.ho = ho, s.wo = wo, s.pad_top = pad_top, s.pad_left = pad_left;
  s.tile_c = tile_c, s.rows = rows, s.tile_w = tile_w, s.chunk = chunk;
  s.in_rows = (rows - 1) * stride + kh;
  s.in_cols = ((tile_w + kPix - 1) / kPix * kPix - 1) * stride + kw;
  s.groups4 = (kw + 3) / 4;
  if (s.in_rows > 256 || s.in_cols > 256) return static_cast<int>(cudaErrorInvalidValue);
  s.c_tiles = (c + tile_c - 1) / tile_c;
  s.bands = (ho + rows - 1) / rows;
  s.w_tiles = (wo + tile_w - 1) / tile_w;
  const int64_t items = static_cast<int64_t>(s.c_tiles) * n * s.bands * s.w_tiles;
  if (items > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  s.items = static_cast<int>(items);
  s.buf_bytes = (s.in_rows * s.in_cols * tile_c + 127) / 128 * 128;
  CUtensorMap map{};
  if (chunk == 16 && !make_map_4d(&map, x, s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return by_load<float>(map, x, sx, w, sw, out, s, st);
    case 1: return by_load<__half>(map, x, sx, w, sw, out, s, st);
    case 2: return by_load<__nv_bfloat16>(map, x, sx, w, sw, out, s, st);
    case 3: return by_load<int32_t>(map, x, sx, w, sw, out, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
