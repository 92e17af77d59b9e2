// K5 and K4: exact MaxSim of bf16 queries over the tile-major corpus, the
// store held in bf16 (K5) or in int8 with per-token scales (K4); K8 and K9:
// the same over the token-major corpus.
//
// Replaces colpali_tpu/ops/maxsim_pallas.py::maxsim_pallas_tiled (K5),
// ::maxsim_pallas_int8_tiled (K4), ::maxsim_pallas_tm (K8) and
// ::maxsim_pallas_int8_tm (K9), which share _maxsim_body. Queries are
// (B, Nq, D) bf16, the corpus is tile-major (n_tiles, Np, 128, D) or
// token-major (Np, n_tiles * 128, D):
//
//   out[b, c] = sum_i max_t (q[b, i] . doc[c, t])      bf16 products, fp32 sums
//
// K4 takes doc[c, t] = bf16(bf16(int8 value) * bf16(scale[c, t])): the
// dequantized token is rounded to bf16 before the product, as on the TPU, so
// that rounding is part of the function. Zero-padded doc tokens take part in
// the max with similarity 0, as in JAX and in the plain versions.
//
// What bounds it on an H100: at B = 1 the bytes of the store (each read
// once); from about B * Nq = 256 query rows on, the bf16 tensor cores
// (2 * B * Nq * C * Np * D operations).
//
// Design: one template over the store's type. A CTA of four warps owns one
// 128-doc tile and a group of whole queries of up to 64 token rows in all
// (two queries of 32 tokens, one of 64; a longer query is walked in chunks
// of 64 rows). CTAs of one tile are neighbours in the grid, so the tile's
// re-reads come from L2. The CTA stages its query rows in shared memory,
// then streams the tile one doc token at a time: the token's (128 docs, D)
// block, contiguous in device memory, is copied (K5) or dequantized (K4)
// into a padded shared tile, and each warp multiplies the 64 query rows with
// its 32 docs by mma.sync m16n8k16 (bf16 in, fp32 accumulators), folding the
// result into a running max held in registers. After the last token the
// maxima go to shared memory and thread c sums the rows of each query for
// doc c, in row order, so the result does not depend on scheduling. D is a
// run-time multiple of 16. Offsets are 64-bit: a store passes 2^31 bytes.
//
// Layouts: both keep one doc token of a 128-doc tile as 128 contiguous rows
// of D; only where that block starts differs. Its first row is
// tile * tile_stride + t * token_stride: (Np * 128, 128) tile-major,
// (128, C) token-major, and the scales follow the same two strides. So the
// token-major kernels are this template with the other pair of strides and
// give bit for bit the tile-major scores on the same data; only the token
// blocks of a tile now lie C * D bytes apart instead of side by side.
//
// Not yet done here (later work): cp.async double buffering of the token
// blocks, wgmma, and keeping the query fragments in registers.

#include <math_constants.h>

#include "mma.cuh"

namespace {

constexpr int kRows = 64;      // query-token rows per chunk: 4 m-tiles
constexpr int kThreads = 128;  // 4 warps x 32 docs
constexpr int kMaxLd = DOC_TILE + 4;  // row stride of the maxima in shared memory

// 8 consecutive dims of one doc token as bf16
__device__ __forceinline__ int4 load_dims(const __nv_bfloat16* store, int64_t offset, float) {
  return *reinterpret_cast<const int4*>(store + offset);
}

__device__ __forceinline__ int4 load_dims(const int8_t* store, int64_t offset, float scale) {
  const int2 raw = *reinterpret_cast<const int2*>(store + offset);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  int4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i)  // int8 -> bf16 is exact; a product of two bf16 is exact in fp32
    o[i] = pack_bf16(static_cast<float>(b[2 * i]) * scale, static_cast<float>(b[2 * i + 1]) * scale);
  return out;
}

template <typename StoreT>
__global__ void __launch_bounds__(kThreads)
    maxsim_tiled_kernel(const __nv_bfloat16* __restrict__ q,  // (B * Nq, D)
                        const StoreT* __restrict__ store,     // (nt, Np, 128, D)
                        const float* __restrict__ scales,     // (nt, Np, 128); unused for a bf16 store
                        float* __restrict__ out,              // (B, nt * 128)
                        int b, int nq, int np_, int d, int queries_per_cta, int groups, int64_t n_tiles,
                        int64_t tile_stride, int64_t token_stride) {  // in rows of D: see Layouts above
  const int ld = d + 8, vec = d / 8;
  extern __shared__ int4 smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (kRows, ld)
  __nv_bfloat16* s_d = s_q + kRows * ld;                              // (128, ld), later the maxima (kRows, kMaxLd)
  float* s_max = reinterpret_cast<float*>(s_d);
  const size_t tile_bytes = static_cast<size_t>(DOC_TILE) * ld * sizeof(__nv_bfloat16);
  const size_t max_bytes = static_cast<size_t>(kRows) * kMaxLd * sizeof(float);
  float* s_out = reinterpret_cast<float*>(reinterpret_cast<char*>(s_d) +
                                          (tile_bytes > max_bytes ? tile_bytes : max_bytes));  // (queries, 128)

  const int64_t tile = blockIdx.x / groups;
  const int b0 = static_cast<int>(blockIdx.x % groups) * queries_per_cta;
  const int b1 = min(b, b0 + queries_per_cta);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int r_end = b1 * nq;

  for (int i = 0; i < b1 - b0; ++i) s_out[i * DOC_TILE + tid] = 0.0f;

  for (int r0 = b0 * nq; r0 < r_end; r0 += kRows) {
    __syncthreads();  // the previous chunk's maxima are summed
    for (int e = tid; e < kRows * vec; e += kThreads) {
      const int r = e / vec, c = (e % vec) * 8;
      int4 val = make_int4(0, 0, 0, 0);
      if (r0 + r < r_end) val = *reinterpret_cast<const int4*>(q + static_cast<int64_t>(r0 + r) * d + c);
      *reinterpret_cast<int4*>(s_q + r * ld + c) = val;
    }

    float mx[4][4][4];  // [m-tile][n-tile][fragment]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) mx[i][j][0] = mx[i][j][1] = mx[i][j][2] = mx[i][j][3] = -CUDART_INF_F;

    for (int t = 0; t < np_; ++t) {
      const int64_t token = tile * tile_stride + t * token_stride;  // first doc row of this token block
      __syncthreads();  // the previous block is consumed (and the query rows stored)
      for (int e = tid; e < DOC_TILE * vec; e += kThreads) {
        const int r = e / vec, c = (e % vec) * 8;
        const float scale = sizeof(StoreT) == 1 ? __bfloat162float(__float2bfloat16_rn(scales[token + r])) : 1.0f;
        *reinterpret_cast<int4*>(s_d + r * ld + c) = load_dims(store, (token + r) * d + c, scale);
      }
      __syncthreads();

      float acc[4][4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
      for (int kk = 0; kk < d; kk += 16) {
        uint32_t a[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat16* pa = s_q + (i * 16 + g) * ld + kk + 2 * tg;
          a[i][0] = ld_pair(pa);
          a[i][1] = ld_pair(pa + 8 * ld);
          a[i][2] = ld_pair(pa + 8);
          a[i][3] = ld_pair(pa + 8 * ld + 8);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat16* pb = s_d + (warp * 32 + j * 8 + g) * ld + kk + 2 * tg;
          const uint32_t b0f = ld_pair(pb), b1f = ld_pair(pb + 8);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_bf16(acc[i][j], a[i][0], a[i][1], a[i][2], a[i][3], b0f, b1f);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[i][j][e] = fmaxf(mx[i][j][e], acc[i][j][e]);
    }

    __syncthreads();  // every warp is done with the last token block
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float* p = s_max + (i * 16 + g) * kMaxLd + warp * 32 + j * 8 + 2 * tg;
        *reinterpret_cast<float2*>(p) = make_float2(mx[i][j][0], mx[i][j][1]);
        *reinterpret_cast<float2*>(p + 8 * kMaxLd) = make_float2(mx[i][j][2], mx[i][j][3]);
      }
    __syncthreads();
    const int rows = min(kRows, r_end - r0);
    for (int r = 0; r < rows; ++r) s_out[((r0 + r) / nq - b0) * DOC_TILE + tid] += s_max[r * kMaxLd + tid];
  }

  const int64_t c_total = n_tiles * DOC_TILE;
  for (int i = 0; i < b1 - b0; ++i) out[(b0 + i) * c_total + tile * DOC_TILE + tid] = s_out[i * DOC_TILE + tid];
}

template <typename StoreT>
cudaError_t launch(const void* q, const void* store, const void* scales, void* out, int b, int nq, int np_, int d,
                   int64_t n_tiles, bool token_major, cudaStream_t stream) {
  if (d % 16 != 0 || d <= 0 || nq <= 0) return cudaErrorInvalidValue;
  const int queries_per_cta = nq >= kRows ? 1 : kRows / nq;
  const int groups = (b + queries_per_cta - 1) / queries_per_cta;
  const size_t ld = d + 8;
  const size_t tile_bytes = DOC_TILE * ld * sizeof(__nv_bfloat16);
  const size_t max_bytes = static_cast<size_t>(kRows) * kMaxLd * sizeof(float);
  const size_t smem = kRows * ld * sizeof(__nv_bfloat16) + (tile_bytes > max_bytes ? tile_bytes : max_bytes) +
                      static_cast<size_t>(queries_per_cta) * DOC_TILE * sizeof(float);
  cudaError_t err = colpali_allow_smem(maxsim_tiled_kernel<StoreT>, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = n_tiles * groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int64_t tile_stride = token_major ? DOC_TILE : static_cast<int64_t>(np_) * DOC_TILE;
  const int64_t token_stride = token_major ? n_tiles * DOC_TILE : DOC_TILE;
  maxsim_tiled_kernel<StoreT><<<static_cast<unsigned int>(blocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const StoreT*>(store), static_cast<const float*>(scales),
      static_cast<float*>(out), b, nq, np_, d, queries_per_cta, groups, n_tiles, tile_stride, token_stride);
  return cudaGetLastError();
}

}  // namespace

// K5: q (B, Nq, D) bf16, store (n_tiles, Np, 128, D) bf16 -> out (B, n_tiles * 128) fp32.
extern "C" int colpali_maxsim_bf16(const void* q, const void* store, void* out, int b, int nq, int np_, int d,
                                   int64_t n_tiles, void* stream) {
  return launch<__nv_bfloat16>(q, store, nullptr, out, b, nq, np_, d, n_tiles, false,
                               static_cast<cudaStream_t>(stream));
}

// K4: the same over an int8 store with (n_tiles, Np, 128) fp32 scales.
extern "C" int colpali_maxsim_int8_bf16(const void* q, const void* store, const void* scales, void* out, int b,
                                        int nq, int np_, int d, int64_t n_tiles, void* stream) {
  return launch<int8_t>(q, store, scales, out, b, nq, np_, d, n_tiles, false, static_cast<cudaStream_t>(stream));
}

// K8: K5 over a token-major store (Np, n_tiles * 128, D) bf16.
extern "C" int colpali_maxsim_bf16_tm(const void* q, const void* store, void* out, int b, int nq, int np_, int d,
                                      int64_t n_tiles, void* stream) {
  return launch<__nv_bfloat16>(q, store, nullptr, out, b, nq, np_, d, n_tiles, true,
                               static_cast<cudaStream_t>(stream));
}

// K9: K4 over a token-major int8 store (Np, n_tiles * 128, D) with (Np, n_tiles * 128) fp32 scales.
extern "C" int colpali_maxsim_int8_bf16_tm(const void* q, const void* store, const void* scales, void* out, int b,
                                           int nq, int np_, int d, int64_t n_tiles, void* stream) {
  return launch<int8_t>(q, store, scales, out, b, nq, np_, d, n_tiles, true, static_cast<cudaStream_t>(stream));
}
