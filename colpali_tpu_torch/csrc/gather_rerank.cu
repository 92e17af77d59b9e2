// K2: fused candidate gather + exact rerank, the second tier of the search.
//
// Replaces colpali_tpu/ops/maxsim_pallas.py::gather_candidates_pallas
// together with the rerank in colpali_tpu/retrieval/store.py::gather_rerank.
// For each query b and candidate j with doc id i = cand[b, j]:
//
//   doc[t, :] = float(store[i / 128, t, i % 128, :]) * scales[i / 128, t, i % 128]   (int8 store)
//   doc[t, :] = float(store[i / 128, t, i % 128, :])                                 (bf16 store)
//   out[b, j] = sum_n max_t (q[b, n, :] . doc[t, :])
//
// in fp32, queries not quantized: one template over the store's type, as the
// JAX rerank takes either store. The TPU path gathers the (c, Np, D) docs
// into HBM first; here nothing but the (B, c) scores is written.
//
// What bounds it on an H100: at Np = 64 the latency of the scattered reads.
// A candidate is Np rows of D bytes, each 128 * D bytes apart in the
// tile-major store, so the c = 1024 shortlist is 8 MB of 128-byte reads
// spread over the corpus. At a full page (Np = 1,040, Nq = 64) the fp32
// products, 8.5 M FMA per candidate on the CUDA cores, outweigh its 133 KB
// (266 KB in bf16: the same products, so about the same time).
//
// Design: one block of 128 threads per (query, candidate). The block stages
// the fp32 query once (zero rows up to a multiple of kQBlock query tokens),
// then streams the candidate's doc tokens through shared memory in chunks of
// kChunk rows, dequantized (or upcast) to fp32 on the way in, so shared
// memory does not grow with Np: a full page (Np = 1,040) takes 17 chunks, the bench's Np = 64 one. Each
// thread owns a 4 x 8 register tile of dot products, query tokens tq + 16 i
// against doc tokens tt + 8 j (tq = tid / 8, tt = tid % 8), read as float4
// along D from rows padded by 4 floats: 12 conflict-free 16-byte loads feed
// 128 FMAs, where one product per thread would read two words per FMA. Each
// dot product accumulates in dimension order with fmaf. The tile's max over
// doc tokens is reduced across the 8 token lanes by warp shuffles and folded
// into a running max per query token in shared memory; the maxima are summed
// over query tokens in query order. D must be a multiple of 4. An id outside
// the store writes NaN instead of reading out of bounds. Offsets are 64-bit.

#include <cuda_bf16.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kChunk = 64;   // doc tokens per shared-memory chunk: 8 token lanes x 8
constexpr int kQBlock = 64;  // query tokens per pass over a chunk: 16 query lanes x 4

// element i of doc row `row` as fp32: an int8 value times its token's scale, or a bf16 value upcast
__device__ __forceinline__ float doc_value(const int8_t* store, const float* scales, int64_t row, int64_t i) {
  return static_cast<float>(store[i]) * scales[row];
}

__device__ __forceinline__ float doc_value(const __nv_bfloat16* store, const float*, int64_t, int64_t i) {
  return __bfloat162float(store[i]);
}

template <typename StoreT>
__global__ void __launch_bounds__(128)
    gather_rerank_kernel(const float* __restrict__ q,        // (B, Nq, D)
                         const StoreT* __restrict__ store,   // (nt, Np, 128, D)
                         const float* __restrict__ scales,   // (nt, Np, 128); unused for a bf16 store
                         const int32_t* __restrict__ cand,   // (B, c)
                         float* __restrict__ out,            // (B, c)
                         int nq, int c, int np_, int d, int64_t n_tiles) {
  extern __shared__ int4 smem_raw[];
  const int ld = d + 4;
  const int nq_pad = (nq + kQBlock - 1) / kQBlock * kQBlock;
  float* s_doc = reinterpret_cast<float*>(smem_raw);  // (kChunk, ld)
  float* s_q = s_doc + kChunk * ld;                   // (nq_pad, ld)
  float* s_best = s_q + nq_pad * ld;                  // (nq_pad) running max over doc tokens
  const int64_t pair = blockIdx.x;
  const int64_t bi = pair / c;
  const int tid = threadIdx.x;
  const int64_t id = cand[pair];
  if (id < 0 || id >= n_tiles * DOC_TILE) {
    if (tid == 0) out[pair] = __int_as_float(0x7fc00000);  // NaN
    return;
  }
  const int64_t tile = id / DOC_TILE;
  const int64_t lane = id % DOC_TILE;
  const int tq = tid >> 3, tt = tid & 7;

  for (int e = tid; e < nq_pad * d; e += blockDim.x) {
    const int n = e / d;
    s_q[n * ld + e % d] = n < nq ? q[bi * nq * d + e] : 0.0f;
  }
  for (int n = tid; n < nq_pad; n += blockDim.x) s_best[n] = -CUDART_INF_F;

  for (int t0 = 0; t0 < np_; t0 += kChunk) {
    const int nt = min(kChunk, np_ - t0);
    __syncthreads();  // the previous chunk is consumed (and the query staged)
    for (int e = tid; e < nt * d; e += blockDim.x) {
      const int t = e / d;
      const int k = e % d;
      const int64_t row = (tile * np_ + t0 + t) * DOC_TILE + lane;
      s_doc[t * ld + k] = doc_value(store, scales, row, row * d + k);
    }
    __syncthreads();

    for (int qb = 0; qb < nq_pad; qb += kQBlock) {
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      for (int k = 0; k < d; k += 4) {
        float4 a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(s_q + (qb + tq + 16 * i) * ld + k);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(s_doc + (tt + 8 * j) * ld + k);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float x = fmaf(a[i].x, b[j].x, acc[i][j]);
            x = fmaf(a[i].y, b[j].y, x);
            x = fmaf(a[i].z, b[j].z, x);
            acc[i][j] = fmaf(a[i].w, b[j].w, x);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float m = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (tt + 8 * j < nt) m = fmaxf(m, acc[i][j]);  // rows past nt hold a stale chunk
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 4));
        const int n = qb + tq + 16 * i;
        if (tt == 0) s_best[n] = fmaxf(s_best[n], m);
      }
    }
  }
  __syncthreads();

  if (tid == 0) {
    float total = 0.0f;
    for (int n = 0; n < nq; ++n) total += s_best[n];
    out[pair] = total;
  }
}

template <typename StoreT>
cudaError_t launch(const void* q, const void* store, const void* scales, const void* cand, void* out, int b, int nq,
                   int c, int np_, int d, int64_t n_tiles, cudaStream_t stream) {
  if (d % 4 != 0) return cudaErrorInvalidValue;
  const size_t nq_pad = (static_cast<size_t>(nq) + kQBlock - 1) / kQBlock * kQBlock;
  const size_t smem = ((kChunk + nq_pad) * (d + 4) + nq_pad) * sizeof(float);
  cudaError_t err = colpali_allow_smem(gather_rerank_kernel<StoreT>, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(b) * c;
  gather_rerank_kernel<StoreT><<<static_cast<unsigned int>(blocks), 128, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const StoreT*>(store), static_cast<const float*>(scales),
      static_cast<const int32_t*>(cand), static_cast<float*>(out), nq, c, np_, d, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// int8 store (nt, Np, 128, D) with (nt, Np, 128) fp32 scales
extern "C" int colpali_gather_rerank(const void* q, const void* store, const void* scales,
                                     const void* cand, void* out, int b, int nq, int c, int np_,
                                     int d, int64_t n_tiles, void* stream) {
  return launch<int8_t>(q, store, scales, cand, out, b, nq, c, np_, d, n_tiles, static_cast<cudaStream_t>(stream));
}

// bf16 store (nt, Np, 128, D), no scales
extern "C" int colpali_gather_rerank_bf16(const void* q, const void* store, const void* cand, void* out, int b,
                                          int nq, int c, int np_, int d, int64_t n_tiles, void* stream) {
  return launch<__nv_bfloat16>(q, store, nullptr, cand, out, b, nq, c, np_, d, n_tiles,
                               static_cast<cudaStream_t>(stream));
}
