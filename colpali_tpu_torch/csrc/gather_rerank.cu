// K2: fused candidate gather + exact rerank, the second tier of the search.
//
// Replaces colpali_tpu/ops/maxsim_pallas.py::gather_candidates_pallas
// together with the rerank in colpali_tpu/retrieval/store.py::gather_rerank.
// For each query b and candidate j with doc id i = cand[b, j]:
//
//   doc[t, :] = float(store[i / 128, t, i % 128, :]) * scales[i / 128, t, i % 128]
//   out[b, j] = sum_n max_t (q[b, n, :] . doc[t, :])
//
// in fp32, queries not quantized. The TPU path gathers the (c, Np, D) docs
// into HBM first; here nothing but the (B, c) scores is written.
//
// What bounds it on an H100: latency of the scattered reads. A candidate is
// Np rows of D bytes, each 128 * D bytes apart in the tile-major store, so
// the c = 1024 shortlist is 8 MB of 128-byte reads spread over the corpus;
// the fp32 products (Nq * Np * D per candidate) are small beside it.
//
// Design: one block per (query, candidate). The block dequantizes its
// candidate's rows into shared memory (rows padded by one float so the dot
// products read conflict-free), stages the fp32 query, computes the
// (Nq, Np) similarities, takes the max over doc tokens and sums over query
// tokens in query order. An id outside the store writes NaN instead of
// reading out of bounds. Offsets are 64-bit.

#include "common.cuh"

__global__ void gather_rerank_kernel(const float* __restrict__ q,        // (B, Nq, D)
                                     const int8_t* __restrict__ store,   // (nt, Np, 128, D)
                                     const float* __restrict__ scales,   // (nt, Np, 128)
                                     const int32_t* __restrict__ cand,   // (B, c)
                                     float* __restrict__ out,            // (B, c)
                                     int nq, int c, int np_, int d, int64_t n_tiles) {
  extern __shared__ int4 smem_raw[];
  float* s_doc = reinterpret_cast<float*>(smem_raw);  // (Np, D + 1)
  float* s_q = s_doc + np_ * (d + 1);                 // (Nq, D)
  float* s_sim = s_q + nq * d;                        // (Nq, Np + 1)
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

  for (int e = tid; e < np_ * d; e += blockDim.x) {
    const int t = e / d;
    const int k = e % d;
    const int64_t row = (tile * np_ + t) * DOC_TILE + lane;
    s_doc[t * (d + 1) + k] = static_cast<float>(store[row * d + k]) * scales[row];
  }
  for (int e = tid; e < nq * d; e += blockDim.x) s_q[e] = q[bi * nq * d + e];
  __syncthreads();

  for (int p = tid; p < nq * np_; p += blockDim.x) {
    const int n = p / np_;
    const int t = p % np_;
    const float* qr = s_q + n * d;
    const float* dr = s_doc + t * (d + 1);
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(qr[k], dr[k], acc);
    s_sim[n * (np_ + 1) + t] = acc;
  }
  __syncthreads();

  for (int n = tid; n < nq; n += blockDim.x) {
    const float* row = s_sim + n * (np_ + 1);
    float best = row[0];
    for (int t = 1; t < np_; ++t) best = fmaxf(best, row[t]);
    s_sim[n * (np_ + 1) + np_] = best;
  }
  __syncthreads();

  if (tid == 0) {
    float total = 0.0f;
    for (int n = 0; n < nq; ++n) total += s_sim[n * (np_ + 1) + np_];
    out[pair] = total;
  }
}

extern "C" int colpali_gather_rerank(const void* q, const void* store, const void* scales,
                                     const void* cand, void* out, int b, int nq, int c, int np_,
                                     int d, int64_t n_tiles, void* stream) {
  const size_t smem = (static_cast<size_t>(np_) * (d + 1) + static_cast<size_t>(nq) * d +
                       static_cast<size_t>(nq) * (np_ + 1)) * sizeof(float);
  cudaError_t err = colpali_allow_smem(gather_rerank_kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(b) * c;
  gather_rerank_kernel<<<static_cast<unsigned int>(blocks), 128, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(store),
      static_cast<const float*>(scales), static_cast<const int32_t*>(cand),
      static_cast<float*>(out), nq, c, np_, d, n_tiles);
  return cudaGetLastError();
}
