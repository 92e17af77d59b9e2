// K3: full-int8 MaxSim over the tile-major corpus, the exact sweep; K10: the
// same over the token-major corpus.
//
// Replaces colpali_tpu/ops/maxsim_pallas.py::maxsim_pallas_int8mxu_tiled
// (K3) and ::maxsim_pallas_int8mxu_tm (K10), body _int8mxu_body. Queries are
// int8 with one fp32 scale per token, the corpus is int8, tile-major
// (n_tiles, Np, 128, D) with (n_tiles, Np, 128) fp32 scales or token-major
// (Np, C, D) with (Np, C) scales:
//
//   out[b, d] = sum_i qs[b, i] * max_t (ds[d, t] * int32(q[b, i] . doc[d, t]))
//
// The doc scale is applied before the max over doc tokens and the query
// scale after it, as on the TPU. Zero-padded doc tokens (value 0, scale 1)
// take part in the max with similarity 0, exactly as in JAX and in the
// plain version.
//
// What bounds it on an H100: at B=1 the sweep reads the whole corpus once
// (8.2 GB for 1M docs x 64 tokens x 128, about 2.4 ms at 3.35 TB/s), but
// this first version does the products on the CUDA cores with __dp4a,
// Nq * Np * D / 4 of them per doc, so integer issue bounds it, not HBM.
// Tensor-core int8 (wgmma) is the later step.
//
// Design: one block of 128 threads per (tile, query); neighbouring blocks
// share a tile, so its second read comes from L2. Each thread owns one doc
// lane: for each doc token it loads the 128-byte row into registers with
// 16-byte loads, then runs it against every query token held in shared
// memory (a broadcast read). The running max lives in shared memory as
// (Nq, 128) floats, one column per thread. All offsets are 64-bit: the
// serving store is over 2^31 bytes. The two layouts differ only in where a
// tile's 128 rows of doc token t start, tile * tile_stride + t *
// token_stride (in rows; the scales follow the same strides), as in
// maxsim_bf16.cu, so K10 gives K3's scores bit for bit on the same data.

#include "common.cuh"

template <int DW>  // D / 4: int32 words per token row
__global__ void maxsim_int8_kernel(const int32_t* __restrict__ q,      // (B*Nq, D) int8
                                   const float* __restrict__ qscale,   // (B*Nq)
                                   const int8_t* __restrict__ store,   // (nt, Np, 128, D)
                                   const float* __restrict__ dscale,   // (nt, Np, 128)
                                   float* __restrict__ out,            // (B, nt*128)
                                   int b, int nq, int np_, int64_t n_tiles, int64_t tile_stride,
                                   int64_t token_stride) {
  extern __shared__ int4 smem_raw[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem_raw);
  const int64_t tile = blockIdx.x / b;
  const int bi = static_cast<int>(blockIdx.x % b);
  const int lane = threadIdx.x;
  int32_t* s_q = smem;                                        // (Nq, DW)
  float* s_qs = reinterpret_cast<float*>(s_q + nq * DW);      // (Nq)
  float* s_max = s_qs + nq;                                   // (Nq, 128)

  for (int i = lane; i < nq * DW; i += blockDim.x) s_q[i] = q[static_cast<int64_t>(bi) * nq * DW + i];
  for (int i = lane; i < nq; i += blockDim.x) s_qs[i] = qscale[bi * nq + i];
  for (int i = 0; i < nq; ++i) s_max[i * DOC_TILE + lane] = -__int_as_float(0x7f800000);  // -inf
  __syncthreads();

  for (int t = 0; t < np_; ++t) {
    const int64_t row = tile * tile_stride + t * token_stride + lane;
    int32_t d[DW];
    const int4* src = reinterpret_cast<const int4*>(store + row * (DW * 4));
#pragma unroll
    for (int k = 0; k < DW / 4; ++k) {
      const int4 v = src[k];
      d[4 * k] = v.x;
      d[4 * k + 1] = v.y;
      d[4 * k + 2] = v.z;
      d[4 * k + 3] = v.w;
    }
    const float ds = dscale[row];
    for (int i = 0; i < nq; ++i) {
      const int4* qrow = reinterpret_cast<const int4*>(s_q + i * DW);
      int acc = 0;
#pragma unroll
      for (int k = 0; k < DW / 4; ++k) {
        const int4 qv = qrow[k];
        acc = __dp4a(qv.x, d[4 * k], acc);
        acc = __dp4a(qv.y, d[4 * k + 1], acc);
        acc = __dp4a(qv.z, d[4 * k + 2], acc);
        acc = __dp4a(qv.w, d[4 * k + 3], acc);
      }
      const float s = static_cast<float>(acc) * ds;
      float* m = s_max + i * DOC_TILE + lane;
      *m = fmaxf(*m, s);
    }
  }
  float total = 0.0f;
  for (int i = 0; i < nq; ++i) total += s_max[i * DOC_TILE + lane] * s_qs[i];
  out[static_cast<int64_t>(bi) * n_tiles * DOC_TILE + tile * DOC_TILE + lane] = total;
}

template <int DW>
static cudaError_t launch(const void* q, const void* qscale, const void* store, const void* dscale,
                          void* out, int b, int nq, int np_, int64_t n_tiles, bool token_major,
                          cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(nq) * DW * sizeof(int32_t) +
                      static_cast<size_t>(nq) * sizeof(float) +
                      static_cast<size_t>(nq) * DOC_TILE * sizeof(float);
  cudaError_t err = colpali_allow_smem(maxsim_int8_kernel<DW>, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = n_tiles * b;
  const int64_t tile_stride = token_major ? DOC_TILE : static_cast<int64_t>(np_) * DOC_TILE;
  const int64_t token_stride = token_major ? n_tiles * DOC_TILE : DOC_TILE;
  maxsim_int8_kernel<DW><<<static_cast<unsigned int>(blocks), DOC_TILE, smem, stream>>>(
      static_cast<const int32_t*>(q), static_cast<const float*>(qscale),
      static_cast<const int8_t*>(store), static_cast<const float*>(dscale),
      static_cast<float*>(out), b, nq, np_, n_tiles, tile_stride, token_stride);
  return cudaGetLastError();
}

static cudaError_t dispatch(const void* q, const void* qscale, const void* store, const void* dscale, void* out,
                            int b, int nq, int np_, int d, int64_t n_tiles, bool token_major, cudaStream_t s) {
  switch (d) {
    case 64: return launch<16>(q, qscale, store, dscale, out, b, nq, np_, n_tiles, token_major, s);
    case 128: return launch<32>(q, qscale, store, dscale, out, b, nq, np_, n_tiles, token_major, s);
    case 256: return launch<64>(q, qscale, store, dscale, out, b, nq, np_, n_tiles, token_major, s);
    default: return cudaErrorInvalidValue;
  }
}

// K3: tile-major store (n_tiles, Np, 128, D), scales (n_tiles, Np, 128).
extern "C" int colpali_maxsim_int8(const void* q, const void* qscale, const void* store,
                                   const void* dscale, void* out, int b, int nq, int np_, int d,
                                   int64_t n_tiles, void* stream) {
  return dispatch(q, qscale, store, dscale, out, b, nq, np_, d, n_tiles, false, static_cast<cudaStream_t>(stream));
}

// K10: token-major store (Np, n_tiles * 128, D), scales (Np, n_tiles * 128).
extern "C" int colpali_maxsim_int8_tm(const void* q, const void* qscale, const void* store,
                                      const void* dscale, void* out, int b, int nq, int np_, int d,
                                      int64_t n_tiles, void* stream) {
  return dispatch(q, qscale, store, dscale, out, b, nq, np_, d, n_tiles, true, static_cast<cudaStream_t>(stream));
}
