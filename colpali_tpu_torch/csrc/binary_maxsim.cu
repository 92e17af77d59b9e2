// K1: sign-sketch MaxSim, the coarse pass of the two-tier search.
//
// Replaces colpali_tpu/ops/maxsim_binary.py::binary_maxsim_pallas_tiled
// (body _binary_kernel). For every query b and doc d of the tile-major
// sketch (n_tiles, W, Npc, 128) int32:
//
//   out[b, d] = sum_i valid[b, i] * max_t (dim - 2 * popc(q[b, i] ^ doc[d, t]))
//
// with popc summed over the W = dim / 32 words of a token.
//
// What bounds it on an H100: integer issue, not bytes. At the serving shape
// (W=4, Npc=16 pooled tokens, Nq=32..64) every sketch word is XORed and
// popcounted against every query token, while the whole 1M-doc sketch is
// 256 MB, about 0.08 ms of HBM at 3.35 TB/s.
//
// Design: one block per 128-doc tile, one thread per doc lane. The tile's
// words stream through shared memory in chunks of up to kChunk sketch tokens,
// each chunk one contiguous 16-byte-vector read per word, laid out
// (W, chunk, 128), so neighbouring threads read neighbouring words with no
// bank conflict. The query words and validity sit in shared memory, where
// every thread reads the same address (a broadcast). Across chunks each
// thread keeps the running integer max of its doc lane for up to kGroup
// query tokens at a time in shared memory, (group, 128) ints, so shared
// memory does not grow with Npc: a full page pooled by 4 (Npc = 260) takes
// 9 chunks, while the bench's Npc = 16 is one chunk that is read once for
// all query tokens, as before. Each thread accumulates valid * max in fp32
// in query-token order, as the TPU kernel does. The sums are of small
// integers, so the result equals the plain PyTorch version exactly. Padded
// doc tokens were filled with the doc's first valid token when the sketch
// was packed, and docs past num_docs are masked by the caller, not here.

#include "common.cuh"

#include <climits>

constexpr int kChunk = 32;  // sketch tokens per shared-memory chunk
constexpr int kGroup = 64;  // query tokens whose running max is kept across chunks

__global__ void binary_maxsim_kernel(const int32_t* __restrict__ qwords,  // (B*Nq, W)
                                     const float* __restrict__ qvalid,    // (B*Nq)
                                     const int32_t* __restrict__ dwords,  // (nt, W, Npc, 128)
                                     float* __restrict__ out,             // (B, nt*128)
                                     int b, int nq, int w, int npc, int dim, int64_t n_tiles) {
  extern __shared__ int4 smem_raw[];
  const int chunk = min(npc, kChunk);
  const int n_chunks = (npc + chunk - 1) / chunk;
  const int nqt = b * nq;
  const int group = n_chunks > 1 ? min(nqt, kGroup) : nqt;
  int32_t* s_doc = reinterpret_cast<int32_t*>(smem_raw);     // (W, chunk, 128)
  int32_t* s_q = s_doc + w * chunk * DOC_TILE;               // (B*Nq, W)
  float* s_qv = reinterpret_cast<float*>(s_q + nqt * w);     // (B*Nq)
  int32_t* s_max = reinterpret_cast<int32_t*>(s_qv + nqt);   // (group, 128), if n_chunks > 1
  const int64_t tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t* tile_words = dwords + tile * w * npc * DOC_TILE;

  for (int i = lane; i < nqt * w; i += blockDim.x) s_q[i] = qwords[i];
  for (int i = lane; i < nqt; i += blockDim.x) s_qv[i] = qvalid[i];

  const int64_t n_docs = n_tiles * DOC_TILE;
  float acc = 0.0f;
  for (int g0 = 0; g0 < nqt; g0 += group) {
    const int g1 = min(nqt, g0 + group);
    for (int ci = 0; ci < n_chunks; ++ci) {
      const int t0 = ci * chunk;
      const int nt = min(chunk, npc - t0);
      if (n_chunks > 1 || g0 == 0) {
        __syncthreads();  // the previous chunk is consumed
        for (int wi = 0; wi < w; ++wi) {
          const int4* src = reinterpret_cast<const int4*>(tile_words + (wi * npc + t0) * DOC_TILE);
          int4* dst = reinterpret_cast<int4*>(s_doc + wi * chunk * DOC_TILE);
          for (int i = lane; i < nt * DOC_TILE / 4; i += blockDim.x) dst[i] = src[i];
        }
        __syncthreads();
      }
      for (int qi = g0; qi < g1; ++qi) {
        const int32_t* qw = s_q + qi * w;
        int best = ci == 0 ? INT_MIN : s_max[(qi - g0) * DOC_TILE + lane];
        for (int t = 0; t < nt; ++t) {
          int ham = 0;
          for (int wi = 0; wi < w; ++wi) ham += __popc(qw[wi] ^ s_doc[(wi * chunk + t) * DOC_TILE + lane]);
          best = max(best, dim - 2 * ham);
        }
        if (ci + 1 < n_chunks) {
          s_max[(qi - g0) * DOC_TILE + lane] = best;  // this lane's own column: no sync needed
        } else {
          acc += s_qv[qi] * static_cast<float>(best);
          if ((qi + 1) % nq == 0) {  // last query token of batch row qi / nq
            out[(qi / nq) * n_docs + tile * DOC_TILE + lane] = acc;
            acc = 0.0f;
          }
        }
      }
    }
  }
}

extern "C" int colpali_binary_maxsim(const void* qwords, const void* qvalid, const void* dwords,
                                     void* out, int b, int nq, int w, int npc, int dim,
                                     int64_t n_tiles, void* stream) {
  const size_t chunk = static_cast<size_t>(npc < kChunk ? npc : kChunk);
  const size_t nqt = static_cast<size_t>(b) * nq;
  const size_t group = chunk < static_cast<size_t>(npc) ? (nqt < kGroup ? nqt : kGroup) : 0;
  const size_t smem = (static_cast<size_t>(w) * chunk * DOC_TILE + nqt * w + group * DOC_TILE) *
                          sizeof(int32_t) + nqt * sizeof(float);
  cudaError_t err = colpali_allow_smem(binary_maxsim_kernel, smem);
  if (err != cudaSuccess) return err;
  binary_maxsim_kernel<<<static_cast<unsigned int>(n_tiles), DOC_TILE, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qwords), static_cast<const float*>(qvalid),
      static_cast<const int32_t*>(dwords), static_cast<float*>(out), b, nq, w, npc, dim, n_tiles);
  return cudaGetLastError();
}

extern "C" const char* colpali_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
