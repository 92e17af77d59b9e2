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
// words are one contiguous 16-byte-vector read into shared memory, laid out
// (W, Npc, 128), so neighbouring threads read neighbouring words with no
// bank conflict. The query words and validity also sit in shared memory,
// where every thread reads the same address (a broadcast). Each thread
// takes the integer max over tokens and accumulates valid * max in fp32 in
// query-token order, as the TPU kernel does. The sums are of small integers,
// so the result equals the plain PyTorch version exactly. Padded doc tokens
// were filled with the doc's first valid token when the sketch was packed,
// and docs past num_docs are masked by the caller, not here.

#include "common.cuh"

__global__ void binary_maxsim_kernel(const int32_t* __restrict__ qwords,  // (B*Nq, W)
                                     const float* __restrict__ qvalid,    // (B*Nq)
                                     const int32_t* __restrict__ dwords,  // (nt, W, Npc, 128)
                                     float* __restrict__ out,             // (B, nt*128)
                                     int b, int nq, int w, int npc, int dim, int64_t n_tiles) {
  extern __shared__ int4 smem_raw[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem_raw);
  const int64_t tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int tile_words = w * npc * DOC_TILE;
  int32_t* s_doc = smem;                       // (W, Npc, 128)
  int32_t* s_q = s_doc + tile_words;           // (B*Nq, W)
  float* s_qv = reinterpret_cast<float*>(s_q + b * nq * w);  // (B*Nq)

  const int4* src = reinterpret_cast<const int4*>(dwords + tile * tile_words);
  int4* dst = reinterpret_cast<int4*>(s_doc);
  for (int i = lane; i < tile_words / 4; i += blockDim.x) dst[i] = src[i];
  for (int i = lane; i < b * nq * w; i += blockDim.x) s_q[i] = qwords[i];
  for (int i = lane; i < b * nq; i += blockDim.x) s_qv[i] = qvalid[i];
  __syncthreads();

  const int64_t n_docs = n_tiles * DOC_TILE;
  for (int bi = 0; bi < b; ++bi) {
    float acc = 0.0f;
    for (int qi = 0; qi < nq; ++qi) {
      const int32_t* q = s_q + (bi * nq + qi) * w;
      int best = -2147483647 - 1;
      for (int t = 0; t < npc; ++t) {
        int ham = 0;
        for (int wi = 0; wi < w; ++wi) ham += __popc(q[wi] ^ s_doc[(wi * npc + t) * DOC_TILE + lane]);
        best = max(best, dim - 2 * ham);
      }
      acc += s_qv[bi * nq + qi] * static_cast<float>(best);
    }
    out[bi * n_docs + tile * DOC_TILE + lane] = acc;
  }
}

extern "C" int colpali_binary_maxsim(const void* qwords, const void* qvalid, const void* dwords,
                                     void* out, int b, int nq, int w, int npc, int dim,
                                     int64_t n_tiles, void* stream) {
  const size_t smem = (static_cast<size_t>(w) * npc * DOC_TILE + static_cast<size_t>(b) * nq * w) *
                          sizeof(int32_t) + static_cast<size_t>(b) * nq * sizeof(float);
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
