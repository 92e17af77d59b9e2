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
// What bounds it on an H100: bytes, once the products leave the CUDA cores.
// The whole 1M-doc sketch is 256 MB (0.078 ms at 3.35 TB/s); a popcount on
// the CUDA cores runs 16 a clock per SM, which puts any CUDA-core design at
// ~0.5 ms over that corpus (tools/b1_probe.py measures 4.0 T popcounts/s).
// The single-bit tensor-core product mma.sync m16n8k256 .b1 .and.popc runs
// at 10.1 P operations/s on the card (the same probe; int8 wgmma's peak is
// 1.98 P), so the products cost a few microseconds and the kernel is left
// with its reads and one integer max per (doc, query token, doc token).
//
// Design:
// - Matching bits, one product. A doc token's row of the product is its W
//   words followed by their complements, a query token's column likewise, so
//   the AND-popcount over the 2 * 128 bits of a k256 step is the number of
//   equal bits m = popc(q & d) + popc(~q & ~d), and dim - 2 popc(q ^ d) =
//   2 m - dim. The max over doc tokens is then one integer max an element;
//   dim - 2 m rides the final sum. W <= 4 is one k256 step (words past W
//   are zero in both halves, so they add nothing), W <= 8 two, W <= 12
//   (dim 320 is W = 10) three.
// - No transpose. In mma.sync's fragments thread (g, t4) holds word t4 of
//   rows g and g + 8 and of column g. The sketch keeps word w of 128 docs
//   contiguous, so one 16-byte load gives a thread word t4 of four
//   neighbouring docs: rows g and g + 8 of two 16-row products. A warp takes
//   32 docs (two m16 tiles) against up to 64 query tokens (8 n8 tiles): the
//   query words and the running max over doc tokens stay in registers, and
//   the warp loads 4 doc tokens ahead of the products.
// - Filling the card. Each warp walks the doc tokens of its 32 docs; when
//   B x (32-doc blocks) is small (the page index: 256 blocks) the doc tokens
//   are split over up to 8 warps of a block, whose maxima are merged through
//   shared memory (exact: a max).
// - Queries longer than 64 tokens are taken 64 tokens at a time by the same
//   warps. The sums are of integers below 2^24 in fp32 (valid is 0 or 1), so
//   the result equals the plain PyTorch version exactly, in any order, and
//   two calls agree bit for bit. Padded doc tokens were filled with the doc's
//   first valid token when the sketch was packed, and docs past num_docs are
//   masked by the caller, not here.

#include "mma.cuh"  // quad_sum

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr int kMaxWords = 12;    // three k256 steps
constexpr int kTargetWarps = 2112;  // 16 warps a SM on 132 SMs

// d = matching bits of the 16 x 256 rows a and the 256 x 8 columns b, plus c
__device__ __forceinline__ void mma_b1(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1, const int (&c)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%10,%11,%12,%13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

struct BinaryArgs {
  const int32_t* qwords;  // (B, nq, W)
  const float* qvalid;    // (B, nq)
  const int32_t* dwords;  // (n_tiles, W, Npc, 128)
  float* out;             // (B, n_tiles * 128)
  int nq, w, npc, dim, splits;
  int64_t n_blocks;       // 32-doc blocks: n_tiles * 4
};

// NT n8 tiles of query tokens (8 NT per pass), KS k256 steps (W <= 4 KS);
// three steps' query words take the registers of a second CTA a SM
template <int NT, int KS>
__global__ void __launch_bounds__(kThreads, KS < 3 ? 2 : 1) binary_maxsim_kernel(const BinaryArgs a) {
  constexpr int kUnroll = 4 / KS;  // doc tokens loaded ahead of their products
  constexpr int GS = 8 * NT;       // query tokens a pass
  extern __shared__ int s_mx[];    // (kWarps, 2 * NT * 4, 32) when splits > 1
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
  const int splits = a.splits, split = warp % splits;
  const int64_t block = static_cast<int64_t>(blockIdx.x) * (kWarps / splits) + warp / splits;
  const bool active = block < a.n_blocks;
  const int b = blockIdx.y;
  const int64_t tile = block / 4;
  const int doc0 = static_cast<int>(block % 4) * 32 + 4 * g;  // this thread's 4 docs within the tile
  const int t_begin = split * a.npc / splits, t_end = (split + 1) * a.npc / splits;
  uint32_t live[KS];  // all ones where word 4s + t4 exists
#pragma unroll
  for (int s = 0; s < KS; ++s) live[s] = 4 * s + t4 < a.w ? ~0u : 0u;
  const int32_t* words = a.dwords + (tile * a.w * a.npc) * DOC_TILE + doc0;
  const int zero[4] = {0, 0, 0, 0};

  float total[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // docs doc0 .. doc0 + 3, over the passes
  for (int n0 = 0; n0 < a.nq; n0 += GS) {
    uint32_t qb[NT][KS][2];  // column g of n-tile j: word 4s + t4 of query token n0 + 8j + g, and its complement
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + 8 * j + g;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const uint32_t x =
            n < a.nq && live[s] ? static_cast<uint32_t>(a.qwords[(static_cast<int64_t>(b) * a.nq + n) * a.w + 4 * s + t4])
                                : 0u;
        qb[j][s][0] = x;
        qb[j][s][1] = ~x & live[s];
      }
    }
    int mx[2][NT][4];  // running max of matching bits: m-tile (docs 4g, 4g+1 | 4g+2, 4g+3) x n-tile
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[mt][j][e] = 0;

    if (active) {
      for (int t = t_begin; t < t_end; t += kUnroll) {
        uint4 dv[kUnroll][KS];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int s = 0; s < KS; ++s)
            dv[u][s] = t + u < t_end && live[s]
                           ? __ldg(reinterpret_cast<const uint4*>(
                                 words + (static_cast<int64_t>(4 * s + t4) * a.npc + t + u) * DOC_TILE))
                           : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (t + u >= t_end) break;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              int d[4];
              const uint32_t r0 = mt ? dv[u][0].z : dv[u][0].x, r1 = mt ? dv[u][0].w : dv[u][0].y;
              mma_b1(d, r0, r1, ~r0 & live[0], ~r1 & live[0], qb[j][0][0], qb[j][0][1], zero);
#pragma unroll
              for (int s = 1; s < KS; ++s) {
                const uint32_t s0 = mt ? dv[u][s].z : dv[u][s].x, s1 = mt ? dv[u][s].w : dv[u][s].y;
                mma_b1(d, s0, s1, ~s0 & live[s], ~s1 & live[s], qb[j][s][0], qb[j][s][1], d);
              }
#pragma unroll
              for (int e = 0; e < 4; ++e) mx[mt][j][e] = max(mx[mt][j][e], d[e]);
            }
          }
        }
      }
    }

    if (splits > 1) {  // merge the doc-token splits of each block into its first warp
      __syncthreads();  // the previous pass's reads are done
      if (split != 0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s_mx[(warp * 8 * NT + (mt * NT + j) * 4 + e) * 32 + lane] = mx[mt][j][e];
      }
      __syncthreads();
      if (split == 0) {
        for (int o = 1; o < splits; ++o) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                mx[mt][j][e] = max(mx[mt][j][e], s_mx[((warp + o) * 8 * NT + (mt * NT + j) * 4 + e) * 32 + lane]);
        }
      }
    }
    if (split == 0) {
      // valid * (2 m - dim) over this thread's query columns 8j + 2 t4 + (e & 1), for doc 2 mt + (e >> 1)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int n = n0 + 8 * j + 2 * t4 + c;
          const float v = n < a.nq ? a.qvalid[static_cast<int64_t>(b) * a.nq + n] : 0.0f;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            total[2 * mt] += v * static_cast<float>(2 * mx[mt][j][c] - a.dim);
            total[2 * mt + 1] += v * static_cast<float>(2 * mx[mt][j][2 + c] - a.dim);
          }
        }
      }
    }
  }

  if (split == 0 && active) {
#pragma unroll
    for (int k = 0; k < 4; ++k) total[k] = quad_sum(total[k]);
    if (t4 == 0) {
      float4* o = reinterpret_cast<float4*>(a.out + static_cast<int64_t>(b) * a.n_blocks * 32 + tile * DOC_TILE + doc0);
      *o = make_float4(total[0], total[1], total[2], total[3]);
    }
  }
}

template <int NT, int KS>
cudaError_t launch(BinaryArgs a, int b, cudaStream_t stream) {
  const size_t smem = a.splits > 1 ? static_cast<size_t>(kWarps) * 8 * NT * 32 * sizeof(int) : 0;
  cudaError_t err = colpali_allow_smem(binary_maxsim_kernel<NT, KS>, smem);
  if (err != cudaSuccess) return err;
  const int per_cta = kWarps / a.splits;
  const dim3 grid(static_cast<unsigned int>((a.n_blocks + per_cta - 1) / per_cta), static_cast<unsigned int>(b));
  binary_maxsim_kernel<NT, KS><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KS>
cudaError_t dispatch_nt(BinaryArgs a, int b, cudaStream_t stream) {
  const int tiles8 = (a.nq + 7) / 8;  // n8 tiles of the whole query, at most 8 a pass
  if (tiles8 <= 1) return launch<1, KS>(a, b, stream);
  if (tiles8 <= 2) return launch<2, KS>(a, b, stream);
  if (tiles8 <= 4) return launch<4, KS>(a, b, stream);
  return launch<8, KS>(a, b, stream);
}

}  // namespace

extern "C" int colpali_binary_maxsim(const void* qwords, const void* qvalid, const void* dwords, void* out, int b,
                                     int nq, int w, int npc, int dim, int64_t n_tiles, void* stream) {
  if (b < 1 || b > 65535 || nq < 1 || w < 1 || w > kMaxWords || npc < 1 || n_tiles < 1 || dim != 32 * w)
    return cudaErrorInvalidValue;
  BinaryArgs a;
  a.qwords = static_cast<const int32_t*>(qwords);
  a.qvalid = static_cast<const float*>(qvalid);
  a.dwords = static_cast<const int32_t*>(dwords);
  a.out = static_cast<float*>(out);
  a.nq = nq;
  a.w = w;
  a.npc = npc;
  a.dim = dim;
  a.n_blocks = n_tiles * 4;
  a.splits = 1;  // split the doc tokens while the card would hold too few warps
  while (a.splits < kWarps && 2 * a.splits <= npc && a.n_blocks * b * a.splits < kTargetWarps) a.splits *= 2;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w <= 4 ? dispatch_nt<1>(a, b, s) : w <= 8 ? dispatch_nt<2>(a, b, s) : dispatch_nt<3>(a, b, s);
}

extern "C" const char* colpali_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
