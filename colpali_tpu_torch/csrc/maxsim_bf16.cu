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
// K4 takes doc[c, t] = bf16(float(int8 value) * bf16(scale[c, t])): the
// dequantized token is rounded to bf16 before the product, as on the TPU,
// so the scale cannot move after the product as in K2. Zero-padded doc
// tokens take part in the max with similarity 0, as in JAX and in the plain
// versions.
//
// What bounds it on an H100. A "block" is the 128 rows of one doc token t of
// one 128-doc tile, contiguous in both layouts. At B = 1 the sweep reads the
// store once: 262,144 bf16 docs x 64 tokens x 128 are 4.3 GB (1.28 ms at
// 3.35 TB/s), 999,936 int8 docs 8.5 GB with their scales (2.52 ms). From
// about B * Nq = 256 query rows on, the bf16 tensor cores bound it
// (2 * B * Nq * C * Np * D operations: 4.24 ms for K4 at B = 8 Nq = 32), and
// on a small corpus, the eval index (one tile of 1,040 tokens, B = 128 x
// Nq = 16), only the operations count (0.071 ms). K4 also converts every
// value on the CUDA cores, about four instructions each, 16,384 a block and
// CTA. On the H100 that conversion is what holds K4 (tools/k4_variants.py):
// alone it takes about as long as the block's products, and the two barely
// overlap, whatever its arithmetic (fp32 or bf16x2, with or without the
// packing conversions) and whether the consumers or the producer's idle
// warps do it. K5 has no conversion and runs near its bounds.
//
// Design (hopper.cuh; K3's stream and K2's products and conversion):
// - One producer thread streams the blocks by TMA through an mbarrier ring,
//   from a 3-D map (D, 128 rows, block) in which block (tile, t) is
//   tile * tile_stride + t * token_stride: K8 and K9 differ from K5 and K4
//   only in those two numbers and give their scores bit for bit. K4's 128
//   scales a block ride the same stage. The producer runs ahead across
//   units and tiles, so loads stay in flight under the products.
// - Products on bf16 wgmma with fp32 accumulators: 64 query rows of a
//   consumer warpgroup are the M side, held in registers as the A operand
//   (D / 4 registers a thread, loaded once a CTA and again only when its
//   query slot changes), the docs of the block the N side, K-major in
//   shared memory (128-byte swizzle, 64-dim chunks). The running max over
//   doc tokens is then an fmaxf a thread on its accumulators.
// - K4: each consumer converts its 64 rows of the int8 block to bf16 in
//   shared memory while its products of the previous block run (two
//   converted buffers at D <= 128; one at 256 and 320, where two do not
//   fit), each element once a CTA, by the exact int-to-float of K2 and one
//   bf16-rounded product with the bf16 scale; fence.proxy.async before
//   wgmma reads it.
// - Query slots: whole queries go to a consumer, up to 64 rows (qpc = 64 /
//   Nq of them; the wrapper cuts longer queries into pieces of 64 tokens and
//   sums their scores). With two slots or more at D <= 128 ("pair"), a
//   CTA's two consumers take two slots against all 128 docs of each block
//   (N = 128), so a block is read and converted once for 128 rows; with one
//   slot, or at D = 256 and 320 (where 128 accumulators, 128 maxima and D / 4
//   query registers do not fit a thread), both take one slot and half the
//   docs each (N = 64). A "lane" is the CTA-sized share of the slots, and a
//   segment is one (tile, lane): all of its Np blocks.
// - Filling the card. With at least as many segments as SMs, a persistent
//   grid of one CTA an SM walks whole segments, seg = blockIdx.x, + grid,
//   ..., in tile-major order, so the lanes of a tile run side by side and
//   its re-reads come from L2; the consumers sum each query's rows. With
//   fewer (a small corpus: the eval index has 16 segments), the doc-token
//   axis is split too: the segments' blocks, lane-major, are one run of
//   segments * Np that is cut into one equal range a CTA, so every SM gets
//   the same number of blocks; a range covers at most two segments when a
//   segment is longer than a range. Each CTA writes its per-row maxima over
//   its tokens to a scratch buffer, slot k of a segment being its k-th CTA,
//   and a second kernel takes the max over those slots and sums each
//   query's rows.
// - One order of sums: a query's score is 0 + m[0] + m[1] + ... + m[Nq - 1]
//   in fp32, whether the consumers add the maxima from shared memory or the
//   second kernel adds them from scratch, and the max is exact. So two
//   calls, and one call split any way, give the same bits.

#include <cuda_bf16.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 3 * 128;  // consumers 0 and 1, then the producer warpgroup
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kRows = 64;          // query rows of a consumer: one wgmma m64
constexpr int kBarConsumer = 1;    // named barriers 1 and 2: one consumer's threads
constexpr int kBarBoth = 3;        // named barrier 3: both consumers (a shared converted block)
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 227 * 1024;

struct SweepArgs {
  const __nv_bfloat16* q;  // (b * nq, D)
  float* out;              // (b, n_tiles * 128): whole segments
  float* scratch;          // (slots of a segment, b * nq, n_tiles * 128): split runs
  int b, nq, np, n_tiles;
  int tile_stride, token_stride;  // in blocks of 128 rows
  int qpc, slots, lanes;          // queries a slot, query slots, CTAs' shares of the slots
  int pair, split, stages;
  int64_t segments;               // n_tiles * lanes
};

template <int D, int N, bool INT8>
struct Layout {
  static constexpr bool PAIR = N == DOC_TILE;            // two query slots against every doc of a block
  static constexpr int CONV = !INT8 ? 0 : D <= 128 ? 2 : 1;  // converted bf16 blocks (K4)
  static constexpr int DW = D > 256 ? D / 2 : D;         // int8 dims a TMA box (at most 256 a side)
  static constexpr uint32_t TILE = DOC_TILE * D * 2;     // a bf16 block: D / 64 chunks of 128 x 64
  static constexpr uint32_t RAW = INT8 ? DOC_TILE * D : TILE;  // a block as loaded
  static constexpr uint32_t STAGE = (RAW + (INT8 ? DOC_TILE * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int LDM = N + 8;                      // row stride of a consumer's maxima
  static constexpr uint32_t MAXIMA = 2 * kRows * LDM * 4;
  static constexpr size_t fixed() { return kSmemSlack + CONV * TILE + MAXIMA; }
  static constexpr size_t per_stage() { return STAGE + 16; }  // + its full and empty barriers
};

// The CTA whose range of the split run holds position pos (ranges
// [i * work / ctas, (i + 1) * work / ctas)).
__host__ __device__ __forceinline__ int64_t cta_of(int64_t pos, int64_t ctas, int64_t work) {
  return ((pos + 1) * ctas - 1) / work;
}

// f(tile, lane, t0, t1, k) for each unit of this CTA in order: blocks t0 to
// t1 - 1 of one segment; k is the CTA's scratch slot in a split run.
template <class F>
__device__ __forceinline__ void for_each_unit(const SweepArgs& a, F&& f) {
  const int64_t cta = blockIdx.x, ctas = gridDim.x;
  if (!a.split) {
    for (int64_t seg = cta; seg < a.segments; seg += ctas)
      f(static_cast<int>(seg / a.lanes), static_cast<int>(seg % a.lanes), 0, a.np, 0);
    return;
  }
  const int64_t work = a.segments * a.np, end = (cta + 1) * work / ctas;
  for (int64_t pos = cta * work / ctas; pos < end;) {
    const int64_t seg = pos / a.np;
    const int t0 = static_cast<int>(pos - seg * a.np);
    const int t1 = end - pos < a.np - t0 ? static_cast<int>(t0 + (end - pos)) : a.np;
    f(static_cast<int>(seg % a.n_tiles), static_cast<int>(seg / a.n_tiles), t0, t1,
      static_cast<int>(cta - cta_of(seg * a.np, ctas, work)));
    pos += t1 - t0;
  }
}

// acc (64 x N) = the consumer's query rows (registers) x N docs of a block at b (K-major, 128-byte swizzle)
template <int D, int N>
__device__ __forceinline__ void products(float* acc, const uint32_t (&af)[D / 16][4], uint32_t b) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_rs_kmajor<N>(acc, af[kk], smem_desc(b + (kk / 4) * DOC_TILE * 128 + (kk % 4) * 32, 16, 1024, kSwizzle128),
                       kk > 0);
  wgmma_commit();
}

// Four int8 values times the bf16 scale s, each product (exact in fp32)
// rounded to bf16, as two packed pairs. float(v) is exact: the float
// 2^23 + (v + 128) less 2^23 + 128.
__device__ __forceinline__ uint2 dequant4(uint32_t w, float s) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f) * s;
  const float f1 = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f) * s;
  const float f2 = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f) * s;
  const float f3 = (__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f) * s;
  return make_uint2(pack_bf16(f0, f1), pack_bf16(f2, f3));
}

template <int D, int N, bool INT8>
__global__ void __launch_bounds__(kThreads, 1)
    maxsim_bf16_kernel(const __grid_constant__ CUtensorMap store_map, const __grid_constant__ CUtensorMap scale_map,
                       const SweepArgs a) {
  using L = Layout<D, N, INT8>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int S = a.stages;
  uint8_t* s_conv = smem;                                               // CONV converted blocks (K4)
  uint8_t* s_ring = smem + L::CONV * L::TILE;                           // S stages
  float* s_max = reinterpret_cast<float*>(s_ring + static_cast<size_t>(S) * L::STAGE);  // (2, 64, LDM)
  const uint32_t bar_full = smem_addr(s_max + 2 * kRows * L::LDM), bar_empty = bar_full + 8 * S;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ---- producer ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;  // one thread issues the loads
    int it = 0;
    for_each_unit(a, [&](int tile, int, int t0, int t1, int) {
      for (int t = t0; t < t1; ++t, ++it) {
        const int stage = it % S;
        mbar_wait(bar_empty + 8 * stage, ((it / S) & 1) ^ 1);
        const int blk = tile * a.tile_stride + t * a.token_stride;
        const uint32_t full = bar_full + 8 * stage, dst = smem_addr(s_ring + stage * L::STAGE);
        if constexpr (INT8) {
          mbar_expect_tx(full, L::RAW + DOC_TILE * 4);
#pragma unroll
          for (int c = 0; c < D / L::DW; ++c)
            tma_load_3d(dst + c * DOC_TILE * L::DW, &store_map, c * L::DW, 0, blk, full);
          tma_load_2d(dst + L::RAW, &scale_map, 0, blk, full);
        } else {
          mbar_expect_tx(full, L::RAW);
#pragma unroll
          for (int c = 0; c < D / 64; ++c) tma_load_3d(dst + c * DOC_TILE * 128, &store_map, c * 64, 0, blk, full);
        }
      }
    });
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int64_t c_total = static_cast<int64_t>(a.n_tiles) * DOC_TILE;
  const int64_t rows_total = static_cast<int64_t>(a.b) * a.nq;
  const int doc0 = L::PAIR ? 0 : 64 * wg;  // this consumer's first doc of a block
  const int bar_conv = L::PAIR ? kBarBoth : kBarConsumer + wg, n_conv = L::PAIR ? 256 : 128;
  float* my_max = s_max + wg * kRows * L::LDM;

  // K4: wait for ring position `pos`, convert this consumer's 64 rows of it into
  // converted buffer `buf`, and release its stage.
  auto convert = [&](int pos, int buf) {
    const int stage = pos % S;
    mbar_wait(bar_full + 8 * stage, (pos / S) & 1);
    const uint8_t* raw = s_ring + stage * L::STAGE;
    const float* scl = reinterpret_cast<const float*>(raw + L::RAW);
    uint8_t* dst = s_conv + buf * L::TILE;
    constexpr int PIECES = kRows * D / 16 / 128;  // 16 values a piece, D / 32 pieces a thread
    uint4 w[PIECES];
    float scale[PIECES];
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {  // every load first: the stores below may not move above them
      const int u = tid + 128 * i, r = 64 * wg + u / (D / 16), k = (u % (D / 16)) * 16;
      w[i] = *reinterpret_cast<const uint4*>(raw + (k / L::DW) * DOC_TILE * L::DW + r * L::DW + k % L::DW);
      scale[i] = scl[r];
    }
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int u = tid + 128 * i, r = 64 * wg + u / (D / 16), k = (u % (D / 16)) * 16;
      const float s = __bfloat162float(__float2bfloat16_rn(scale[i]));
      const uint2 e0 = dequant4(w[i].x, s), e1 = dequant4(w[i].y, s), e2 = dequant4(w[i].z, s), e3 = dequant4(w[i].w, s);
      *reinterpret_cast<uint4*>(dst + swizzled<DOC_TILE>(r, k)) = make_uint4(e0.x, e0.y, e1.x, e1.y);
      *reinterpret_cast<uint4*>(dst + swizzled<DOC_TILE>(r, k + 8)) = make_uint4(e2.x, e2.y, e3.x, e3.y);
    }
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
  };

  uint32_t af[D / 16][4];  // the slot's rows 16 warp + g and + 8 as wgmma's A fragments, k16 step by step
  float acc[N / 2], mx[N / 2];
  int cur_lane = -1, slot = 0, q_count = 0, it = 0;
  for_each_unit(a, [&](int tile, int ln, int t0, int t1, int k) {
    if (ln != cur_lane) {  // this consumer's query slot and its rows
      cur_lane = ln;
      slot = L::PAIR ? 2 * ln + wg : ln;
      q_count = slot < a.slots ? min(a.qpc, a.b - slot * a.qpc) : 0;
      const int rows = q_count * a.nq, r0 = 16 * warp + g;
      const __nv_bfloat16* q0 = a.q + static_cast<int64_t>(slot) * a.qpc * a.nq * D + 2 * t4;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + 8 * (i & 1);
          af[ks][i] = r < rows ? *reinterpret_cast<const uint32_t*>(q0 + r * D + 16 * ks + 8 * (i >> 1)) : 0u;
        }
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) mx[i] = -CUDART_INF_F;

    if constexpr (!INT8) {
      for (int t = t0; t < t1; ++t, ++it) {
        const int stage = it % S;
        mbar_wait(bar_full + 8 * stage, (it / S) & 1);
        products<D, N>(acc, af, smem_addr(s_ring + stage * L::STAGE) + doc0 * 128);
        wgmma_wait_all();
        fence_operands<N / 2>(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) mx[i] = fmaxf(mx[i], acc[i]);
      }
    } else if constexpr (L::CONV == 2) {  // block t + 1 converted under block t's products
      int buf = 0;
      convert(it, 0);
      named_bar_sync(bar_conv, n_conv);
      for (int t = t0; t < t1; ++t, ++it) {
        products<D, N>(acc, af, smem_addr(s_conv + buf * L::TILE) + doc0 * 128);
        if (t + 1 < t1) convert(it + 1, buf ^ 1);
        wgmma_wait_all();
        fence_operands<N / 2>(acc);
        named_bar_sync(bar_conv, n_conv);  // block t + 1 converted; nobody reads block t any more
#pragma unroll
        for (int i = 0; i < N / 2; ++i) mx[i] = fmaxf(mx[i], acc[i]);
        buf ^= 1;
      }
    } else {  // one converted buffer: convert, then multiply
      for (int t = t0; t < t1; ++t, ++it) {
        convert(it, 0);
        named_bar_sync(bar_conv, n_conv);
        products<D, N>(acc, af, smem_addr(s_conv) + doc0 * 128);
        wgmma_wait_all();
        fence_operands<N / 2>(acc);
        named_bar_sync(bar_conv, n_conv);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) mx[i] = fmaxf(mx[i], acc[i]);
      }
    }

    // mx[4j + e]: row 16 warp + g (+ 8 for e >= 2), doc 8j + 2 t4 + (e & 1) of this consumer's N
    const int r_lo = 16 * warp + g;
    if (a.split) {  // the maxima over blocks t0..t1 - 1 to scratch slot k
      const int rows = q_count * a.nq;
      float* o = a.scratch + (k * rows_total + static_cast<int64_t>(slot) * a.qpc * a.nq) * c_total +
                 static_cast<int64_t>(tile) * DOC_TILE + doc0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        if (r_lo < rows) *reinterpret_cast<float2*>(o + r_lo * c_total + 8 * j) = make_float2(mx[4 * j], mx[4 * j + 1]);
        if (r_lo + 8 < rows)
          *reinterpret_cast<float2*>(o + (r_lo + 8) * c_total + 8 * j) = make_float2(mx[4 * j + 2], mx[4 * j + 3]);
      }
      return;
    }
    // a whole segment: each query's rows summed in order through shared memory
    named_bar_sync(kBarConsumer + wg, 128);  // the last segment's maxima are read
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      float* p = my_max + r_lo * L::LDM + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(p) = make_float2(mx[4 * j], mx[4 * j + 1]);
      *reinterpret_cast<float2*>(p + 8 * L::LDM) = make_float2(mx[4 * j + 2], mx[4 * j + 3]);
    }
    named_bar_sync(kBarConsumer + wg, 128);
    const int col = tid % N;
    float* o = a.out + static_cast<int64_t>(slot) * a.qpc * c_total + static_cast<int64_t>(tile) * DOC_TILE + doc0 + col;
    for (int qi = tid / N; qi < q_count; qi += 128 / N) {
      float s = 0.0f;
      for (int i = 0; i < a.nq; ++i) s += my_max[(qi * a.nq + i) * L::LDM + col];
      o[qi * c_total] = s;
    }
  });
}

// The second pass of a split run: for each (query b, doc c) the max over the
// scratch slots of its segment, then the sum over its rows in order.
__global__ void __launch_bounds__(256) merge_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                                                    const SweepArgs a, int64_t ctas) {
  const int64_t c_total = static_cast<int64_t>(a.n_tiles) * DOC_TILE;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= a.b * c_total) return;
  const int bq = static_cast<int>(idx / c_total);
  const int64_t c = idx - bq * c_total;
  const int slot = bq / a.qpc, ln = a.pair ? slot / 2 : slot;
  const int64_t work = a.segments * a.np, first = (static_cast<int64_t>(ln) * a.n_tiles + c / DOC_TILE) * a.np;
  const int n_k = static_cast<int>(cta_of(first + a.np - 1, ctas, work) - cta_of(first, ctas, work)) + 1;
  const int64_t rows_total = static_cast<int64_t>(a.b) * a.nq, k_stride = rows_total * c_total;
  const float* p = scratch + static_cast<int64_t>(bq) * a.nq * c_total + c;
  float s = 0.0f;
  for (int i = 0; i < a.nq; ++i, p += c_total) {
    float m = -CUDART_INF_F;
    for (int k = 0; k < n_k; ++k) m = fmaxf(m, p[k * k_stride]);
    s += m;
  }
  out[idx] = s;
}

template <int D, int N, bool INT8>
cudaError_t launch(const void* q, const void* store, const void* scales, void* out, void* scratch, int b, int nq,
                   int np, int n_tiles, int qpc, int ctas, int split, bool token_major, cudaStream_t stream) {
  using L = Layout<D, N, INT8>;
  const int64_t blocks = static_cast<int64_t>(n_tiles) * np;
  CUtensorMap store_map, scale_map;
  {
    const cuuint64_t es = INT8 ? 1 : 2;
    const cuuint64_t dims[3] = {D, DOC_TILE, static_cast<cuuint64_t>(blocks)};
    const cuuint64_t strides[2] = {D * es, DOC_TILE * D * es};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(INT8 ? L::DW : 64), DOC_TILE, 1};
    cudaError_t err = colpali_tensor_map(&store_map, INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                         3, store, dims, strides, box,
                                         INT8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  scale_map = store_map;  // a bf16 store has no scales: never read
  if (INT8) {
    const cuuint64_t dims[2] = {DOC_TILE, static_cast<cuuint64_t>(blocks)}, strides[1] = {DOC_TILE * 4};
    const cuuint32_t box[2] = {DOC_TILE, 1};
    cudaError_t err = colpali_tensor_map(&scale_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scales, dims, strides, box,
                                         CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  SweepArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.out = static_cast<float*>(out);
  a.scratch = static_cast<float*>(scratch);
  a.b = b;
  a.nq = nq;
  a.np = np;
  a.n_tiles = n_tiles;
  a.tile_stride = token_major ? 1 : np;
  a.token_stride = token_major ? n_tiles : 1;
  a.qpc = qpc;
  a.slots = (b + qpc - 1) / qpc;
  a.lanes = L::PAIR ? (a.slots + 1) / 2 : a.slots;
  a.pair = L::PAIR;
  a.split = split;
  a.segments = static_cast<int64_t>(n_tiles) * a.lanes;
  if (split && ctas > a.segments * np) return cudaErrorInvalidValue;  // every CTA of a split run takes a block
  a.stages = static_cast<int>(std::min<size_t>(kMaxStages, (kSmemLimit - L::fixed()) / L::per_stage()));
  if (a.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = L::fixed() + a.stages * L::per_stage();
  cudaError_t err = colpali_allow_smem(maxsim_bf16_kernel<D, N, INT8>, smem);
  if (err != cudaSuccess) return err;
  maxsim_bf16_kernel<D, N, INT8><<<ctas, kThreads, smem, stream>>>(store_map, scale_map, a);
  if (split) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int64_t n = static_cast<int64_t>(b) * n_tiles * DOC_TILE;
    merge_kernel<<<static_cast<unsigned int>((n + 255) / 256), 256, 0, stream>>>(a.scratch, a.out, a, ctas);
  }
  return cudaGetLastError();
}

template <bool INT8>
cudaError_t dispatch(const void* q, const void* store, const void* scales, void* out, void* scratch, int b, int nq,
                     int np, int d, int64_t n_tiles, int qpc, int pair, int ctas, int split, bool token_major,
                     cudaStream_t s) {
  if (b < 1 || nq < 1 || nq > kRows || qpc < 1 || qpc * nq > kRows || np < 1 || n_tiles < 1 ||
      n_tiles * np > INT_MAX || ctas < 1 || (split && scratch == nullptr) ||
      static_cast<int64_t>(b) * n_tiles * DOC_TILE > INT_MAX * 256LL)
    return cudaErrorInvalidValue;
  const int nt = static_cast<int>(n_tiles);
#define COLPALI_SWEEP(D, N) launch<D, N, INT8>(q, store, scales, out, scratch, b, nq, np, nt, qpc, ctas, split, token_major, s)
  switch (d) {
    case 64: return pair ? COLPALI_SWEEP(64, 128) : COLPALI_SWEEP(64, 64);
    case 128: return pair ? COLPALI_SWEEP(128, 128) : COLPALI_SWEEP(128, 64);
    case 256: return pair ? cudaErrorInvalidValue : COLPALI_SWEEP(256, 64);
    case 320: return pair ? cudaErrorInvalidValue : COLPALI_SWEEP(320, 64);
    default: return cudaErrorInvalidValue;
  }
#undef COLPALI_SWEEP
}

}  // namespace

// Queries (b, nq, d) bf16 with nq <= 64, d 64, 128, 256 or 320 (the wrapper
// cuts longer queries into pieces); out (b, n_tiles * 128) fp32. The plan
// (ops/maxsim_tiled.py::maxsim_bf16_plan): qpc whole queries a consumer,
// pair (two slots a CTA, d <= 128), ctas CTAs, split (the doc tokens split
// across CTAs: scratch holds (slots a segment, b * nq, n_tiles * 128) fp32).
// Every pointer 16-byte aligned.
// K5: q, store (n_tiles, Np, 128, D) bf16.
extern "C" int colpali_maxsim_bf16(const void* q, const void* store, void* out, void* scratch, int b, int nq, int np_,
                                   int d, int64_t n_tiles, int qpc, int pair, int ctas, int split, void* stream) {
  return dispatch<false>(q, store, nullptr, out, scratch, b, nq, np_, d, n_tiles, qpc, pair, ctas, split, false,
                         static_cast<cudaStream_t>(stream));
}

// K4: the same over an int8 store with (n_tiles, Np, 128) fp32 scales.
extern "C" int colpali_maxsim_int8_bf16(const void* q, const void* store, const void* scales, void* out, void* scratch,
                                        int b, int nq, int np_, int d, int64_t n_tiles, int qpc, int pair, int ctas,
                                        int split, void* stream) {
  return dispatch<true>(q, store, scales, out, scratch, b, nq, np_, d, n_tiles, qpc, pair, ctas, split, false,
                        static_cast<cudaStream_t>(stream));
}

// K8: K5 over a token-major store (Np, n_tiles * 128, D) bf16.
extern "C" int colpali_maxsim_bf16_tm(const void* q, const void* store, void* out, void* scratch, int b, int nq,
                                      int np_, int d, int64_t n_tiles, int qpc, int pair, int ctas, int split,
                                      void* stream) {
  return dispatch<false>(q, store, nullptr, out, scratch, b, nq, np_, d, n_tiles, qpc, pair, ctas, split, true,
                         static_cast<cudaStream_t>(stream));
}

// K9: K4 over a token-major int8 store (Np, n_tiles * 128, D) with (Np, n_tiles * 128) fp32 scales.
extern "C" int colpali_maxsim_int8_bf16_tm(const void* q, const void* store, const void* scales, void* out,
                                           void* scratch, int b, int nq, int np_, int d, int64_t n_tiles, int qpc,
                                           int pair, int ctas, int split, void* stream) {
  return dispatch<true>(q, store, scales, out, scratch, b, nq, np_, d, n_tiles, qpc, pair, ctas, split, true,
                        static_cast<cudaStream_t>(stream));
}
