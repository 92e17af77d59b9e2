// K6 backward: dq, dk and dv of the segment-masked flash attention.
//
// Replaces the two backward kernels of the stock Pallas TPU flash attention
// that colpali_tpu/models/layers.py::_flash_kernel_call reaches through its
// custom_vjp (_flash_attention_bwd_dkv and _flash_attention_bwd_dq). From
// q (B, S, H, D), k, v (B, S, Hkv, D), the forward's output o and row
// log-sum-exp L (B, H, S; base 2, of the scaled logits) and the incoming
// gradient dO, with x = scale * log2(e) * q . k under the forward's mask
// (same segment, key < S, key <= query when causal):
//
//   P = exp2(x - L)         recomputed per tile, 0 where masked
//   Delta = rowsum(dO * o)
//   dV = P^T dO             dP = dO V^T          dS = P * (dP - Delta)
//   dQ = scale * dS K       dK = scale * dS^T Q
//
// For MQA/GQA, dk and dv of a KV head are the sums over its query heads.
//
// What bounds it on an H100: tensor-core throughput, as the forward. The
// minimum is 2.5x the forward's operations (five products against two);
// this version does 3.5x (seven products), with no atomics.
//
// Design: three kernels on one stream, one C entry point; the two large
// ones are built like the forward (flash_attention.cu, hopper.cuh): a
// producer warp fills an mbarrier ring by TMA, two consumer warpgroups run
// wgmma.
// 1. delta: one warp per (b, s, h) row sums dO * o in fp32 into (B, H, S).
// 2. dkv: one CTA per (64-key block, KV head, batch row), no split of D.
//    K and V are loaded once; the CTA loops over the query heads of its KV
//    head and over 64-query tiles in a fixed order, and Q, dO and the
//    tiles' L, Delta and query segment ids come through the ring; the CTA's
//    keys compare their own ids (kv_seg). Consumer 0
//    computes S^T = K Q^T over the full D, turns it into P^T and hands it to
//    consumer 1 through shared memory (fp32, so dS is computed from the
//    same P as in one thread); consumer 1 computes dP^T = V dO^T over the
//    full D and dS^T = P^T * (dP^T - Delta). Then consumer 0 accumulates
//    dV += P^T dO and consumer 1 dK += dS^T Q, each with its own operand in
//    registers (the accumulators of its product, packed to bf16) and the
//    other MN-major in shared memory. So S^T and dP^T are computed once per
//    (key tile, query tile, head): 4 products a tile, and at D = 256 each
//    consumer keeps 128 accumulator registers a thread. dK and dV stay in
//    registers across the whole loop: the group sum needs no atomics and a
//    step is reproducible bit for bit.
// 3. dq: one CTA per (64-query block, two heads or two row blocks, batch
//    row), beside dkv on a side stream where dkv fills the card (forked
//    after delta, joined back to the caller's stream), with the forward's
//    shape and a ring of K and V tiles of 64 keys; S = Q K^T and
//    dP = dO V^T are recomputed, then dQ += dS K (K MN-major). Storing dS
//    from the dkv pass instead would write and read B * H * S^2 * 2 bytes
//    (135 MB at the page shape, growing with S^2) to save two products that
//    cost about as much. At D = 256 the key tile is 32 keys so that Q and dO
//    of both consumers (128 KB) and two ring stages fit.
// Built for the forward's head dims: DP = 64 (the Idefics3 towers: a row is one
// 128-byte swizzle atom, four ring stages in each kernel), 80 (D 72 and 80:
// SigLIP, the Qwen2-VL vision towers), 128 (the Qwen2 decoders) and 256 (Gemma).
// The queries' ids (seg) and the keys' (kv_seg) are separate arrays, as in the
// forward: the Idefics3 decoder gives every query id 1 and the keys the
// validity mask, so pad rows attend to the valid keys (JAX's key-padding bias).
// At DP = 128 dkv takes 150,840 bytes of shared memory and dq 165,688, three
// stages each; at DP = 64 about 100 KB each with four. The register split
// stays 2 x 128 x 232 + 128 x 40 at every DP.
// Rows past S, dims past D and masked pairs contribute zeros; a row with no
// allowed key has L = -inf and P = 0 everywhere, so its gradients are zero,
// never NaN. q, k and v are read through their strides as in the forward;
// dO, o and the three gradients are contiguous. Offsets are 64-bit.
//
// Not yet done here (later work): overlapping a consumer's elementwise work
// with its next product (in dkv the two consumers wait for each other every
// tile), a persistent grid, skipping tiles that share no segment.

#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = kConsumerRows;  // rows of a consumer's own tile; queries of a dkv ring tile
constexpr int kThreads = 3 * 128;  // consumers 0 and 1, then the producer
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kBarPFull = 1, kBarPEmpty = 2;  // named barriers of the P^T hand-over

struct BwdArgs {
  const int32_t* seg;     // (B, S), the queries' ids
  const int32_t* kv_seg;  // (B, S), the keys' ids (seg itself where they are the same)
  const float* lse;       // (B, H, S)
  float* delta;           // (B, H, S), written by delta_kernel
  __nv_bfloat16 *dq, *dk, *dv;  // (B, S, H, D) and (B, S, Hkv, D) contiguous
  int s, h, hkv, d, causal;
  float scale, scale_log2;
};

// ---- delta = rowsum(dO * o), (B, S, H, D) contiguous -> (B, H, S) ----------

__global__ void delta_kernel(const __nv_bfloat16* __restrict__ d_out, const __nv_bfloat16* __restrict__ out,
                             float* __restrict__ delta, int64_t rows, int s, int h, int d) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* a = d_out + row * d;
  const __nv_bfloat16* b = out + row * d;
  float sum = 0.0f;
  for (int i = lane; i < d; i += 32) sum += __bfloat162float(a[i]) * __bfloat162float(b[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int64_t bs = row / h;  // row = (b * S + s) * H + h
    const int head = static_cast<int>(row % h);
    delta[((bs / s) * h + head) * s + bs % s] = sum;
  }
}

// ---- dk, dv -----------------------------------------------------------------

template <int DP>
__host__ __device__ constexpr int dkv_stages() {  // at D = 64 a ring tile is 8 KB: one stage more
  return DP == 256 ? 2 : DP == 64 ? 4 : 3;
}

template <int DP>
__host__ __device__ constexpr size_t dkv_smem() {
  constexpr size_t tile = HeadDims<DP>::template bytes<kRows>();
  return kSmemSlack + (2 + 2 * dkv_stages<DP>()) * tile + 32 * 128 * 4 + dkv_stages<DP>() * kRows * 12 +
         (1 + 2 * dkv_stages<DP>()) * 8;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ TileMaps q_maps, const __grid_constant__ TileMaps k_maps,
                         const __grid_constant__ TileMaps v_maps, const __grid_constant__ TileMaps do_maps,
                         const BwdArgs a) {
  constexpr int STAGES = dkv_stages<DP>();
  constexpr uint32_t TILE = HeadDims<DP>::template bytes<kRows>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t s_k = smem_addr(smem), s_v = s_k + TILE;  // the CTA's keys
  const uint32_t s_q = s_v + TILE;                           // STAGES tiles
  const uint32_t s_do = s_q + STAGES * TILE;                 // STAGES tiles
  float* s_p = reinterpret_cast<float*>(smem + (2 + 2 * STAGES) * TILE);  // P^T hand-over, (32, 128)
  float* s_lse = s_p + 32 * 128;                                            // (STAGES, 64) each
  float* s_delta = s_lse + STAGES * kRows;
  int32_t* s_seg = reinterpret_cast<int32_t*>(s_delta + STAGES * kRows);
  const uint32_t bar_kv = smem_addr(s_seg + STAGES * kRows);
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * STAGES;

  const int k0 = blockIdx.x * kRows;
  const int kv_head = blockIdx.y;
  const int bi = blockIdx.z;
  const int group = a.h / a.hkv;
  const int q_begin = a.causal ? k0 : 0;  // queries before the tile's first key see none of it
  const int q_tiles = (a.s - q_begin + kRows - 1) / kRows;
  const int n_tiles = group * q_tiles;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ---- producer ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 != 8) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * TILE);
      load_tile<DP, kRows>(s_k, k_maps, kv_head, k0, bi, bar_kv);
      load_tile<DP, kRows>(s_v, v_maps, kv_head, k0, bi, bar_kv);
    }
    const int32_t* seg_row = a.seg + static_cast<int64_t>(bi) * a.s;  // the ring's queries
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % STAGES;
      const int head = kv_head * group + t / q_tiles, q0 = q_begin + (t % q_tiles) * kRows;
      mbar_wait(bar_empty + 8 * stage, ((t / STAGES) & 1) ^ 1);
      const int64_t stat = (static_cast<int64_t>(bi) * a.h + head) * a.s;
      for (int e = lane; e < kRows; e += 32) {
        const bool in = q0 + e < a.s;
        s_lse[stage * kRows + e] = in ? a.lse[stat + q0 + e] : 0.0f;
        s_delta[stage * kRows + e] = in ? a.delta[stat + q0 + e] : 0.0f;
        s_seg[stage * kRows + e] = in ? seg_row[q0 + e] : 0;
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t full = bar_full + 8 * stage;
        mbar_expect_tx(full, 2 * TILE);
        load_tile<DP, kRows>(s_q + stage * TILE, q_maps, head, q0, bi, full);
        load_tile<DP, kRows>(s_do + stage * TILE, do_maps, head, q0, bi, full);
      }
    }
    return;
  }

  // ---- consumers: 0 owns dV, 1 owns dK ----
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const int32_t* seg_row = a.kv_seg + static_cast<int64_t>(bi) * a.s;  // the CTA's own keys
  const int seg_lo = key_lo < a.s ? seg_row[key_lo] : 0, seg_hi = key_hi < a.s ? seg_row[key_hi] : 0;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

  mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % STAGES;
    const int q0 = q_begin + (t % q_tiles) * kRows;
    mbar_wait(bar_full + 8 * stage, (t / STAGES) & 1);
    float x[kRows / 2];  // S^T (consumer 0) or dP^T (consumer 1): this warp's 16 keys x the tile's 64 queries
    uint32_t frag[kRows / 16][4];
    // consumer 0: S^T = K Q^T, then dV += P^T dO; consumer 1: dP^T = V dO^T, then dK += dS^T Q
    const uint32_t q_tile = s_q + stage * TILE, do_tile = s_do + stage * TILE;
    wgmma_fence();
    product_ss<DP, kRows>(x, wg == 0 ? s_k : s_v, wg == 0 ? q_tile : do_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands<kRows / 2>(x);
    if (wg == 0) {
      const float* lse = s_lse + stage * kRows;
      const int32_t* qseg = s_seg + stage * kRows;
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        const int j = (i / 4) * 8 + 2 * tg + (i & 1);
        const int row = q0 + j;
        const bool upper = (i & 2) != 0;
        const int key = upper ? key_hi : key_lo;
        const bool ok = key < a.s && row < a.s && qseg[j] == (upper ? seg_hi : seg_lo) && (!a.causal || key <= row);
        x[i] = ok ? fast_exp2(fmaf(x[i], a.scale_log2, -lse[j])) : 0.0f;  // P^T
      }
      if (t > 0) named_bar_sync(kBarPEmpty, 256);  // consumer 1 has read the previous tile's P^T
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) s_p[i * 128 + tid] = x[i];
      named_bar_arrive(kBarPFull, 256);
    } else {
      const float* delta = s_delta + stage * kRows;
      named_bar_sync(kBarPFull, 256);
#pragma unroll
      for (int i = 0; i < kRows / 2; ++i) {
        const int j = (i / 4) * 8 + 2 * tg + (i & 1);
        x[i] = s_p[i * 128 + tid] * (x[i] - delta[j]);  // dS^T
      }
      if (t + 1 < n_tiles) named_bar_arrive(kBarPEmpty, 256);
    }
    to_a_fragments<kRows>(frag, x);
    wgmma_fence();
    product_rs<DP, kRows>(acc, frag, wg == 0 ? do_tile : q_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands<DP / 2>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
  }

  const float mul = wg == 0 ? 1.0f : a.scale;
  __nv_bfloat16* grad = wg == 0 ? a.dv : a.dk;
  const int64_t row_stride = static_cast<int64_t>(a.hkv) * a.d;
  const int64_t base = static_cast<int64_t>(bi) * a.s * row_stride + static_cast<int64_t>(kv_head) * a.d;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * tg;
    if (col >= a.d) continue;
    if (key_lo < a.s)
      *reinterpret_cast<uint32_t*>(grad + base + key_lo * row_stride + col) =
          pack_bf16(acc[4 * n] * mul, acc[4 * n + 1] * mul);
    if (key_hi < a.s)
      *reinterpret_cast<uint32_t*>(grad + base + key_hi * row_stride + col) =
          pack_bf16(acc[4 * n + 2] * mul, acc[4 * n + 3] * mul);
  }
}

// ---- dq -----------------------------------------------------------------------

template <int DP>
__host__ __device__ constexpr int dq_keys() {  // keys per ring tile
  return DP == 256 ? 32 : 64;
}

template <int DP>
__host__ __device__ constexpr int dq_stages() {
  return DP == 256 ? 2 : DP == 64 ? 4 : 3;
}

template <int DP>
__host__ __device__ constexpr size_t dq_smem() {
  constexpr size_t own = HeadDims<DP>::template bytes<kRows>();
  constexpr size_t ring = HeadDims<DP>::template bytes<dq_keys<DP>()>();
  return kSmemSlack + 4 * own + 2 * dq_stages<DP>() * ring + dq_stages<DP>() * dq_keys<DP>() * 4 +
         (1 + 2 * dq_stages<DP>()) * 8;
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ TileMaps q_maps, const __grid_constant__ TileMaps k_maps,
                        const __grid_constant__ TileMaps v_maps, const __grid_constant__ TileMaps do_maps,
                        const BwdArgs a) {
  constexpr int BK = dq_keys<DP>(), STAGES = dq_stages<DP>();
  constexpr uint32_t OWN = HeadDims<DP>::template bytes<kRows>(), RING = HeadDims<DP>::template bytes<BK>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t s_q = smem_addr(smem), s_do = s_q + 2 * OWN;  // one tile of each per consumer
  const uint32_t s_k = s_do + 2 * OWN, s_v = s_k + STAGES * RING;
  int32_t* s_seg = reinterpret_cast<int32_t*>(smem + 4 * OWN + 2 * STAGES * RING);  // (STAGES, BK)
  const uint32_t bar_own = smem_addr(s_seg + STAGES * BK);
  const uint32_t bar_full = bar_own + 8, bar_empty = bar_full + 8 * STAGES;

  const int bi = blockIdx.z;
  const ConsumerRows w0 = consumer_rows(0, a.s, a.h, a.hkv, a.causal);  // the forward's assignment
  const ConsumerRows w1 = consumer_rows(1, a.s, a.h, a.hkv, a.causal);
  const int kv_head = w0.head / (a.h / a.hkv);
  const int n_tiles = (max(w0.k_end, w1.k_end) + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_own, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ---- producer ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 != 8) return;
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(bar_own, (w1.active ? 4 : 2) * OWN);
      load_tile<DP, kRows>(s_q, q_maps, w0.head, w0.row0, bi, bar_own);
      load_tile<DP, kRows>(s_do, do_maps, w0.head, w0.row0, bi, bar_own);
      if (w1.active) {
        load_tile<DP, kRows>(s_q + OWN, q_maps, w1.head, w1.row0, bi, bar_own);
        load_tile<DP, kRows>(s_do + OWN, do_maps, w1.head, w1.row0, bi, bar_own);
      }
    }
    const int32_t* seg_row = a.kv_seg + static_cast<int64_t>(bi) * a.s;  // the ring's keys
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % STAGES;
      mbar_wait(bar_empty + 8 * stage, ((t / STAGES) & 1) ^ 1);
      const int k0 = t * BK;
      for (int e = lane; e < BK; e += 32) s_seg[stage * BK + e] = k0 + e < a.s ? seg_row[k0 + e] : 0;
      __syncwarp();
      if (lane == 0) {
        const uint32_t full = bar_full + 8 * stage;
        mbar_expect_tx(full, 2 * RING);
        load_tile<DP, BK>(s_k + stage * RING, k_maps, kv_head, k0, bi, full);
        load_tile<DP, BK>(s_v + stage * RING, v_maps, kv_head, k0, bi, full);
      }
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const ConsumerRows w = wg == 0 ? w0 : w1;
  const int my_head = w.head, my_end = w.k_end;
  const int row_lo = w.row0 + warp * 16 + g, row_hi = row_lo + 8;
  const int32_t* seg_row = a.seg + static_cast<int64_t>(bi) * a.s;  // the block's own queries
  const int64_t stat = (static_cast<int64_t>(bi) * a.h + my_head) * a.s;
  const bool in_lo = my_end > 0 && row_lo < a.s, in_hi = my_end > 0 && row_hi < a.s;
  const int seg_lo = in_lo ? seg_row[row_lo] : 0, seg_hi = in_hi ? seg_row[row_hi] : 0;
  const float lse_lo = in_lo ? a.lse[stat + row_lo] : 0.0f, lse_hi = in_hi ? a.lse[stat + row_hi] : 0.0f;
  const float del_lo = in_lo ? a.delta[stat + row_lo] : 0.0f, del_hi = in_hi ? a.delta[stat + row_hi] : 0.0f;
  const uint32_t q_tile = s_q + wg * OWN, do_tile = s_do + wg * OWN;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

  mbar_wait(bar_own, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % STAGES;
    mbar_wait(bar_full + 8 * stage, (t / STAGES) & 1);
    const int k0 = t * BK;
    if (k0 < my_end) {
      float sc[BK / 2], dp[BK / 2];
      wgmma_fence();
      product_ss<DP, BK>(sc, q_tile, s_k + stage * RING);
      product_ss<DP, BK>(dp, do_tile, s_v + stage * RING);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<BK / 2>(sc);
      fence_operands<BK / 2>(dp);
      const int32_t* kseg = s_seg + stage * BK;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int j = (i / 4) * 8 + 2 * tg + (i & 1);
        const int key = k0 + j;
        const bool upper = (i & 2) != 0;
        const int row = upper ? row_hi : row_lo;
        const bool ok = key < a.s && row < a.s && kseg[j] == (upper ? seg_hi : seg_lo) && (!a.causal || key <= row);
        const float p = ok ? fast_exp2(fmaf(sc[i], a.scale_log2, -(upper ? lse_hi : lse_lo))) : 0.0f;
        sc[i] = p * (dp[i] - (upper ? del_hi : del_lo));  // dS
      }
      uint32_t frag[BK / 16][4];
      to_a_fragments<BK>(frag, sc);
      wgmma_fence();
      product_rs<DP, BK>(acc, frag, s_k + stage * RING);  // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<DP / 2>(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
  }
  if (my_end == 0) return;

  const int64_t row_stride = static_cast<int64_t>(a.h) * a.d;
  __nv_bfloat16* o_base = a.dq + static_cast<int64_t>(bi) * a.s * row_stride + static_cast<int64_t>(my_head) * a.d;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * tg;
    if (col >= a.d) continue;
    if (row_lo < a.s)
      *reinterpret_cast<uint32_t*>(o_base + row_lo * row_stride + col) =
          pack_bf16(acc[4 * n] * a.scale, acc[4 * n + 1] * a.scale);
    if (row_hi < a.s)
      *reinterpret_cast<uint32_t*>(o_base + row_hi * row_stride + col) =
          pack_bf16(acc[4 * n + 2] * a.scale, acc[4 * n + 3] * a.scale);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* out, const void* d_out, int b,
                   Strides qs, Strides ks, Strides vs, const BwdArgs& a, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(b) * a.s * a.h;
  delta_kernel<<<static_cast<unsigned int>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(d_out), static_cast<const __nv_bfloat16*>(out), a.delta,
      rows, a.s, a.h, a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const Strides os{static_cast<int64_t>(a.s) * a.h * a.d, static_cast<int64_t>(a.h) * a.d, a.d};  // dO, contiguous
  constexpr int BK = dq_keys<DP>();
  TileMaps q_maps, do_maps, k_ring, v_ring, k_own, v_own;  // K and V as dq's ring tiles and as dkv's own
  err = colpali_tile_maps(&q_maps, DP, q, b, a.s, a.h, a.d, qs, kRows);
  if (err == cudaSuccess) err = colpali_tile_maps(&do_maps, DP, d_out, b, a.s, a.h, a.d, os, kRows);
  if (err == cudaSuccess) err = colpali_tile_maps(&k_ring, DP, k, b, a.s, a.hkv, a.d, ks, BK);
  if (err == cudaSuccess) err = colpali_tile_maps(&v_ring, DP, v, b, a.s, a.hkv, a.d, vs, BK);
  if (err == cudaSuccess) err = colpali_tile_maps(&k_own, DP, k, b, a.s, a.hkv, a.d, ks, kRows);
  if (err == cudaSuccess) err = colpali_tile_maps(&v_own, DP, v, b, a.s, a.hkv, a.d, vs, kRows);
  if (err == cudaSuccess) err = colpali_allow_smem(flash_bwd_dq_kernel<DP>, dq_smem<DP>());
  if (err == cudaSuccess) err = colpali_allow_smem(flash_bwd_dkv_kernel<DP>, dkv_smem<DP>());
  if (err != cudaSuccess) return err;

  // dkv has one CTA per (key block, KV head, batch row): at Gemma's page shape 136 for 132 SMs, a second
  // wave of 4. Where it fills the card at least once, dq runs beside it on a side stream (forked after
  // delta, joined back to the caller's stream) and its CTAs take the SMs that wave leaves idle. Below one
  // wave both kernels are short and the fork and join would cost more host time than they save.
  const int blocks = (a.s + kRows - 1) / kRows;
  const dim3 dkv_grid(blocks, a.hkv, b), dq_grid = consumer_grid(b, a.s, a.h, a.hkv);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (static_cast<int64_t>(blocks) * a.hkv * b < sms) {
    flash_bwd_dkv_kernel<DP><<<dkv_grid, kThreads, dkv_smem<DP>(), stream>>>(q_maps, k_own, v_own, do_maps, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<DP><<<dq_grid, kThreads, dq_smem<DP>(), stream>>>(q_maps, k_ring, v_ring, do_maps, a);
    return cudaGetLastError();
  }
  SideStream* side = nullptr;
  err = colpali_side_stream(&side);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(side->mu);
  err = cudaEventRecord(side->fork, stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(side->stream, side->fork, 0);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<DP><<<dkv_grid, kThreads, dkv_smem<DP>(), stream>>>(q_maps, k_own, v_own, do_maps, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DP><<<dq_grid, kThreads, dq_smem<DP>(), side->stream>>>(q_maps, k_ring, v_ring, do_maps, a);
  err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaEventRecord(side->join, side->stream);
  if (err == cudaSuccess) err = cudaStreamWaitEvent(stream, side->join, 0);
  return err;
}

}  // namespace

// q, k and v as in colpali_flash_attention (element strides, contiguous head
// dim, 16-byte aligned base and rows); out, d_out, dq (B, S, H, D) and dk, dv
// (B, S, Hkv, D) contiguous bf16; lse (B, H, S) as the forward wrote it;
// delta (B, H, S) fp32 workspace; seg the queries' ids and kv_seg the keys' (B, S) int32, as in the forward.
// d is one of the forward's head dims: 64, 72, 80, 128 and 256.
extern "C" int colpali_flash_attention_bwd(const void* q, const void* k, const void* v, const void* seg,
                                           const void* kv_seg, const void* out, const void* d_out, const void* lse,
                                           void* delta, void* dq, void* dk, void* dv, int b, int s, int h, int hkv, int d,
                                           int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                           int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
                                           int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const BwdArgs a{static_cast<const int32_t*>(seg), static_cast<const int32_t*>(kv_seg),
                  static_cast<const float*>(lse), static_cast<float*>(delta),
                  static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                  s, h, hkv, d, causal, scale, scale * 1.4426950408889634f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, out, d_out, b, qs, ks, vs, a, st);    // the Idefics3 towers
    case 72:                                                                   // SigLIP
    case 80: return launch<80>(q, k, v, out, d_out, b, qs, ks, vs, a, st);    // the Qwen2-VL vision towers
    case 128: return launch<128>(q, k, v, out, d_out, b, qs, ks, vs, a, st);  // the Qwen2 decoders
    case 256: return launch<256>(q, k, v, out, d_out, b, qs, ks, vs, a, st);  // Gemma
    default: return cudaErrorInvalidValue;
  }
}
