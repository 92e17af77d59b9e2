// K6: segment-masked flash attention forward, bf16 in and out; also K11.
//
// Replaces colpali_tpu/models/layers.py::flash_attention_padded, which drives
// the stock Pallas TPU flash kernel through _flash_kernel_call, and
// colpali_tpu/ops/flash_seqmajor.py::flash_seqmajor (K11). From
// q (B, S, H, D) and k, v (B, S, Hkv, D) with H % Hkv == 0, the query rows'
// segment ids seg (B, S) int32 and the keys' kv_seg (B, S) int32 (the stock
// TPU kernel's SegmentIds(q=, kv=); most callers pass one array for both):
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / (H / Hkv)]) v[b, j, h / (H / Hkv)]
//
// over the keys j with kv_seg[b, j] == seg[b, i] (and j <= i when causal),
// with fp32 logits, an fp32 online softmax and fp32 accumulation. Pad tokens
// carry their own segment id, so pad rows attend only to pad rows, as on the
// TPU; callers mask them. Query ids of 1 on every row over key ids of the
// validity mask give a key-padding mask instead: every row, pad rows too,
// attends to the valid keys (the JAX package's additive-bias route, which
// the Idefics3 decoder's right-padded rows follow).
//
// What bounds it on an H100: tensor-core throughput. At SigLIP's shape
// (S = 1024, D = 72) a (b, h) pair does 4 * S^2 * D = 302 MFLOP on 0.6 MB of
// q, k, v (at the Idefics3 tower's D = 64, 268 MFLOP on 0.5 MB); at Gemma's (S = 1029, D = 256, 8 query heads on one KV head)
// 1.1 GFLOP per pair. Both sit far above the card's 295 FLOP/byte ridge, so
// the design feeds the tensor cores the way Hopper allows (hopper.cuh):
//
// - A CTA is three warpgroups: two consumers of 64 query rows each, then a
//   producer whose first warp issues every load (setmaxnreg moves registers
//   from it to the consumers). Under MQA/GQA the consumers take two query
//   heads of one KV head over the same rows, so Gemma's 8/1 stages each K/V
//   tile 4 times, not 8; otherwise two neighbouring 64-row blocks of one
//   head. A group with an odd number of heads leaves the last CTA's second
//   consumer idle: it keeps the barrier protocol and writes nothing.
// - K and V tiles (128 keys at D <= 128, 64 at D = 256) come through an
//   mbarrier ring (4 stages at D = 64 and 80, 3 at 128, 2 at 256), filled by TMA
//   from 4-D tensor maps over the tensors' own (D, H, S, B) strides: no
//   copy, no repeat of the KV head, zeros past S and past D from the
//   hardware. The producer also stages the tile's key segment ids. Q is
//   loaded once.
// - S = Q K^T is wgmma m64n128k16 (m64n64k16 at D = 256) with both operands
//   K-major in shared memory; O += P V is wgmma with P in registers (the S
//   accumulators packed to bf16) and V MN-major through the transpose flag,
//   n = D in one instruction per 16 keys (n = 64 + 16 at D = 72 and 80).
// - The online softmax as before: base 2 with the scale folded into
//   log2(e), row max and sum in registers, the segment and causal masks on
//   S, key tiles past the diagonal not loaded. The producer marks a tile
//   whose keys all lie below S in one segment; where that is the rows'
//   segment (and the tile is below the diagonal), no mask is computed.
// - At D <= 128 (3 or 4 stages) a consumer issues S of tile t + 1 and
//   O += P V of tile t together and computes tile t + 1's softmax while
//   P V runs, holding two stages; and the two consumers take turns to issue
//   their products (two named barriers), so one's softmax runs while the
//   other's products do. At D = 256 only two stages fit, so a consumer
//   takes one tile at a time and the producer stays a tile ahead.
// A row whose keys are all masked (impossible under segment semantics,
// since a token matches itself) writes zeros instead of dividing by zero.
//
// K11 is this kernel: the seq-major TPU kernel exists to read (B, S, H, D)
// blocks without the stock kernel's transposes, padding and GQA repeat,
// which the tensor maps already do. ops/flash_seqmajor.py launches it and
// counts apart.
//
// What holds it back now (PERF.md): at D = 72 and 80 the softmax's
// exponentials (one per query-key pair, 16 a clock on an SM) weigh about as
// much as the two products (an estimate, not measured apart); at D = 256,
// the two-stage ring; under a causal mask, the 128-key tile on the diagonal,
// half of which a 64-row consumer masks. Not yet done here (later work): the
// overlap inside a consumer at D = 256 (it needs a third stage, or K and V
// in separate stages), a TMA store of O, skipping key tiles that share no
// segment with the block, and a persistent grid.

#include <math_constants.h>

#include "hopper.cuh"

namespace {

constexpr int kRows = kConsumerRows;   // query rows of a consumer
constexpr int kThreads = 3 * 128;      // consumers 0 and 1, then the producer
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kBarTurn = 1;  // named barriers 1 and 2: consumer 0's and consumer 1's turn to issue products

struct FwdArgs {
  const int32_t* seg;     // (B, S): the query rows' segment ids
  const int32_t* kv_seg;  // (B, S): the keys'
  __nv_bfloat16* out;  // (B, S, H, D) contiguous
  float* lse;          // (B, H, S) or null
  int s, h, hkv, d, causal;
  float scale_log2;
};

template <int DP>
__host__ __device__ constexpr int keys() {  // keys of a K/V tile
  return DP == 256 ? 64 : 128;
}

template <int DP>
__host__ __device__ constexpr int stages() {
  return DP == 256 ? 2 : DP == 128 ? 3 : 4;
}

template <int DP>
__host__ __device__ constexpr size_t smem_bytes() {
  constexpr size_t q_tile = HeadDims<DP>::template bytes<kRows>(), kv_tile = HeadDims<DP>::template bytes<keys<DP>()>();
  return kSmemSlack + 2 * q_tile + 2 * stages<DP>() * kv_tile + stages<DP>() * (keys<DP>() + 2) * 4 +
         (1 + 2 * stages<DP>()) * 8;
}

// The online softmax state of a thread's two rows (g and g + 8 of its
// warp's 16), in base 2 with the scale folded into log2(e): running max m of
// the scaled logits, per-thread partial sums l (reduced over the quad at the
// end) and the factor the last update rescales O by.
struct RowSoftmax {
  float m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi;

  // sc: this tile's raw logits on entry (N / 2 of a 64 x N tile), its
  // unnormalized probabilities on exit. `whole`: every key of the tile is
  // allowed for both rows, so no mask.
  template <int N>
  __device__ __forceinline__ void update(float (&sc)[N], bool whole, const int32_t* kseg, int k0, int row_lo,
                                         int row_hi, int seg_lo, int seg_hi, int tg, const FwdArgs& a) {
    float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
    if (!whole) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int j = (i / 4) * 8 + 2 * tg + (i & 1);
        const int key = k0 + j;
        const bool upper = (i & 2) != 0;
        const bool ok = key < a.s && kseg[j] == (upper ? seg_hi : seg_lo) &&
                        (!a.causal || key <= (upper ? row_hi : row_lo));
        if (!ok) sc[i] = -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i & 2) mx_hi = fmaxf(mx_hi, sc[i]);
      else mx_lo = fmaxf(mx_lo, sc[i]);
    }
    const float new_lo = fmaxf(m_lo, quad_max(mx_lo) * a.scale_log2);
    const float new_hi = fmaxf(m_hi, quad_max(mx_hi) * a.scale_log2);
    const float base_lo = new_lo == -CUDART_INF_F ? 0.0f : new_lo;  // no key yet: keep exp2 finite
    const float base_hi = new_hi == -CUDART_INF_F ? 0.0f : new_hi;
    alpha_lo = fast_exp2(m_lo - base_lo);
    alpha_hi = fast_exp2(m_hi - base_hi);
    m_lo = new_lo;
    m_hi = new_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool upper = (i & 2) != 0;
      sc[i] = fast_exp2(fmaf(sc[i], a.scale_log2, -(upper ? base_hi : base_lo)));
      if (upper) sum_hi += sc[i];
      else sum_lo += sc[i];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
  }

  template <int DP>
  __device__ __forceinline__ void rescale(float* o) const {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= (i & 2) ? alpha_hi : alpha_lo;
  }
};

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ TileMaps q_maps, const __grid_constant__ TileMaps k_maps,
                     const __grid_constant__ TileMaps v_maps, const FwdArgs a) {
  constexpr int STAGES = stages<DP>(), BN = keys<DP>();
  constexpr uint32_t QTILE = HeadDims<DP>::template bytes<kRows>(), KVTILE = HeadDims<DP>::template bytes<BN>();
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t s_q = smem_addr(smem);          // 2 tiles: one per consumer
  const uint32_t s_k = s_q + 2 * QTILE;          // STAGES tiles
  const uint32_t s_v = s_k + STAGES * KVTILE;    // STAGES tiles
  int32_t* s_seg = reinterpret_cast<int32_t*>(smem + 2 * QTILE + 2 * STAGES * KVTILE);  // (STAGES, BN)
  int32_t* s_tile = s_seg + STAGES * BN;                                                // (STAGES, 2)
  const uint32_t bar_q = smem_addr(s_tile + 2 * STAGES);
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * STAGES;

  const int bi = blockIdx.z;
  const ConsumerRows w0 = consumer_rows(0, a.s, a.h, a.hkv, a.causal);  // always has work
  const ConsumerRows w1 = consumer_rows(1, a.s, a.h, a.hkv, a.causal);
  const int kv_head = w0.head / (a.h / a.hkv);
  const int n_tiles = (max(w0.k_end, w1.k_end) + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ---- producer ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 != 8) return;  // one warp issues the loads
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_expect_tx(bar_q, (w1.active ? 2 : 1) * QTILE);
      load_tile<DP, kRows>(s_q, q_maps, w0.head, w0.row0, bi, bar_q);
      if (w1.active) load_tile<DP, kRows>(s_q + QTILE, q_maps, w1.head, w1.row0, bi, bar_q);
    }
    const int32_t* seg_row = a.kv_seg + static_cast<int64_t>(bi) * a.s;
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % STAGES;
      mbar_wait(bar_empty + 8 * stage, ((t / STAGES) & 1) ^ 1);
      const int k0 = t * BN;
      const int32_t first = seg_row[k0];
      bool same = k0 + BN <= a.s;
      for (int e = lane; e < BN; e += 32) {
        const int32_t id = k0 + e < a.s ? seg_row[k0 + e] : 0;
        s_seg[stage * BN + e] = id;
        same = same && id == first;
      }
      same = __all_sync(0xffffffffu, same);
      if (lane == 0) {
        s_tile[2 * stage] = same;
        s_tile[2 * stage + 1] = first;
      }
      __syncwarp();
      if (lane == 0) {
        const uint32_t full = bar_full + 8 * stage;
        mbar_expect_tx(full, 2 * KVTILE);
        load_tile<DP, BN>(s_k + stage * KVTILE, k_maps, kv_head, k0, bi, full);
        load_tile<DP, BN>(s_v + stage * KVTILE, v_maps, kv_head, k0, bi, full);
      }
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<kConsumerRegs>();
  const ConsumerRows w = wg == 0 ? w0 : w1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int row_lo = w.row0 + warp * 16 + g, row_hi = row_lo + 8;
  const int32_t* seg_row = a.seg + static_cast<int64_t>(bi) * a.s;
  const int seg_lo = row_lo < a.s ? seg_row[row_lo] : 0;
  const int seg_hi = row_hi < a.s ? seg_row[row_hi] : 0;
  const uint32_t q_tile = s_q + wg * QTILE;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  RowSoftmax sm{-CUDART_INF_F, -CUDART_INF_F, 0.0f, 0.0f, 1.0f, 1.0f};
  float sc[BN / 2];         // S, then P, for this warp's 16 rows x a tile's BN keys
  uint32_t p[BN / 16][4];   // P as the bf16 A operand of O += P V
  const int my_tiles = (w.k_end + BN - 1) / BN;
  auto full = [&](int t) { return bar_full + 8 * (t % STAGES); };
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * (t % STAGES));
  };
  // the online softmax over tile t's keys, S in sc on entry, unnormalized P on exit
  auto softmax = [&](int t) {
    const int stage = t % STAGES, k0 = t * BN;
    const int* tile = s_tile + 2 * stage;  // {the tile's keys all lie below S in one segment, that segment}
    const bool whole = tile[0] && tile[1] == seg_lo && tile[1] == seg_hi && (!a.causal || k0 + BN - 1 <= row_lo);
    sm.update(sc, whole, s_seg + stage * BN, k0, row_lo, row_hi, seg_lo, seg_hi, tg, a);
  };

  // At D <= 128 the consumers take turns to issue their products, one turn a tile (past its own tiles a
  // consumer still takes its turns), so one's softmax runs while the other's products do; consumer 0 first.
  auto turn_wait = [&] { named_bar_sync(kBarTurn + wg, 256); };
  auto turn_pass = [&](int t) {
    if (wg == 0 || t + 1 < n_tiles) named_bar_arrive(kBarTurn + 1 - wg, 256);
  };

  mbar_wait(bar_q, 0);
  if constexpr (STAGES > 2) {
    // O += P V of tile t runs on the tensor cores while this warpgroup computes the softmax of tile t + 1,
    // whose S product was issued just before it. Each consumer holds two stages at a time.
    if (wg == 1) named_bar_arrive(kBarTurn, 256);
    if (my_tiles > 0) {
      mbar_wait(full(0), 0);
      turn_wait();
      wgmma_fence();
      product_ss<DP, BN>(sc, q_tile, s_k);
      wgmma_commit();
      turn_pass(0);
      wgmma_wait_all();
      fence_operands<BN / 2>(sc);
      softmax(0);
      to_a_fragments<BN>(p, sc);
    }
    for (int t = 0; t + 1 < my_tiles; ++t) {
      mbar_wait(full(t + 1), ((t + 1) / STAGES) & 1);
      turn_wait();
      wgmma_fence();
      product_ss<DP, BN>(sc, q_tile, s_k + ((t + 1) % STAGES) * KVTILE);
      wgmma_commit();
      product_rs<DP, BN>(o, p, s_v + (t % STAGES) * KVTILE);
      wgmma_commit();
      turn_pass(t + 1);
      wgmma_wait_one();  // S of tile t + 1 is in; P V of tile t may still run
      fence_operands<BN / 2>(sc);
      softmax(t + 1);
      wgmma_wait_all();
      fence_operands<DP / 2>(o);
      release(t);
      sm.rescale<DP>(o);
      to_a_fragments<BN>(p, sc);
    }
    if (my_tiles > 0) {  // the last tile's P V
      const int t = my_tiles - 1;
      wgmma_fence();
      product_rs<DP, BN>(o, p, s_v + (t % STAGES) * KVTILE);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<DP / 2>(o);
      release(t);
    }
  } else {  // two stages (D = 256): one tile at a time, so the producer loads a tile ahead
    for (int t = 0; t < my_tiles; ++t) {
      mbar_wait(full(t), (t / STAGES) & 1);
      wgmma_fence();
      product_ss<DP, BN>(sc, q_tile, s_k + (t % STAGES) * KVTILE);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<BN / 2>(sc);
      softmax(t);
      sm.rescale<DP>(o);
      to_a_fragments<BN>(p, sc);
      wgmma_fence();
      product_rs<DP, BN>(o, p, s_v + (t % STAGES) * KVTILE);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands<DP / 2>(o);
      release(t);
    }
  }
  for (int t = my_tiles; t < n_tiles; ++t) {  // tiles past this consumer's diagonal, or an idle consumer
    mbar_wait(full(t), (t / STAGES) & 1);
    if constexpr (STAGES > 2) {
      turn_wait();
      turn_pass(t);
    }
    release(t);
  }
  if (!w.active) return;

  const float l_lo = quad_sum(sm.l_lo), l_hi = quad_sum(sm.l_hi);
  const float inv_lo = l_lo > 0.0f ? 1.0f / l_lo : 0.0f;
  const float inv_hi = l_hi > 0.0f ? 1.0f / l_hi : 0.0f;
  if (a.lse != nullptr && tg == 0) {  // base-2 log-sum-exp of the scaled logits; -inf for a row with no key
    float* lse_row = a.lse + (static_cast<int64_t>(bi) * a.h + w.head) * a.s;
    if (row_lo < a.s) lse_row[row_lo] = l_lo > 0.0f ? sm.m_lo + log2f(l_lo) : -CUDART_INF_F;
    if (row_hi < a.s) lse_row[row_hi] = l_hi > 0.0f ? sm.m_hi + log2f(l_hi) : -CUDART_INF_F;
  }
  const int64_t row_stride = static_cast<int64_t>(a.h) * a.d;
  __nv_bfloat16* o_base = a.out + static_cast<int64_t>(bi) * a.s * row_stride + static_cast<int64_t>(w.head) * a.d;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = n * 8 + 2 * tg;
    if (col >= a.d) continue;
    if (row_lo < a.s)
      *reinterpret_cast<uint32_t*>(o_base + row_lo * row_stride + col) =
          pack_bf16(o[4 * n] * inv_lo, o[4 * n + 1] * inv_lo);
    if (row_hi < a.s)
      *reinterpret_cast<uint32_t*>(o_base + row_hi * row_stride + col) =
          pack_bf16(o[4 * n + 2] * inv_hi, o[4 * n + 3] * inv_hi);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, int b, Strides qs, Strides ks, Strides vs,
                   const FwdArgs& a, cudaStream_t stream) {
  TileMaps q_maps, k_maps, v_maps;
  cudaError_t err = colpali_tile_maps(&q_maps, DP, q, b, a.s, a.h, a.d, qs, kRows);
  if (err == cudaSuccess) err = colpali_tile_maps(&k_maps, DP, k, b, a.s, a.hkv, a.d, ks, keys<DP>());
  if (err == cudaSuccess) err = colpali_tile_maps(&v_maps, DP, v, b, a.s, a.hkv, a.d, vs, keys<DP>());
  if (err == cudaSuccess) err = colpali_allow_smem(flash_fwd_kernel<DP>, smem_bytes<DP>());
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<DP><<<consumer_grid(b, a.s, a.h, a.hkv), kThreads, smem_bytes<DP>(), stream>>>(q_maps, k_maps,
                                                                                                     v_maps, a);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements; the head dim of q, k and v must be contiguous,
// d one of 64, 72, 80, 128 and 256, and every row and the base 16-byte aligned
// (the wrapper checks all of it). lse, when not null, receives each row's
// log-sum-exp of the scaled logits in base 2 as (B, H, S) fp32, which the
// backward kernels read.
extern "C" int colpali_flash_attention(const void* q, const void* k, const void* v, const void* seg,
                                       const void* kv_seg, void* out, void* lse, int b, int s, int h, int hkv, int d, int64_t q_sb, int64_t q_ss,
                                       int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                                       int64_t v_ss, int64_t v_sh, float scale, int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const FwdArgs a{static_cast<const int32_t*>(seg), static_cast<const int32_t*>(kv_seg),
                  static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), s, h, hkv, d, causal,
                  scale * 1.4426950408889634f};  // softmax in base 2
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the head dims of the models that run it: the Idefics3 towers 64 (a bf16 row of 64 is one 128-byte swizzle
  // atom: no narrow chunk, no padding), SigLIP 72, Qwen2-VL's vision tower 80 and text tower 128, Gemma 256
  switch (d) {
    case 64: return launch<64>(q, k, v, b, qs, ks, vs, a, st);
    case 72:
    case 80: return launch<80>(q, k, v, b, qs, ks, vs, a, st);
    case 128: return launch<128>(q, k, v, b, qs, ks, vs, a, st);
    case 256: return launch<256>(q, k, v, b, qs, ks, vs, a, st);
    default: return cudaErrorInvalidValue;
  }
}
