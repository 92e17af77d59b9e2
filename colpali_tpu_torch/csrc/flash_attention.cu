// K6: segment-masked flash attention forward, bf16 in and out; also K11.
//
// Replaces colpali_tpu/models/layers.py::flash_attention_padded, which drives
// the stock Pallas TPU flash kernel through _flash_kernel_call, and
// colpali_tpu/ops/flash_seqmajor.py::flash_seqmajor (K11). From
// q (B, S, H, D) and k, v (B, S, Hkv, D) with H % Hkv == 0 and segment ids
// seg (B, S) int32:
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / (H / Hkv)]) v[b, j, h / (H / Hkv)]
//
// over the keys j with seg[b, j] == seg[b, i] (and j <= i when causal), with
// fp32 logits, an fp32 online softmax and fp32 accumulation. Pad tokens carry
// their own segment id, so pad rows attend only to pad rows, as on the TPU;
// callers mask them.
//
// What bounds it on an H100: tensor-core throughput. At SigLIP's shape
// (S = 1024, D = 72) a (b, h) pair does 4 * S^2 * D = 302 MFLOP on 0.6 MB of
// q, k, v; at Gemma's (S = 1030, D = 256, 8 query heads on one KV head)
// 1.1 GFLOP per pair. Both sit far above the card's 295 FLOP/byte ridge.
//
// Design: one CTA of four warps per (64-query block, head, batch row); each
// warp owns 16 query rows. The CTA stages its Q tile once, then streams 64-key
// tiles of K and V through shared memory, both row-major with 16-byte
// coalesced loads and stores. S = Q K^T and O += P V run as mma.sync m16n8k16
// on the bf16 tensor cores with fp32 accumulators: a Q or K fragment is one
// 32-bit shared-memory load, and V's fragments come transposed from
// ldmatrix.trans. P stays in registers (the S accumulator layout is the
// A-fragment layout of the second product). The online softmax works in
// base 2 with the scale folded into log2(e). Nothing is padded in device
// memory: the kernel reads q, k and v through their (B, S, H) strides, picks
// the KV head by index (no repeat for MQA/GQA), zero-fills head dims past D
// up to the multiple of 16 the mma needs (72 -> 80) in shared memory only,
// and masks keys past S. Rows are padded by 8 bf16 so the fragment loads are
// free of bank conflicts. A row whose keys are all masked (impossible under
// segment semantics, since a token matches itself) writes zeros instead of
// dividing by zero. Offsets are 64-bit.
//
// K11 is this kernel. The seq-major TPU kernel exists to read (B, S, H, D)
// blocks without the stock kernel's transposes, head-dim and sequence
// padding and GQA repeat: on the TPU that glue costs HBM passes, and Mosaic
// could not slice one head out of a seq-major block cheaply. Here the design
// above already is that: strided seq-major reads, the KV head picked by
// index, padding only in shared memory and masks past S. So K11 adds head
// dims, not code: DP = 80 serves D = 80 (Qwen2-VL's vision tower; nothing is
// zero-filled) as it serves D = 72, and DP = 128 serves D = 128 (its text
// tower, GQA 12/2), whose O accumulator is 64 fp32 registers a thread, half
// of D = 256's. ops/flash_seqmajor.py launches it and counts apart.
//
// Not yet done here (later work): cp.async/TMA double buffering of the K/V
// tiles, wgmma, and skipping key tiles that share no segment with the block.

#include <math_constants.h>

#include "mma.cuh"

namespace {

constexpr int kBlockQ = 64;  // query rows per CTA: 4 warps x 16 rows
constexpr int kBlockK = 64;  // keys per K/V tile
constexpr int kThreads = 128;

template <int DP>  // head dim rounded up to what the tiles hold (a multiple of 16)
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ seg,
                           __nv_bfloat16* __restrict__ out,  // (B, S, H, D) contiguous
                           float* __restrict__ lse,          // (B, H, S) or null
                           Strides qs, Strides ks, Strides vs, int s, int h, int hkv, int d, float scale_log2,
                           int causal) {
  constexpr int LD = DP + 8;        // row stride of the Q, K and V tiles
  constexpr int VEC = DP / 8;       // 16-byte vectors per row
  constexpr int NK = kBlockK / 8;   // n-tiles of S per warp
  constexpr int ND = DP / 8;        // n-tiles of O per warp
  extern __shared__ int4 smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (kBlockQ, LD)
  __nv_bfloat16* s_k = s_q + kBlockQ * LD;                            // (kBlockK, LD)
  __nv_bfloat16* s_v = s_k + kBlockK * LD;                            // (kBlockK, LD)
  int32_t* s_seg = reinterpret_cast<int32_t*>(s_v + kBlockK * LD);    // (kBlockK)

  const int q0 = blockIdx.x * kBlockQ;
  const int head = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int kv_head = head / (h / hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row and column pair

  const __nv_bfloat16* q_base = q + bi * qs.b + head * qs.h;
  const __nv_bfloat16* k_base = k + bi * ks.b + kv_head * ks.h;
  const __nv_bfloat16* v_base = v + bi * vs.b + kv_head * vs.h;
  const int32_t* seg_row = seg + bi * s;

  for (int e = tid; e < kBlockQ * VEC; e += kThreads) {
    const int r = e / VEC, c = (e % VEC) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (q0 + r < s && c < d) val = *reinterpret_cast<const int4*>(q_base + (q0 + r) * qs.s + c);
    *reinterpret_cast<int4*>(s_q + r * LD + c) = val;
  }

  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const int seg_lo = row_lo < s ? seg_row[row_lo] : 0;
  const int seg_hi = row_hi < s ? seg_row[row_hi] : 0;
  const __nv_bfloat16* s_qw = s_q + warp * 16 * LD;

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_lo = -CUDART_INF_F, m_hi = -CUDART_INF_F, l_lo = 0.0f, l_hi = 0.0f;

  const int k_end = causal ? min(s, q0 + kBlockQ) : s;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile is consumed (and the Q tile stored)
    for (int e = tid; e < kBlockK * VEC; e += kThreads) {
      const int r = e / VEC, c = (e % VEC) * 8;
      int4 kv = make_int4(0, 0, 0, 0), vv = make_int4(0, 0, 0, 0);
      if (k0 + r < s && c < d) {
        kv = *reinterpret_cast<const int4*>(k_base + (k0 + r) * ks.s + c);
        vv = *reinterpret_cast<const int4*>(v_base + (k0 + r) * vs.s + c);
      }
      *reinterpret_cast<int4*>(s_k + r * LD + c) = kv;
      *reinterpret_cast<int4*>(s_v + r * LD + c) = vv;
    }
    for (int e = tid; e < kBlockK; e += kThreads) s_seg[e] = k0 + e < s ? seg_row[k0 + e] : 0;
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sc[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      const __nv_bfloat16* qa = s_qw + g * LD + kk + 2 * tg;
      const uint32_t a0 = ld_pair(qa), a1 = ld_pair(qa + 8 * LD);
      const uint32_t a2 = ld_pair(qa + 8), a3 = ld_pair(qa + 8 * LD + 8);
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const __nv_bfloat16* kb = s_k + (n * 8 + g) * LD + kk + 2 * tg;
        mma_bf16(sc[n], a0, a1, a2, a3, ld_pair(kb), ld_pair(kb + 8));
      }
    }

    // mask, scale to base 2, and the online softmax update
    float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * tg + (e & 1);
        const int key = k0 + j;
        const bool upper = e >= 2;
        const bool ok = key < s && s_seg[j] == (upper ? seg_hi : seg_lo) &&
                        (!causal || key <= (upper ? row_hi : row_lo));
        const float x = ok ? sc[n][e] * scale_log2 : -CUDART_INF_F;
        sc[n][e] = x;
        if (upper) mx_hi = fmaxf(mx_hi, x);
        else mx_lo = fmaxf(mx_lo, x);
      }
    }
    const float new_lo = fmaxf(m_lo, quad_max(mx_lo)), new_hi = fmaxf(m_hi, quad_max(mx_hi));
    const float base_lo = new_lo == -CUDART_INF_F ? 0.0f : new_lo;  // no key yet: keep exp2 finite
    const float base_hi = new_hi == -CUDART_INF_F ? 0.0f : new_hi;
    const float alpha_lo = exp2f(m_lo - base_lo), alpha_hi = exp2f(m_hi - base_hi);
    m_lo = new_lo;
    m_hi = new_hi;
    float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      sc[n][0] = exp2f(sc[n][0] - base_lo);
      sc[n][1] = exp2f(sc[n][1] - base_lo);
      sc[n][2] = exp2f(sc[n][2] - base_hi);
      sc[n][3] = exp2f(sc[n][3] - base_hi);
      sum_lo += sc[n][0] + sc[n][1];
      sum_hi += sc[n][2] + sc[n][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;  // per-thread partial row sums, reduced at the end
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha_lo;
      o[n][1] *= alpha_lo;
      o[n][2] *= alpha_hi;
      o[n][3] *= alpha_hi;
    }

    // O += P V, P taken from the S accumulators as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      const uint32_t a1 = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      const uint32_t a2 = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      // lanes 0-15 address keys kk*16 + 0..15 of dims n*8.., lanes 16-31 of dims n*8+8..
      const __nv_bfloat16* vrow = s_v + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(b0, b1, b2, b3, vrow + n * 8);
        mma_bf16(o[n], a0, a1, a2, a3, b0, b1);
        mma_bf16(o[n + 1], a0, a1, a2, a3, b2, b3);
      }
    }
  }

  l_lo = quad_sum(l_lo);
  l_hi = quad_sum(l_hi);
  const float inv_lo = l_lo > 0.0f ? 1.0f / l_lo : 0.0f;
  const float inv_hi = l_hi > 0.0f ? 1.0f / l_hi : 0.0f;
  if (lse != nullptr && tg == 0) {  // base-2 log-sum-exp of the scaled logits; -inf for a row with no key
    float* lse_row = lse + (bi * h + head) * s;
    if (row_lo < s) lse_row[row_lo] = l_lo > 0.0f ? m_lo + log2f(l_lo) : -CUDART_INF_F;
    if (row_hi < s) lse_row[row_hi] = l_hi > 0.0f ? m_hi + log2f(l_hi) : -CUDART_INF_F;
  }
  const int64_t row_stride = static_cast<int64_t>(h) * d;
  __nv_bfloat16* o_base = out + bi * s * row_stride + static_cast<int64_t>(head) * d;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * tg;
    if (col >= d) continue;
    if (row_lo < s)
      *reinterpret_cast<uint32_t*>(o_base + row_lo * row_stride + col) = pack_bf16(o[n][0] * inv_lo, o[n][1] * inv_lo);
    if (row_hi < s)
      *reinterpret_cast<uint32_t*>(o_base + row_hi * row_stride + col) = pack_bf16(o[n][2] * inv_hi, o[n][3] * inv_hi);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse, int b, int s,
                   int h,
                   int hkv, int d, Strides qs, Strides ks, Strides vs, float scale_log2, int causal,
                   cudaStream_t stream) {
  static_assert(DP % 16 == 0, "the tiles hold a multiple of 16 head dims");
  const size_t smem = static_cast<size_t>(kBlockQ + 2 * kBlockK) * (DP + 8) * sizeof(__nv_bfloat16) +
                      kBlockK * sizeof(int32_t);
  cudaError_t err = colpali_allow_smem(flash_attention_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((s + kBlockQ - 1) / kBlockQ, h, b);
  flash_attention_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(seg), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), qs, ks, vs, s, h, hkv, d, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// Strides are in elements; the head dim of q, k and v must be contiguous,
// d one of 72, 80, 128 and 256, and every row 16-byte aligned (the wrapper
// checks all of it). lse, when not null, receives each row's log-sum-exp of the scaled
// logits in base 2 as (B, H, S) fp32, which the backward kernels read.
extern "C" int colpali_flash_attention(const void* q, const void* k, const void* v, const void* seg, void* out,
                                       void* lse, int b, int s, int h, int hkv, int d, int64_t q_sb, int64_t q_ss,
                                       int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh, int64_t v_sb,
                                       int64_t v_ss, int64_t v_sh, float scale, int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const float scale_log2 = scale * 1.4426950408889634f;  // softmax in base 2
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the head dims of the models that run it: SigLIP 72, Qwen2-VL's vision tower 80 and text tower 128, Gemma 256
  switch (d) {
    case 72:
    case 80: return launch<80>(q, k, v, seg, out, lse, b, s, h, hkv, d, qs, ks, vs, scale_log2, causal, st);
    case 128: return launch<128>(q, k, v, seg, out, lse, b, s, h, hkv, d, qs, ks, vs, scale_log2, causal, st);
    case 256: return launch<256>(q, k, v, seg, out, lse, b, s, h, hkv, d, qs, ks, vs, scale_log2, causal, st);
    default: return cudaErrorInvalidValue;
  }
}
