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
// minimum is 2.5x the forward's operations (five products against two); this
// version recomputes S and dP in both kernels, and twice more where D is
// split, so it does 3.5x (D = 72) to 4.5x (D = 256).
//
// Design: three kernels on one stream, one C entry point.
// 1. delta: one warp per (b, s, h) row sums dO * o in fp32 into (B, H, S).
// 2. dq: one CTA of four warps per (64-query block, head, batch row), the
//    forward's shape. Q and dO tiles are staged once; K and V tiles stream
//    through shared memory; S = Q K^T and dP = dO V^T use the forward's
//    first product, dQ += dS K its second (K read through ldmatrix.trans),
//    with dS taken from the accumulators as bf16 A fragments. At D = 256
//    the dQ accumulators are 128 registers a thread, so the key tile is 32
//    keys there (64 at D = 72) to keep S and dP at 16 registers each.
// 3. dkv: one CTA of four warps per (64-key block, D split, KV head, batch
//    row); each warp owns 16 keys. It loops over the query heads of its KV
//    head and over query tiles in a fixed order and keeps dK and dV in
//    registers, so the group sum needs no atomics and a step is
//    reproducible bit for bit. The products are the transposed ones:
//    S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q (dO and Q read
//    through ldmatrix.trans). At D = 256 the dK and dV accumulators of a
//    64-key tile would be 2 x 128 registers a thread, so D is split in two
//    halves over two CTAs: each recomputes S^T and dP^T over the full D and
//    accumulates 2 x 64 registers for its 128 dims, over 32-query tiles.
// Rows past S, dims past D and masked pairs contribute zeros; a row with no
// allowed key has L = -inf and P = 0 everywhere, so its gradients are zero,
// never NaN. q, k and v are read through their strides as in the forward;
// dO, o and the three gradients are contiguous. Offsets are 64-bit.
//
// Not yet done here (later work): one fused pass, cp.async double
// buffering, wgmma, skipping tiles that share no segment.

#include <math_constants.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerCta = 64;  // rows of the CTA's own tile: 4 warps x 16

// Stage `rows` rows of `DP` dims of a strided (B, S, H, D) tensor into a
// padded shared tile, zero-filled past S and past D.
template <int DP>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* base, int64_t row_stride,
                                           int row0, int rows, int s, int d, int tid) {
  constexpr int LD = DP + 8, VEC = DP / 8;
  for (int e = tid; e < rows * VEC; e += kThreads) {
    const int r = e / VEC, c = (e % VEC) * 8;
    int4 val = make_int4(0, 0, 0, 0);
    if (row0 + r < s && c < d) val = *reinterpret_cast<const int4*>(base + (row0 + r) * row_stride + c);
    *reinterpret_cast<int4*>(dst + r * LD + c) = val;
  }
}

// acc[n] += A(16 x DP, this warp's rows of `a_tile`) . B(N x DP, rows of `b_tile`)^T for N = 8 * NT
template <int DP, int NT>
__device__ __forceinline__ void product_nt(float (&acc)[NT][4], const __nv_bfloat16* a_rows,
                                           const __nv_bfloat16* b_tile, int g, int tg) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP; kk += 16) {
    const __nv_bfloat16* pa = a_rows + g * LD + kk + 2 * tg;
    const uint32_t a0 = ld_pair(pa), a1 = ld_pair(pa + 8 * LD);
    const uint32_t a2 = ld_pair(pa + 8), a3 = ld_pair(pa + 8 * LD + 8);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const __nv_bfloat16* pb = b_tile + (n * 8 + g) * LD + kk + 2 * tg;
      mma_bf16(acc[n], a0, a1, a2, a3, ld_pair(pb), ld_pair(pb + 8));
    }
  }
}

// acc (16 x 8 * ND, dims d0..) += P(16 x 8 * NT, from accumulators) . B(8 * NT x DP, row-major rows of `b_tile`)
template <int DP, int NT, int ND>
__device__ __forceinline__ void product_pb(float (&acc)[ND][4], const float (&p)[NT][4],
                                           const __nv_bfloat16* b_tile, int d0, int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a0 = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    const uint32_t a1 = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    const uint32_t a2 = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const __nv_bfloat16* brow = b_tile + (kk * 16 + (lane & 15)) * LD + d0 + (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b0, b1, b2, b3, brow + n * 8);
      mma_bf16(acc[n], a0, a1, a2, a3, b0, b1);
      mma_bf16(acc[n + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

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

// ---- dq ---------------------------------------------------------------------

template <int DP, int BK>  // padded head dim; keys per streamed tile
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ seg,
                        const __nv_bfloat16* __restrict__ d_out,  // (B, S, H, D) contiguous
                        const float* __restrict__ lse, const float* __restrict__ delta,  // (B, H, S)
                        __nv_bfloat16* __restrict__ dq,  // (B, S, H, D) contiguous
                        Strides qs, Strides ks, Strides vs, int s, int h, int hkv, int d, float scale,
                        float scale_log2, int causal) {
  constexpr int LD = DP + 8, NK = BK / 8, ND = DP / 8;
  extern __shared__ int4 smem_raw[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (64, LD)
  __nv_bfloat16* s_do = s_q + kRowsPerCta * LD;                       // (64, LD)
  __nv_bfloat16* s_k = s_do + kRowsPerCta * LD;                       // (BK, LD)
  __nv_bfloat16* s_v = s_k + BK * LD;                                 // (BK, LD)
  int32_t* s_seg = reinterpret_cast<int32_t*>(s_v + BK * LD);         // (BK)

  const int q0 = blockIdx.x * kRowsPerCta;
  const int head = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int kv_head = head / (h / hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int64_t row_stride = static_cast<int64_t>(h) * d;  // of dO and dq

  const __nv_bfloat16* k_base = k + bi * ks.b + kv_head * ks.h;
  const __nv_bfloat16* v_base = v + bi * vs.b + kv_head * vs.h;
  const int32_t* seg_row = seg + bi * s;
  stage_tile<DP>(s_q, q + bi * qs.b + head * qs.h, qs.s, q0, kRowsPerCta, s, d, tid);
  stage_tile<DP>(s_do, d_out + bi * s * row_stride + static_cast<int64_t>(head) * d, row_stride, q0, kRowsPerCta, s,
                 d, tid);

  const int row_lo = q0 + warp * 16 + g, row_hi = row_lo + 8;
  const float* stat = lse + (bi * h + head) * s;
  const float* dstat = delta + (bi * h + head) * s;
  const int seg_lo = row_lo < s ? seg_row[row_lo] : 0, seg_hi = row_hi < s ? seg_row[row_hi] : 0;
  const float lse_lo = row_lo < s ? stat[row_lo] : 0.0f, lse_hi = row_hi < s ? stat[row_hi] : 0.0f;
  const float del_lo = row_lo < s ? dstat[row_lo] : 0.0f, del_hi = row_hi < s ? dstat[row_hi] : 0.0f;

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int k_end = causal ? min(s, q0 + kRowsPerCta) : s;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and the Q and dO tiles stored)
    stage_tile<DP>(s_k, k_base, ks.s, k0, BK, s, d, tid);
    stage_tile<DP>(s_v, v_base, vs.s, k0, BK, s, d, tid);
    for (int e = tid; e < BK; e += kThreads) s_seg[e] = k0 + e < s ? seg_row[k0 + e] : 0;
    __syncthreads();

    float sc[NK][4], dp[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.0f;
    }
    product_nt<DP, NK>(sc, s_q + warp * 16 * LD, s_k, g, tg);
    product_nt<DP, NK>(dp, s_do + warp * 16 * LD, s_v, g, tg);
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * tg + (e & 1);
        const int key = k0 + j;
        const bool upper = e >= 2;
        const int row = upper ? row_hi : row_lo;
        const bool ok = key < s && row < s && s_seg[j] == (upper ? seg_hi : seg_lo) && (!causal || key <= row);
        const float p = ok ? exp2f(sc[n][e] * scale_log2 - (upper ? lse_hi : lse_lo)) : 0.0f;
        sc[n][e] = p * (dp[n][e] - (upper ? del_hi : del_lo));  // dS
      }
    }
    product_pb<DP, NK, ND>(acc, sc, s_k, 0, lane);
  }

  __nv_bfloat16* o_base = dq + bi * s * row_stride + static_cast<int64_t>(head) * d;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = n * 8 + 2 * tg;
    if (col >= d) continue;
    if (row_lo < s)
      *reinterpret_cast<uint32_t*>(o_base + row_lo * row_stride + col) = pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    if (row_hi < s)
      *reinterpret_cast<uint32_t*>(o_base + row_hi * row_stride + col) = pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// ---- dk, dv -----------------------------------------------------------------

template <int DP, int DH, int BQ>  // padded head dim; dims accumulated by one CTA; queries per streamed tile
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ seg,
                         const __nv_bfloat16* __restrict__ d_out,  // (B, S, H, D) contiguous
                         const float* __restrict__ lse, const float* __restrict__ delta,  // (B, H, S)
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,  // (B, S, Hkv, D) contiguous
                         Strides qs, Strides ks, Strides vs, int s, int h, int hkv, int d, float scale,
                         float scale_log2, int causal) {
  constexpr int LD = DP + 8, NQ = BQ / 8, ND = DH / 8, SPLITS = DP / DH;
  extern __shared__ int4 smem_raw[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (64, LD)
  __nv_bfloat16* s_v = s_k + kRowsPerCta * LD;                        // (64, LD)
  __nv_bfloat16* s_q = s_v + kRowsPerCta * LD;                        // (BQ, LD)
  __nv_bfloat16* s_do = s_q + BQ * LD;                                // (BQ, LD)
  float* s_lse = reinterpret_cast<float*>(s_do + BQ * LD);            // (BQ)
  float* s_delta = s_lse + BQ;                                        // (BQ)
  int32_t* s_seg = reinterpret_cast<int32_t*>(s_delta + BQ);          // (BQ)

  const int k0 = (blockIdx.x / SPLITS) * kRowsPerCta;
  const int d0 = (blockIdx.x % SPLITS) * DH;  // this CTA's dims of dk and dv
  const int kv_head = blockIdx.y;
  const int64_t bi = blockIdx.z;
  const int group = h / hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, tg = lane & 3;
  const int64_t do_stride = static_cast<int64_t>(h) * d;

  const int32_t* seg_row = seg + bi * s;
  stage_tile<DP>(s_k, k + bi * ks.b + kv_head * ks.h, ks.s, k0, kRowsPerCta, s, d, tid);
  stage_tile<DP>(s_v, v + bi * vs.b + kv_head * vs.h, vs.s, k0, kRowsPerCta, s, d, tid);

  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;
  const int seg_lo = key_lo < s ? seg_row[key_lo] : 0, seg_hi = key_hi < s ? seg_row[key_hi] : 0;

  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc_k[n][0] = acc_k[n][1] = acc_k[n][2] = acc_k[n][3] = 0.0f;
    acc_v[n][0] = acc_v[n][1] = acc_v[n][2] = acc_v[n][3] = 0.0f;
  }

  const int q_begin = causal ? (k0 / BQ) * BQ : 0;  // queries before the tile's first key see none of it
  for (int hg = 0; hg < group; ++hg) {
    const int head = kv_head * group + hg;
    const __nv_bfloat16* q_base = q + bi * qs.b + head * qs.h;
    const __nv_bfloat16* do_base = d_out + bi * s * do_stride + static_cast<int64_t>(head) * d;
    const float* stat = lse + (bi * h + head) * s;
    const float* dstat = delta + (bi * h + head) * s;
    for (int q0 = q_begin; q0 < s; q0 += BQ) {
      __syncthreads();  // the previous tile is consumed (and the K and V tiles stored)
      stage_tile<DP>(s_q, q_base, qs.s, q0, BQ, s, d, tid);
      stage_tile<DP>(s_do, do_base, do_stride, q0, BQ, s, d, tid);
      for (int e = tid; e < BQ; e += kThreads) {
        const bool in = q0 + e < s;
        s_lse[e] = in ? stat[q0 + e] : 0.0f;
        s_delta[e] = in ? dstat[q0 + e] : 0.0f;
        s_seg[e] = in ? seg_row[q0 + e] : 0;
      }
      __syncthreads();

      float st[NQ][4], dpt[NQ][4];  // S^T and dP^T: this warp's 16 keys x the tile's queries
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.0f;
        dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.0f;
      }
      product_nt<DP, NQ>(st, s_k + warp * 16 * LD, s_q, g, tg);
      product_nt<DP, NQ>(dpt, s_v + warp * 16 * LD, s_do, g, tg);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * tg + (e & 1);
          const int row = q0 + j;
          const bool upper = e >= 2;
          const int key = upper ? key_hi : key_lo;
          const bool ok = key < s && row < s && s_seg[j] == (upper ? seg_hi : seg_lo) && (!causal || key <= row);
          const float p = ok ? exp2f(st[n][e] * scale_log2 - s_lse[j]) : 0.0f;
          st[n][e] = p;                                  // P^T
          dpt[n][e] = p * (dpt[n][e] - s_delta[j]);      // dS^T
        }
      }
      product_pb<DP, NQ, ND>(acc_v, st, s_do, d0, lane);
      product_pb<DP, NQ, ND>(acc_k, dpt, s_q, d0, lane);
    }
  }

  const int64_t row_stride = static_cast<int64_t>(hkv) * d;
  const int64_t base = bi * s * row_stride + static_cast<int64_t>(kv_head) * d;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = d0 + n * 8 + 2 * tg;
    if (col >= d) continue;
    if (key_lo < s) {
      *reinterpret_cast<uint32_t*>(dk + base + key_lo * row_stride + col) =
          pack_bf16(acc_k[n][0] * scale, acc_k[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + key_lo * row_stride + col) = pack_bf16(acc_v[n][0], acc_v[n][1]);
    }
    if (key_hi < s) {
      *reinterpret_cast<uint32_t*>(dk + base + key_hi * row_stride + col) =
          pack_bf16(acc_k[n][2] * scale, acc_k[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + key_hi * row_stride + col) = pack_bf16(acc_v[n][2], acc_v[n][3]);
    }
  }
}

template <int DP, int DH, int BK, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, const void* seg, const void* out,
                   const void* d_out, const void* lse, void* delta, void* dq, void* dk, void* dv, int b, int s,
                   int h, int hkv, int d, Strides qs, Strides ks, Strides vs, float scale, int causal,
                   cudaStream_t stream) {
  static_assert(DP % 16 == 0 && DH % 16 == 0 && DP % DH == 0, "tiles hold multiples of 16 head dims");
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* segp = static_cast<const int32_t*>(seg);
  const auto* dop = static_cast<const __nv_bfloat16*>(d_out);
  const auto* lsep = static_cast<const float*>(lse);
  auto* deltap = static_cast<float*>(delta);

  const int64_t rows = static_cast<int64_t>(b) * s * h;
  delta_kernel<<<static_cast<unsigned int>((rows + 7) / 8), 256, 0, stream>>>(
      dop, static_cast<const __nv_bfloat16*>(out), deltap, rows, s, h, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr int LD = DP + 8;
  const int tiles = (s + kRowsPerCta - 1) / kRowsPerCta;
  const size_t smem_dq = static_cast<size_t>(2 * kRowsPerCta + 2 * BK) * LD * sizeof(__nv_bfloat16) + BK * 4;
  err = colpali_allow_smem(flash_bwd_dq_kernel<DP, BK>, smem_dq);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<DP, BK><<<dim3(tiles, h, b), kThreads, smem_dq, stream>>>(
      qp, kp, vp, segp, dop, lsep, deltap, static_cast<__nv_bfloat16*>(dq), qs, ks, vs, s, h, hkv, d, scale,
      scale_log2, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_dkv = static_cast<size_t>(2 * kRowsPerCta + 2 * BQ) * LD * sizeof(__nv_bfloat16) + BQ * 12;
  err = colpali_allow_smem(flash_bwd_dkv_kernel<DP, DH, BQ>, smem_dkv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<DP, DH, BQ><<<dim3(tiles * (DP / DH), hkv, b), kThreads, smem_dkv, stream>>>(
      qp, kp, vp, segp, dop, lsep, deltap, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), qs,
      ks, vs, s, h, hkv, d, scale, scale_log2, causal);
  return cudaGetLastError();
}

}  // namespace

// q, k and v as in colpali_flash_attention (element strides, contiguous head
// dim, 16-byte aligned rows); out, d_out, dq (B, S, H, D) and dk, dv
// (B, S, Hkv, D) contiguous bf16; lse (B, H, S) as the forward wrote it;
// delta (B, H, S) fp32 workspace. d is one of 72 and 256.
extern "C" int colpali_flash_attention_bwd(const void* q, const void* k, const void* v, const void* seg,
                                           const void* out, const void* d_out, const void* lse, void* delta,
                                           void* dq, void* dk, void* dv, int b, int s, int h, int hkv, int d,
                                           int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                                           int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh, float scale,
                                           int causal, void* stream) {
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh}, vs{v_sb, v_ss, v_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {  // <padded D, dims per dkv CTA, keys per dq tile, queries per dkv tile>
    case 72:
      return launch<80, 80, 64, 64>(q, k, v, seg, out, d_out, lse, delta, dq, dk, dv, b, s, h, hkv, d, qs, ks, vs,
                                    scale, causal, st);  // SigLIP
    case 256:
      return launch<256, 128, 32, 32>(q, k, v, seg, out, d_out, lse, delta, dq, dk, dv, b, s, h, hkv, d, qs, ks,
                                      vs, scale, causal, st);  // Gemma
    default: return cudaErrorInvalidValue;
  }
}
