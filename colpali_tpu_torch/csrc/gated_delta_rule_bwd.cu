// Q2's backward: the gradients of the chunked gated delta rule
// (csrc/gated_delta_rule.cu) with respect to q, k (before the l2norm and the
// Dk^-0.5 scale), v, the log-decay g and beta.
//
// Replaces the gradient that JAX takes of
// colpali_tpu/models/qwen3_5.py::chunk_gated_delta_rule (:161-259) by
// differentiating it (XLA; no Pallas there). Everything is fp32, as the
// forward. For one chunk and one value head, with S the state at the chunk's
// start, q^ = l2norm(q) Dk^-0.5, k^ = l2norm(k), G the in-chunk cumulative
// log-decay, Gam_ij = exp(G_i - G_j) on the lower triangle (masked before
// exp), L the chunk's last row and the forward's
//   T = -strict_tril(beta k^ k^T o Gam), M = I - T, U = beta (v - e^G (k^ S)),
//   Vn = M^-1 U, P = tril(q^ k^T o Gam), O = e^G (q^ S) + P Vn,
//   S' = e^{G_L} S + Kd^T Vn with Kd = e^{G_L - G} k^,
// the backward of a chunk, given dO and dS' (the next chunk's dS), is
//   dVn = Kd dS' + P^T dO
//   dU  = M^-T dVn                          (back substitution: A is never formed)
//   dv  = beta dU,  dKS = -beta e^G dU
//   dP  = tril(dO Vn^T),  dT = strict_tril(dU Vn^T)
//   dq^ = e^G dO S^T + (dP o Gam) k^
//   dk^ = e^{G_L - G} Vn dS'^T + dKS S^T + (dP o Gam)^T q^ + (dK + dK^T) k^,  dK = -beta (dT o Gam)
//   dbeta_i = <dU_i, v_i - e^{G_i} (k^ S)_i> - sum_j dT_ij (k^ k^T)_ij Gam_ij
//   dG_i = e^{G_i} <(q^ S)_i, dO_i> - beta_i e^{G_i} <dU_i, (k^ S)_i> - r_i
//          + sum_j E_ij - sum_j E_ji,   E = dP o P + dT o T,  r_i = <Vn_i, (Kd dS')_i>
//   dG_L += e^{G_L} <S, dS'> + sum_i r_i
//   dS  = e^{G_L} dS' + q^T (e^G dO) + k^T dKS
// and dg is the reverse cumulative sum of dG inside the chunk (rows past S are
// zero rows, but their dG carries G_L's terms to the real rows).
//
// Design. The forward saves the state at every chunk's start (B, Hv, N, Dk,
// Dv fp32; the forward kernel writes it when given a buffer). The Dv axis is
// independent everywhere except in the contractions that give dq^, dk^, dG and
// dbeta, so a CTA owns one (batch, value head, 64 columns of dS), as the
// forward's CTA owns 64 columns of S, and walks the chunks backwards: it
// reloads the chunk's q and k (normalised again), S, v and dO, recomputes
// k^k^T, q^k^T, k^S, q^S, T, P, U and Vn as the forward does, then runs the
// steps above with dS' held in shared memory. Its contributions to dq^ and dk^
// (per row, 128 wide), to dg and to dbeta are partial sums over its 64
// columns, written to scratch. A second kernel sums, in a fixed order, the
// Dv/64 column blocks and the Hv/Hk value heads that read a key head, applies
// the l2norm's backward (dx = n (dx^ - x^ (x^.dx^)), n = rsqrt(|x|^2 + 1e-6);
// an all-zero padded token gives n = 1000 and a finite gradient) and writes
// dq, dk, dg and dbeta. No atomics: two calls give bit-equal gradients.
// 256 threads; every product is fp32 FMAs on the CUDA cores from shared
// memory; the two substitutions are 63 steps of __syncthreads each, a column's
// sum split over four lanes. Shared memory: 226,880 bytes, one CTA an SM.
//
// What bounds it: operations (fp32 FMAs: ~69 GFLOP at the page shape, B=8
// S=753 Hv=32, against ~0.4 GB moved, most of it the saved states). Not done:
// TF32 or bf16 wgmma for the products, the triangles' zero halves skipped in
// the dq^/dk^ pass, a redesign of forward and backward on one data layout.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kC = 64;          // chunk rows
constexpr int kDK = 128;        // key head dim
constexpr int kBV = 64;         // dS columns a CTA holds
constexpr int kThreads = 256;
constexpr int kLdQ = kDK + 1;   // q and k rows
constexpr int kLdS = kBV + 1;   // S and dS rows (one per key dim)
constexpr int kLdM = kC + 1;    // T / dK and P / dQK rows
constexpr int kLdU = kBV + 8;   // Vn, dU and dO rows: the substitutions' four row groups fall on distinct banks
constexpr size_t kSmemFloats = 2 * kC * kLdQ + 2 * kDK * kLdS + 2 * kC * kLdM + 3 * kC * kLdU + 16 * kC +
                               6 * kC + 2 * (kThreads / 32);
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kSmemBytes <= 232448, "one CTA's shared memory");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float sum16(float x) {  // over the 16 lanes that share a row group, the same order each time
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float sum32(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gated_delta_rule_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                            const float* __restrict__ g, const T* __restrict__ beta,
                            const float* __restrict__ states, const T* __restrict__ dout, T* __restrict__ dv_out,
                            float* __restrict__ part_q, float* __restrict__ part_k, float* __restrict__ part_g,
                            float* __restrict__ part_b, int seq, int hk_heads, int hv_heads, int dv, int64_t ld_qk,
                            int64_t ld_v) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [kC][kLdQ] q^
  float* ks = qs + kC * kLdQ;        // [kC][kLdQ] k^
  float* st = ks + kC * kLdQ;        // [kDK][kLdS] S at the chunk's start
  float* ds = st + kDK * kLdS;       // [kDK][kLdS] dS' (the next chunk's dS), then this chunk's dS
  float* tm = ds + kDK * kLdS;       // [kC][kLdM] T, then dK = -beta (dT o Gam)
  float* pm = tm + kC * kLdM;        // [kC][kLdM] P, then dQK = dP o Gam
  float* um = pm + kC * kLdM;        // [kC][kLdU] U, Vn, then e^{G_L - G} Vn
  float* du = um + kC * kLdU;        // [kC][kLdU] dVn, dU, then dKS
  float* dom = du + kC * kLdU;       // [kC][kLdU] dO, then e^G dO
  float* colp = dom + kC * kLdU;     // [16][kC] E's column sums over each row group
  float* gc = colp + 16 * kC;        // [kC] G
  float* bt = gc + kC;               // [kC] beta
  float* eg = bt + kC;               // [kC] e^G
  float* el = eg + kC;               // [kC] e^{G_L - G}
  float* dgv = el + kC;              // [kC] dG's row terms, then dG
  float* dbv = dgv + kC;             // [kC] dbeta
  float* red = dbv + kC;             // [2][kThreads / 32] per-warp sums of r and of <S, dS'>

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nblk = dv / kBV;
  const int hk = h / (hv_heads / hk_heads);
  const int64_t row0 = static_cast<int64_t>(b) * seq;
  const float qscale = rsqrtf(static_cast<float>(kDK));
  const int v0 = h * dv + vb * kBV;  // this CTA's first value column within a token's row
  const int nchunks = (seq + kC - 1) / kC;
  const float* state0 = states + (static_cast<int64_t>(b) * hv_heads + h) * nchunks * kDK * dv + vb * kBV;

  for (int i = tid; i < kDK * kLdS; i += kThreads) ds[i] = 0.f;
  // C x C and C x 64 blocks: rows ti * 4 + r, columns tj + 16 c
  const int ti = tid >> 4, tj = tid & 15;

  for (int ci = nchunks - 1; ci >= 0; --ci) {
    const int c0 = ci * kC;
    const int rows = min(kC, seq - c0);
    // ---- load: q and k rows normalised as the forward does, G, beta, S, dO; v into registers
    for (int r = warp; r < 2 * kC; r += kThreads / 32) {
      const int i = r & (kC - 1);
      const bool is_q = r < kC;
      float x[kDK / 32];
      float ss = 0.f;
      if (i < rows) {
        const T* src = (is_q ? q : k) + (row0 + c0 + i) * ld_qk + static_cast<int64_t>(hk) * kDK;
#pragma unroll
        for (int e = 0; e < kDK / 32; ++e) {
          x[e] = to_f(src[lane + 32 * e]);
          ss = fmaf(x[e], x[e], ss);
        }
      } else {
#pragma unroll
        for (int e = 0; e < kDK / 32; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int off = 16; off; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
      const float inv = rsqrtf(ss + 1e-6f);
      float* dst = (is_q ? qs : ks) + i * kLdQ;
#pragma unroll
      for (int e = 0; e < kDK / 32; ++e) dst[lane + 32 * e] = is_q ? (x[e] * inv) * qscale : x[e] * inv;
    }
    if (warp == 0) {  // inclusive scan of g over the chunk, two rows a lane
      const int i0 = 2 * lane, i1 = i0 + 1;
      const float a = i0 < rows ? g[(row0 + c0 + i0) * hv_heads + h] : 0.f;
      const float a1 = i1 < rows ? g[(row0 + c0 + i1) * hv_heads + h] : 0.f;
      float incl = a + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) excl = 0.f;
      const float g0 = excl + a, g1 = g0 + a1;
      const float last = __shfl_sync(0xffffffffu, g1, 31);
      gc[i0] = g0;
      gc[i1] = g1;
      eg[i0] = expf(g0);
      eg[i1] = expf(g1);
      el[i0] = expf(last - g0);
      el[i1] = expf(last - g1);
    } else if (warp == 1) {
      for (int i = lane; i < kC; i += 32) bt[i] = i < rows ? to_f(beta[(row0 + c0 + i) * hv_heads + h]) : 0.f;
    }
    {
      const float* src = state0 + static_cast<int64_t>(ci) * kDK * dv;
      for (int idx = tid; idx < kDK * kBV; idx += kThreads) {
        const int d = idx / kBV, c = idx % kBV;
        st[d * kLdS + c] = src[static_cast<int64_t>(d) * dv + c];
      }
      for (int idx = tid; idx < kC * kBV; idx += kThreads) {
        const int i = idx / kBV, c = idx % kBV;
        dom[i * kLdU + c] = i < rows ? to_f(dout[(row0 + c0 + i) * hv_heads * dv + v0 + c]) : 0.f;
      }
    }
    float vr[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        vr[r][c] = i < rows ? to_f(v[(row0 + c0 + i) * ld_v + v0 + tj + 16 * c]) : 0.f;
    }
    __syncthreads();

    // ---- one pass over Dk: k^k^T and q^k^T (64 x 64); k^S, q^S and k^dS' (64 x 64 columns)
    float kk[4][4] = {}, qk[4][4] = {}, ws[4][4] = {}, os[4][4] = {}, kd[4][4] = {};
#pragma unroll 2
    for (int d = 0; d < kDK; ++d) {
      float kr[4], qr[4], kc[4], sv[4], dsv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        kr[r] = ks[(ti * 4 + r) * kLdQ + d];
        qr[r] = qs[(ti * 4 + r) * kLdQ + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kc[c] = ks[(tj + 16 * c) * kLdQ + d];
        sv[c] = st[d * kLdS + tj + 16 * c];
        dsv[c] = ds[d * kLdS + tj + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kk[r][c] = fmaf(kr[r], kc[c], kk[r][c]);
          qk[r][c] = fmaf(qr[r], kc[c], qk[r][c]);
          ws[r][c] = fmaf(kr[r], sv[c], ws[r][c]);
          os[r][c] = fmaf(qr[r], sv[c], os[r][c]);
          kd[r][c] = fmaf(kr[r], dsv[c], kd[r][c]);
        }
    }
    float dgr[4], dbr[4];  // this thread's share of each of its rows' dG and dbeta
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti * 4 + r;
      const float gi = gc[i], bi = bt[i], ei = eg[i], li = el[i];
      dgr[r] = 0.f;
      dbr[r] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tj + 16 * c;
        const float decay = j <= i ? expf(gi - gc[j]) : 0.f;  // masked before exp
        tm[i * kLdM + j] = j < i ? -(bi * kk[r][c]) * decay : 0.f;
        pm[i * kLdM + j] = qk[r][c] * decay;
        um[i * kLdU + j] = bi * (vr[r][c] - ei * ws[r][c]);
        dgr[r] = fmaf(ei * os[r][c], dom[i * kLdU + j], dgr[r]);
        kd[r][c] *= li;  // (Kd dS')_ij
      }
    }
    __syncthreads();

    // ---- Vn = M^-1 U by forward substitution, in place (as the forward)
    {
      const int col = warp * 8 + (lane & 7), part = lane >> 3;
      for (int i = 1; i < rows; ++i) {
        float acc = 0.f;
        for (int m = part; m < i; m += 4) acc = fmaf(tm[i * kLdM + m], um[m * kLdU + col], acc);
        acc += __shfl_xor_sync(0xffffffffu, acc, 8);
        acc += __shfl_xor_sync(0xffffffffu, acc, 16);
        if (part == 0) um[i * kLdU + col] += acc;
        __syncthreads();
      }
    }

    // ---- dVn = Kd dS' + P^T dO; r_i = <Vn_i, (Kd dS')_i>
    float rpart = 0.f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti * 4 + r;
      float acc[4], rr = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = kd[r][c];
      for (int j = i; j < kC; ++j) {
        const float p = pm[j * kLdM + i];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(p, dom[j * kLdU + tj + 16 * c], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        du[i * kLdU + tj + 16 * c] = acc[c];
        rr = fmaf(um[i * kLdU + tj + 16 * c], kd[r][c], rr);
      }
      dgr[r] -= rr;
      rpart += rr;
    }
    __syncthreads();

    // ---- dU = M^-T dVn by back substitution, in place: dU_i = dVn_i + sum_{m > i} T_mi dU_m
    {
      const int col = warp * 8 + (lane & 7), part = lane >> 3;
      for (int i = rows - 2; i >= 0; --i) {
        float acc = 0.f;
        for (int m = i + 1 + part; m < rows; m += 4) acc = fmaf(tm[m * kLdM + i], du[m * kLdU + col], acc);
        acc += __shfl_xor_sync(0xffffffffu, acc, 8);
        acc += __shfl_xor_sync(0xffffffffu, acc, 16);
        if (part == 0) du[i * kLdU + col] += acc;
        __syncthreads();
      }
    }

    // ---- dP = dO Vn^T and dT = dU Vn^T over this CTA's 64 columns
    float dp[4][4] = {}, dt[4][4] = {};
#pragma unroll 4
    for (int c = 0; c < kBV; ++c) {
      float o[4], u[4], w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        o[r] = dom[(ti * 4 + r) * kLdU + c];
        u[r] = du[(ti * 4 + r) * kLdU + c];
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) w[cc] = um[(tj + 16 * cc) * kLdU + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          dp[r][cc] = fmaf(o[r], w[cc], dp[r][cc]);
          dt[r][cc] = fmaf(u[r], w[cc], dt[r][cc]);
        }
    }
    __syncthreads();

    // ---- element by element (each thread its own elements): dv, dbeta, dG's row terms and E's sums; then
    // P -> dQK, T -> dK, dO -> e^G dO, dU -> dKS, Vn -> e^{G_L - G} Vn in place
    {
      float colacc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti * 4 + r;
        const float gi = gc[i], bi = bt[i], ei = eg[i], li = el[i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tj + 16 * c;
          const float u = du[i * kLdU + j];
          dbr[r] = fmaf(u, vr[r][c] - ei * ws[r][c], dbr[r]);
          dgr[r] -= bi * ei * u * ws[r][c];
          if (i < rows) dv_out[(row0 + c0 + i) * hv_heads * dv + v0 + j] = from_f<T>(bi * u);
          const float gam = j <= i ? expf(gi - gc[j]) : 0.f;  // masked before exp
          const float dpij = j <= i ? dp[r][c] : 0.f;
          const float dtij = j < i ? dt[r][c] : 0.f;
          const float e = dpij * pm[i * kLdM + j] + dtij * tm[i * kLdM + j];
          dgr[r] += e;
          colacc[c] += e;
          dbr[r] = fmaf(dtij, -(kk[r][c] * gam), dbr[r]);
          pm[i * kLdM + j] = dpij * gam;
          tm[i * kLdM + j] = -(bi * dtij) * gam;
          dom[i * kLdU + j] *= ei;
          du[i * kLdU + j] = -(bi * ei) * u;
          um[i * kLdU + j] *= li;
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) colp[ti * kC + tj + 16 * c] = colacc[c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float gsum = sum16(dgr[r]), bsum = sum16(dbr[r]);
        if (tj == 0) {
          dgv[ti * 4 + r] = gsum;
          dbv[ti * 4 + r] = bsum;
        }
      }
      rpart = sum32(rpart);
      if (lane == 0) red[warp] = rpart;
    }
    __syncthreads();

    // ---- dq^ = e^G dO S^T + dQK k^;  dk^ = e^{G_L-G} Vn dS'^T + dKS S^T + dQK^T q^ + (dK + dK^T) k^
    // rows ti * 4 + r, key dims tj + 16 e
    {
      float aq[4][8] = {}, ak[4][8] = {};
#pragma unroll 2
      for (int c = 0; c < kBV; ++c) {
        float x[4], y[4], z[4], s[8], t[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          x[r] = dom[(ti * 4 + r) * kLdU + c];
          y[r] = du[(ti * 4 + r) * kLdU + c];
          z[r] = um[(ti * 4 + r) * kLdU + c];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s[e] = st[(tj + 16 * e) * kLdS + c];
          t[e] = ds[(tj + 16 * e) * kLdS + c];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            aq[r][e] = fmaf(x[r], s[e], aq[r][e]);
            ak[r][e] = fmaf(z[r], t[e], fmaf(y[r], s[e], ak[r][e]));
          }
      }
#pragma unroll 2
      for (int j = 0; j < kC; ++j) {
        float a[4], at[4], kt[4], kkt[4], kj[8], qj[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ti * 4 + r;
          a[r] = pm[i * kLdM + j];
          at[r] = pm[j * kLdM + i];
          kt[r] = tm[i * kLdM + j];
          kkt[r] = tm[j * kLdM + i];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          kj[e] = ks[j * kLdQ + tj + 16 * e];
          qj[e] = qs[j * kLdQ + tj + 16 * e];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            aq[r][e] = fmaf(a[r], kj[e], aq[r][e]);
            ak[r][e] = fmaf(at[r], qj[e], fmaf(kt[r] + kkt[r], kj[e], ak[r][e]));
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti * 4 + r;
        if (i < rows) {
          const int64_t o = (((row0 + c0 + i) * hv_heads + h) * nblk + vb) * kDK + tj;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            part_q[o + 16 * e] = aq[r][e];
            part_k[o + 16 * e] = ak[r][e];
          }
        }
      }
    }
    __syncthreads();

    // ---- dS = e^{G_L} dS' + q^T (e^G dO) + k^T dKS; and <S, dS'>: key dims td * 8 + e, columns tj + 16 c
    {
      const int td = tid >> 4;
      float acc[8][4] = {};
      for (int i = 0; i < rows; ++i) {
        float x[4], y[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          x[c] = dom[i * kLdU + tj + 16 * c];
          y[c] = du[i * kLdU + tj + 16 * c];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float qd = qs[i * kLdQ + td * 8 + e], kdv = ks[i * kLdQ + td * 8 + e];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[e][c] = fmaf(qd, x[c], fmaf(kdv, y[c], acc[e][c]));
        }
      }
      const float decay = eg[kC - 1];
      float sdot = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* p = ds + (td * 8 + e) * kLdS + tj + 16 * c;
          sdot = fmaf(st[(td * 8 + e) * kLdS + tj + 16 * c], *p, sdot);
          *p = fmaf(*p, decay, acc[e][c]);
        }
      sdot = sum32(sdot);
      if (lane == 0) red[kThreads / 32 + warp] = sdot;
    }
    __syncthreads();

    // ---- dG = row terms - E's column sums (+ G_L's terms on the last row); dg = dG's reverse cumsum in the chunk
    if (tid < kC) {
      float col = 0.f;
      for (int t = 0; t < 16; ++t) col += colp[t * kC + tid];
      float x = dgv[tid] - col;
      if (tid == kC - 1) {
        float rs = 0.f, sd = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) {
          rs += red[w];
          sd += red[kThreads / 32 + w];
        }
        x += eg[kC - 1] * sd + rs;
      }
      dgv[tid] = x;
    }
    __syncthreads();
    if (warp == 0) {
      const int i0 = 2 * lane, i1 = i0 + 1;
      const float a0 = dgv[i0], a1 = dgv[i1];
      const float pair = a0 + a1;
      float incl = pair;  // sum of the pairs from this lane's to the last
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += t;
      }
      const float after = incl - pair;
      const float g1 = after + a1, g0 = g1 + a0;
      const int64_t o = ((row0 + c0) * hv_heads + h) * nblk + vb;
      if (i0 < rows) {
        part_g[o + static_cast<int64_t>(i0) * hv_heads * nblk] = g0;
        part_b[o + static_cast<int64_t>(i0) * hv_heads * nblk] = dbv[i0];
      }
      if (i1 < rows) {
        part_g[o + static_cast<int64_t>(i1) * hv_heads * nblk] = g1;
        part_b[o + static_cast<int64_t>(i1) * hv_heads * nblk] = dbv[i1];
      }
    }
    __syncthreads();
  }
}

// One warp a (token, key head): dq^ and dk^ summed over the Hv/Hk value heads that read the key head and the
// Dv/64 column blocks, in that order, then the l2norm's backward. Threads past those warps: one a (token,
// value head), dg and dbeta summed over the column blocks.
template <typename T>
__global__ void __launch_bounds__(256)
gated_delta_rule_bwd_reduce_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const float* __restrict__ part_q, const float* __restrict__ part_k,
                                   const float* __restrict__ part_g, const float* __restrict__ part_b,
                                   T* __restrict__ dq, T* __restrict__ dk, float* __restrict__ dg,
                                   T* __restrict__ dbeta, int64_t tokens, int hk_heads, int hv_heads, int nblk,
                                   int64_t ld_qk, int qk_blocks) {
  const int lane = threadIdx.x & 31;
  if (static_cast<int>(blockIdx.x) < qk_blocks) {
    const int64_t w = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    if (w >= tokens * hk_heads) return;
    const int64_t tok = w / hk_heads;
    const int j = static_cast<int>(w % hk_heads);
    const int parts = (hv_heads / hk_heads) * nblk;
    const int64_t p0 = (tok * hv_heads + static_cast<int64_t>(j) * (hv_heads / hk_heads)) * nblk * kDK;
    const float qscale = rsqrtf(static_cast<float>(kDK));
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* part = (which ? part_k : part_q) + p0;
      const T* x_in = (which ? k : q) + tok * ld_qk + static_cast<int64_t>(j) * kDK;
      float dx[kDK / 32], x[kDK / 32];
      float ss = 0.f;
#pragma unroll
      for (int e = 0; e < kDK / 32; ++e) {
        float s = 0.f;
        for (int p = 0; p < parts; ++p) s += part[p * kDK + lane + 32 * e];
        dx[e] = which ? s : s * qscale;
        x[e] = to_f(x_in[lane + 32 * e]);
        ss = fmaf(x[e], x[e], ss);
      }
      ss = sum32(ss);
      const float n = rsqrtf(ss + 1e-6f);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kDK / 32; ++e) dot = fmaf(x[e] * n, dx[e], dot);
      dot = sum32(dot);
      T* out = (which ? dk : dq) + (tok * hk_heads + j) * kDK;
#pragma unroll
      for (int e = 0; e < kDK / 32; ++e) out[lane + 32 * e] = from_f<T>(n * (dx[e] - (x[e] * n) * dot));
    }
  } else {
    const int64_t t = static_cast<int64_t>(blockIdx.x - qk_blocks) * blockDim.x + threadIdx.x;
    if (t >= tokens * hv_heads) return;
    float sg = 0.f, sb = 0.f;
    for (int p = 0; p < nblk; ++p) {
      sg += part_g[t * nblk + p];
      sb += part_b[t * nblk + p];
    }
    dg[t] = sg;
    dbeta[t] = from_f<T>(sb);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const void* beta, const void* states,
                   const void* dout, void* dq, void* dk, void* dv_out, void* dg, void* dbeta, void* scratch, int b,
                   int seq, int hk, int hv, int dv, int64_t ld_qk, int64_t ld_v, cudaStream_t stream) {
  auto kernel = gated_delta_rule_bwd_kernel<T>;
  cudaError_t err = colpali_allow_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  const int nblk = dv / kBV;
  const int64_t tokens = static_cast<int64_t>(b) * seq;
  float* part_q = static_cast<float*>(scratch);
  float* part_k = part_q + tokens * hv * nblk * kDK;
  float* part_g = part_k + tokens * hv * nblk * kDK;
  float* part_b = part_g + tokens * hv * nblk;
  const dim3 grid(nblk, hv, b);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(g),
      static_cast<const T*>(beta), static_cast<const float*>(states), static_cast<const T*>(dout),
      static_cast<T*>(dv_out), part_q, part_k, part_g, part_b, seq, hk, hv, dv, ld_qk, ld_v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t qk_blocks = (tokens * hk * 32 + 255) / 256;
  const int64_t gb_blocks = (tokens * hv + 255) / 256;
  if (qk_blocks + gb_blocks > 0x7fffffff) return cudaErrorInvalidValue;
  gated_delta_rule_bwd_reduce_kernel<T><<<static_cast<unsigned>(qk_blocks + gb_blocks), 256, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), part_q, part_k, part_g, part_b, static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<float*>(dg), static_cast<T*>(dbeta), tokens, hk, hv, nblk, ld_qk,
      static_cast<int>(qk_blocks));
  return cudaGetLastError();
}

}  // namespace

// Q2's backward. q, k (B, S, Hk, 128) with token stride ld_qk, v (B, S, Hv, Dv) with token stride ld_v, g and beta
// (B, S, Hv) as the forward took them; states (B, Hv, ceil(S / 64), 128, Dv) fp32, the state at each chunk's start
// that the forward wrote; dout (B, S, Hv, Dv) contiguous. Writes dq, dk (B, S, Hk, 128), dv (B, S, Hv, Dv), dbeta
// (B, S, Hv) contiguous in q's dtype (bf16 when is_bf16) and dg (B, S, Hv) fp32. scratch holds 2 x B x S x Hv x
// (Dv / 64) x (128 + 1) floats. Two launches on the stream.
extern "C" int colpali_gated_delta_rule_bwd(const void* q, const void* k, const void* v, const void* g,
                                            const void* beta, const void* states, const void* dout, void* dq,
                                            void* dk, void* dv_out, void* dg, void* dbeta, void* scratch, int b,
                                            int seq, int hk, int hv, int dv, int is_bf16, int64_t ld_qk,
                                            int64_t ld_v, void* stream) {
  if (b < 1 || seq < 1 || hk < 1 || hv < hk || hv % hk || dv < kBV || dv % kBV || hv > 65535 || b > 65535 ||
      ld_qk < static_cast<int64_t>(hk) * kDK || ld_v < static_cast<int64_t>(hv) * dv)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, g, beta, states, dout, dq, dk, dv_out, dg, dbeta, scratch, b, seq,
                                         hk, hv, dv, ld_qk, ld_v, s)
                 : launch<float>(q, k, v, g, beta, states, dout, dq, dk, dv_out, dg, dbeta, scratch, b, seq, hk, hv,
                                 dv, ld_qk, ld_v, s);
}
