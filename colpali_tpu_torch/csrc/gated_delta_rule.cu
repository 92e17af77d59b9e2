// Q2: the chunked gated delta rule, the token mixer of Qwen3.5's GatedDeltaNet
// layers (36 of the default config's 48).
//
// Replaces colpali_tpu/models/qwen3_5.py::chunk_gated_delta_rule (:161-259),
// which XLA runs on the TPU (no Pallas there): per head a (Dk, Dv) state is
// carried over chunks of 64 tokens, and inside a chunk the delta rule's
// correction is one lower-triangular system. Everything is fp32. For a chunk
// with in-chunk cumulative log-decay G (from the fp32 g), l2-normalised q
// (times Dk^-0.5) and k, and beta:
//   T    = -(beta_i k_i.k_j) exp(G_i - G_j) for j < i (the exponent masked
//          before exp: above the diagonal G_i - G_j > 0 overflows)
//   U    = beta (v - e^G (k S))
//   Vnew = (I - T)^-1 U                     (forward substitution)
//   out  = e^G (q S) + tril(q k^T exp(G_i - G_j)) Vnew
//   S   <- e^{G_last} S + (k e^{G_last - G})^T Vnew
// which is JAX's  v2 - kcd S  with  A = (I - T)^-1  taken out of the product:
// A (beta v) - A (beta e^G k) S = A U.
//
// Design. The state's Dv columns are independent once T is known, so a CTA
// owns one (batch, value head, 64 state columns) and walks the chunks in
// order: B x Hv x Dv/64 CTAs (8 x 32 x 2 = 512 at a page batch of Qwen3.5's
// default config). A CTA keeps its 128 x 64 state slice in shared memory for
// the whole sequence and recomputes the chunk's q k^T and k k^T itself (the
// two CTAs of a head repeat that part). Value head h reads key head
// h / (Hv / Hk), and q, k, v are read in place through a token stride (the
// conv's output row), so nothing is transposed, padded or repeated in device
// memory; rows past S load as zeros with g = beta = 0, as the JAX pad makes
// them. 256 threads; every product is fp32 FMAs on the CUDA cores from
// shared memory (q and k rows padded to 129 floats, so row and column reads
// are both conflict-free), each thread holding a 4 x 4 block of four
// products at once (k k^T, q k^T, k S, q S) in one pass over Dk; q S stays
// in registers until the output. The substitution is 63 steps of
// __syncthreads, each column's sum split over four lanes. Shared memory:
// 152,064 bytes, one CTA an SM.
//
// What bounds it: operations (fp32 FMAs: ~35 GFLOP at the page shape, B=8
// S=753 Hv=32, against ~0.15 GB of inputs and output). Not done: TF32 or
// bf16 wgmma for the products, a chunk-parallel first pass (the inter-chunk
// state is the only sequential part), two CTAs an SM.

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kC = 64;          // chunk rows
constexpr int kDK = 128;        // key head dim
constexpr int kBV = 64;         // state columns a CTA holds
constexpr int kThreads = 256;
constexpr int kLdQ = kDK + 1;   // q and k rows
constexpr int kLdS = kBV + 1;   // state rows (one per key dim)
constexpr int kLdM = kC + 1;    // T and P rows
constexpr int kLdU = kBV + 8;   // U rows: the substitution's four row groups fall on distinct banks
constexpr size_t kSmemFloats = 2 * kC * kLdQ + kDK * kLdS + 2 * kC * kLdM + kC * kLdU + 4 * kC;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gated_delta_rule_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        const float* __restrict__ g, const T* __restrict__ beta, T* __restrict__ out,
                        float* __restrict__ states, int seq, int hk_heads, int hv_heads, int dv, int64_t ld_qk,
                        int64_t ld_v) {
  extern __shared__ float smem[];
  float* qs = smem;                  // [kC][kLdQ] l2-normalised q times Dk^-0.5
  float* ks = qs + kC * kLdQ;        // [kC][kLdQ] l2-normalised k
  float* st = ks + kC * kLdQ;        // [kDK][kLdS] the state slice
  float* tm = st + kDK * kLdS;       // [kC][kLdM] T
  float* pm = tm + kC * kLdM;        // [kC][kLdM] tril(q k^T exp(G_i - G_j))
  float* um = pm + kC * kLdM;        // [kC][kLdU] U, then Vnew
  float* gc = um + kC * kLdU;        // [kC] G
  float* bt = gc + kC;               // [kC] beta
  float* eg = bt + kC;               // [kC] e^G
  float* el = eg + kC;               // [kC] e^{G_last - G}

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hv_heads / hk_heads);
  const int64_t row0 = static_cast<int64_t>(b) * seq;
  const float qscale = rsqrtf(static_cast<float>(kDK));
  const int v0 = h * dv + vb * kBV;  // this CTA's first value column within a token's row

  for (int i = tid; i < kDK * kLdS; i += kThreads) st[i] = 0.f;
  __syncthreads();
  // the 4 x 4 blocks: rows ti * 4 + r, columns tj + 16 c
  const int ti = tid >> 4, tj = tid & 15;

  float* state_out = states ? states + (static_cast<int64_t>(b) * hv_heads + h) * ((seq + kC - 1) / kC) * kDK * dv +
                                  vb * kBV : nullptr;
  for (int c0 = 0; c0 < seq; c0 += kC) {
    const int rows = min(kC, seq - c0);
    if (state_out) {  // the state at the chunk's start, for the backward (csrc/gated_delta_rule_bwd.cu)
      float* dst = state_out + static_cast<int64_t>(c0 / kC) * kDK * dv;
      for (int idx = tid; idx < kDK * kBV; idx += kThreads)
        dst[static_cast<int64_t>(idx / kBV) * dv + idx % kBV] = st[(idx / kBV) * kLdS + idx % kBV];
    }
    // ---- load: q and k rows (a warp a row), normalised; g's in-chunk cumsum and beta
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
    // the value block, fetched ahead of the products
    float vr[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti * 4 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        vr[r][c] = i < rows ? to_f(v[(row0 + c0 + i) * ld_v + v0 + tj + 16 * c]) : 0.f;
    }
    __syncthreads();

    // ---- one pass over Dk: k k^T and q k^T (64 x 64), k S and q S (64 x 64 state columns)
    float kk[4][4] = {}, qk[4][4] = {}, ws[4][4] = {}, os[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < kDK; ++d) {
      float kr[4], qr[4], kc[4], sv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        kr[r] = ks[(ti * 4 + r) * kLdQ + d];
        qr[r] = qs[(ti * 4 + r) * kLdQ + d];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kc[c] = ks[(tj + 16 * c) * kLdQ + d];
        sv[c] = st[d * kLdS + tj + 16 * c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          kk[r][c] = fmaf(kr[r], kc[c], kk[r][c]);
          qk[r][c] = fmaf(qr[r], kc[c], qk[r][c]);
          ws[r][c] = fmaf(kr[r], sv[c], ws[r][c]);
          os[r][c] = fmaf(qr[r], sv[c], os[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti * 4 + r;
      const float gi = gc[i], bi = bt[i], ei = eg[i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tj + 16 * c;
        const float decay = j <= i ? expf(gi - gc[j]) : 0.f;  // masked before exp
        tm[i * kLdM + j] = j < i ? -(bi * kk[r][c]) * decay : 0.f;
        pm[i * kLdM + j] = qk[r][c] * decay;
        um[i * kLdU + j] = bi * (vr[r][c] - ei * ws[r][c]);
        os[r][c] *= ei;
      }
    }
    __syncthreads();

    // ---- Vnew = (I - T)^-1 U by forward substitution, in place: a column's sum over four lanes
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

    // ---- out = e^G (q S) + P Vnew, for the chunk's real rows
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = ti * 4 + r;
      float acc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = 0.f;
      for (int j = 0; j <= i; ++j) {
        const float p = pm[i * kLdM + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(p, um[j * kLdU + tj + 16 * c], acc[c]);
      }
      if (i < rows) {
        T* dst = out + ((row0 + c0 + i) * hv_heads) * dv + v0 + tj;
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[16 * c] = from_f<T>(os[r][c] + acc[c]);
      }
    }
    // ---- S <- e^{G_last} S + (k e^{G_last - G})^T Vnew: rows td * 8 + e, columns tj + 16 c
    {
      const int td = tid >> 4;
      float acc[8][4] = {};
      for (int i = 0; i < rows; ++i) {
        const float f = el[i];
        float uv[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) uv[c] = um[i * kLdU + tj + 16 * c];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float kd = ks[i * kLdQ + td * 8 + e] * f;
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[e][c] = fmaf(kd, uv[c], acc[e][c]);
        }
      }
      const float decay = eg[kC - 1];
#pragma unroll
      for (int e = 0; e < 8; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* s = st + (td * 8 + e) * kLdS + tj + 16 * c;
          *s = fmaf(*s, decay, acc[e][c]);
        }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, const void* beta, void* out,
                   void* states, int b, int seq, int hk, int hv, int dv, int64_t ld_qk, int64_t ld_v,
                   cudaStream_t stream) {
  auto kernel = gated_delta_rule_kernel<T>;
  cudaError_t err = colpali_allow_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(dv / kBV, hv, b);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(g),
      static_cast<const T*>(beta), static_cast<T*>(out), static_cast<float*>(states), seq, hk, hv, dv, ld_qk, ld_v);
  return cudaGetLastError();
}

}  // namespace

// q, k (B, S, Hk, 128) with token stride ld_qk, v (B, S, Hv, Dv) with token stride ld_v (heads contiguous within a
// token, S tokens a batch entry), g (B, S, Hv) fp32 and beta (B, S, Hv) contiguous -> out (B, S, Hv, Dv)
// contiguous; q, k, v, beta and out bf16 (is_bf16 = 1) or fp32. Hv a multiple of Hk, Dv a multiple of 64. states,
// when not null, receives the fp32 state at each chunk's start, (B, Hv, ceil(S / 64), 128, Dv), for the backward.
extern "C" int colpali_gated_delta_rule(const void* q, const void* k, const void* v, const void* g, const void* beta,
                                        void* out, void* states, int b, int seq, int hk, int hv, int dv, int is_bf16,
                                        int64_t ld_qk, int64_t ld_v, void* stream) {
  if (b < 1 || seq < 1 || hk < 1 || hv < hk || hv % hk || dv < kBV || dv % kBV || hv > 65535 || b > 65535 ||
      ld_qk < static_cast<int64_t>(hk) * kDK || ld_v < static_cast<int64_t>(hv) * dv)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, g, beta, out, states, b, seq, hk, hv, dv, ld_qk, ld_v, s)
                 : launch<float>(q, k, v, g, beta, out, states, b, seq, hk, hv, dv, ld_qk, ld_v, s);
}
