// K2: fused candidate gather + exact rerank, the second tier of the search.
//
// Replaces colpali_tpu/ops/maxsim_pallas.py::gather_candidates_pallas
// together with the rerank in colpali_tpu/retrieval/store.py::gather_rerank.
// For each query b and candidate j with doc id i = cand[b, j]:
//
//   doc[t, :] = float(store[i / 128, t, i % 128, :]) * scales[i / 128, t, i % 128]   (int8 store)
//   doc[t, :] = float(store[i / 128, t, i % 128, :])                                 (bf16 store)
//   out[b, j] = sum_n max_t (q[b, n, :] . doc[t, :])
//
// in fp32, queries not quantized: one template over the store's type, as the
// JAX rerank takes either store. The TPU path gathers the (c, Np, D) docs
// into HBM first; here nothing but the (B, c) scores is written.
//
// What bounds it on an H100: at a full page (Np = 1,040, Nq = 64, D = 128,
// c = 1,024) the candidates are 140 MB of int8 and scales (0.042 ms at
// 3.35 TB/s) and the products 8.7 G multiply-adds. On the tensor cores at
// fp32-grade accuracy those are three bf16 passes (below): 52 GFLOP, 0.053
// ms at 989 TFLOP/s. The gather of scattered 128-byte rows reaches ~2 TB/s
// (tools/k2_variants.py: the loads alone take 0.08 ms), and each tile's
// barriers, copy issue and epilogue cost a fixed ~1 us a consumer, so the
// tiles are large. At Np = 64 the whole call is 8.6 MB: launch and latency.
//
// Design (hopper.cuh):
// - Products on the tensor cores, fp32 accuracy. A doc value is exact in
//   bf16 (an int8 value, |v| <= 127, or a bf16 store's own value). Each fp32
//   query element is split into three bf16 terms, hi = bf16(q), mid =
//   bf16(q - hi), lo = bf16(q - hi - mid), which hold its 24 bits; the three
//   products accumulate in one fp32 wgmma accumulator (lo first). An int8
//   token's scale factors out of its dot products and multiplies its column
//   in the epilogue, before the max.
// - Layout. A query piece of 64 tokens is the M side (wgmma m64, rows past
//   Nq zero and dropped from the sum; longer queries are taken 64 tokens at
//   a time and their sums added): at D <= 128 its three terms are the
//   register operand (3 D / 4 registers a thread, split once a piece), at
//   D = 256 and 320 three tiles in shared memory. T doc tokens of one
//   candidate are the N side (T = 128, 32 at D = 256, 16 at D = 320), a
//   K-major bf16 tile of 64-dim chunks, 128-byte swizzle. The max over a row's doc tokens is a max
//   inside a thread and a quad shuffle; columns past Np are -inf.
// - Gather by TMA. In the store (nt, Np, 128, D) a candidate's tokens lie
//   128 * D elements apart: a rank-4 map (D, 128, Np, nt) with a box of (D or
//   64, 1, T, 1) brings T tokens of one candidate in one copy, rows past Np
//   zero-filled (an int8 row of 320 takes two boxes of 160: a box is at
//   most 256 elements a side). The scales, one float a token 512 bytes apart, come by
//   cp.async from the 32 lanes of the issuing warp, whose arrivals the
//   stage's barrier also counts (a TMA box of 4-byte rows would read 16
//   bytes a token and must start on 16 bytes). A bf16 store lands
//   swizzled, ready for wgmma; an int8 tile lands as it is and is converted
//   to bf16 (exact: 2^23 + u as a float, less 2^23 + 128) into one of two
//   buffers while the previous tile's products run, its scales beside it.
// - Filling the card. A CTA is two consumer warpgroups over one query's
//   candidates, ceil(SMs / B) CTAs a query: the CTA splits the query into
//   its bf16 terms once and its consumers take every second candidate of its
//   share, each through its own ring of stages that its first warp keeps
//   full (one elected lane issues the copies).
// - Each row's max is one thread's then two shuffles, the sum over rows a
//   fixed tree: two calls agree bit for bit. An id outside the store loads
//   doc 0 and writes NaN. D is 64, 128, 256 or 320.

#include <cuda_bf16.h>
#include <math_constants.h>

#include <algorithm>
#include <climits>

#include "hopper.cuh"

namespace {

constexpr int kConsumers = 2, kThreads = 128 * kConsumers;
constexpr int kRows = 64;  // query tokens a piece: one wgmma m64
constexpr int kMaxStages = 6;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kBarConsumer = 1;  // named barriers 1 and 2: one consumer's own threads

struct RerankArgs {
  const float* q;       // (B, nq, D)
  const float* scales;  // (nt, Np, 128); int8 store only
  const int32_t* cand;  // (B, c)
  float* out;           // (B, c)
  int nq, c, np, pieces, cps, stages;
  int64_t n_docs;       // n_tiles * 128
};

template <int D, int T, bool INT8>
struct Layout {
  static constexpr int CHUNKS = D / 64;                  // 64-dim chunks: 128-byte rows, 128-byte swizzle
  static constexpr bool RS = D <= 128;                   // the query terms in registers (3 D / 4 a thread)
  static constexpr uint32_t TERM = kRows * D * 2;        // one bf16 term of a query piece
  static constexpr uint32_t A = RS ? 0 : 3 * TERM;       // hi, mid, lo in shared memory (D = 256)
  static constexpr uint32_t B = T * D * 2;               // one bf16 tile of doc tokens
  static constexpr uint32_t DOC = INT8 ? T * D : B;      // a stage's doc tokens as loaded
  static constexpr int DW = INT8 && D > 256 ? D / 2 : D;  // int8 dims a TMA box (at most 256): T rows each
  static constexpr uint32_t SCALES = INT8 ? T * 4 : 0;  // a stage's scales, one a doc token
  static constexpr uint32_t STAGE = (DOC + SCALES + 1023) / 1024 * 1024;
  // a consumer's two converted tiles, then their scales (rounded to keep the ring on 1024 bytes)
  static constexpr uint32_t CONVERTED = INT8 ? 2 * B + (2 * T * 4 + 1023) / 1024 * 1024 : 0;
  static constexpr size_t fixed() { return kSmemSlack + A + kConsumers * (CONVERTED + 8 * sizeof(float)); }
  static constexpr size_t per_stage() { return kConsumers * (STAGE + 8 + 4); }  // + its barrier and id flag
};

// 4 bytes from global to shared memory (zeros where !valid); the copy
// completes on this thread's next cp_async_arrive.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// One arrival on `bar` once this thread's earlier cp.async copies have landed
// (counted in the barrier's expected arrivals).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The three bf16 terms of two fp32 values, packed in pairs (low half first).
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16(x, y);
  const float rx = x - __uint_as_float(hi << 16), ry = y - __uint_as_float(hi & 0xffff0000u);  // exact
  mid = pack_bf16(rx, ry);
  lo = pack_bf16(rx - __uint_as_float(mid << 16), ry - __uint_as_float(mid & 0xffff0000u));
}

// Four int8 values as four bf16 values, exactly: the float 2^23 + (v + 128)
// less 2^23 + 128 is v, and the top half of a float that holds a small
// integer is its bf16 value.
__device__ __forceinline__ uint2 int8x4_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.0f;
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
                    __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

template <int D, int T, bool INT8>
__global__ void __launch_bounds__(kThreads, 1)
    gather_rerank_kernel(const __grid_constant__ CUtensorMap doc_map, const RerankArgs a) {
  using L = Layout<D, T, INT8>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int S = a.stages;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int b = blockIdx.x / a.cps, part = blockIdx.x % a.cps;
  uint8_t* s_a = smem;                                                           // the piece's three terms
  uint8_t* s_conv = smem + L::A + wg * L::CONVERTED;                             // int8: converted tiles
  float* s_scl = reinterpret_cast<float*>(s_conv + 2 * L::B);                     // and their scales
  uint8_t* s_ring = smem + L::A + kConsumers * L::CONVERTED + static_cast<size_t>(wg) * S * L::STAGE;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + L::A + kConsumers * L::CONVERTED +
                                                static_cast<size_t>(kConsumers) * S * L::STAGE);
  int* s_ok = reinterpret_cast<int*>(s_bar + kConsumers * S);
  float* s_red = reinterpret_cast<float*>(s_ok + kConsumers * S) + wg * 8;
  uint64_t* bar = s_bar + wg * S;
  int* ok_flag = s_ok + wg * S;  // whether a stage's candidate id lies in the store

  // this consumer's candidates: first, first + step, ...; an item is (candidate, tile of T doc tokens)
  const int first = 2 * part + wg, step = 2 * a.cps;
  const int n_mine = first < a.c ? (a.c - first + step - 1) / step : 0;
  const int n_dt = (a.np + T - 1) / T;
  const int n_items = n_mine * n_dt;
  const int32_t* cand = a.cand + static_cast<int64_t>(b) * a.c;

  if (threadIdx.x == 0) {
    // the copy's arrival, and for an int8 store the 32 lanes' arrivals once their scales land
    for (int i = 0; i < kConsumers * S; ++i) mbar_init(smem_addr(s_bar + i), INT8 ? 33 : 1);
    fence_barrier_init();
  }

  // Warp 0 of a consumer loads item `item` (ring position `pos`): lane l
  // holds the id of candidate id_base + l, lane 0 issues the TMA copies and
  // each lane copies the scales of doc tokens lane and lane + 32.
  int id_base = 0, my_id = 0;
  auto issue = [&](int item, int pos) {
    const int i = item / n_dt, dt = item % n_dt;
    if (item == 0 || i >= id_base + 32) {
      id_base = i;
      my_id = i + lane < n_mine ? cand[first + (i + lane) * step] : 0;
    }
    const int id = __shfl_sync(0xffffffffu, my_id, i - id_base);
    const bool ok = id >= 0 && id < a.n_docs;
    const int doc = ok ? id : 0;
    const int stage = pos % S;
    uint8_t* st = s_ring + stage * L::STAGE;
    const uint32_t full = smem_addr(bar + stage);
    if constexpr (INT8) {  // a TMA box of 4-byte rows would take 16: the lanes copy the scales
      const float* src = a.scales + (static_cast<int64_t>(doc / DOC_TILE) * a.np + dt * T) * DOC_TILE + doc % DOC_TILE;
      for (int t = lane; t < T; t += 32)
        cp_async_4(smem_addr(st + L::DOC + 4 * t), src + static_cast<int64_t>(t) * DOC_TILE, dt * T + t < a.np);
      cp_async_arrive(full);
    }
    if (lane == 0) {
      ok_flag[stage] = ok;
      mbar_expect_tx(full, L::DOC);
      if constexpr (INT8) {
#pragma unroll
        for (int c = 0; c < D / L::DW; ++c)
          tma_load_4d(smem_addr(st) + c * T * L::DW, &doc_map, c * L::DW, doc % DOC_TILE, dt * T, doc / DOC_TILE,
                      full);
      } else {
#pragma unroll
        for (int c = 0; c < L::CHUNKS; ++c)
          tma_load_4d(smem_addr(st) + c * T * 128, &doc_map, 64 * c, doc % DOC_TILE, dt * T, doc / DOC_TILE, full);
      }
    }
  };

  int pos0 = 0;  // ring position of this piece's first item
  uint32_t af[L::RS ? 3 : 1][L::RS ? D / 16 : 1][4];  // RS: the A fragments of the three terms, k16 step by step
  for (int piece = 0; piece < a.pieces; ++piece) {
    __syncthreads();  // the barriers are initialised; the last piece's products are done
    if constexpr (L::RS) {  // this thread's rows 16 warp + g and + 8, dims 16 ks + 2 t4 (+ 1, + 8, + 9)
      const int r0 = piece * kRows + 16 * warp + g;
      const float* q0 = a.q + (static_cast<int64_t>(b) * a.nq + r0) * D + 2 * t4;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        float2 x[4];  // (row, dims): (r0, k), (r0 + 8, k), (r0, k + 8), (r0 + 8, k + 8)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + 8 * (i & 1);
          x[i] = row < a.nq ? *reinterpret_cast<const float2*>(q0 + 8 * (i & 1) * D + 16 * ks + 8 * (i >> 1))
                            : make_float2(0.0f, 0.0f);
          split3(x[i].x, x[i].y, af[0][ks][i], af[1][ks][i], af[2][ks][i]);
        }
      }
    } else {  // the piece's query tokens as three bf16 terms in shared memory, by both consumers
      const int row0 = piece * kRows;
      const float* qp = a.q + (static_cast<int64_t>(b) * a.nq + row0) * D;
      for (int u = threadIdx.x; u < kRows * D / 8; u += kThreads) {
        const int r = u / (D / 8), k = (u % (D / 8)) * 8;
        float4 x0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), x1 = x0;
        if (row0 + r < a.nq) {
          x0 = *reinterpret_cast<const float4*>(qp + r * D + k);
          x1 = *reinterpret_cast<const float4*>(qp + r * D + k + 4);
        }
        uint4 hi, mid, lo;
        split3(x0.x, x0.y, hi.x, mid.x, lo.x);
        split3(x0.z, x0.w, hi.y, mid.y, lo.y);
        split3(x1.x, x1.y, hi.z, mid.z, lo.z);
        split3(x1.z, x1.w, hi.w, mid.w, lo.w);
        const uint32_t off = swizzled<kRows>(r, k);
        *reinterpret_cast<uint4*>(s_a + off) = hi;
        *reinterpret_cast<uint4*>(s_a + L::TERM + off) = mid;
        *reinterpret_cast<uint4*>(s_a + 2 * L::TERM + off) = lo;
      }
      fence_proxy_async();
      __syncthreads();
    }
    if (n_items == 0) continue;
    if (warp == 0)
      for (int it = 0; it < min(S, n_items); ++it) issue(it, pos0 + it);

    // Wait for item `it`; an int8 tile is converted into its bf16 buffer and
    // its scales copied beside it. Returns the tile's operand address; `ok`
    // whether the candidate's id lies in the store.
    auto prepare = [&](int it, int& ok) -> uint32_t {
      const int pos = pos0 + it, stage = pos % S;
      mbar_wait(smem_addr(bar + stage), (pos / S) & 1);
      const uint8_t* st = s_ring + stage * L::STAGE;
      ok = ok_flag[stage];
      if constexpr (INT8) {
        uint8_t* dst = s_conv + (pos & 1) * L::B;
        for (int u = tid; u < T * D / 16; u += 128) {
          const int r = u / (D / 16), k = (u % (D / 16)) * 16;
          const uint4 w = *reinterpret_cast<const uint4*>(st + (k / L::DW) * T * L::DW + r * L::DW + k % L::DW);
          const uint2 e0 = int8x4_to_bf16(w.x), e1 = int8x4_to_bf16(w.y);
          const uint2 e2 = int8x4_to_bf16(w.z), e3 = int8x4_to_bf16(w.w);
          *reinterpret_cast<uint4*>(dst + swizzled<T>(r, k)) = make_uint4(e0.x, e0.y, e1.x, e1.y);
          *reinterpret_cast<uint4*>(dst + swizzled<T>(r, k + 8)) = make_uint4(e2.x, e2.y, e3.x, e3.y);
        }
        const float* scales = reinterpret_cast<const float*>(st + L::DOC);
        for (int t = tid; t < T; t += 128) s_scl[(pos & 1) * T + t] = scales[t];
        fence_proxy_async();
        return smem_addr(dst);
      } else {
        return smem_addr(st);
      }
    };

    float mx_lo = -CUDART_INF_F, mx_hi = -CUDART_INF_F;  // rows 16 warp + g and + 8: running max over doc tokens
    bool ok = true;
    int id_ok, id_ok_next = 0;
    uint32_t b_tile = prepare(0, id_ok), b_next = 0;
    named_bar_sync(kBarConsumer + wg, 128);  // item 0 is ready
    if (INT8 && warp == 0 && S < n_items) issue(S, pos0 + S);
    for (int it = 0; it < n_items; ++it) {
      const int dt = it % n_dt;
      if (tid == 0 && dt == 0) ok = id_ok;
      float acc[T / 2];
      __syncwarp();  // warp 0 may have issued copies from one lane: wgmma needs the whole warp
      wgmma_fence();
#pragma unroll
      for (int term = 2; term >= 0; --term)
#pragma unroll
        for (int c = 0; c < L::CHUNKS; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t db = smem_desc(b_tile + c * T * 128 + kk * 32, 16, 1024, kSwizzle128);
            if constexpr (L::RS)
              wgmma_rs_kmajor<T>(acc, af[term][4 * c + kk], db, term < 2 || c + kk > 0);
            else
              wgmma_ss<T>(acc,
                          smem_desc(smem_addr(s_a) + term * L::TERM + c * kRows * 128 + kk * 32, 16, 1024, kSwizzle128),
                          db, term < 2 || c + kk > 0);
          }
      wgmma_commit();
      if (it + 1 < n_items) b_next = prepare(it + 1, id_ok_next);  // under the products
      __syncwarp();
      wgmma_wait_all();
      fence_operands<T / 2>(acc);

      const int n_valid = a.np - dt * T;  // doc tokens of this tile inside the doc
      const float* scl = s_scl + ((pos0 + it) & 1) * T;
#pragma unroll
      for (int j = 0; j < T / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = acc[4 * j + e];
          if constexpr (INT8) v *= scl[8 * j + 2 * t4 + (e & 1)];
          v = 8 * j + 2 * t4 + (e & 1) < n_valid ? v : -CUDART_INF_F;
          if (e < 2)
            mx_lo = fmaxf(mx_lo, v);
          else
            mx_hi = fmaxf(mx_hi, v);
        }
      const bool last = dt == n_dt - 1;  // the candidate's last tile: sum its rows' maxima
      float* red = s_red + (it & 1) * 4;  // two sets: tid 0 reads one while the others fill the next
      if (last) {
        mx_lo = quad_max(mx_lo);
        mx_hi = quad_max(mx_hi);
        const int r = piece * kRows + 16 * warp + g;
        float s = t4 != 0 ? 0.0f : (r < a.nq ? mx_lo : 0.0f) + (r + 8 < a.nq ? mx_hi : 0.0f);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (lane == 0) red[warp] = s;
        mx_lo = mx_hi = -CUDART_INF_F;
      }
      named_bar_sync(kBarConsumer + wg, 128);  // item it + 1 is ready; item it's products are done
      if (last && tid == 0) {
        float* o = a.out + static_cast<int64_t>(b) * a.c + first + (it / n_dt) * step;
        const float total = (red[0] + red[1]) + (red[2] + red[3]);
        *o = !ok ? __int_as_float(0x7fc00000) : piece == 0 ? total : *o + total;
      }
      if (warp == 0) {  // refill the stage this consumer no longer reads
        const int next = INT8 ? it + 1 + S : it + S;
        if (next < n_items) issue(next, pos0 + next);
      }
      b_tile = b_next;
      id_ok = id_ok_next;
    }
    pos0 += n_items;
  }
}

template <int D, int T, bool INT8>
cudaError_t launch(const void* q, const void* store, const void* scales, const void* cand, void* out, int b, int nq,
                   int c, int np, int64_t n_tiles, cudaStream_t stream) {
  using L = Layout<D, T, INT8>;
  CUtensorMap doc_map;
  {
    const cuuint64_t es = INT8 ? 1 : 2;
    const cuuint64_t dims[4] = {D, DOC_TILE, static_cast<cuuint64_t>(np), static_cast<cuuint64_t>(n_tiles)};
    const cuuint64_t strides[3] = {D * es, DOC_TILE * D * es, static_cast<cuuint64_t>(np) * DOC_TILE * D * es};
    const cuuint32_t box[4] = {static_cast<cuuint32_t>(INT8 ? L::DW : 64), 1, T, 1};
    cudaError_t err = colpali_tensor_map(&doc_map, INT8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                         4, store, dims, strides, box,
                                         INT8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  RerankArgs a;
  a.q = static_cast<const float*>(q);
  a.scales = static_cast<const float*>(scales);
  a.cand = static_cast<const int32_t*>(cand);
  a.out = static_cast<float*>(out);
  a.nq = nq;
  a.c = c;
  a.np = np;
  a.pieces = (nq + kRows - 1) / kRows;
  a.cps = std::max(1, std::min((c + kConsumers - 1) / kConsumers, sms / b));
  a.stages = static_cast<int>(std::min<size_t>(kMaxStages, (kSmemLimit - L::fixed()) / L::per_stage()));
  a.n_docs = n_tiles * DOC_TILE;
  if (a.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = L::fixed() + a.stages * L::per_stage();
  err = colpali_allow_smem(gather_rerank_kernel<D, T, INT8>, smem);
  if (err != cudaSuccess) return err;
  gather_rerank_kernel<D, T, INT8><<<static_cast<unsigned int>(b) * a.cps, kThreads, smem, stream>>>(doc_map, a);
  return cudaGetLastError();
}

template <bool INT8>
cudaError_t dispatch(const void* q, const void* store, const void* scales, const void* cand, void* out, int b, int nq,
                     int c, int np, int d, int64_t n_tiles, cudaStream_t stream) {
  if (b < 1 || nq < 1 || c < 1 || np < 1 || n_tiles < 1 || n_tiles > INT32_MAX / DOC_TILE)
    return cudaErrorInvalidValue;
  switch (d) {
    case 64: return launch<64, 128, INT8>(q, store, scales, cand, out, b, nq, c, np, n_tiles, stream);
    case 128: return launch<128, 128, INT8>(q, store, scales, cand, out, b, nq, c, np, n_tiles, stream);
    case 256: return launch<256, 32, INT8>(q, store, scales, cand, out, b, nq, c, np, n_tiles, stream);
    case 320: return launch<320, 16, INT8>(q, store, scales, cand, out, b, nq, c, np, n_tiles, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Queries (b, nq, d) fp32, candidates (b, c) int32, out (b, c) fp32; d 64,
// 128, 256 or 320; every pointer 16-byte aligned.
// int8 store (nt, Np, 128, D) with (nt, Np, 128) fp32 scales
extern "C" int colpali_gather_rerank(const void* q, const void* store, const void* scales, const void* cand, void* out,
                                     int b, int nq, int c, int np_, int d, int64_t n_tiles, void* stream) {
  return dispatch<true>(q, store, scales, cand, out, b, nq, c, np_, d, n_tiles, static_cast<cudaStream_t>(stream));
}

// bf16 store (nt, Np, 128, D), no scales
extern "C" int colpali_gather_rerank_bf16(const void* q, const void* store, const void* cand, void* out, int b, int nq,
                                          int c, int np_, int d, int64_t n_tiles, void* stream) {
  return dispatch<false>(q, store, nullptr, cand, out, b, nq, c, np_, d, n_tiles, static_cast<cudaStream_t>(stream));
}
