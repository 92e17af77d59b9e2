// K3: full-int8 MaxSim over the tile-major corpus, the exact sweep; K10: the
// same over the token-major corpus.
//
// Replaces colpali_tpu/ops/maxsim_pallas.py::maxsim_pallas_int8mxu_tiled
// (K3) and ::maxsim_pallas_int8mxu_tm (K10), body _int8mxu_body. Queries are
// int8 with one fp32 scale per token, the corpus is int8, tile-major
// (n_tiles, Np, 128, D) with (n_tiles, Np, 128) fp32 scales or token-major
// (Np, C, D) with (Np, C) scales:
//
//   out[b, d] = sum_i qs[b, i] * max_t (ds[d, t] * int32(q[b, i] . doc[d, t]))
//
// The doc scale is applied before the max over doc tokens and the query
// scale after it, as on the TPU. Zero-padded doc tokens (value 0, scale 1)
// take part in the max with similarity 0, exactly as in JAX and in the
// plain version.
//
// What bounds it on an H100: a "block" is the 128 rows of one doc token t of
// one tile (128 x D int8, contiguous in both layouts). At B=1 the sweep
// reads the corpus once (8.2 GB for 1M docs x 64 tokens x 128: 2.5 ms at
// 3.35 TB/s); at B=8 and Nq=64 it does 2 * 512 * Np * D operations per doc
// (8.4 T over 1M docs: 4.2 ms at 1,979 int8 TOP/s), and at the page shape
// (8,192 docs x 1,040 tokens) only operations count. Every product element
// also needs an epilogue on the CUDA cores: convert, scale by ds, max. That
// is 3 to 4 instructions per element against 2 * D tensor operations, of
// the same order as the products, so it has to overlap them.
//
// Design (hopper.cuh):
// - Products are wgmma m64nNk32 s8 x s8 -> s32, A = 64 doc rows, B = N query
//   tokens, both K-major in shared memory (128-byte swizzle; 64-byte at
//   D = 64 and at D = 320, whose 320-byte rows are not a whole number of
//   128-byte atoms: five 64-byte chunks a row, five TMA boxes a block).
//   Each doc block goes through an mbarrier ring, loaded by TMA
//   from a 3-D map (D, 128 rows, block) that both layouts share: block
//   (tile, t) is tile * tile_stride + t * token_stride, so K10 differs from
//   K3 only in those two numbers and gives its scores bit for bit. The
//   block's 128 scales ride the same stage. One producer warp issues every
//   load; two consumer warpgroups run the products.
// - The queries are loaded once per CTA and stay in shared memory; the
//   corpus is never streamed once per query.
// - The running max over doc tokens lives in registers (N / 2 accumulators
//   and N / 2 maxima a thread), so a consumer holds at most N = 128 query
//   tokens. The int32 -> fp32 conversion is exact and avoids the quarter-rate
//   converter: |acc| <= 2^22, so the bits of acc + 0x4B400000 are the float
//   1.5 * 2^23 + acc.
// - Two ways to split the work, chosen per call from B * Nq (Nq padded to a
//   multiple of 8 and at most 128 by the wrapper; whole queries per consumer):
//   up to 128 query tokens in all, one CTA per tile takes whole blocks and
//   its consumers take 64 rows each against the same queries; beyond that a
//   CTA takes 64 rows of each block (a "half") and its consumers take 128
//   query tokens each, so a tile's data is read ceil(B * Nq / 256) times,
//   by CTAs that run side by side (neighbouring ids), the later reads mostly
//   from L2.
// - The grid is persistent: CTAs that share a tile's rows sit together, and
//   each walks the tiles k, k + ctas_per_lane, ...; the producer streams the
//   next tile's blocks while the consumers finish the last one.
// - The consumers take turns to issue their products (named barriers 1 and
//   2, as in the flash forward), so one's epilogue runs while the other's
//   products do.
// - At the end of a tile each thread multiplies its maxima by qs and sums
//   each query's columns, then sums across its quad with shuffles: a fixed
//   order, so two calls agree bit for bit.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 3 * 128;  // consumers 0 and 1, then the producer
constexpr int kConsumerRegs = 232, kProducerRegs = 40;
constexpr int kBarTurn = 1;        // named barriers 1 and 2: consumer 0's and consumer 1's turn
constexpr int kBarConsumer = 3;    // named barriers 3 and 4: one consumer's own threads
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 227 * 1024;

struct Int8Args {
  const float* qscale;  // (B * nq)
  float* out;           // (B, n_tiles * 128)
  int b, nq, np, n_tiles;
  int tile_stride, token_stride;  // in blocks of 128 rows
  int qpc;                        // queries of a consumer's slot: 128 / nq
  int slots;                      // ceil(b / qpc)
  int lanes;                      // CTAs on one tile: 1, or 2 halves x ceil(slots / 2) groups
  int ctas_per_lane;
  int stages;
};

template <int D>
__host__ __device__ constexpr int chunk_bytes() {  // bytes of a swizzled row chunk: 128, or 64 (D = 64 and 320)
  return D % 128 == 0 ? 128 : 64;
}

template <int D, int N, int ROWS>
struct Layout {
  static constexpr int CW = chunk_bytes<D>(), CHUNKS = D / CW;
  static constexpr int QTILES = ROWS == 128 ? 1 : 2;  // one query tile for both consumers, or one each
  static constexpr uint32_t QTILE = N * D, BLOCK = ROWS * D;
  static constexpr int SWIZZLE = CW == 128 ? kSwizzle128 : kSwizzle64;
  static constexpr size_t fixed() { return kSmemSlack + QTILES * QTILE + 2 * N * 4 + 8; }
  static constexpr size_t per_stage() { return BLOCK + ROWS * 4 + 2 * 8; }
};

template <int D, int N, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
    maxsim_int8_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap store_map,
                       const __grid_constant__ CUtensorMap scale_map, const Int8Args a) {
  using L = Layout<D, N, ROWS>;
  constexpr int CW = L::CW;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int S = a.stages;
  const uint32_t s_q = smem_addr(smem);                           // QTILES query tiles
  const uint32_t s_doc = s_q + L::QTILES * L::QTILE;               // S doc blocks
  float* s_scale = reinterpret_cast<float*>(smem + L::QTILES * L::QTILE + S * L::BLOCK);  // (S, ROWS)
  float* s_qs = s_scale + S * ROWS;                                // (2, N): each consumer's query scales
  const uint32_t bar_q = smem_addr(s_qs + 2 * N);
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * S;

  const int lane_id = blockIdx.x % a.lanes, first_tile = blockIdx.x / a.lanes;
  const int half = lane_id & 1, group = lane_id >> 1;
  const int row_base = ROWS == 128 ? 0 : 64 * half;  // the block rows this CTA loads
  const int n_turns = ((a.n_tiles - 1 - first_tile) / a.ctas_per_lane + 1) * a.np;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
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
    mbar_expect_tx(bar_q, L::QTILES * L::QTILE);
    for (int qt = 0; qt < L::QTILES; ++qt) {
      const int slot = ROWS == 128 ? 0 : 2 * group + qt;
      const int row0 = slot < a.slots ? slot * a.qpc * a.nq : 0;  // an idle consumer gets valid rows, unused
#pragma unroll
      for (int c = 0; c < L::CHUNKS; ++c) tma_load_2d(s_q + qt * L::QTILE + c * N * CW, &q_map, c * CW, row0, bar_q);
    }
    int it = 0;
    for (int tile = first_tile; tile < a.n_tiles; tile += a.ctas_per_lane) {
      for (int t = 0; t < a.np; ++t, ++it) {
        const int stage = it % S;
        mbar_wait(bar_empty + 8 * stage, ((it / S) & 1) ^ 1);
        const int blk = tile * a.tile_stride + t * a.token_stride;
        const uint32_t full = bar_full + 8 * stage;
        mbar_expect_tx(full, L::BLOCK + ROWS * 4);
#pragma unroll
        for (int c = 0; c < L::CHUNKS; ++c)
          tma_load_3d(s_doc + stage * L::BLOCK + c * ROWS * CW, &store_map, c * CW, row_base, blk, full);
        tma_load_2d(smem_addr(s_scale + stage * ROWS), &scale_map, row_base, blk, full);
      }
    }
    return;
  }

  // ---- consumers ----
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int slot = ROWS == 128 ? 0 : 2 * group + wg;
  const bool active = slot < a.slots;
  const int row_off = ROWS == 128 ? 64 * wg : 0;  // this consumer's rows within a stage
  const int row_lo = row_off + 16 * warp + g;      // and this thread's, row_lo and row_lo + 8
  const uint32_t q_tile = s_q + (ROWS == 128 ? 0 : wg * L::QTILE);
  const int q_first = slot * a.qpc;                              // the slot's first query
  const int q_count = active ? min(a.qpc, a.b - q_first) : 0;    // and its number of queries
  float* qs = s_qs + wg * N;
  for (int j = tid; j < N; j += 128) qs[j] = j < q_count * a.nq ? a.qscale[q_first * a.nq + j] : 0.0f;
  named_bar_sync(kBarConsumer + wg, 128);

  uint32_t acc[N / 2];
  float mx[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0;
  const int64_t c_total = static_cast<int64_t>(a.n_tiles) * DOC_TILE;

  mbar_wait(bar_q, 0);
  if (wg == 1) named_bar_arrive(kBarTurn, 256);
  int it = 0;
  for (int tile = first_tile; tile < a.n_tiles; tile += a.ctas_per_lane) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) mx[i] = -__int_as_float(0x7f800000);  // -inf
    for (int t = 0; t < a.np; ++t, ++it) {
      const int stage = it % S;
      mbar_wait(bar_full + 8 * stage, (it / S) & 1);
      named_bar_sync(kBarTurn + wg, 256);  // this consumer's turn to issue
      const uint32_t a_tile = s_doc + stage * L::BLOCK + row_off * CW;
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < L::CHUNKS; ++c) {
#pragma unroll
        for (int kk = 0; kk < CW / 32; ++kk)
          wgmma_s8<N>(acc, smem_desc(a_tile + c * ROWS * CW + kk * 32, 16, 8 * CW, L::SWIZZLE),
                      smem_desc(q_tile + c * N * CW + kk * 32, 16, 8 * CW, L::SWIZZLE), c + kk > 0);
      }
      wgmma_commit();
      if (wg == 0 || it + 1 < n_turns) named_bar_arrive(kBarTurn + 1 - wg, 256);  // the other's turn
      wgmma_wait_all();
      fence_operands<N / 2>(acc);
      const float ds_lo = s_scale[stage * ROWS + row_lo], ds_hi = s_scale[stage * ROWS + row_lo + 8];
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float sim = __int_as_float(static_cast<int>(acc[i] + 0x4B400000u)) - 12582912.0f;  // exact
        mx[i] = fmaxf(mx[i], sim * ((i & 2) ? ds_hi : ds_lo));
      }
    }
    // qs times the maxima, summed over each query's columns (8-column blocks: nq % 8 == 0)
    float* out_lo = a.out + static_cast<int64_t>(tile) * DOC_TILE + row_base + row_lo;
    float sum_lo = 0.0f, sum_hi = 0.0f;
    int query = 0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const float q0 = qs[8 * j + 2 * tg], q1 = qs[8 * j + 2 * tg + 1];
      sum_lo += mx[4 * j] * q0;
      sum_lo += mx[4 * j + 1] * q1;
      sum_hi += mx[4 * j + 2] * q0;
      sum_hi += mx[4 * j + 3] * q1;
      if ((8 * (j + 1)) % a.nq == 0) {  // the last block of this query's columns
        sum_lo = quad_sum(sum_lo);
        sum_hi = quad_sum(sum_hi);
        if (tg == 0 && query < q_count) {
          float* o = out_lo + static_cast<int64_t>(q_first + query) * c_total;
          o[0] = sum_lo;
          o[8] = sum_hi;
        }
        ++query;
        sum_lo = sum_hi = 0.0f;
      }
    }
  }
}

template <int D, int N, int ROWS>
cudaError_t launch(const void* q, const void* qscale, const void* store, const void* dscale, void* out, int b,
                   int nq, int np, int n_tiles, int qpc, int slots, bool token_major, cudaStream_t stream) {
  using L = Layout<D, N, ROWS>;
  constexpr CUtensorMapSwizzle swizzle = L::CW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const int64_t blocks = static_cast<int64_t>(n_tiles) * np;
  CUtensorMap q_map, store_map, scale_map;
  {
    const cuuint64_t dims[2] = {D, static_cast<cuuint64_t>(b) * nq}, strides[1] = {D};
    const cuuint32_t box[2] = {L::CW, N};
    cudaError_t err = colpali_tensor_map(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, dims, strides, box, swizzle);
    if (err != cudaSuccess) return err;
  }
  {
    const cuuint64_t dims[3] = {D, DOC_TILE, static_cast<cuuint64_t>(blocks)}, strides[2] = {D, DOC_TILE * D};
    const cuuint32_t box[3] = {L::CW, ROWS, 1};
    cudaError_t err =
        colpali_tensor_map(&store_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, store, dims, strides, box, swizzle);
    if (err != cudaSuccess) return err;
  }
  {
    const cuuint64_t dims[2] = {DOC_TILE, static_cast<cuuint64_t>(blocks)}, strides[1] = {DOC_TILE * 4};
    const cuuint32_t box[2] = {ROWS, 1};
    cudaError_t err = colpali_tensor_map(&scale_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, dscale, dims, strides, box,
                                         CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  Int8Args a;
  a.qscale = static_cast<const float*>(qscale);
  a.out = static_cast<float*>(out);
  a.b = b;
  a.nq = nq;
  a.np = np;
  a.n_tiles = n_tiles;
  a.tile_stride = token_major ? 1 : np;
  a.token_stride = token_major ? n_tiles : 1;
  a.qpc = qpc;
  a.slots = slots;
  a.lanes = ROWS == 128 ? 1 : 2 * ((slots + 1) / 2);
  a.ctas_per_lane = std::max(1, std::min(n_tiles, sms / a.lanes));
  // as many stages as shared memory holds, up to kMaxStages: at D = 320, 4 or 5 whole blocks beside one query
  // tile, or 7 halves beside two
  a.stages = static_cast<int>(std::min<size_t>(kMaxStages, (kSmemLimit - L::fixed()) / L::per_stage()));
  static_assert((kSmemLimit - L::fixed()) / L::per_stage() >= 2, "shared memory holds fewer than 2 stages");
  const size_t smem = L::fixed() + a.stages * L::per_stage();
  err = colpali_allow_smem(maxsim_int8_kernel<D, N, ROWS>, smem);
  if (err != cudaSuccess) return err;
  maxsim_int8_kernel<D, N, ROWS><<<a.lanes * a.ctas_per_lane, kThreads, smem, stream>>>(q_map, store_map, scale_map, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_n(const void* q, const void* qscale, const void* store, const void* dscale, void* out, int b,
                       int nq, int np, int n_tiles, bool token_major, cudaStream_t s) {
  const int qpc = DOC_TILE / nq, slots = (b + qpc - 1) / qpc;
  if (slots > 1)  // half blocks, each consumer 128 query tokens of its own
    return launch<D, 128, 64>(q, qscale, store, dscale, out, b, nq, np, n_tiles, qpc, slots, token_major, s);
  const int n = b * nq;  // whole blocks, both consumers on every query
  if (n <= 32) return launch<D, 32, 128>(q, qscale, store, dscale, out, b, nq, np, n_tiles, qpc, 1, token_major, s);
  if (n <= 64) return launch<D, 64, 128>(q, qscale, store, dscale, out, b, nq, np, n_tiles, qpc, 1, token_major, s);
  return launch<D, 128, 128>(q, qscale, store, dscale, out, b, nq, np, n_tiles, qpc, 1, token_major, s);
}

cudaError_t dispatch(const void* q, const void* qscale, const void* store, const void* dscale, void* out, int b, int nq,
                     int np, int d, int64_t n_tiles, bool token_major, cudaStream_t s) {
  if (b < 1 || nq < 8 || nq > DOC_TILE || nq % 8 || np < 1 || n_tiles < 1 || n_tiles * np > INT32_MAX)
    return cudaErrorInvalidValue;
  const int nt = static_cast<int>(n_tiles);
  switch (d) {
    case 64: return dispatch_n<64>(q, qscale, store, dscale, out, b, nq, np, nt, token_major, s);
    case 128: return dispatch_n<128>(q, qscale, store, dscale, out, b, nq, np, nt, token_major, s);
    case 256: return dispatch_n<256>(q, qscale, store, dscale, out, b, nq, np, nt, token_major, s);
    case 320: return dispatch_n<320>(q, qscale, store, dscale, out, b, nq, np, nt, token_major, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Queries (b * nq, d) int8 and (b * nq) fp32 scales with nq a multiple of 8
// up to 128 (the wrapper pads and splits longer queries), d 64, 128, 256 or 320;
// every pointer 16-byte aligned.
// K3: tile-major store (n_tiles, Np, 128, D), scales (n_tiles, Np, 128).
extern "C" int colpali_maxsim_int8(const void* q, const void* qscale, const void* store, const void* dscale, void* out,
                                   int b, int nq, int np_, int d, int64_t n_tiles, void* stream) {
  return dispatch(q, qscale, store, dscale, out, b, nq, np_, d, n_tiles, false, static_cast<cudaStream_t>(stream));
}

// K10: token-major store (Np, n_tiles * 128, D), scales (Np, n_tiles * 128).
extern "C" int colpali_maxsim_int8_tm(const void* q, const void* qscale, const void* store, const void* dscale,
                                      void* out, int b, int nq, int np_, int d, int64_t n_tiles, void* stream) {
  return dispatch(q, qscale, store, dscale, out, b, nq, np_, d, n_tiles, true, static_cast<cudaStream_t>(stream));
}
