// Q1a: per-row symmetric int8 quantization of activations; Q1b: int8 x int8
// -> int32 matrix product with the dequantization epilogue fused.
//
// Replace colpali_tpu/ops/quant_dense.py::_quantize_rows (Q1a) and the
// lax.dot_general(int8, int8 -> int32) and rescale of ::stored_int8_apply
// (Q1b), which XLA runs on the TPU (no Pallas there). Every projection of a
// ColPali layer with both dims >= 512 goes through them when its weight is
// stored as int8: 253 Q1b launches a page forward, 90 a query forward.
//
// Q1a. One CTA per row: the row's absmax (a block max), then
//   scale = absmax > 0 ? absmax * fp32(1/127) : 1
//   q = clip(round_half_even(x / scale), -127, 127)
// with an IEEE divide (__fdiv_rn) and __float2int_rn, the arithmetic XLA
// compiles JAX's forward to. What bounds it: bytes (the row read twice, the
// second time from L1/L2, the int8 row and its scale written once), e.g.
// 405 MB at 8,232 rows x 16,384 (down_proj's input of a page batch).
//
// Q1b. out (M, N) = cvt(float(A (M, K) . B (N, K)^T) * a_scale[m] * b_scale[n])
// (+ bias[n] after the rounding to the output type, as QDense adds it in
// JAX: bf16 rounds, adds in fp32 and rounds again; fp32 takes the second
// multiply and the add as one __fmaf_rn, which is what XLA compiles JAX's
// fp32 epilogue to. Every other step is an explicit __fmul_rn/__fadd_rn, so
// the compiler fuses nothing else; the int32 sum converts with
// __int2float_rn, and int32 sums are exact, so any tiling gives the same
// bits). Both operands are K-major int8, the layout s8 wgmma takes. A tile
// is 128 rows x BN columns (BN 256 where that keeps every SM busy, else
// 128): a TMA ring of 128-byte K slices of A and B (128-byte swizzle), one
// producer thread issuing the loads, and two consumer warpgroups of 64 rows,
// each running wgmma m64nBNk32 s32.s8.s8 (four a slice) with one group kept
// in flight. The grid is persistent (one CTA an SM, tiles in groups of 8 row
// blocks so the tiles in flight share their operands in L2), and the
// producer loads the next tile while the consumers run the last one's
// epilogue. A bf16 output tile goes to shared memory (128-byte swizzle, so
// the quads' 4-byte writes hit 32 banks) and out by TMA stores that the
// consumer does not wait for; TMA skips rows and columns past M and N. An
// fp32 output, or bf16 rows not a multiple of 16 bytes, is stored pair by
// pair from the registers. TMA fills rows past M and N and columns past K
// with zeros on the loads, so a slice overhanging K (4,304 = 33 x 128 + 80)
// adds nothing. The operands' rows may lie further apart than K bytes (a
// row stride of K rounded up to 16, TMA's stride rule): Qwen's patch
// embedding (K = 3 x 2 x 14 x 14 = 1,176) and Qwen2.5-VL's vision down_proj
// (K = 3,420) are stored so, and Q1a writes its rows so, with the map's
// width K. What bounds it: operations at the page shapes (M =
// 8,192-8,232: 2MNK over 1,979 TOP/s), bytes at the query shapes (M =
// 32-256: the N x K weight read once). Not done: a split of K when the
// tiles leave SMs idle (N = 2,048 at a small M fills 16 of 132 SMs),
// clusters, ping-pong consumers.

#include <algorithm>

#include "hopper.cuh"

namespace {

// ---- Q1a ---------------------------------------------------------------------------

constexpr int kRowThreads = 256;
constexpr float kInv127 = 1.0f / 127.0f;  // fp32(1/127), correctly rounded

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// VEC values of T, loaded as one 16-byte access (VEC = 1: one value).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <int VEC>
struct Int8Pack;  // VEC int8 values stored as one access
template <>
struct Int8Pack<1> {
  using type = int8_t;
};
template <>
struct Int8Pack<4> {
  using type = uint32_t;
};
template <>
struct Int8Pack<8> {
  using type = uint2;
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kRowThreads) quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                                                                    float* __restrict__ scale, int k, int ldq) {
  using V = Vec<T, VEC>;
  using Packed = typename Int8Pack<VEC>::type;
  const int64_t row = blockIdx.x;
  const V* xr = reinterpret_cast<const V*>(x + row * k);
  Packed* qr = reinterpret_cast<Packed*>(q + row * ldq);
  const int nvec = k / VEC;

  float m = 0.0f;
  for (int i = threadIdx.x; i < nvec; i += kRowThreads) {
    const V v = xr[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) m = fmaxf(m, fabsf(to_float(v.v[j])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[kRowThreads / 32];
  __shared__ float row_scale;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kRowThreads / 32 ? warp_max[lane] : 0.0f;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) {
      row_scale = m > 0.0f ? __fmul_rn(m, kInv127) : 1.0f;
      scale[row] = row_scale;
    }
  }
  __syncthreads();
  const float s = row_scale;
  for (int i = threadIdx.x; i < nvec; i += kRowThreads) {
    const V v = xr[i];
    union {
      int8_t b[VEC];
      Packed p;
    } out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int r = __float2int_rn(__fdiv_rn(to_float(v.v[j]), s));
      out.b[j] = static_cast<int8_t>(max(-127, min(127, r)));
    }
    qr[i] = out.p;
  }
}

template <typename T>
cudaError_t launch_quantize_rows(const void* x, void* q, void* scale, int64_t rows, int k, int ldq,
                                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid(static_cast<unsigned>(rows));
  if (k % kVec == 0)  // every row of x starts on 16 bytes (and every row of q on 16, since ldq % 16 == 0)
    quantize_rows_kernel<T, kVec><<<grid, kRowThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scale), k, ldq);
  else
    quantize_rows_kernel<T, 1><<<grid, kRowThreads, 0, stream>>>(static_cast<const T*>(x), static_cast<int8_t*>(q),
                                                                  static_cast<float*>(scale), k, ldq);
  return cudaGetLastError();
}

// ---- Q1b ---------------------------------------------------------------------------

constexpr int kTileM = 128;                // rows of A a tile: one m64 slab a consumer
constexpr int kSliceK = 128;               // int8 columns of a K slice: one 128-byte swizzled row
constexpr int kGemmThreads = 3 * 128;      // consumers 0 and 1, then the producer warpgroup
constexpr int kConsumerRegs = 232, kProducerRegs = 40;

// STAGED: bf16 output tiles go through shared memory (OUT bytes: each consumer's 64 x BN tile as BN / 64
// boxes of 64 x 64, 128-byte swizzle) and out by TMA; else each thread stores its pairs itself.
template <int BN, bool STAGED>
struct GemmLayout {
  static constexpr uint32_t A = kTileM * kSliceK, B = BN * kSliceK, STAGE = A + B;
  static constexpr int STAGES = STAGED ? (BN == 256 ? 3 : 5) : (BN == 256 ? 4 : 6);
  static constexpr uint32_t OUT = STAGED ? 2 * 64 * BN * 2 : 0, OUT_BOX = 64 * 64 * 2;
  static constexpr size_t SMEM = kSmemSlack + STAGES * STAGE + OUT + 2 * STAGES * 8;
};

struct GemmArgs {
  const float* a_scale;  // (M)
  const float* b_scale;  // (N)
  const void* bias;      // (N) of the output type, or null
  void* out;             // (M, N)
  int m, n, k;
  int lda, ldb;          // row strides of A and B in bytes (multiples of 16, >= k)
  int tiles_m, tiles_n, tiles;
};

// Tiles run in groups of kGroupM row blocks, row blocks fastest within a group, so the tiles in flight
// share a few A row blocks and a few B column blocks in L2 (N-fastest order re-reads all of a wide B,
// 32 MB for gate_proj, from memory for every row block).
constexpr int kGroupM = 8;

__device__ __forceinline__ void tile_origin(const GemmArgs& a, int tile, int bn, int* m0, int* n0) {
  const int per_group = kGroupM * a.tiles_n, first = (tile / per_group) * kGroupM;
  const int rows = min(a.tiles_m - first, kGroupM), in_group = tile % per_group;
  *m0 = (first + in_group % rows) * kTileM;
  *n0 = (in_group / rows) * bn;
}

// bf16(t * sb) (+ bias, then rounded again): one output of the bf16 epilogue.
__device__ __forceinline__ __nv_bfloat16 out_bf16(float t, float sb, const __nv_bfloat16* bias, int c) {
  const __nv_bfloat16 y = __float2bfloat16_rn(__fmul_rn(t, sb));
  return bias == nullptr ? y : __float2bfloat16_rn(__fadd_rn(__bfloat162float(y), __bfloat162float(bias[c])));
}

// Columns c and c + 1 of row r from t = float(acc) * a_scale and the column scales sb.
template <bool BF16_OUT>
__device__ __forceinline__ void store_pair(const GemmArgs& a, int r, int c, float t0, float t1, float sb0,
                                           float sb1) {
  const bool pair = (a.n & 1) == 0;  // then c even and c < n put c + 1 inside the row, 4- or 8-byte aligned
  if constexpr (BF16_OUT) {
    const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(a.bias);
    const __nv_bfloat16 y0 = out_bf16(t0, sb0, bias, c), y1 = c + 1 < a.n ? out_bf16(t1, sb1, bias, c + 1) : y0;
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) + static_cast<int64_t>(r) * a.n + c;
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __halves2bfloat162(y0, y1);
    } else {
      o[0] = y0;
      if (c + 1 < a.n) o[1] = y1;
    }
  } else {
    const float* bias = static_cast<const float*>(a.bias);
    float v0, v1;
    if (bias != nullptr) {
      v0 = __fmaf_rn(t0, sb0, bias[c]);
      v1 = c + 1 < a.n ? __fmaf_rn(t1, sb1, bias[c + 1]) : 0.0f;
    } else {
      v0 = __fmul_rn(t0, sb0);
      v1 = __fmul_rn(t1, sb1);
    }
    float* o = static_cast<float*>(a.out) + static_cast<int64_t>(r) * a.n + c;
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (c + 1 < a.n) o[1] = v1;
    }
  }
}

// Persistent: CTA b takes tiles b, b + gridDim.x, ... in tile_origin's order. The producer
// streams the next tile's slices while the consumers run the last one's epilogue; the ring's phases
// run on over the tiles (`it` counts slices).
template <int BN, bool BF16_OUT, bool STAGED>
__global__ void __launch_bounds__(kGemmThreads, 1)
    int8_gemm_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
                     const __grid_constant__ CUtensorMap out_map, const GemmArgs args) {
  using L = GemmLayout<BN, STAGED>;
  constexpr int S = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t s_ring = smem_addr(smem);  // stage i: A slice at s_ring + i * STAGE, then its B slice
  const uint32_t s_out = s_ring + S * L::STAGE;  // the consumers' output tiles (STAGED)
  const uint32_t bar_full = s_out + L::OUT, bar_empty = bar_full + 8 * S;
  const int k_tiles = (args.k + kSliceK - 1) / kSliceK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(bar_full + 8 * i, 1);
      mbar_init(bar_empty + 8 * i, 8);  // lane 0 of each consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // ---- producer: one thread issues every load ----
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != 256) return;
    int it = 0;
    for (int tile = blockIdx.x; tile < args.tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(args, tile, BN, &m0, &n0);
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int stage = it % S;
        mbar_wait(bar_empty + 8 * stage, ((it / S) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * stage, dst = s_ring + stage * L::STAGE;
        mbar_expect_tx(full, L::STAGE);
        tma_load_2d(dst, &a_map, kt * kSliceK, m0, full);
        tma_load_2d(dst + L::A, &b_map, kt * kSliceK, n0, full);
      }
    }
    return;
  }

  // ---- consumers: 64 rows each ----
  setmaxnreg_inc<kConsumerRegs>();
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  uint32_t acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < args.tiles; tile += gridDim.x) {
    int m0, n0;
    tile_origin(args, tile, BN, &m0, &n0);
    const int row0 = m0 + 64 * wg;
    if (row0 >= args.m) {  // rows past M: free each slice, issue nothing
      for (int kt = 0; kt < k_tiles; ++kt, ++it) {
        const int stage = it % S;
        mbar_wait(bar_full + 8 * stage, (it / S) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
      }
      continue;
    }
    for (int kt = 0; kt < k_tiles; ++kt, ++it) {
      const int stage = it % S;
      mbar_wait(bar_full + 8 * stage, (it / S) & 1);
      const uint32_t a_tile = s_ring + stage * L::STAGE + wg * 64 * kSliceK, b_tile = s_ring + stage * L::STAGE + L::A;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSliceK / 32; ++kk)
        wgmma_s8<BN>(acc, smem_desc(a_tile + kk * 32, 16, 1024, kSwizzle128),
                     smem_desc(b_tile + kk * 32, 16, 1024, kSwizzle128), kt + kk > 0);
      wgmma_commit();
      wgmma_wait_one();  // the previous slice's products are done: free it
      if (kt > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % S));
      }
    }
    wgmma_wait_all();
    fence_operands<BN / 2>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * ((it - 1) % S));  // this tile's last slice

    // epilogue: thread (warp, g = lane / 4, tg = lane % 4) holds rows 16 warp + g (+ 8),
    // columns 8 j + 2 tg (+ 1) of its consumer's 64 x BN tile
    const int r_lo = row0 + 16 * warp + g, r_hi = r_lo + 8;
    const float sa_lo = r_lo < args.m ? args.a_scale[r_lo] : 0.0f;
    const float sa_hi = r_hi < args.m ? args.a_scale[r_hi] : 0.0f;
    if constexpr (STAGED) {  // bf16 pairs into the swizzled output tile, then TMA stores (which skip past M, N)
      const __nv_bfloat16* bias = static_cast<const __nv_bfloat16*>(args.bias);
      uint8_t* out_tile = smem + S * L::STAGE + wg * (L::OUT / 2);
      const int rl = 16 * warp + g;  // row within the tile; rl + 8 is the other
      if (tid == 0) bulk_wait_read();  // the last tile's stores have read the tile
      named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = 8 * j + 2 * tg, c = n0 + cl;
        const bool in0 = c < args.n, in1 = c + 1 < args.n;
        const float sb0 = in0 ? args.b_scale[c] : 0.0f, sb1 = in1 ? args.b_scale[c + 1] : 0.0f;
        const __nv_bfloat16* b0 = in0 ? bias : nullptr;
        const __nv_bfloat16* b1 = in1 ? bias : nullptr;
        const uint32_t at = (cl / 64) * L::OUT_BOX + ((((cl % 64) / 8) ^ (rl & 7)) << 4) + (cl % 8) * 2;
        const __nv_bfloat162 lo = __halves2bfloat162(
            out_bf16(__fmul_rn(__int2float_rn(static_cast<int>(acc[4 * j])), sa_lo), sb0, b0, c),
            out_bf16(__fmul_rn(__int2float_rn(static_cast<int>(acc[4 * j + 1])), sa_lo), sb1, b1, c + 1));
        const __nv_bfloat162 hi = __halves2bfloat162(
            out_bf16(__fmul_rn(__int2float_rn(static_cast<int>(acc[4 * j + 2])), sa_hi), sb0, b0, c),
            out_bf16(__fmul_rn(__int2float_rn(static_cast<int>(acc[4 * j + 3])), sa_hi), sb1, b1, c + 1));
        *reinterpret_cast<__nv_bfloat162*>(out_tile + at + rl * 128) = lo;  // (rl + 8) & 7 == rl & 7
        *reinterpret_cast<__nv_bfloat162*>(out_tile + at + (rl + 8) * 128) = hi;
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (tid == 0) {
        const uint32_t src = s_out + wg * (L::OUT / 2);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b)
          if (n0 + 64 * b < args.n) tma_store_2d(&out_map, src + b * L::OUT_BOX, n0 + 64 * b, row0);
        bulk_commit();
      }
    } else {  // each thread stores its pairs
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = n0 + 8 * j + 2 * tg;
        if (c >= args.n) continue;
        const float sb0 = args.b_scale[c], sb1 = c + 1 < args.n ? args.b_scale[c + 1] : 0.0f;
        if (r_lo < args.m)
          store_pair<BF16_OUT>(args, r_lo, c, __fmul_rn(__int2float_rn(static_cast<int>(acc[4 * j])), sa_lo),
                               __fmul_rn(__int2float_rn(static_cast<int>(acc[4 * j + 1])), sa_lo), sb0, sb1);
        if (r_hi < args.m)
          store_pair<BF16_OUT>(args, r_hi, c, __fmul_rn(__int2float_rn(static_cast<int>(acc[4 * j + 2])), sa_hi),
                               __fmul_rn(__int2float_rn(static_cast<int>(acc[4 * j + 3])), sa_hi), sb0, sb1);
      }
    }
  }
  if (STAGED && tid == 0) bulk_wait();  // the shared memory outlives every store from it
}

// A (rows, k) int8 K-major operand with rows `ld` bytes apart (a multiple of 16: TMA's stride rule) as a 2-D
// map of (128 bytes x `box_rows`) boxes, 128-byte swizzle. The map's width is k, so TMA reads columns k to ld
// as zeros whatever the buffer holds there.
cudaError_t operand_map(CUtensorMap* map, const void* base, int rows, int k, int ld, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {kSliceK, static_cast<cuuint32_t>(box_rows)};
  return colpali_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, base, dims, strides, box,
                            CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int BN, bool BF16_OUT, bool STAGED>
cudaError_t launch_tiles(const void* a, const void* b, GemmArgs args, int sms, cudaStream_t stream) {
  using L = GemmLayout<BN, STAGED>;
  CUtensorMap a_map, b_map, out_map;
  cudaError_t err = operand_map(&a_map, a, args.m, args.k, args.lda, kTileM);
  if (err == cudaSuccess) err = operand_map(&b_map, b, args.n, args.k, args.ldb, BN);
  out_map = a_map;  // not read unless STAGED
  if (STAGED && err == cudaSuccess) {  // (M, N) bf16 in boxes of 64 rows x 64 columns
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(args.n), static_cast<cuuint64_t>(args.m)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(args.n) * 2};
    const cuuint32_t box[2] = {64, 64};
    err = colpali_tensor_map(&out_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, args.out, dims, strides, box,
                             CU_TENSOR_MAP_SWIZZLE_128B);
  }
  if (err == cudaSuccess) err = colpali_allow_smem(int8_gemm_kernel<BN, BF16_OUT, STAGED>, L::SMEM);
  if (err != cudaSuccess) return err;
  args.tiles_m = (args.m + kTileM - 1) / kTileM;
  args.tiles_n = (args.n + BN - 1) / BN;
  args.tiles = args.tiles_m * args.tiles_n;
  int8_gemm_kernel<BN, BF16_OUT, STAGED><<<std::min(args.tiles, sms), kGemmThreads, L::SMEM, stream>>>(
      a_map, b_map, out_map, args);
  return cudaGetLastError();
}

// bf16 output with 16-byte rows (N % 8 == 0) goes out through shared memory and TMA.
template <int BN, bool BF16_OUT>
cudaError_t launch_gemm(const void* a, const void* b, const GemmArgs& args, int sms, cudaStream_t stream) {
  if (BF16_OUT && args.n % 8 == 0) return launch_tiles<BN, BF16_OUT, BF16_OUT>(a, b, args, sms, stream);
  return launch_tiles<BN, BF16_OUT, false>(a, b, args, sms, stream);
}

// N tiles of 256 (two m64n256 products a slice, half the shared-memory reads of A per product) where
// they keep every SM busy and pad N by no more than tiles of 128 do; else 128.
template <bool BF16_OUT>
cudaError_t dispatch_gemm(const void* a, const void* b, const GemmArgs& args, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int tiles_m = (args.m + kTileM - 1) / kTileM, n256 = (args.n + 255) / 256, n128 = (args.n + 127) / 128;
  if (tiles_m * n256 >= sms && 2 * n256 == n128) return launch_gemm<256, BF16_OUT>(a, b, args, sms, stream);
  return launch_gemm<128, BF16_OUT>(a, b, args, sms, stream);
}

}  // namespace

// Q1a: x (rows, k) bf16 (x_bf16 = 1) or fp32, contiguous -> q (rows, k) int8 with rows ldq bytes apart
// (ldq % 16 == 0, ldq >= k: Q1b's operand layout; columns k to ldq are not written), scale (rows) fp32.
extern "C" int colpali_quantize_rows(const void* x, void* q, void* scale, int64_t rows, int k, int ldq, int x_bf16,
                                     void* stream) {
  if (rows < 1 || rows > INT32_MAX || k < 1 || ldq < k || ldq % 16) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch_quantize_rows<__nv_bfloat16>(x, q, scale, rows, k, ldq, s)
                : launch_quantize_rows<float>(x, q, scale, rows, k, ldq, s);
}

// Q1b: a (m, k) int8 with rows lda bytes apart and a_scale (m) fp32, b (n, k) int8 with rows ldb bytes apart
// and b_scale (n) fp32, bias (n) of the output type or null -> out (m, n) bf16 (out_bf16 = 1) or fp32, contiguous.
// Any k >= 1; lda and ldb are multiples of 16 and >= k (a k that is not is padded in the row stride: TMA reads
// the columns past k as zeros, which add nothing to an int32 sum); 16-byte aligned bases.
extern "C" int colpali_int8_gemm(const void* a, int lda, const void* a_scale, const void* b, int ldb,
                                 const void* b_scale, const void* bias, void* out, int m, int n, int k, int out_bf16,
                                 void* stream) {
  if (m < 1 || n < 1 || k < 1 || lda < k || ldb < k || lda % 16 || ldb % 16) return cudaErrorInvalidValue;
  GemmArgs args;
  args.a_scale = static_cast<const float*>(a_scale);
  args.b_scale = static_cast<const float*>(b_scale);
  args.bias = bias;
  args.out = out;
  args.m = m;
  args.n = n;
  args.k = k;
  args.lda = lda;
  args.ldb = ldb;
  const int64_t tiles = static_cast<int64_t>((m + kTileM - 1) / kTileM) * ((n + 127) / 128);
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_bf16 ? dispatch_gemm<true>(a, b, args, s) : dispatch_gemm<false>(a, b, args, s);
}
