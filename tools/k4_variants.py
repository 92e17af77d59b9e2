#!/usr/bin/env python3
"""Time variants of the K4 kernel (colpali_tpu_torch/csrc/maxsim_bf16.cu) on one GPU.

Each variant is the committed source with one edit, built by ``nvcc`` into
its own library under ``build/k4_variants/`` and timed with CUDA events
(mean of 10 calls after a warm-up) at K4's shapes, a quarter of the
999,936-doc corpus at B=1 and B=8 (Nq=32) and the eval index's shape (one
tile of 1,040 tokens, B=128 Nq=16); every variant that keeps the arithmetic
is checked bit for bit against the source as it is. Run from the
repository root on a machine with the card:

    python3 tools/k4_variants.py [other.cu ...] [--timing-only probe.cu ...]

Each ``other.cu`` (a whole copy of the source, changed) is one more
variant, held bit-equal too; each ``probe.cu`` after ``--timing-only`` is
timed only (it may change what is computed). Variants: ``as_is``; ``no_convert`` (the int8
blocks are not converted: the products read stale buffers); ``no_products``
(the conversion alone); ``convert_stores_only`` (the raw words stored where
the converted ones go: the shared-memory traffic without the arithmetic);
``convert_alu_only`` (the arithmetic, one store a thread); ``half_rows``
(half the rows converted); ``no_fence`` (no proxy fence after the
stores); ``trunc_pack`` (bf16 by truncation, no packing conversion);
``bf16x2`` (the conversion in bf16 pairs: two masks, a subtraction and a
product a pair, dims permuted within groups of four, the queries to match);
``k5_as_is`` (K5 over a bf16 copy of the same blocks: no conversion, twice
the bytes). Only ``as_is`` computes K4's exact bits; the rest are timed.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from colpali_tpu_torch.ops import _cuda  # noqa: E402
from colpali_tpu_torch.ops.maxsim_tiled import _sm_count, maxsim_bf16_plan  # noqa: E402

SOURCE = REPO / "colpali_tpu_torch" / "csrc" / "maxsim_bf16.cu"
OUT = REPO / "build" / "k4_variants"
CONVERT = """      const uint2 e0 = dequant4(w[i].x, s), e1 = dequant4(w[i].y, s), e2 = dequant4(w[i].z, s), e3 = dequant4(w[i].w, s);
      *reinterpret_cast<uint4*>(dst + swizzled<DOC_TILE>(r, k)) = make_uint4(e0.x, e0.y, e1.x, e1.y);
      *reinterpret_cast<uint4*>(dst + swizzled<DOC_TILE>(r, k + 8)) = make_uint4(e2.x, e2.y, e3.x, e3.y);"""
PRODUCTS = "        products<D, N>(acc, af, smem_addr(s_conv + buf * L::TILE) + doc0 * 128);"
PIECES = "    constexpr int PIECES = kRows * D / 16 / 128;"
FENCE = "    fence_proxy_async();\n    __syncwarp();\n    if (lane == 0) mbar_arrive(bar_empty + 8 * stage);"
PACK = ("  return make_uint2(pack_bf16(f0, f1), pack_bf16(f2, f3));",
        "  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),\n"
        "                    __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));")
# bf16x2: the conversion in bf16 pairs (two masks, a subtraction and a product a pair, no fp32 and no packing
# conversion), dims (0, 2) and (1, 3) of each group of four side by side and the query fragments permuted to match
DEQUANT = ("__device__ __forceinline__ uint2 dequant4(uint32_t w, float s) {", """__device__ __forceinline__ uint2 dequant4(uint32_t w, __nv_bfloat162 s2) {
  const uint32_t odd = w >> 8;
  uint32_t x02 = (w & 0x007F007Fu) | 0x43004300u, x13 = (odd & 0x007F007Fu) | 0x43004300u;
  uint32_t c02 = (w & 0x00800080u) | 0x43004300u, c13 = (odd & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 p02 = __hmul2(__hsub2(*reinterpret_cast<__nv_bfloat162*>(&x02), *reinterpret_cast<__nv_bfloat162*>(&c02)), s2);
  __nv_bfloat162 p13 = __hmul2(__hsub2(*reinterpret_cast<__nv_bfloat162*>(&x13), *reinterpret_cast<__nv_bfloat162*>(&c13)), s2);
  return make_uint2(*reinterpret_cast<uint32_t*>(&p02), *reinterpret_cast<uint32_t*>(&p13));
}
__device__ __forceinline__ uint2 dequant4_fp32(uint32_t w, float s) {""")
SCALE = ("      const float s = __bfloat162float(__float2bfloat16_rn(scale[i]));",
         "      const __nv_bfloat162 s = __bfloat162bfloat162(__float2bfloat16_rn(scale[i]));")
QLOAD = ("""      const __nv_bfloat16* q0 = a.q + static_cast<int64_t>(slot) * a.qpc * a.nq * D + 2 * t4;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + 8 * (i & 1);
          af[ks][i] = r < rows ? *reinterpret_cast<const uint32_t*>(q0 + r * D + 16 * ks + 8 * (i >> 1)) : 0u;
        }""", """      const __nv_bfloat16* q0 = a.q + static_cast<int64_t>(slot) * a.qpc * a.nq * D + (INT8 ? 4 * (t4 >> 1) : 2 * t4);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + 8 * (i & 1);
          const __nv_bfloat16* p = q0 + r * D + 16 * ks + 8 * (i >> 1);
          if constexpr (INT8) {
            const uint2 x = r < rows ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
            af[ks][i] = __byte_perm(x.x, x.y, (t4 & 1) ? 0x7632 : 0x5410);
          } else {
            af[ks][i] = r < rows ? *reinterpret_cast<const uint32_t*>(p) : 0u;
          }
        }""")
# (tiles, doc tokens, B, Nq): a quarter of the kernel corpus at B=1 and B=8, and the eval index
CASES = {"B=1 Nq=32 Np=64 C=249984": (1953, 64, 1, 32), "B=8 Nq=32 Np=64 C=249984": (1953, 64, 8, 32),
         "eval B=128 Nq=16 Np=1040 C=128": (1, 1040, 128, 16)}


def variants(src: str) -> dict:
    for piece in (CONVERT, PRODUCTS, PIECES, FENCE, PACK[0], DEQUANT[0], SCALE[0], QLOAD[0]):
        if piece not in src:
            raise SystemExit(f"the source no longer holds the piece a variant edits:\n{piece}")
    alu_only = CONVERT.replace("*reinterpret_cast<uint4*>(dst + swizzled<DOC_TILE>(r, k)) =",
                               "if ((e0.x ^ e1.y ^ e2.x ^ e3.y) == 0x12345679u) *reinterpret_cast<uint4*>(dst) =")
    alu_only = alu_only.replace("*reinterpret_cast<uint4*>(dst + swizzled<DOC_TILE>(r, k + 8)) =",
                                "if ((e0.y ^ e1.x ^ e2.y ^ e3.x) == 0x12345679u) *reinterpret_cast<uint4*>(dst) =")
    stores_only = """      (void)s;
      *reinterpret_cast<uint4*>(dst + swizzled<DOC_TILE>(r, k)) = w[i];
      *reinterpret_cast<uint4*>(dst + swizzled<DOC_TILE>(r, k + 8)) = w[i];"""
    bf16x2 = src.replace(DEQUANT[0], DEQUANT[1]).replace(SCALE[0], SCALE[1]).replace(QLOAD[0], QLOAD[1])
    return {
        "as_is": (src, True),
        "no_convert": (src.replace(CONVERT, "      (void)s;"), False),
        "no_products": (src.replace(PRODUCTS, "        wgmma_fence();\n        wgmma_commit();"), False),
        "convert_stores_only": (src.replace(CONVERT, stores_only), False),
        "convert_alu_only": (src.replace(CONVERT, alu_only), False),
        "half_rows": (src.replace(PIECES, PIECES.replace("kRows * D / 16 / 128", "kRows * D / 32 / 128")), False),
        "no_fence": (src.replace(FENCE, FENCE.replace("    fence_proxy_async();\n", "")), False),
        "trunc_pack": (src.replace(PACK[0], PACK[1]), False),
        "bf16x2": (bf16x2, False),
    }


def build(named: dict) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _cuda._nvcc(), {}
    for name, (text, _) in named.items():
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_cuda.NVCC_FLAGS, "-shared", "-I", str(SOURCE.parent), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name} failed to build:\n{log[-3000:]}")
        warnings = [line.strip() for line in log.splitlines() if "C75" in line]
        print(f"{name}: built, {len(warnings)} ptxas performance warning(s) {warnings[:1]}", flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, n_ptr in ((lib.colpali_maxsim_int8_bf16, 5), (lib.colpali_maxsim_bf16, 4)):
            fn.argtypes = [*([ctypes.c_void_p] * n_ptr), *([ctypes.c_int] * 4), ctypes.c_int64,
                           *([ctypes.c_int] * 4), ctypes.c_void_p]
        libs[name] = lib
    return libs


def time_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device visible", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    named = variants(SOURCE.read_text())
    held = True
    for arg in sys.argv[1:]:
        if arg == "--timing-only":
            held = False
            continue
        named[Path(arg).stem] = (Path(arg).read_text(), held)
    libs = build(named)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for case, (nt, np_, b, nq) in CASES.items():
        store = torch.randint(-127, 128, (nt, np_, 128, 128), generator=gen, device=dev, dtype=torch.int8)
        scales = (0.5 + torch.rand((nt, np_, 128), generator=gen, device=dev)) / (127 * 128**0.5)
        bstore = (store.float() * scales[..., None]).to(torch.bfloat16)
        q = torch.randn((b, nq, 128), generator=gen, device=dev)
        q = (q / q.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
        plan = maxsim_bf16_plan(b, nq, np_, 128, nt, _sm_count(0))
        out = torch.empty((b, nt * 128), device=dev)
        scratch = torch.empty(max(1, plan.scratch_bytes // 4), device=dev)
        tail = (b, nq, np_, 128, nt, plan.qpc, int(plan.pair), plan.ctas, int(plan.split))
        ref = None
        for name, lib in [*libs.items(), ("k5_as_is", libs["as_is"])]:
            def call(lib=lib, name=name):
                stream = torch.cuda.current_stream().cuda_stream
                if name == "k5_as_is":
                    err = lib.colpali_maxsim_bf16(q.data_ptr(), bstore.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                                  *tail, stream)
                else:
                    err = lib.colpali_maxsim_int8_bf16(q.data_ptr(), store.data_ptr(), scales.data_ptr(),
                                                       out.data_ptr(), scratch.data_ptr(), *tail, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            if name == "as_is":
                ref = out.clone()
            elif name in named and named[name][1] and not torch.equal(out, ref):
                raise AssertionError(f"{name} at {case}: not bit-equal to the source as it is")
            print(f"{case:32s} {name:20s} {time_ms(call):8.3f} ms", flush=True)
        del store, scales, bstore
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
