#!/usr/bin/env python3
"""Measure the H100's single-bit tensor-core rate beside its int8 rate and its CUDA-core popcount rate.

K1 (the sign-sketch coarse pass) scores ``D - 2 popc(q ^ d)`` for every
(query token, doc token) pair. PTX offers that product on the tensor cores
as ``mma.sync ... .b1.b1.s32.and.popc`` (m16n8k128, m16n8k256) and, on
sm_90a, ``wgmma ... .b1 .and.popc`` (m64nNk256); NVIDIA's data sheet gives
no rate for either. Each probe here is a loop of independent products on
register (or shared-memory) operands, so it reads nothing from device
memory: its time is the issue rate of the instruction alone. Operations are
counted as 2 * M * N * K a product, as for int8. Run from the repository
root on a machine with the card:

    python3 tools/b1_probe.py

Prints the card's name and power limit, then one line per probe (TOP/s, or
why the probe did not build) and a JSON line with every rate.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from colpali_tpu_torch.ops import _cuda  # noqa: E402

OUT = REPO / "build" / "b1_probe"
SMS, ITERS = 132, 4096

HEADER = r"""
#include <cstdint>
#include <cuda_runtime.h>

// ILP independent accumulators a warp, ITERS rounds; one sum written so nothing is dead.
#define MMA_LOOP(BODY)                                                     \
  const uint32_t x = threadIdx.x * 2654435761u + blockIdx.x;              \
  uint32_t a0 = x, a1 = x ^ 0x5555u, a2 = x + 7u, a3 = x * 3u, b0 = ~x, b1 = x >> 3; \
  int c[4][4] = {};                                                        \
  for (int it = 0; it < iters; ++it) {                                     \
    _Pragma("unroll") for (int i = 0; i < 4; ++i) { BODY }                \
  }                                                                        \
  int s = 0;                                                               \
  for (int i = 0; i < 4; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];  \
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;

#define LAUNCH(name)                                                                        \
  extern "C" int launch_##name(int* out, int blocks, int threads, int iters, void* stream) { \
    name<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);          \
    return cudaGetLastError();                                                              \
  }
"""

B1_SOURCE = HEADER + r"""
__global__ void b1_k128(int* out, int iters) {
  MMA_LOOP(asm volatile("mma.sync.aligned.m16n8k128.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, {%4,%5}, {%6}, "
                        "{%0,%1,%2,%3};\n"
                        : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
                        : "r"(a0), "r"(a1), "r"(b0));)
}

__global__ void b1_k256(int* out, int iters) {
  MMA_LOOP(asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
                        "{%8,%9}, {%0,%1,%2,%3};\n"
                        : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
                        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));)
}
LAUNCH(b1_k128)
LAUNCH(b1_k256)
"""

INT_SOURCE = HEADER + r"""
__global__ void s8_k32(int* out, int iters) {
  MMA_LOOP(asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
                        "{%0,%1,%2,%3};\n"
                        : "+r"(c[i][0]), "+r"(c[i][1]), "+r"(c[i][2]), "+r"(c[i][3])
                        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));)
}

// CUDA cores: 8 independent chains of popc(q ^ d) a thread
__global__ void popc_xor(int* out, int iters) {
  uint32_t d = threadIdx.x * 2654435761u + blockIdx.x;
  uint32_t q[8];
  int h[8] = {};
  for (int i = 0; i < 8; ++i) q[i] = d * (i + 3);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) h[i] += __popc(q[i] ^ (d + r));
    }
    d = d * 1664525u + 1013904223u;
  }
  int s = 0;
  for (int i = 0; i < 8; ++i) s += h[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

LAUNCH(s8_k32)
LAUNCH(popc_xor)
"""

# wgmma with single-bit operands, m64n128k256, both K-major in shared memory (unswizzled, zero data:
# the rate does not depend on the bits). Kept apart: ptxas may refuse it.
WGMMA_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(128 >> 4) << 16 |
         static_cast<uint64_t>(256 >> 4) << 32;
}

__global__ void __launch_bounds__(128) b1_wgmma(int* out, int iters) {
  __shared__ __align__(1024) uint8_t s[64 * 32 + 128 * 32];
  for (int i = threadIdx.x; i < (int)sizeof(s); i += 128) s[i] = 0;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(s));
  const uint64_t da = desc(base), db = desc(base + 64 * 32);
  uint32_t d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0;
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int r = 0; r < 4; ++r)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
          "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,"
          "%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,"
          "%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p;\n}\n"
          : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
            "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
            "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
            "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
            "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
            "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
            "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
            "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
          : "l"(da), "l"(db), "r"(1));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  int sum = 0;
  for (int i = 0; i < 64; ++i) sum += d[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

extern "C" int launch_b1_wgmma(int* out, int blocks, int threads, int iters, void* stream) {
  b1_wgmma<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return cudaGetLastError();
}
"""

# name: (source, threads, blocks per SM, operations per instruction, instructions per round per warp(group))
PROBES = {
    "b1_k128": ("b1", 256, 4, 2 * 16 * 8 * 128, 4),
    "b1_k256": ("b1", 256, 4, 2 * 16 * 8 * 256, 4),
    "s8_k32": ("int", 256, 4, 2 * 16 * 8 * 32, 4),
    "b1_wgmma": ("wgmma", 128, 2, 2 * 64 * 128 * 256, 4),
    "popc_xor": ("int", 256, 4, 1, 32),  # counted in popcounts of a 32-bit word a thread
}


def build_all() -> dict:
    """Compile the three probe sources side by side: {source: (library or None, compiler output)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, source in (("b1", B1_SOURCE), ("int", INT_SOURCE), ("wgmma", WGMMA_SOURCE)):
        src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        src.write_text(source)
        procs[name] = (lib, subprocess.Popen(
            [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-shared", "-Xptxas", "-v", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        libs[name] = (ctypes.CDLL(str(lib)) if proc.returncode == 0 else None), log
    return libs


def measure_rates(report=print) -> dict:
    """Each probe's rate on the current card (operations/s, popcounts/s for
    ``popc_xor``; None where the probe did not build)."""
    libs = build_all()
    stream = torch.cuda.current_stream().cuda_stream
    rates = {}
    for name, (src, threads, per_sm, ops, per_round) in PROBES.items():
        lib, log = libs[src]
        if lib is None:
            report(f"{name}: did not build:\n{log[-1500:]}")
            rates[name] = None
            continue
        fn = getattr(lib, f"launch_{name}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        blocks = SMS * per_sm
        out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")

        def run(iters):
            err = fn(out.data_ptr(), blocks, threads, iters, stream)
            if err:
                raise RuntimeError(f"{name}: launch error {err}")

        run(16)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run(ITERS)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        units = blocks * (threads // (128 if src == "wgmma" else 32)) if name != "popc_xor" else blocks * threads
        rate = units * ITERS * per_round * ops / (ms * 1e-3)
        rates[name] = rate
        label = "popcounts/s" if name == "popc_xor" else "OP/s"
        report(f"{name}: {ms:.3f} ms for {ITERS} rounds, {rate / 1e12:.1f} T{label} ({rate / 1e12 / SMS:.3f} T a SM)")
    return rates


def main() -> int:
    if not torch.cuda.is_available():
        print("b1_probe: no CUDA device visible", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps({"rates": measure_rates()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
