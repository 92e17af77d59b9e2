#!/usr/bin/env python3
"""Time variants of Q1b, the int8 GEMM of stored-int8 weights
(colpali_tpu_torch/csrc/quant_dense.cu), on one GPU.

Each variant is the committed source with one edit, built by ``nvcc`` into
its own library under ``build/q1_variants/`` and timed with CUDA events
(mean of 10 calls after a warm-up), bf16 out, at the page batch's shapes
of ColPali-3B (M = 8,232 rows; gate/up, down_proj, SigLIP fc1, fc2 and
q/k/v/o) and two query shapes (M = 32 and 256 against gate/up's weight),
beside bf16 ``F.linear`` on the unquantized weight. Run from the repository
root on a machine with the card:

    python3 tools/q1_variants.py

Variants: ``as_is``; ``register_stores`` (each thread stores its bf16
pairs from the registers, as fp32 outputs are stored, instead of the tile
going through shared memory and TMA); ``n_fastest`` (tiles in N-fastest
order, no groups of row blocks); ``tiles_128`` (N tiles of 128 only);
``no_epilogue`` (nothing converted or stored: the loads and the products);
``no_products`` (no ``wgmma``: the loads and the epilogue). The first
three compute Q1b's exact bits and are checked against ``as_is``; the last
two are timed only.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from colpali_tpu_torch.ops import _cuda  # noqa: E402
from colpali_tpu_torch.ops import quant_dense as qd  # noqa: E402

SOURCE = REPO / "colpali_tpu_torch" / "csrc" / "quant_dense.cu"
OUT = REPO / "build" / "q1_variants"
VARIANTS = {
    "as_is": [],
    "register_stores": [("  if (BF16_OUT && args.n % 8 == 0) return launch_tiles<BN, BF16_OUT, BF16_OUT>",
                         "  if (false) return launch_tiles<BN, BF16_OUT, BF16_OUT>")],
    "n_fastest": [("constexpr int kGroupM = 8;", "constexpr int kGroupM = 1;")],
    "tiles_128": [("  if (tiles_m * n256 >= sms && 2 * n256 == n128) return", "  if (false) return")],
    "no_epilogue": [("    const int r_lo = row0 + 16 * warp + g, r_hi = r_lo + 8;",
                     "    if (args.k > 0) continue;\n    const int r_lo = row0 + 16 * warp + g, r_hi = r_lo + 8;")],
    "no_products": [("      for (int kk = 0; kk < kSliceK / 32; ++kk)\n        wgmma_s8<BN>(",
                     "      for (int kk = 0; kk < kSliceK / 32 * (args.k < 0); ++kk)\n        wgmma_s8<BN>(")],
}
EXACT = ("as_is", "register_stores", "n_fastest", "tiles_128")
SHAPES = [(8232, 2048, 16384, "gate/up"), (8232, 16384, 2048, "down_proj"), (8232, 1152, 4304, "SigLIP fc1"),
          (8232, 4304, 1152, "SigLIP fc2"), (8232, 1152, 1152, "SigLIP q/k/v/o"), (32, 2048, 16384, "gate/up, x1"),
          (256, 2048, 16384, "gate/up, x8")]


def build(name: str, edits: list) -> ctypes._CFuncPtr:
    src = SOURCE.read_text()
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(src)
    flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    res = subprocess.run([_cuda._nvcc(), *flags, f"-I{SOURCE.parent}", "-shared", "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stderr[-3000:]}")
    fn = ctypes.CDLL(str(so)).colpali_int8_gemm
    fn.argtypes = [*[ctypes.c_void_p] * 6, *[ctypes.c_int] * 4, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
        print("q1_variants: no CUDA device visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    fns = {name: build(name, edits) for name, edits in VARIANTS.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    for m, k, n, label in SHAPES:
        x = (torch.randn((m, k), generator=gen, device=dev) * 3).to(torch.bfloat16)
        w = (torch.randn((n, k), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        qa, sa = qd.quantize_rows(x)
        qw, sw = qd.quantize_rows_eager(w)
        sw = sw.reshape(-1)
        outs, line = {}, []
        for name, fn in fns.items():
            out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)

            def call(fn=fn, out=out):
                err = fn(qa.data_ptr(), sa.data_ptr(), qw.data_ptr(), sw.data_ptr(), None, out.data_ptr(), m, n, k, 1,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            line.append(f"{name} {time_ms(call):.4f}")
            outs[name] = out
        for name in EXACT[1:]:
            if not torch.equal(outs[name], outs["as_is"]):
                raise AssertionError(f"{label}: variant {name} is not bit-equal to the source as it is")
        line.append(f"bf16 F.linear {time_ms(lambda: F.linear(x, w)):.4f}")
        print(f"M={m} K={k} N={n} ({label}), ms: " + ", ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
