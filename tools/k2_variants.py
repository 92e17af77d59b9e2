#!/usr/bin/env python3
"""Time variants of the K2 kernel (colpali_tpu_torch/csrc/gather_rerank.cu) on one GPU.

Each variant is the committed source with one edit, built by ``nvcc`` into
its own library under ``build/k2_variants/`` and timed with CUDA events
(mean of 10 calls after a warm-up) at the page index's shape (8,192 docs x
1,040 tokens x 128, 1,024 random candidates a query, Nq=64) over an int8
and a bf16 store. The variant that keeps the arithmetic is held bit-equal
to the source as it is. Run from the repository root on a machine with the
card:

    python3 tools/k2_variants.py

Variants: ``as_is``; ``one_term`` (the products of the query's ``hi`` term
alone: a third of the tensor work); ``no_products`` (no ``wgmma``: the
loads, the int8 conversion and the epilogue); ``no_convert`` (the int8
tile is not converted: the products read the last converted tile);
``loads_only`` (neither products nor conversion: the TMA gather and the
ring's barriers); ``compute_only`` (int8 only: nothing is loaded, the
ring's barriers complete at once and the products, conversion and epilogue
run on what shared memory holds); ``no_fence`` (int8: the proxy fence after
the conversion dropped: a race, timed only); ``no_scale_copies`` (int8: the
scales are not copied); ``overhead_only`` (int8:
neither loads nor products nor conversion: the ring's barriers, the copy
issue and the epilogue).
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

SOURCE = REPO / "colpali_tpu_torch" / "csrc" / "gather_rerank.cu"
OUT = REPO / "build" / "k2_variants"
TERMS = "      for (int term = 2; term >= 0; --term)"
MMA = "              wgmma_rs_kmajor<T>(acc, af[term][4 * c + kk], db, term < 2 || c + kk > 0);"
CONVERT = "        for (int u = tid; u < T * D / 16; u += 128) {"
LOAD = "      mbar_expect_tx(full, L::DOC);"
TMA = ("          tma_load_4d(smem_addr(st) + c * T * L::DW, &doc_map, c * L::DW, doc % DOC_TILE, dt * T, "
       "doc / DOC_TILE,\n                      full);")
SCALES = "        cp_async_4(smem_addr(st + L::DOC + 4 * t)"
EPILOGUE = "          if constexpr (INT8) v *= scl[8 * j + 2 * t4 + (e & 1)];"
FENCE = "        fence_proxy_async();\n        return smem_addr(dst);"
CASES = {"int8 B=1": (False, 1), "bf16 B=1": (True, 1), "int8 B=4": (False, 4)}  # (bf16 store, B)
TILES, NP, NQ, DIM, CAND = 64, 1040, 64, 128, 1024


def variants(src: str) -> dict:
    for piece in (TERMS, MMA, CONVERT, LOAD, TMA, SCALES, EPILOGUE, FENCE):
        if piece not in src:
            raise SystemExit(f"the source no longer holds the piece a variant edits:\n{piece}")
    no_convert = CONVERT.replace("u < T * D / 16", "u < 0")
    compute_only = (src.replace(LOAD, "      mbar_arrive(full);").replace(TMA, "          ;")
                    .replace(SCALES, "        if (0) cp_async_4(smem_addr(st + L::DOC + 4 * t)"))
    return {
        "as_is": (src, True),
        "one_term": (src.replace(TERMS, TERMS.replace("term = 2", "term = 0")), False),
        "no_products": (src.replace(MMA, "              ;"), False),
        "no_convert": (src.replace(CONVERT, no_convert), False),
        "loads_only": (src.replace(MMA, "              ;").replace(CONVERT, no_convert), False),
        "compute_only": (compute_only, False),
        "no_fence": (src.replace(FENCE, "        return smem_addr(dst);"), False),
        "no_scale_copies": (src.replace(SCALES, "        if (0) cp_async_4(smem_addr(st + L::DOC + 4 * t)"), False),
        "overhead_only": (compute_only.replace(MMA, "              ;").replace(CONVERT, no_convert), False),
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
        lib.colpali_gather_rerank.argtypes = [*([ctypes.c_void_p] * 5), *([ctypes.c_int] * 5), ctypes.c_int64,
                                              ctypes.c_void_p]
        lib.colpali_gather_rerank_bf16.argtypes = [*([ctypes.c_void_p] * 4), *([ctypes.c_int] * 5), ctypes.c_int64,
                                                   ctypes.c_void_p]
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
        print("k2_variants: no CUDA device visible", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    named = variants(SOURCE.read_text())
    libs = build(named)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    store = torch.randint(-127, 128, (TILES, NP, 128, DIM), generator=gen, device=dev, dtype=torch.int8)
    scales = (0.5 + torch.rand((TILES, NP, 128), generator=gen, device=dev)) / (127 * DIM**0.5)
    bstore = (store.float() * scales[..., None]).to(torch.bfloat16)
    for case, (bf16, b) in CASES.items():
        q = torch.randn((b, NQ, DIM), generator=gen, device=dev)
        cand = torch.randint(0, TILES * 128, (b, CAND), generator=gen, device=dev, dtype=torch.int32)
        out = torch.empty((b, CAND), device=dev)
        ref = None
        for name, lib in libs.items():
            if bf16 and name.startswith(("compute", "overhead")):  # these skip the int8 loads only
                continue

            def call(lib=lib, name=name):
                stream = torch.cuda.current_stream().cuda_stream
                if bf16:
                    err = lib.colpali_gather_rerank_bf16(q.data_ptr(), bstore.data_ptr(), cand.data_ptr(),
                                                         out.data_ptr(), b, NQ, CAND, NP, DIM, TILES, stream)
                else:
                    err = lib.colpali_gather_rerank(q.data_ptr(), store.data_ptr(), scales.data_ptr(), cand.data_ptr(),
                                                    out.data_ptr(), b, NQ, CAND, NP, DIM, TILES, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            if name == "as_is":
                ref = out.clone()
            elif named[name][1] and not torch.equal(out, ref):
                raise AssertionError(f"{name} at {case}: not bit-equal to the source as it is")
            print(f"{case:10s} {name:12s} {time_ms(call):8.3f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
