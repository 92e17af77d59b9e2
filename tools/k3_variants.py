#!/usr/bin/env python3
"""Time variants of the K3 kernel (colpali_tpu_torch/csrc/maxsim_int8.cu) on one GPU.

Each variant is the committed source with one edit, built by ``nvcc`` into
its own library under ``build/k3_variants/`` and timed with CUDA events
(mean of 10 calls after a warm-up) at K3's large-B shapes; every variant
that keeps the arithmetic is checked bit for bit against the source as it
is. Run from the repository root on a machine with the card:

    python3 tools/k3_variants.py [other.cu ...]

Each ``other.cu`` (a whole copy of the source, changed) is one more
variant, held bit-equal too. Variants: ``as_is``; ``no_epilogue``
(products only: the running max is not updated); ``no_products`` (the
epilogue over a zero accumulator); ``epilogue_2`` (the int -> float
conversion dropped: two instructions of four); ``epilogue_c0_only`` (both
consumers' products, consumer 0's epilogue); ``products_twice`` (no
epilogue, every product issued twice: eight k-steps a wait);
``pass_after_wait`` (a consumer hands the turn over once its products are
done, not once issued); ``split2`` and ``split4`` (each consumer's product
as 2 or 4 independent n64/n32 products).
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
from colpali_tpu_torch.ops.quant import quantize_per_token  # noqa: E402

SOURCE = REPO / "colpali_tpu_torch" / "csrc" / "maxsim_int8.cu"
OUT = REPO / "build" / "k3_variants"
MMA = """          wgmma_s8<N>(acc, smem_desc(a_tile + c * ROWS * CW + kk * 32, 16, 8 * CW, L::SWIZZLE),
                      smem_desc(q_tile + c * N * CW + kk * 32, 16, 8 * CW, L::SWIZZLE), c + kk > 0);"""
EPILOGUE = "        mx[i] = fmaxf(mx[i], sim * ((i & 2) ? ds_hi : ds_lo));"
CONVERT = "__int_as_float(static_cast<int>(acc[i] + 0x4B400000u)) - 12582912.0f"
PASS = "      if (wg == 0 || it + 1 < n_turns) named_bar_arrive(kBarTurn + 1 - wg, 256);  // the other's turn\n"
WAIT = "      wgmma_wait_all();\n"
# (tiles, doc tokens, B, Nq): the page slice's index and a quarter of the 1M-doc corpus
CASES = {"page B=8 Nq=64 Np=1040 C=8192": (64, 1040, 8, 64), "B=8 Nq=32 Np=64 C=249984": (1953, 64, 8, 32),
         "B=8 Nq=64 Np=64 C=249984": (1953, 64, 8, 64)}


def split(h: int) -> str:
    return f"""          if constexpr (N / {h} >= 32) {{
            const uint64_t da = smem_desc(a_tile + c * ROWS * CW + kk * 32, 16, 8 * CW, L::SWIZZLE);
#pragma unroll
            for (int hh = 0; hh < {h}; ++hh)
              wgmma_s8<N / {h}>(acc + hh * (N / {h}) / 2, da,
                                smem_desc(q_tile + c * N * CW + hh * (N / {h}) * CW + kk * 32, 16, 8 * CW,
                                          L::SWIZZLE), c + kk > 0);
          }} else {{
{MMA}
          }}"""


def variants(src: str) -> dict:
    for piece in (MMA, EPILOGUE, CONVERT, PASS + WAIT):
        if piece not in src:
            raise SystemExit(f"the source no longer holds the piece a variant edits:\n{piece}")
    return {
        "as_is": (src, True),
        "no_epilogue": (src.replace(EPILOGUE, "        if (ds_lo == 12345.f) mx[i] += sim;"), False),
        "no_products": (src.replace(MMA, "          ;"), False),
        "epilogue_2": (src.replace(CONVERT, "__int_as_float(static_cast<int>(acc[i]))"), False),
        "epilogue_c0_only": (src.replace(EPILOGUE, "        if (wg == 0) " + EPILOGUE.strip()), False),
        "pass_after_wait": (src.replace(PASS + WAIT, WAIT + PASS), True),
        "products_twice": (src.replace(MMA, "        {\n" + MMA + "\n" + MMA.replace("c + kk > 0)", "1)") + "\n        }")
                           .replace(EPILOGUE, "        if (ds_lo == 12345.f) mx[i] += sim;"), False),
        "split2": (src.replace(MMA, split(2)), True),
        "split4": (src.replace(MMA, split(4)), True),
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
    fns = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name} failed to build:\n{log[-3000:]}")
        warnings = [line.strip() for line in log.splitlines() if "C75" in line]
        codes = sorted({w[w.index("(C75"):w.index("(C75") + 7] for w in warnings})
        print(f"{name}: built, {len(warnings)} ptxas performance warning(s) {codes} {warnings[:1]}", flush=True)
        fn = ctypes.CDLL(str(so)).colpali_maxsim_int8
        fn.argtypes = [*([ctypes.c_void_p] * 5), *([ctypes.c_int] * 4), ctypes.c_int64, ctypes.c_void_p]
        fns[name] = fn
    return fns


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
        print("k3_variants: no CUDA device visible", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    named = variants(SOURCE.read_text())
    for path in map(Path, sys.argv[1:]):
        named[path.stem] = (path.read_text(), True)
    fns = build(named)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for case, (nt, np_, b, nq) in CASES.items():
        store = torch.randint(-127, 128, (nt, np_, 128, 128), generator=gen, device=dev, dtype=torch.int8)
        scales = (0.5 + torch.rand((nt, np_, 128), generator=gen, device=dev)) / (127 * 128**0.5)
        qi, qs = quantize_per_token(torch.randn((b, nq, 128), generator=gen, device=dev))
        out = torch.empty((b, nt * 128), device=dev)
        ref = None
        for name, fn in fns.items():
            def call(fn=fn):
                err = fn(qi.data_ptr(), qs.data_ptr(), store.data_ptr(), scales.data_ptr(), out.data_ptr(), b, nq,
                         np_, 128, nt, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            if name == "as_is":
                ref = out.clone()
            elif named[name][1] and not torch.equal(out, ref):
                raise AssertionError(f"{name} at {case}: not bit-equal to the source as it is")
            print(f"{case:32s} {name:16s} {time_ms(call):8.3f} ms", flush=True)
        del store, scales
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
