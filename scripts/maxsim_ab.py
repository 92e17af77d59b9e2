#!/usr/bin/env python3
"""Time two checkouts' bf16 exact sweeps on one GPU, in turns: K4, K5, K8 and K9.

    python scripts/maxsim_ab.py PARENT_ROOT CHANGE_ROOT [--pairs 1]

Each root is a directory holding a ``colpali_tpu_torch`` package (a
``git archive`` of a commit, unpacked). The roots run as parent, change,
change, parent, repeated ``--pairs`` times, each in its own process with the
root first on ``PYTHONPATH`` (each builds its own kernels into
``<root>/build/``). Every run makes, from seed 0 on the card:

- the kernel corpus of ``chip_smoke.py``: 999,936 docs x 64 tokens x 128
  int8 with per-token scales, and a bf16 copy (the dequantized values
  rounded to bf16) of its first 262,144 docs; token-major copies of both;
- the eval index's shape: 128 random unit docs x 1,040 tokens x 128 in
  bf16, and its int8 copy (``quantize_per_token``);

and times each kernel through its ops entry point by CUDA events, the mean
of 10 calls after a warm-up (the eval shape also as the mean of 20 replays
of a CUDA graph, the card's time without the host's call). A kernel and its
other layout (K5 and K8, K4 and K9) are timed in turns, first, second,
second, first, and each is the mean of its two: the card's clock falls as
it heats under sustained products, so a fixed order would favour the first:

- K5 and K8 over the bf16 docs, K4 and K9 over the int8 corpus, at B=1
  Nq=32, B=8 Nq=32 and the served merged batch B=8 Nq=64;
- K5 and K4 at the eval shape, B=128 Nq=16 over one tile of 1,040 tokens.

Queries are random unit tokens, the last 3 of each zero (padding). Prints
the card's name and power limit, one JSON line per run, then each root's
medians and each case's bound (the larger of its bytes at 3.35 TB/s and its
bf16 operations at 989 TFLOP/s).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

CORPUS_DOCS, BF16_DOCS, DOC_TOKENS, DIM = 999_936, 262_144, 64, 128
EVAL_DOCS, EVAL_TOKENS, EVAL_B, EVAL_NQ = 128, 1040, 128, 16
SHAPES = [(1, 32), (8, 32), (8, 64)]  # (B, Nq) over the corpora: bench.py's query, and the served merged batch
HBM_BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12


def bounds() -> dict:
    """{case: bound ms} for every case :func:`measure` times."""
    out = {}
    for b, nq in SHAPES:
        for name, docs, per_token in (("K5", BF16_DOCS, 2 * DIM), ("K8", BF16_DOCS, 2 * DIM),
                                      ("K4", CORPUS_DOCS, DIM + 4), ("K9", CORPUS_DOCS, DIM + 4)):
            nbytes = docs * DOC_TOKENS * per_token + b * nq * DIM * 2 + b * docs * 4
            ops = 2 * b * nq * docs * DOC_TOKENS * DIM
            out[f"{name} B={b} Nq={nq}"] = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    ops = 2 * EVAL_B * EVAL_NQ * EVAL_DOCS * EVAL_TOKENS * DIM
    for name, per_token in (("K5", 2 * DIM), ("K4", DIM + 4)):
        nbytes = EVAL_DOCS * EVAL_TOKENS * per_token + EVAL_B * EVAL_NQ * DIM * 2 + EVAL_B * EVAL_DOCS * 4
        out[f"{name} eval B={EVAL_B} Nq={EVAL_NQ}"] = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    return out


def measure() -> dict:
    """One run in this process: {case: [events ms]} (the eval cases [events ms, graph ms])."""
    import torch

    from colpali_tpu_torch.ops import maxsim_token_major as tm
    from colpali_tpu_torch.ops.maxsim_tiled import DOC_TILE, maxsim_int8_tiled, maxsim_tiled
    from colpali_tpu_torch.ops.quant import quantize_per_token

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_tiles, bf16_tiles = CORPUS_DOCS // DOC_TILE, BF16_DOCS // DOC_TILE
    store = torch.empty((n_tiles, DOC_TOKENS, DOC_TILE, DIM), dtype=torch.int8, device=dev)
    scales = torch.empty((n_tiles, DOC_TOKENS, DOC_TILE), dtype=torch.float32, device=dev)
    for s in range(0, n_tiles, 256):
        k = min(256, n_tiles - s)
        store[s : s + k] = torch.randint(-127, 128, (k, DOC_TOKENS, DOC_TILE, DIM), generator=gen, device=dev,
                                         dtype=torch.int8)
        scales[s : s + k] = (0.5 + torch.rand((k, DOC_TOKENS, DOC_TILE), generator=gen, device=dev)) / (
            127.0 * DIM**0.5)
    bstore = torch.empty((bf16_tiles, DOC_TOKENS, DOC_TILE, DIM), dtype=torch.bfloat16, device=dev)
    for s in range(0, bf16_tiles, 256):
        bstore[s : s + 256] = (store[s : s + 256].float() * scales[s : s + 256, ..., None]).to(torch.bfloat16)

    def token_major(tiled):  # (nt, Np, 128, ...) -> (Np, nt * 128, ...), a chunk of tiles at a time
        nt, np_, rest = tiled.shape[0], tiled.shape[1], tiled.shape[3:]
        out = torch.empty((np_, nt * DOC_TILE, *rest), dtype=tiled.dtype, device=dev)
        for s in range(0, nt, 256):
            k = min(256, nt - s)
            out[:, s * DOC_TILE : (s + k) * DOC_TILE] = tiled[s : s + k].transpose(0, 1).reshape(np_, k * DOC_TILE,
                                                                                              *rest)
        return out

    docs_tm, scales_tm, bdocs_tm = token_major(store), token_major(scales), token_major(bstore)
    x = torch.randn((EVAL_DOCS, EVAL_TOKENS, DIM), generator=gen, device=dev)
    x = (x / x.norm(dim=-1, keepdim=True)).reshape(1, DOC_TILE, EVAL_TOKENS, DIM).transpose(1, 2).contiguous()
    eval_bf16 = x.to(torch.bfloat16)
    eval_int8, eval_scales = quantize_per_token(x)

    def queries(b, nq):
        q = torch.randn((b, nq, DIM), generator=gen, device=dev)
        q[:, -3:] = 0.0
        return q / q.norm(dim=-1, keepdim=True).clamp_min(1e-6)

    def events_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):  # the entry points may set a kernel's attributes
            fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def in_turns(first, second):  # first, second, second, first: the card's clock drifts under sustained load
        times = [events_ms(first), events_ms(second), events_ms(second), events_ms(first)]
        return [(times[0] + times[3]) / 2], [(times[1] + times[2]) / 2]

    out = {}
    for b, nq in SHAPES:
        q = queries(b, nq)
        label = f"B={b} Nq={nq}"
        out[f"K5 {label}"], out[f"K8 {label}"] = in_turns(lambda: maxsim_tiled(q, bstore),
                                                         lambda: tm.maxsim_pallas_tm(q, bdocs_tm))
        out[f"K4 {label}"], out[f"K9 {label}"] = in_turns(lambda: maxsim_int8_tiled(q, store, scales),
                                                         lambda: tm.maxsim_pallas_int8_tm(q, docs_tm, scales_tm))
    q = queries(EVAL_B, EVAL_NQ)
    for name, fn in (("K5", lambda: maxsim_tiled(q, eval_bf16)),
                     ("K4", lambda: maxsim_int8_tiled(q, eval_int8, eval_scales))):
        out[f"{name} eval B={EVAL_B} Nq={EVAL_NQ}"] = [events_ms(fn), graph_ms(fn)]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--pairs", type=int, default=1)
    parser.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)  # one run, in a child process
    args = parser.parse_args()
    if args.measure:
        print(json.dumps(measure()))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    runs = {"parent": [], "change": []}
    for side in ["parent", "change", "change", "parent"] * args.pairs:
        root = os.path.abspath(getattr(args, side))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), args.parent, args.change, "--measure"],
                              cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(side, json.dumps(runs[side][-1]), flush=True)
    for side, results in runs.items():
        medians = {case: [statistics.median(r[case][i] for r in results) for i in range(len(first))]
                   for case, first in results[0].items()}
        print(json.dumps({"median": side, **medians}))
    print(json.dumps({"bound_ms": bounds()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
