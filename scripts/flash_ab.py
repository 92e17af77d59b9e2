#!/usr/bin/env python3
"""Time two checkouts' K6/K11 flash kernels on one GPU, in turns.

    python scripts/flash_ab.py PARENT_ROOT CHANGE_ROOT [--pairs 2]

Each root is a directory holding a ``colpali_tpu_torch`` package (a
``git archive`` of a commit, unpacked). The roots run as
parent, change, change, parent, repeated ``--pairs`` times, each in its
own process with the root first on ``PYTHONPATH`` (each builds its own
kernels into ``<root>/build/``). Every run times K6's forward at the
kernel table's shapes (SigLIP, Gemma over a page, Gemma over padded
queries, and K11's ColQwen2 vision and GQA text shapes, causal too) and
K6's backward (page, collated queries, SigLIP): the mean over 20 calls by
CUDA events after a warm-up, and the kernels' summed device time per call
from ``torch.profiler`` over 10 calls. At small shapes back-to-back calls
measure the host, which the device time does not; there the C entry
point's own host time per call is measured too (the wrapper's Python is
the same on both sides). Where the backward runs dq on a side stream, the
profiler's sum may exceed the events' time.
Prints one JSON line per run, then the median of each root's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

FWD = [("siglip", 8, 1024, 16, 16, 72, False, None), ("page", 8, 1029, 8, 1, 256, False, None),
       ("queries", 8, 32, 8, 1, 256, False, [32, 19, 32, 7, 25, 32, 11, 30]),
       ("vision", 8, 2464, 16, 16, 80, False, None), ("gqa", 8, 768, 12, 2, 128, False, None),
       ("gqa_causal", 8, 768, 12, 2, 128, True, None)]
BWD = [("page", 8, 1029, 8, 1, 256), ("queries", 8, 14, 8, 1, 256), ("siglip", 8, 1024, 16, 16, 72)]


def measure() -> dict:
    """One run in this process: {case: [events ms, device ms(, C entry host us)]}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from colpali_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def events(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def device(fn, calls=10):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls

    def entry_us(kernel, fn, calls=100, rounds=10):
        """Host microseconds per call of ``kernel``'s C entry point alone,
        with the arguments that ``fn`` passes it: the least of ``rounds``
        rounds of ``calls`` calls, few enough that the launch queue never
        fills and holds the host back."""
        fn()
        real, seen = kernel._fn, []
        kernel._fn = lambda *a: seen.append(a) or real(*a)
        fn()
        kernel._fn = real
        best = float("inf")
        for _ in range(rounds):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                real(*seen[-1])
            best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return best

    def inputs(b, s, h, hkv, d):
        return [torch.randn((b, s, n, d), generator=gen, device=dev).bfloat16() for n in (h, hkv, hkv)]

    out = {}
    for name, b, s, h, hkv, d, causal, lengths in FWD:
        q, k, v = inputs(b, s, h, hkv, d)
        seg = torch.ones((b, s), dtype=torch.int32, device=dev)
        if lengths:
            seg = (torch.arange(s, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]).int()
        fn = lambda: fa.flash_attention(q, k, v, seg, d**-0.5, causal)  # noqa: E731
        out["fwd " + name] = [events(fn), device(fn)] + ([entry_us(fa.FLASH_ATTENTION, fn)] if s < 64 else [])
    for name, b, s, h, hkv, d in BWD:
        q, k, v = inputs(b, s, h, hkv, d)
        seg = torch.ones((b, s), dtype=torch.int32, device=dev)
        d_out = torch.randn((b, s, h, d), generator=gen, device=dev).bfloat16()
        o, lse = fa._forward_cuda(q, k, v, seg, d**-0.5, False, True)
        fn = lambda: fa.flash_attention_backward(q, k, v, seg, o, lse, d_out, d**-0.5)  # noqa: E731
        out["bwd " + name] = [events(fn), device(fn)] + ([entry_us(fa.FLASH_ATTENTION_BWD, fn)] if s < 64 else [])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent")
    parser.add_argument("change")
    parser.add_argument("--pairs", type=int, default=2)
    parser.add_argument("--measure", action="store_true", help=argparse.SUPPRESS)  # one run, in a child process
    args = parser.parse_args()
    if args.measure:
        print(json.dumps(measure()))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    runs = {"parent": [], "change": []}
    for side in ["parent", "change", "change", "parent"] * args.pairs:
        root = os.path.abspath(getattr(args, side))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), args.parent, args.change, "--measure"],
                              cwd=root, env=env, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        runs[side].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(side, runs[side][-1], flush=True)
    for side, results in runs.items():
        medians = {case: [statistics.median(r[case][i] for r in results) for i in range(len(results[0][case]))]
                   for case in results[0]}
        print(json.dumps({"median": side, **medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
