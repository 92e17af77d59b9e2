#!/usr/bin/env python3
"""Time two checkouts' two-tier search on one GPU, in turns: K1, K2 and the tiered search's stages.

    python scripts/search_ab.py PARENT_ROOT CHANGE_ROOT [--pairs 1]

Each root is a directory holding a ``colpali_tpu_torch`` package (a
``git archive`` of a commit, unpacked). The roots run as parent, change,
change, parent, repeated ``--pairs`` times, each in its own process with the
root first on ``PYTHONPATH`` (each builds its own kernels into
``<root>/build/``); the harness (``chip_smoke.py`` of the checkout this
script lives in) is the same for both. Every run makes, from seed 0 on the
card:

- the page index: 8,192 random unit docs x 1,040 tokens x 128 through
  ``DeviceIndexBuilder`` (int8, sign sketch pooled by 4), and a bf16 copy
  of its store;
- the kernel corpus: 999,936 docs x 64 tokens, ``chip_smoke.make_corpus``;

and times, by CUDA events, the mean of 20 calls after a warm-up and the
mean of 20 replays of the call captured in a CUDA graph (no host launches):

- K1 on the page index at B=1 and B=4 (Nq=64, the served padding), and over
  the corpus at B=1 Nq=32, B=1 Nq=64 and B=4 Nq=64;
- K2 (int8 store, and bf16 on the page index) over the 1,024 candidates K1
  gives, at the same shapes (the corpus at B=1, Nq=32 and 64);
- ``CorpusIndex.search`` by stage (``chip_smoke.tiered_stages``) on the
  page index at B=1 and B=4 and on the corpus at B=1, and one query on the page
  index through ``CorpusIndex.search`` and through ``/search`` of
  ``serve.make_handler`` by the host clock (medians of 20).

Prints the card's name and power limit, one JSON line per run, then each
root's medians.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HARNESS = Path(__file__).resolve().parents[1]  # holds chip_smoke.py
PAGE_DOCS, PAGE_TOKENS, CORPUS_DOCS, CANDIDATES, SERVED = 8192, 1040, 999_936, 1024, 64


def measure() -> dict:
    """One run in this process: {case: [events ms, graph ms]} and {stages case: {stage: ms}}."""
    import numpy as np
    import torch

    import importlib.util

    # this checkout's chip_smoke.py by its path (the root under test has its own), importing the root's package
    spec = importlib.util.spec_from_file_location("harness_chip_smoke", HARNESS / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from colpali_tpu_torch.ops.maxsim_binary import binary_maxsim_tiled
    from colpali_tpu_torch.ops.maxsim_tiled import gather_rerank_tiled
    from colpali_tpu_torch.ops.quant import binarize_words
    from colpali_tpu_torch.retrieval.store import DeviceIndexBuilder
    from colpali_tpu_torch.utils.tensor_utils import top_k

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    builder = DeviceIndexBuilder(PAGE_TOKENS, cs.DIM, dtype="int8", prefilter="binary", coarse_pool=cs.COARSE_POOL)
    for _ in range(PAGE_DOCS // 256):
        x = torch.randn((256, PAGE_TOKENS, cs.DIM), generator=gen, device=dev)
        builder.add(x / x.norm(dim=-1, keepdim=True))
    index = builder.build()
    page = (index._store, index._scales, index._bwords)
    bstore = torch.empty(page[0].shape, dtype=torch.bfloat16, device=dev)
    for s in range(0, bstore.shape[0], 8):
        bstore[s : s + 8] = (page[0][s : s + 8].float() * page[1][s : s + 8, ..., None]).to(torch.bfloat16)
    corpus = cs.make_corpus(gen, CORPUS_DOCS, dev)

    def queries(b, nq):  # unit random tokens
        x = torch.randn((b, nq, cs.DIM), generator=gen, device=dev)
        return x / x.norm(dim=-1, keepdim=True)

    out = {}

    def both(name, fn):
        out[name] = [cs.time_ms(fn, reps=20), cs.graph_ms(fn)]

    cases = [("page", page, 1, 64), ("page", page, 4, 64), ("corpus", corpus, 1, 32), ("corpus", corpus, 1, 64),
             ("corpus", corpus, 4, 64)]
    for where, (store, scales, bwords), b, nq in cases:
        q = queries(b, nq)
        qw, qv = binarize_words(q)
        label = f"{where} B={b} Nq={nq}"
        both(f"K1 {label}", lambda: binary_maxsim_tiled(qw, qv, bwords, cs.DIM))
        if where == "corpus" and b > 1:
            continue
        _, cand = top_k(binary_maxsim_tiled(qw, qv, bwords, cs.DIM), CANDIDATES)
        both(f"K2 int8 {label}", lambda: gather_rerank_tiled(q, store, scales, cand))
        if where == "page":
            both(f"K2 bf16 {label}", lambda: gather_rerank_tiled(q, bstore, None, cand))
    q_page = torch.cat([queries(4, 32), torch.zeros((4, SERVED - 32, cs.DIM), device=dev)], dim=1)  # padded as served
    for b in (1, 4):
        out[f"stages page B={b}"] = cs.tiered_stages(f"page B={b}", index, q_page[:b].cpu().numpy())
    out["stages corpus B=1"] = cs.tiered_stages("corpus B=1", cs.index_over(*corpus, CORPUS_DOCS),
                                                q_page[:1].cpu().numpy())
    one = [q_page[0, :32].cpu().numpy()]
    index.search(one, k=10)
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        index.search(one, k=10)
        host.append((time.perf_counter() - t0) * 1e3)
    out["CorpusIndex.search x1 page, host ms"] = [float(np.median(host))]
    out["/search x1 page, host ms"] = [http_search_ms(cs, index, one)]
    return out


def http_search_ms(cs, index, one: list) -> float:
    """Median round trip of 20 ``/search`` requests of one query through the
    root's ``serve.make_handler`` over ``index`` (after a warm-up)."""
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    from colpali_tpu_torch import serve

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(index, [str(i) for i in range(index.num_docs)]))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url, payload = f"http://127.0.0.1:{httpd.server_port}", {"embeddings": [one[0].tolist()], "k": 10}
    try:
        cs._http(url, "/search", payload)
        times = []
        for _ in range(20):
            t0 = time.perf_counter()
            cs._http(url, "/search", payload)
            times.append((time.perf_counter() - t0) * 1e3)
    finally:
        httpd.shutdown()
        httpd.server_close()
    return float(np.median(times))


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
        medians = {}
        for case, first in results[0].items():
            if isinstance(first, dict):
                medians[case] = {k: statistics.median(r[case][k] for r in results) for k in first}
            else:
                medians[case] = [statistics.median(r[case][i] for r in results) for i in range(len(first))]
        print(json.dumps({"median": side, **medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
