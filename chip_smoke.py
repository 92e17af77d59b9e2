#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's text-in serving path once on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (one line of output each, then two JSON lines):

1. device: the card's name and power limit (``nvidia-smi``), and the build
   of the CUDA kernels from ``colpali_tpu_torch/csrc`` (``build/kernels/``);
2. kernels: K1 (sign-sketch coarse pass), K2 (candidate gather + rerank)
   and K3 (full-int8 exact sweep) against their plain PyTorch versions on
   a 999,936-doc x 64-token x 128-dim int8 corpus generated on the card
   from a seeded ``torch.Generator``; each is timed over the whole corpus
   with CUDA events, kernel and plain version alike;
3. slice: ColPali-3B's text tower at full width (18 x 2048, MQA 8/1 x 256,
   vocab 257,216, seeded random bf16 weights), a whitespace tokenizer, a
   65,536-doc two-tier int8 index saved to ``.npz`` and loaded back, and
   ``colpali_tpu_torch.serve.make_handler`` on a local HTTP server answering
   /healthz, /search_text (tiered and exact routes), /search and /tune.

It exits non-zero, printing no result, when no CUDA device is visible or
any check fails. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

from colpali_tpu_torch.ops import _cuda
from colpali_tpu_torch.ops.maxsim_binary import (
    BINARY_MAXSIM,
    binary_maxsim_tiled,
    binary_maxsim_tiled_plain,
)
from colpali_tpu_torch.ops.maxsim_tiled import (
    DOC_TILE,
    GATHER_RERANK,
    MAXSIM_INT8,
    gather_rerank_int8,
    gather_rerank_plain,
    maxsim_int8mxu_tiled,
    maxsim_int8mxu_tiled_plain,
)
from colpali_tpu_torch.ops.quant import binarize_words, quantize_per_token

SEED = 0
CORPUS_DOCS = 999_936  # 7,812 tiles of 128 docs
DOC_TOKENS = 64
DIM = 128
COARSE_POOL = 4
QUERY_TOKENS = 32  # bench.py's query length
SERVED_TOKENS = 64  # MicroBatcher.query_token_pad: every served sweep pads queries to it
CANDIDATES = 1024
CHECK_TILES = 64  # tiles at each end of the corpus compared with the plain version
RTOL, ATOL = 1e-5, 1e-4  # K2/K3 vs plain: fp32 sums in another order
KERNELS = {
    "binary_maxsim": dict(counter=BINARY_MAXSIM, route="cuda",
                          source="colpali_tpu_torch/csrc/binary_maxsim.cu",
                          replaces="colpali_tpu/ops/maxsim_binary.py:117"),
    "gather_rerank": dict(counter=GATHER_RERANK, route="cuda",
                          source="colpali_tpu_torch/csrc/gather_rerank.cu",
                          replaces="colpali_tpu/ops/maxsim_pallas.py:512"),
    "maxsim_int8": dict(counter=MAXSIM_INT8, route="cuda",
                        source="colpali_tpu_torch/csrc/maxsim_int8.cu",
                        replaces="colpali_tpu/ops/maxsim_pallas.py:465"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# -- phase 1 -------------------------------------------------------------------


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = _cuda.build()
    _cuda.library()
    build_s = time.perf_counter() - t0
    ptxas = lib.with_suffix(".log").read_text()
    log(f"phase device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}, allow_tf32=False, "
        f"kernels built in {build_s:.1f} s -> {lib.name}")
    for line in ptxas.splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")


# -- phase 2 -------------------------------------------------------------------


def make_corpus(gen: torch.Generator, num_docs: int, device: torch.device):
    """Random int8 tile-major corpus, per-token scales and the pooled sign
    sketch, generated on the card a chunk of tiles at a time."""
    n_tiles = num_docs // DOC_TILE
    store = torch.empty((n_tiles, DOC_TOKENS, DOC_TILE, DIM), dtype=torch.int8, device=device)
    scales = torch.empty((n_tiles, DOC_TOKENS, DOC_TILE), dtype=torch.float32, device=device)
    npc = DOC_TOKENS // COARSE_POOL
    bwords = torch.empty((n_tiles, DIM // 32, npc, DOC_TILE), dtype=torch.int32, device=device)
    step = 256
    for s in range(0, n_tiles, step):
        k = min(step, n_tiles - s)
        store[s : s + k] = torch.randint(-127, 128, (k, DOC_TOKENS, DOC_TILE, DIM), generator=gen,
                                         device=device, dtype=torch.int8)
        scales[s : s + k] = (0.5 + torch.rand((k, DOC_TOKENS, DOC_TILE), generator=gen, device=device)) / (
            127.0 * DIM**0.5)
        deq = store[s : s + k].float() * scales[s : s + k, ..., None]
        pooled = deq.reshape(k, npc, COARSE_POOL, DOC_TILE, DIM).sum(dim=2)  # (k, Npc, T, D)
        words, _ = binarize_words(pooled)  # (k, Npc, T, W)
        bwords[s : s + k] = words.permute(0, 3, 1, 2)
    return store, scales, bwords


def phase_kernels(device: torch.device) -> dict:
    """Each kernel against its plain version on both ends of the corpus (the
    last tiles sit past 2^31 bytes) at the bench shape (Nq=32) and at the
    shapes the served path gives it (queries padded to SERVED_TOKENS, up to
    4 queries tiered, up to 64 exact); timed over the whole corpus."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    store, scales, bwords = make_corpus(gen, CORPUS_DOCS, device)
    torch.cuda.synchronize()
    n_tiles = store.shape[0]
    log(f"phase kernels: corpus {CORPUS_DOCS} docs x {DOC_TOKENS} x {DIM} int8 "
        f"({store.numel() / 2**30:.2f} GiB, sketch pool {COARSE_POOL}) made in {time.perf_counter() - t0:.1f} s")
    ends = [slice(0, CHECK_TILES), slice(n_tiles - CHECK_TILES, n_tiles)]
    errs = {name: 0.0 for name in KERNELS}

    def queries(b, nq):
        q = torch.randn((b, nq, DIM), generator=gen, device=device)
        q[:, -3:] = 0.0  # padded query tokens
        return q / q.norm(dim=-1, keepdim=True).clamp_min(1e-6)

    def check(name, got, want):
        err = (got - want).abs().max().item()
        if name == "binary_maxsim" and err != 0.0:
            raise AssertionError(f"K1 differs from its plain version: max abs err {err}")
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        errs[name] = max(errs[name], err)

    def cols(sl):
        return slice(sl.start * DOC_TILE, sl.stop * DOC_TILE)

    q = {shape: queries(*shape) for shape in [(1, QUERY_TOKENS), (8, QUERY_TOKENS), (1, SERVED_TOKENS),
                                              (4, SERVED_TOKENS), (8, SERVED_TOKENS), (64, SERVED_TOKENS)]}
    words = {shape: binarize_words(x) for shape, x in q.items()}
    quant = {shape: quantize_per_token(x) for shape, x in q.items()}
    cand = torch.randint(0, CORPUS_DOCS, (4, CANDIDATES), generator=gen, device=device, dtype=torch.int32)
    cand[:, 0], cand[:, 1] = 0, CORPUS_DOCS - 1

    for shape in [(1, QUERY_TOKENS), (4, SERVED_TOKENS)]:
        qw, qv = words[shape]
        full = binary_maxsim_tiled(qw, qv, bwords, DIM)
        for sl in ends:
            check("binary_maxsim", full[:, cols(sl)], binary_maxsim_tiled_plain(qw, qv, bwords[sl], DIM))
        c = cand[: shape[0]].contiguous()
        check("gather_rerank", gather_rerank_int8(q[shape], store, scales, c),
              gather_rerank_plain(q[shape], store, scales, c))
    for shape in [(1, QUERY_TOKENS), (8, QUERY_TOKENS), (64, SERVED_TOKENS)]:
        qi, qs = quant[shape]
        full = maxsim_int8mxu_tiled(qi, qs, store, scales)
        for sl in ends:
            check("maxsim_int8", full[:, cols(sl)], maxsim_int8mxu_tiled_plain(qi, qs, store[sl], scales[sl]))

    def k1(shape, plain=False):
        fn = binary_maxsim_tiled_plain if plain else binary_maxsim_tiled
        return lambda: fn(*words[shape], bwords, DIM)

    def k2(shape, plain=False):
        fn = gather_rerank_plain if plain else gather_rerank_int8
        return lambda: fn(q[shape], store, scales, cand[: shape[0]].contiguous())

    def k3(shape, plain=False):
        fn = maxsim_int8mxu_tiled_plain if plain else maxsim_int8mxu_tiled
        return lambda: fn(*quant[shape], store, scales)

    b1, b8, s1, s8 = (1, QUERY_TOKENS), (8, QUERY_TOKENS), (1, SERVED_TOKENS), (8, SERVED_TOKENS)
    results = {
        "binary_maxsim": dict(ms=time_ms(k1(b1)), plain_ms=time_ms(k1(b1, True), reps=2),
                              ms_served=time_ms(k1(s1)),
                              shape=f"B=1 Nq={QUERY_TOKENS} (served: Nq={SERVED_TOKENS}) W=4 Npc=16 C={CORPUS_DOCS}"),
        "gather_rerank": dict(ms=time_ms(k2(b1)), plain_ms=time_ms(k2(b1, True)), ms_served=time_ms(k2(s1)),
                              shape=f"B=1 Nq={QUERY_TOKENS} (served: Nq={SERVED_TOKENS}) c={CANDIDATES} Np={DOC_TOKENS}"),
        "maxsim_int8": dict(ms=time_ms(k3(b1)), plain_ms=time_ms(k3(b1, True), reps=2),
                            ms_b8=time_ms(k3(b8)), plain_ms_b8=time_ms(k3(b8, True), reps=2),
                            ms_served=time_ms(k3(s8)),
                            shape=f"B=1 and B=8 Nq={QUERY_TOKENS} (served: B=8 Nq={SERVED_TOKENS}) "
                                  f"Np={DOC_TOKENS} C={CORPUS_DOCS}"),
    }
    for name, r in results.items():
        r["max_abs_err"] = errs[name]
        extra = f", B=8 kernel {r['ms_b8']:.3f} ms, plain {r['plain_ms_b8']:.3f} ms" if "ms_b8" in r else ""
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{extra}, "
            f"served shape {r['ms_served']:.3f} ms, max_abs_err {r['max_abs_err']:.3g}")
    del store, scales, bwords
    torch.cuda.empty_cache()
    return results


# -- phase 3 -------------------------------------------------------------------

INDEX_DOCS = 65_536
QUERIES = [
    "quarterly revenue report for the northern region",
    "organisational chart of the engineering division",
    "safety instructions for the chemical laboratory",
    "annual rainfall measured at coastal weather stations",
    "patent claims describing a folding bicycle frame",
    "menu prices of the downtown italian restaurant",
    "timetable of regional trains on weekend mornings",
    "clinical trial results for the new vaccine dose",
]
PLANTED = [int(i) for i in np.linspace(100, INDEX_DOCS - 100, len(QUERIES))]
SERVE_RTOL = 1e-3  # /search_text vs encode + /search: same bf16 batch, sums in another order


class WordTokenizer:
    """Whitespace tokenizer with PaliGemma's pinned special tokens; other
    words hash (crc32) into the ids below the image token. It offers what
    ``ColPaliProcessor`` calls on a tokenizer."""

    pad_token, eos_token, bos_token = "<pad>", "<eos>", "<bos>"

    def __init__(self, image_token_id: int):
        self.image_token_id = image_token_id
        self.special = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "<image>": image_token_id}
        self._split = re.compile("(" + "|".join(re.escape(t) for t in self.special) + ")")

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self.special:
            return self.special[token]
        return 3 + zlib.crc32(token.encode()) % (self.image_token_id - 3)

    def _ids(self, text: str) -> list:
        out = []
        for part in self._split.split(text):
            if part in self.special:
                out.append(self.special[part])
            else:
                out.extend(self.convert_tokens_to_ids(w) for w in part.split())
        return out

    def __call__(self, texts, padding="longest", padding_side="right", add_special_tokens=False,
                 return_tensors="np"):
        if (padding, padding_side, add_special_tokens, return_tensors) != ("longest", "right", False, "np"):
            raise ValueError("WordTokenizer only pads right to the longest text, adds no special "
                             "tokens and returns numpy")
        rows = [self._ids(t) for t in texts]
        width = max(len(r) for r in rows)
        ids = np.zeros((len(rows), width), np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def _http(url: str, path: str, payload=None) -> dict:
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url + path, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as resp:
        if resp.status != 200:
            raise AssertionError(f"{path}: HTTP {resp.status}")
        return json.loads(resp.read())


def _check_ranked(name: str, out: dict, n: int) -> None:
    scores = np.asarray(out["scores"], np.float64)
    if scores.shape[0] != n or not np.isfinite(scores).all():
        raise AssertionError(f"{name}: expected {n} rows of finite scores, got {scores.shape}")
    if (np.diff(scores, axis=1) > 0).any():
        raise AssertionError(f"{name}: scores are not in descending order")


def phase_slice(device: torch.device) -> dict:
    """Drive the served path through its entry points; returns each kernel's
    launch count over the requests."""
    import tempfile
    from http.server import ThreadingHTTPServer
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.configs import PaliGemmaConfig
    from colpali_tpu_torch.models.paligemma import ColPali
    from colpali_tpu_torch.processors.colpali import ColPaliProcessor
    from colpali_tpu_torch.retrieval.serving import QueryEncoder
    from colpali_tpu_torch.retrieval.store import CorpusIndex

    cfg = PaliGemmaConfig()
    t0 = time.perf_counter()
    model = ColPali(cfg, dim=DIM, device=device, dtype=torch.bfloat16)
    hf_init_(model, torch.Generator(device=device).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    processor = ColPaliProcessor(WordTokenizer(cfg.image_token_index))
    encoder = QueryEncoder(model, processor)
    encoder.warmup()
    t_model = time.perf_counter() - t0
    t = cfg.text
    log(f"phase slice: ColPali text tower {t.num_hidden_layers} x {t.hidden_size}, MLP {t.intermediate_size}, "
        f"heads {t.num_attention_heads}/{t.num_key_value_heads} x {t.head_dim}, vocab {t.vocab_size}: "
        f"{n_params / 1e9:.3f} B params bf16, built + warmed in {t_model:.1f} s")

    planted_q = encoder.encode(QUERIES)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    docs = torch.randn((INDEX_DOCS, DOC_TOKENS, DIM), generator=gen, device=device)
    docs = (docs / docs.norm(dim=-1, keepdim=True)).cpu().numpy()
    for q, doc_id in zip(planted_q, PLANTED):
        docs[doc_id] = 0.0
        docs[doc_id, : q.shape[0]] = q
    t0 = time.perf_counter()
    built = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
    t_build = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/index.npz"
        built.save(path)
        del built
        index = CorpusIndex.load(path, device=device)
    del docs
    log(f"  index: {index.num_docs} docs x {index.doc_tokens} x {index.dim} int8 + sketch pool "
        f"{index.coarse_pool}, built in {t_build:.1f} s, saved + loaded, nbytes {index.nbytes}")

    files = [f"doc_{i}" for i in range(index.num_docs)]
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(index, files, encoder=encoder))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        for spec in KERNELS.values():
            spec["counter"].reset()
        health = _http(url, "/healthz")
        if health != {"status": "ok", "num_docs": INDEX_DOCS, "text_in": True}:
            raise AssertionError(f"/healthz: {health}")

        t0 = time.perf_counter()
        one = _http(url, "/search_text", {"queries": QUERIES[:1], "k": 10})  # tiered route
        ms_text_1 = (time.perf_counter() - t0) * 1e3
        _check_ranked("/search_text x1", one, 1)
        if one["doc_ids"][0][0] != PLANTED[0]:
            raise AssertionError(f"tiered: top-1 {one['doc_ids'][0][0]} != planted {PLANTED[0]}")

        t0 = time.perf_counter()
        text = _http(url, "/search_text", {"queries": QUERIES, "k": 10})  # exact route (8 > 4)
        ms_text_8 = (time.perf_counter() - t0) * 1e3
        _check_ranked("/search_text x8", text, len(QUERIES))
        top1 = [row[0] for row in text["doc_ids"]]
        if top1 != PLANTED:
            raise AssertionError(f"exact: top-1 {top1} != planted {PLANTED}")

        t0 = time.perf_counter()
        embs = encoder.encode(QUERIES)
        ms_encode = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        emb = _http(url, "/search", {"embeddings": [e.tolist() for e in embs], "k": 10, "mode": "exact"})
        ms_search_8 = (time.perf_counter() - t0) * 1e3
        _check_ranked("/search", emb, len(QUERIES))
        if emb["doc_ids"] != text["doc_ids"]:
            raise AssertionError("/search_text and encode + /search return different ids")
        np.testing.assert_allclose(text["scores"], emb["scores"], rtol=SERVE_RTOL)

        tune = _http(url, "/tune", {"embeddings": [e.tolist() for e in embs], "k": 10})
        if not (0.0 <= tune["recall"] <= 1.0 and tune["candidates"] >= 64):
            raise AssertionError(f"/tune: {tune}")
        metrics = _http(url, "/metrics")
        launches = {name: spec["counter"].launches for name, spec in KERNELS.items()}
    finally:
        httpd.shutdown()
        httpd.server_close()
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    log(f"  served: /search_text x1 (tiered) {ms_text_1:.1f} ms, x8 (exact) {ms_text_8:.1f} ms; "
        f"encode x8 {ms_encode:.1f} ms; /search x8 (exact) {ms_search_8:.1f} ms; "
        f"/tune -> {tune}; metrics p50 {metrics.get('search_ms_p50')} ms; launches {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script only runs on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    phase_device()
    timings = phase_kernels(device)
    launches = phase_slice(device)
    kernels = [dict(name=name, route=spec["route"], source=spec["source"], replaces=spec["replaces"],
                    launches=launches[name], **timings[name])
               for name, spec in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
