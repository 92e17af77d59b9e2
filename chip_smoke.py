#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and page-embedding paths once on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (a few lines of output each, then two JSON lines):

1. device: the card's name and power limit (``nvidia-smi``), and the build
   of the CUDA kernels from ``colpali_tpu_torch/csrc`` (``build/kernels/``);
2. kernels: K1 (sign-sketch coarse pass), K2 (candidate gather + rerank)
   and K3 (full-int8 exact sweep) against their plain PyTorch versions on
   a 999,936-doc x 64-token x 128-dim int8 corpus generated on the card
   from a seeded ``torch.Generator``; each is timed over the whole corpus
   with CUDA events, kernel and plain version alike;
3. text slice: ColPali-3B at full width (SigLIP-So400m 27 x 1152, projector
   1152 -> 2048, Gemma-2B 18 x 2048 with MQA 8/1 x 256 and vocab 257,216;
   seeded random bf16 weights), a whitespace tokenizer, a 65,536-doc
   two-tier int8 index saved to ``.npz`` and loaded back, and
   ``colpali_tpu_torch.serve.make_handler`` on a local HTTP server answering
   /healthz, /search_text (tiered and exact routes), /search and /tune;
4. page slice: K6 (flash attention) against its plain version and timed
   beside ``F.scaled_dot_product_attention`` at the shapes the path gives it
   (SigLIP over 8 pages, Gemma over 8 pages' prompts, Gemma over the 8 text
   queries as ``QueryEncoder`` pads them); one batch of 8 pages and the 8
   text queries embedded through the K6 route and the plain route; 64 seeded 1275 x 1650 pages through
   ``embed_pages_fused(transport="yuv420")``, an 8,192-doc x 1,040-token
   two-tier int8 index of them and seeded filler docs behind ``make_handler``,
   each of 8 pages found at rank 1 by its own first 32 token vectors on the
   tiered and the exact route; then K1, K2 and K3 against their plain
   versions on that index, and a ``torch.profiler`` breakdown of one batch.

It exits non-zero, printing no result, when no CUDA device is visible or
any check fails. The line before the last lists each kernel with its
launches on the page slice; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import zlib
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from colpali_tpu_torch.ops import _cuda
from colpali_tpu_torch.ops import flash_attention as fa
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
    "flash_attention": dict(counter=fa.FLASH_ATTENTION, route="cuda",
                            source="colpali_tpu_torch/csrc/flash_attention.cu",
                            replaces="colpali_tpu/models/layers.py:389"),
}
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes moved
    (each input read once, each output written once) over the HBM rate and
    the operations over the peak rate for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations")


def reset_launches() -> None:
    for spec in KERNELS.values():
        spec["counter"].reset()


def read_launches(phase: str) -> dict:
    """Each kernel's launches since :func:`reset_launches`; every kernel of
    the path must have run."""
    launches = {name: spec["counter"].launches for name, spec in KERNELS.items()}
    if not all(launches.values()):
        raise AssertionError(f"{phase}: a kernel of the path was not launched: {launches}")
    return launches


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
    log(smi)
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
    w, npc, nq, c = DIM // 32, DOC_TOKENS // COARSE_POOL, QUERY_TOKENS, CORPUS_DOCS
    results["binary_maxsim"].update(bound(c * w * npc * 4 + nq * (w + 1) * 4 + c * 4, 2 * nq * c * npc * DIM, "int8"))
    results["gather_rerank"].update(bound(CANDIDATES * DOC_TOKENS * (DIM + 4) + nq * DIM * 4 + CANDIDATES * 8,
                                          2 * nq * CANDIDATES * DOC_TOKENS * DIM, "fp32"))
    results["maxsim_int8"].update(bound(c * DOC_TOKENS * (DIM + 4) + nq * (DIM + 4) + c * 4,
                                        2 * nq * c * DOC_TOKENS * DIM, "int8"))
    for name, r in results.items():
        r["max_abs_err"] = errs[name]
        r["library_ms"] = None  # no single PyTorch call computes these
        extra = f", B=8 kernel {r['ms_b8']:.3f} ms, plain {r['plain_ms_b8']:.3f} ms" if "ms_b8" in r else ""
        log(f"  {name} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms{extra}, "
            f"served shape {r['ms_served']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"max_abs_err {r['max_abs_err']:.3g}")
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


def build_model(device: torch.device):
    """ColPali-3B at full width with seeded random bf16 weights on the card,
    its processor (448 px pages, 1,024 image tokens) and a warmed query
    encoder."""
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.configs import PaliGemmaConfig
    from colpali_tpu_torch.models.paligemma import ColPali
    from colpali_tpu_torch.processors.colpali import ColPaliProcessor
    from colpali_tpu_torch.retrieval.serving import QueryEncoder

    cfg = PaliGemmaConfig()
    t0 = time.perf_counter()
    model = ColPali(cfg, dim=DIM, device=device, dtype=torch.bfloat16)
    hf_init_(model, torch.Generator(device=device).manual_seed(SEED))
    n_params = sum(p.numel() for p in model.parameters())
    processor = ColPaliProcessor(WordTokenizer(cfg.image_token_index))
    encoder = QueryEncoder(model, processor)
    encoder.warmup()
    t, v = cfg.text, cfg.vision
    log(f"model: ColPali-3B, SigLIP {v.num_hidden_layers} x {v.hidden_size} (MLP {v.intermediate_size}, heads "
        f"{v.num_attention_heads} x {v.head_dim}, {v.num_patches} patches), projector {v.hidden_size} -> "
        f"{cfg.projection_dim}, Gemma {t.num_hidden_layers} x {t.hidden_size} (MLP {t.intermediate_size}, heads "
        f"{t.num_attention_heads}/{t.num_key_value_heads} x {t.head_dim}, vocab {t.vocab_size}): "
        f"{n_params / 1e9:.3f} B params bf16, built + query encoder warmed in {time.perf_counter() - t0:.1f} s")
    return model, processor, encoder


def phase_slice(device: torch.device, encoder) -> dict:
    """Drive the text-in served path through its entry points; returns each
    kernel's launch count over the requests."""
    import tempfile
    from http.server import ThreadingHTTPServer
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.retrieval.store import CorpusIndex

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
    log(f"phase slice (text in): index {index.num_docs} docs x {index.doc_tokens} x {index.dim} int8 + sketch pool "
        f"{index.coarse_pool}, built in {t_build:.1f} s, saved + loaded, nbytes {index.nbytes}")

    files = [f"doc_{i}" for i in range(index.num_docs)]
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(index, files, encoder=encoder))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        reset_launches()
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
        launches = read_launches("text slice")
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"  served: /search_text x1 (tiered) {ms_text_1:.1f} ms, x8 (exact) {ms_text_8:.1f} ms; "
        f"encode x8 {ms_encode:.1f} ms; /search x8 (exact) {ms_search_8:.1f} ms; "
        f"/tune -> {tune}; metrics p50 {metrics.get('search_ms_p50')} ms; launches {launches}")
    return launches


# -- phase 4 -------------------------------------------------------------------

PAGES = 64
PAGE_HW = (1650, 1275)  # a US-letter page at 150 dpi, height x width
PAGE_BATCH = 8
PAGE_INDEX_DOCS = 8_192
PAGE_DOC_TOKENS = 1_040  # 1,024 image tokens + the prompt's 5, rounded up to 16
PLANTED_PAGES = 8
PAGE_QUERY_TOKENS = 32
# K6 vs plain, element by element on valid rows: rtol is two bf16 ulps (both round the output; the kernel
# rounds unnormalized probabilities, the plain version normalized ones); atol is 2% of the plain output's
# RMS, which random q, k and v put near sqrt(e / S): 0.05 at S = 1,024, far below 1
K6_RTOL, K6_ATOL_RMS = 1.6e-2, 2e-2
# K6 route vs plain route through 45 bf16 layers of random weights, per token: about 3x the gaps measured on
# the H100 (mean cos 0.99935, min cos 0.99856, max abs 0.0173 over a batch of 8 pages)
FORWARD_COS_MEAN, FORWARD_COS_MIN, FORWARD_ATOL = 0.998, 0.995, 0.05
PAGE_SERVE_RTOL = 1e-3


def k6_shapes(model, processor, encoder) -> dict:
    """K6's shapes on the path, ``(B, S, H, Hkv, D, lengths)``: SigLIP over
    a batch of pages, Gemma over the pages' prompts, and Gemma over QUERIES
    as the query encoder pads them (``lengths`` right-pads each row)."""
    v, t = model.config.vision, model.config.text
    page = processor._tokenize([processor._expand_image_prompt(processor.visual_prompt_prefix)])
    feed, _ = encoder._pad_static(processor.process_queries(QUERIES))
    lengths = [int(n) for n in feed["attention_mask"].sum(axis=1)]
    gemma = (t.num_attention_heads, t.num_key_value_heads, t.head_dim)
    return {"siglip": (PAGE_BATCH, v.num_patches, v.num_attention_heads, v.num_attention_heads, v.head_dim, None),
            "gemma_page": (PAGE_BATCH, page["input_ids"].shape[1], *gemma, None),
            "gemma_query": (len(lengths), feed["input_ids"].shape[1], *gemma, lengths)}


def k6_case(gen: torch.Generator, device: torch.device, b: int, s: int, h: int, hkv: int, d: int,
            lengths) -> dict:
    """K6 against its plain version (valid rows) and beside SDPA with a
    boolean mask, at one shape; ``lengths`` right-pads each row."""
    q, k, v = (torch.randn((b, s, n, d), generator=gen, device=device).to(torch.bfloat16) for n in (h, hkv, hkv))
    seg = torch.ones((b, s), dtype=torch.int32, device=device)
    if lengths is not None:
        seg = (torch.arange(s, device=device)[None] < torch.tensor(lengths, device=device)[:, None]).to(torch.int32)
    scale = d**-0.5
    rows = seg.bool()
    got = fa.flash_attention(q, k, v, seg, scale)[rows].float()
    want = fa.flash_attention_plain(q, k, v, seg, scale)[rows].float()
    atol = K6_ATOL_RMS * want.pow(2).mean().sqrt().item()
    torch.testing.assert_close(got, want, rtol=K6_RTOL, atol=atol)
    err = (got - want).abs()
    limit_share = (err / (atol + K6_RTOL * want.abs())).max().item()  # of the tolerance, at the worst element
    allowed = seg[:, :, None] == seg[:, None, :]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed[:, None], scale=scale,
                                              enable_gqa=h != hkv)

    pairs = allowed.sum().item()  # (query, key) pairs that this data attends
    return dict(ms=time_ms(lambda: fa.flash_attention(q, k, v, seg, scale)),
                plain_ms=time_ms(lambda: fa.flash_attention_plain(q, k, v, seg, scale), reps=2),
                library_ms=time_ms(sdpa), max_abs_err=err.max().item(), atol=atol, limit_share=limit_share,
                **bound(2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * seg.numel(),
                        4 * pairs * h * d, "bf16"),
                shape=f"B={b} S={s} H={h} Hkv={hkv} D={d}" + ("" if lengths is None else " key padding"))


def make_pages(n: int, seed: int) -> list:
    """Seeded uint8 RGB pages of noise at a scanned page's size: every patch
    differs, so every page token does."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(*PAGE_HW, 3), dtype=np.uint8) for _ in range(n)]


def forward_check(name: str, embed) -> dict:
    """``embed()`` through the K6 route and through the plain route (K6's
    plain version patched in for the comparison only), token by token."""
    kernel = embed()
    with mock.patch.object(fa, "flash_attention", fa.flash_attention_plain):
        plain = embed()
    a, b = np.concatenate(kernel), np.concatenate(plain)
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    out = dict(tokens=len(a), mean_cos=float(cos.mean()), min_cos=float(cos.min()), max_abs=float(np.abs(a - b).max()))
    if not (np.isfinite(a).all() and out["mean_cos"] >= FORWARD_COS_MEAN and out["min_cos"] >= FORWARD_COS_MIN
            and out["max_abs"] <= FORWARD_ATOL):
        raise AssertionError(f"{name}: K6 route vs plain route {out}, limits mean cos >= {FORWARD_COS_MEAN}, "
                             f"min cos >= {FORWARD_COS_MIN}, max abs <= {FORWARD_ATOL}")
    log(f"  {name}, K6 route vs plain route, {out['tokens']} tokens: mean cos {out['mean_cos']:.6f}, min cos "
        f"{out['min_cos']:.6f}, max abs {out['max_abs']:.4g} (limits {FORWARD_COS_MEAN}, {FORWARD_COS_MIN}, "
        f"{FORWARD_ATOL})")
    return out


def profile_page_forward(model, processor, device: torch.device) -> None:
    """``torch.profiler`` over one forward of a batch of pages: device time
    by kernel class and the device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    tok = processor._tokenize([processor._expand_image_prompt(processor.visual_prompt_prefix)] * PAGE_BATCH)
    ids = torch.from_numpy(tok["input_ids"]).to(device)
    att = torch.from_numpy(tok["attention_mask"]).to(device)
    size = processor.image_size
    pixels = torch.rand((PAGE_BATCH, size, size, 3), generator=torch.Generator(device=device).manual_seed(SEED),
                        device=device) * 2 - 1
    with torch.inference_mode():
        model(ids, att, pixels)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(ids, att, pixels)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total / 1e3
    total = sum(kernels.values())
    if total == 0.0:
        log(f"  profile: one forward of {PAGE_BATCH} pages {wall_ms:.1f} ms wall; the profiler saw no device time")
        return
    classes = {"K6 flash_attention": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in kernels.items():
        if "flash_attention" in name:
            classes["K6 flash_attention"] += ms
        elif any(t in name.lower() for t in ("gemm", "cutlass", "nvjet", "xmma", "matmul")):
            classes["matmul"] += ms
        else:
            classes["other"] += ms
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    log(f"  profile: one forward of {PAGE_BATCH} pages {wall_ms:.1f} ms wall, {total:.1f} ms of kernels "
        f"(device idle {max(0.0, 1 - total / wall_ms):.1%}); "
        + ", ".join(f"{k} {v:.1f} ms ({v / total:.1%})" for k, v in classes.items()))
    for name, ms in top:
        log(f"    {ms:8.2f} ms  {name[:110]}")


def phase_pages(device: torch.device, model, processor, encoder) -> tuple:
    """Drive the page-embedding path: pages -> embeddings -> a served
    two-tier index. Returns the launches over the path, K6's timings, K1-K3's
    timings at full-page length, and pages/min with the forward check."""
    from http.server import ThreadingHTTPServer
    import threading

    from colpali_tpu_torch import serve
    from colpali_tpu_torch.ops.maxsim_binary import binary_maxsim_tiled, binary_maxsim_tiled_plain
    from colpali_tpu_torch.ops.maxsim_tiled import (
        gather_rerank_int8,
        gather_rerank_plain,
        maxsim_int8mxu_tiled,
        maxsim_int8mxu_tiled_plain,
    )
    from colpali_tpu_torch.retrieval.ingest import embed_pages_fused
    from colpali_tpu_torch.retrieval.store import CorpusIndex, top_k

    gen = torch.Generator(device=device).manual_seed(SEED + 4)
    k6 = {case: k6_case(gen, device, *shape) for case, shape in k6_shapes(model, processor, encoder).items()}
    for case, r in k6.items():
        log(f"phase pages: K6 {case} [{r['shape']}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"SDPA {r['library_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"max_abs_err {r['max_abs_err']:.3g} (atol {r['atol']:.3g}, {r['limit_share']:.0%} of the tolerance)")

    pages = make_pages(PAGES, SEED + 2)
    fwd = dict(pages=forward_check(f"page forward ({PAGE_BATCH} pages)", lambda: embed_pages_fused(
                   model, processor, pages[:PAGE_BATCH], transport="yuv420", batch_size=PAGE_BATCH)),
               queries=forward_check(f"query forward ({len(QUERIES)} queries)", lambda: encoder.encode(QUERIES)))

    reset_launches()
    t0 = time.perf_counter()
    embs = embed_pages_fused(model, processor, pages, transport="yuv420", batch_size=PAGE_BATCH)
    t_embed = time.perf_counter() - t0
    n_tok = embs[0].shape[0]
    for e in embs:
        norms = np.linalg.norm(e, axis=-1)
        if e.shape != (n_tok, DIM) or not np.isfinite(e).all() or np.abs(norms - 1).max() > 1e-2:
            raise AssertionError(f"page embedding {e.shape}, norms {norms.min()}..{norms.max()}")
    log(f"  embedded {PAGES} pages of {PAGE_HW[1]} x {PAGE_HW[0]} (yuv420, batch {PAGE_BATCH}) in {t_embed:.2f} s: "
        f"{PAGES / t_embed * 60:.0f} pages/min, {n_tok} tokens each")

    t0 = time.perf_counter()
    n_fill = PAGE_INDEX_DOCS - PAGES
    fill = np.empty((n_fill, PAGE_DOC_TOKENS, DIM), np.float32)
    for s0 in range(0, n_fill, 1024):
        x = torch.randn((min(1024, n_fill - s0), PAGE_DOC_TOKENS, DIM), generator=gen, device=device)
        fill[s0 : s0 + x.shape[0]] = (x / x.norm(dim=-1, keepdim=True)).cpu().numpy()
    page_ids = [int(i) for i in np.linspace(37, PAGE_INDEX_DOCS - 37, PAGES)]
    docs, rows = [], iter(fill)
    for doc_id in range(PAGE_INDEX_DOCS):
        docs.append(embs[page_ids.index(doc_id)] if doc_id in page_ids else next(rows))
    t_fill = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=COARSE_POOL, device=device)
    t_build = time.perf_counter() - t0
    del docs, fill, rows
    if index.doc_tokens != PAGE_DOC_TOKENS:
        raise AssertionError(f"doc_tokens {index.doc_tokens} != {PAGE_DOC_TOKENS}")
    log(f"  index: {index.num_docs} docs x {index.doc_tokens} x {index.dim} int8 + sketch pool {index.coarse_pool} "
        f"({index.nbytes} bytes), filler made in {t_fill:.1f} s, built on the host in {t_build:.1f} s")

    planted = page_ids[:: PAGES // PLANTED_PAGES][:PLANTED_PAGES]
    queries = [embs[page_ids.index(i)][:PAGE_QUERY_TOKENS] for i in planted]
    files = [f"page_{i}" for i in range(index.num_docs)]
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(index, files, encoder=encoder))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_port}"
    try:
        tiered_ms = []
        tiered = []
        for q in queries:  # one query per request: the two-tier route
            t0 = time.perf_counter()
            out = _http(url, "/search", {"embeddings": [q.tolist()], "k": 10})
            tiered_ms.append((time.perf_counter() - t0) * 1e3)
            _check_ranked("/search x1", out, 1)
            tiered.append(out)
        t0 = time.perf_counter()
        exact = _http(url, "/search", {"embeddings": [q.tolist() for q in queries], "k": 10})  # 8 > 4: exact
        exact_ms = (time.perf_counter() - t0) * 1e3
        _check_ranked("/search x8", exact, len(queries))
        top_tiered = [out["doc_ids"][0][0] for out in tiered]
        top_exact = [row[0] for row in exact["doc_ids"]]
        if top_tiered != planted or top_exact != planted:
            raise AssertionError(f"pages at rank 1: tiered {top_tiered}, exact {top_exact}, planted {planted}")
        for i, out in enumerate(tiered):
            np.testing.assert_allclose(out["scores"][0][0], exact["scores"][i][0], rtol=PAGE_SERVE_RTOL)
        text = _http(url, "/search_text", {"queries": QUERIES[:2], "k": 5})
        _check_ranked("/search_text x2", text, 2)
        launches = read_launches("page slice")
    finally:
        httpd.shutdown()
        httpd.server_close()
    log(f"  served: each of {PLANTED_PAGES} pages at rank 1 on the tiered route (/search x1, median "
        f"{np.median(tiered_ms):.1f} ms) and the exact route (/search x8, {exact_ms:.1f} ms); /search_text "
        f"answered; launches {launches}")

    # K1, K2 and K3 against their plain versions at Np = 1,040 on the page index
    q = torch.zeros((4, SERVED_TOKENS, DIM), device=device)
    for i, e in enumerate(queries[:4]):
        q[i, : e.shape[0]] = torch.from_numpy(e)
    qw, qv = binarize_words(q)
    coarse = binary_maxsim_tiled(qw, qv, index._bwords, DIM)
    k1_err = (coarse - binary_maxsim_tiled_plain(qw, qv, index._bwords, DIM)).abs().max().item()
    if k1_err != 0.0:
        raise AssertionError(f"K1 differs from its plain version at Np={PAGE_DOC_TOKENS}: {k1_err}")
    _, cand = top_k(coarse[:, : index.num_docs], CANDIDATES)
    got = gather_rerank_int8(q, index._store, index._scales, cand)
    want = gather_rerank_plain(q, index._store, index._scales, cand)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    k2_err = (got - want).abs().max().item()
    q8 = q.repeat(2, 1, 1)
    qi, qsc = quantize_per_token(q8)
    got = maxsim_int8mxu_tiled(qi, qsc, index._store, index._scales)
    want = maxsim_int8mxu_tiled_plain(qi, qsc, index._store, index._scales)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    k3_err = (got - want).abs().max().item()

    c, nq, npc, w = index.padded_docs, SERVED_TOKENS, PAGE_DOC_TOKENS // COARSE_POOL, DIM // 32
    q1, qw1, qv1, cand1 = q[:1], qw[:1].contiguous(), qv[:1].contiguous(), cand[:1].contiguous()
    page = {
        "binary_maxsim": dict(ms=time_ms(lambda: binary_maxsim_tiled(qw1, qv1, index._bwords, DIM)),
                              plain_ms=time_ms(lambda: binary_maxsim_tiled_plain(qw1, qv1, index._bwords, DIM), 2),
                              max_abs_err=k1_err,
                              **bound(c * w * npc * 4 + nq * (w + 1) * 4 + c * 4, 2 * nq * c * npc * DIM, "int8")),
        "gather_rerank": dict(ms=time_ms(lambda: gather_rerank_int8(q1, index._store, index._scales, cand1)),
                              plain_ms=time_ms(lambda: gather_rerank_plain(q1, index._store, index._scales, cand1), 2),
                              max_abs_err=k2_err,
                              **bound(CANDIDATES * PAGE_DOC_TOKENS * (DIM + 4) + nq * DIM * 4 + CANDIDATES * 8,
                                      2 * nq * CANDIDATES * PAGE_DOC_TOKENS * DIM, "fp32")),
        "maxsim_int8": dict(ms=time_ms(lambda: maxsim_int8mxu_tiled(qi, qsc, index._store, index._scales)),
                            plain_ms=time_ms(lambda: maxsim_int8mxu_tiled_plain(qi, qsc, index._store,
                                                                                index._scales), 2),
                            max_abs_err=k3_err,
                            **bound(c * PAGE_DOC_TOKENS * (DIM + 4) + 8 * nq * (DIM + 4) + 8 * c * 4,
                                    2 * 8 * nq * c * PAGE_DOC_TOKENS * DIM, "int8")),
    }
    shapes = {"binary_maxsim": f"B=1 Nq={nq} W={w} Npc={npc} C={c}",
              "gather_rerank": f"B=1 Nq={nq} c={CANDIDATES} Np={PAGE_DOC_TOKENS}",
              "maxsim_int8": f"B=8 Nq={nq} Np={PAGE_DOC_TOKENS} C={c}"}
    for name, r in page.items():
        log(f"  {name} at Np={PAGE_DOC_TOKENS} [{shapes[name]}]: kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), max_abs_err {r['max_abs_err']:.3g}")
    profile_page_forward(model, processor, device)
    del index
    torch.cuda.empty_cache()
    return launches, k6, page, dict(pages_per_min=PAGES / t_embed * 60, forward_check=fwd)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script only runs on a GPU", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    phase_device()
    timings = phase_kernels(device)
    model, processor, encoder = build_model(device)
    text_launches = phase_slice(device, encoder)
    launches, k6, page, extra = phase_pages(device, model, processor, encoder)
    timings["flash_attention"] = dict(k6["siglip"], gemma_page=k6["gemma_page"], gemma_query=k6["gemma_query"])
    for name, r in page.items():
        timings[name]["full_page"] = dict(r, shape=f"Np={PAGE_DOC_TOKENS}")
    kernels = [dict(name=name, route=spec["route"], source=spec["source"], replaces=spec["replaces"],
                    launches=launches[name], launches_text_slice=text_launches[name], **timings[name])
               for name, spec in KERNELS.items()]
    print(json.dumps({"kernels": kernels, "pages_per_min": extra["pages_per_min"],
                      "forward_check": extra["forward_check"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
