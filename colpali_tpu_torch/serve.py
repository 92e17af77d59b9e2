"""Retrieval server over a device-resident CorpusIndex (PyTorch counterpart
of ``scripts/serve.py``; same endpoints and JSON):

  POST /search       {"embeddings": [[...], ...], "k": 10, "mode": "auto"}
      -> {"doc_ids": [...], "scores": [...], "files": [...]}
  POST /search_text  {"queries": ["...", ...], "k": 10}   (needs an encoder)
      -> same response; queries are tokenized and encoded in-process
  POST /tune         {"embeddings": [...], "k": 10, "target_recall": 0.95}
  POST /add          {"embeddings": [...], "files": [...]}
  GET  /healthz, /metrics

Run: ``python -m colpali_tpu_torch.serve corpus.npz --device cuda``, and add
``--checkpoint DIR`` to load a query encoder from an HF-format checkpoint
(:func:`colpali_tpu_torch.auto.load_retriever`) and enable
``/search_text``. As in the JAX server, the encoder serves stored-int8
weights (kernels Q1a and Q1b) unless ``--no-quantize`` keeps the
checkpoint's bf16 weights.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from colpali_tpu_torch.retrieval.serving import EncodeBatcher, MicroBatcher
from colpali_tpu_torch.retrieval.store import CorpusIndex


def load_corpus(path: str):
    """Embeddings written by ``scripts/embed_corpus.py`` (``emb_<i>`` arrays)
    and their file names (``<path>.files.json``, else the indices)."""
    with np.load(path) as data:
        embs = [data[k] for k in sorted(data.files, key=lambda s: int(s.split("_")[1]))]
    try:
        with open(path + ".files.json") as f:
            files = json.load(f)
    except FileNotFoundError:
        files = [str(i) for i in range(len(embs))]
    return embs, files


def make_handler(index, files, window_ms: float = 2.0, exact_threshold: int = 4, encoder=None):
    """An HTTP handler class serving ``index``; ``encoder`` (a QueryEncoder
    or EncodeBatcher) enables ``/search_text``. The class's ``close()``
    stops the batcher threads it started, which hold the index and the
    model: :class:`RetrievalServer` calls it from ``server_close()``."""
    owned = []  # the batchers started here: their dispatcher threads keep the index and the model alive
    if encoder is not None and not isinstance(encoder, EncodeBatcher):
        # concurrent /search_text requests merge into single encode forwards
        encoder = EncodeBatcher(encoder, window_ms=window_ms)
        owned.append(encoder)

    lock = threading.Lock()  # extend() mutates the index; searches race it
    # concurrent /search requests merge into single sweeps; merged batches
    # above exact_threshold route to the exact sweep
    batcher = MicroBatcher(index, window_ms=window_ms, exact_threshold=exact_threshold, lock=lock)
    owned.append(batcher)
    batcher.warmup()
    stats_lock = threading.Lock()
    latencies: list = []  # last 1024 search latencies (ms)
    counters = {"searches": 0, "queries": 0, "errors": 0}

    def record(ms: float, n_queries: int) -> None:
        with stats_lock:
            counters["searches"] += 1
            counters["queries"] += n_queries
            latencies.append(ms)
            if len(latencies) > 1024:
                del latencies[: len(latencies) - 1024]

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "num_docs": index.num_docs,
                                 "text_in": encoder is not None})
            elif self.path == "/metrics":
                with stats_lock:
                    lat = sorted(latencies)
                    out = dict(counters, num_docs=index.num_docs)
                if lat:
                    q = lambda p: lat[min(len(lat) - 1, int(p * len(lat)))]  # noqa: E731
                    out.update(search_ms_p50=round(q(0.50), 3),
                               search_ms_p90=round(q(0.90), 3),
                               search_ms_p99=round(q(0.99), 3))
                self._json(200, out)
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):  # noqa: N802
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                if self.path in ("/search", "/search_text"):
                    if self.path == "/search_text":
                        if encoder is None:
                            raise ValueError("/search_text needs a query encoder (checkpoint "
                                             "loading is not ported yet: pass encoder= to make_handler)")
                        qs = encoder.encode([str(t) for t in payload["queries"]])
                    else:
                        qs = [np.asarray(e, np.float32) for e in payload["embeddings"]]
                    k = int(payload.get("k", 10))
                    cand = payload.get("candidates")
                    mode = payload.get("mode", "auto")  # auto|exact|tiered
                    t0 = time.perf_counter()
                    scores, ids = batcher.search(qs, k=k, candidates=int(cand) if cand else None, mode=mode)
                    record((time.perf_counter() - t0) * 1e3, len(qs))
                    self._json(200, {
                        "doc_ids": ids.tolist(),
                        "scores": scores.tolist(),
                        "files": [[files[i] for i in row] for row in ids],
                    })
                elif self.path == "/tune":
                    # recall-targeted shortlist sizing: sample queries in,
                    # pinned `candidates` default + measured recall out
                    qs = [np.asarray(e, np.float32) for e in payload["embeddings"]]
                    k = int(payload.get("k", 10))
                    target = float(payload.get("target_recall", 0.95))
                    with lock:
                        cand, recall = index.tune_candidates(qs, k=k, target_recall=target)
                    self._json(200, {"candidates": cand, "recall": recall})
                elif self.path == "/add":
                    new = [np.asarray(e, np.float32) for e in payload["embeddings"]]
                    names = payload.get("files")
                    if names is not None and len(names) != len(new):
                        raise ValueError(f"{len(new)} embeddings but {len(names)} files")
                    with lock:
                        # default names come from num_docs inside the lock, so
                        # concurrent /adds never register duplicate names
                        if names is None:
                            names = [str(index.num_docs + i) for i in range(len(new))]
                        index.extend(new)
                        files.extend(names)
                    self._json(200, {"num_docs": index.num_docs})
                else:
                    self._json(404, {"error": "unknown path"})
            except Exception as exc:  # noqa: BLE001 — surface the error to the client
                with stats_lock:
                    counters["errors"] += 1
                self._json(400, {"error": str(exc)})

        def log_message(self, fmt, *fmt_args):
            pass  # quiet

        @staticmethod
        def close() -> None:
            for b in owned:
                b.close()

    return Handler


class RetrievalServer(ThreadingHTTPServer):
    """``ThreadingHTTPServer`` over a :func:`make_handler` class:
    ``server_close()`` also stops the handler's batcher threads, so the
    index and the query encoder's model are freed with the server."""

    def server_close(self) -> None:
        super().server_close()
        self.RequestHandlerClass.close()


def make_server(argv=None) -> RetrievalServer:
    """Parse the command line, build the index (and the query encoder) and
    return the server, not yet serving."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("corpus_npz", help="embeddings from scripts/embed_corpus.py, or a packed "
                        "index written by CorpusIndex.save / --save-index (of either package)")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--device", default="cuda", help="where the index and the query encoder live")
    parser.add_argument("--dtype", default="int8", choices=["bf16", "int8"])
    parser.add_argument("--prefilter", action="store_true",
                        help="build a two-tier index (sign-sketch coarse pass + exact rerank)")
    parser.add_argument("--save-index", metavar="PATH.npz",
                        help="after building, persist the packed index here and keep serving")
    parser.add_argument("--checkpoint", help="HF-format retriever checkpoint dir: loads the model and "
                        "processor in-process and enables POST /search_text")
    parser.add_argument("--family", help="checkpoint family: colpali, colqwen2, colqwen2_5, colqwen3, colqwen3_5, "
                        "colidefics3, colgemma3 or colmodernvbert (else detected from its config.json)")
    parser.add_argument("--no-quantize", action="store_true",
                        help="with --checkpoint: serve the checkpoint's bf16 weights instead of stored int8")
    args = parser.parse_args(argv)

    with np.load(args.corpus_npz) as probe:
        is_index = "store" in probe.files
    if is_index:
        index = CorpusIndex.load(args.corpus_npz, device=args.device)
        try:
            with open(args.corpus_npz + ".files.json") as f:
                files = json.load(f)
        except FileNotFoundError:
            files = [str(i) for i in range(index.num_docs)]
    else:
        embs, files = load_corpus(args.corpus_npz)
        index = CorpusIndex(embs, dtype=args.dtype, device=args.device,
                            prefilter="binary" if args.prefilter else None)
        if args.save_index:
            index.save(args.save_index)
            with open(args.save_index + ".files.json", "w") as f:
                json.dump(files, f)
            print(f"Packed index saved to {args.save_index}")
    encoder = None
    if args.checkpoint:
        from colpali_tpu_torch.auto import load_retriever
        from colpali_tpu_torch.retrieval.serving import QueryEncoder

        encoder = QueryEncoder(*load_retriever(args.checkpoint, family=args.family, device=args.device,
                                               quantize=not args.no_quantize))
        print(f"Text-in serving: query encoder loaded from {args.checkpoint} "
              f"({'bf16' if args.no_quantize else 'stored-int8'} weights)")
    print(f"Serving {index.num_docs} docs ({index.nbytes / 2**20:.1f} MiB on {args.device}) on :{args.port}")
    return RetrievalServer(("0.0.0.0", args.port), make_handler(index, files, encoder=encoder))


def main(argv=None) -> None:
    make_server(argv).serve_forever()


if __name__ == "__main__":
    main()
