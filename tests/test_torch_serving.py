"""The text-in serving slice as a whole: colpali_tpu_torch.serve against
scripts/serve.py.

Both stacks get the same tiny ColPali (JAX parameters carried over with
core/from_jax.py), the same word tokenizer, and the same two-tier int8
index with planted docs equal to the queries' own embeddings. Requests of
up to 4 queries route to the two-tier path, whose math the JAX CPU path
shares with the port (sign-sketch coarse pass, fp32 rerank).

Tolerance: planted top-1 ids equal, all ids equal, scores rtol=1e-4
(fp32 encoder outputs that differ in the last digits, then int8 rerank).
"""

import json
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

from colpali_tpu.models.configs import GemmaConfig as JaxGemmaConfig  # noqa: E402
from colpali_tpu.models.configs import PaliGemmaConfig as JaxPaliGemmaConfig  # noqa: E402
from colpali_tpu.models.configs import SiglipVisionConfig as JaxSiglipVisionConfig  # noqa: E402
from colpali_tpu.models.paligemma import ColPali as JaxColPali  # noqa: E402
from colpali_tpu.processors.colpali import ColPaliProcessor as JaxProcessor  # noqa: E402
from colpali_tpu.retrieval.serving import QueryEncoder as JaxQueryEncoder  # noqa: E402
from colpali_tpu.retrieval.store import CorpusIndex as JaxIndex  # noqa: E402
from colpali_tpu_torch import serve  # noqa: E402
from colpali_tpu_torch.core.from_jax import state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.models.configs import GemmaConfig, PaliGemmaConfig, SiglipVisionConfig  # noqa: E402
from colpali_tpu_torch.models.paligemma import ColPali  # noqa: E402
from colpali_tpu_torch.processors.colpali import ColPaliProcessor  # noqa: E402
from colpali_tpu_torch.retrieval.serving import EncodeBatcher, MicroBatcher, QueryEncoder, route  # noqa: E402
from colpali_tpu_torch.retrieval.store import CorpusIndex  # noqa: E402

RTOL = 1e-4
QUERIES = ["find document page 0 quarterly report", "what is the total revenue ?", "figure with chart data"]
TEXT = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=1, head_dim=16)
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2, image_size=28,
              patch_size=14)  # the smallest tower: only the text path runs here
IMAGE_TOKEN = 4  # the word tokenizer's <image> id
PLANTED = [17, 150, 260]


def _serve(handler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


def _post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    import serve as jax_serve
    import validate_checkpoint as vc
    from transformers import AutoTokenizer

    tok_dir = tmp_path_factory.mktemp("tokenizer")
    vc._save_paligemma_word_tokenizer(str(tok_dir))
    tokenizer = AutoTokenizer.from_pretrained(str(tok_dir))

    jax_model = JaxColPali(JaxPaliGemmaConfig(vision=JaxSiglipVisionConfig(**VISION), text=JaxGemmaConfig(**TEXT),
                                              projection_dim=64, image_token_index=IMAGE_TOKEN),
                           dim=32, dtype=jnp.float32)
    ids = jnp.ones((1, 8), jnp.int32)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), ids, ids, jnp.zeros((1, 28, 28, 3)))
    jax_encoder = JaxQueryEncoder(jax_model, variables, JaxProcessor(tokenizer))

    state = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    model = ColPali(PaliGemmaConfig(vision=SiglipVisionConfig(**VISION), text=GemmaConfig(**TEXT), projection_dim=64,
                                    image_token_index=IMAGE_TOKEN), dim=32, device="cpu")
    model.load_state_dict(state)
    encoder = QueryEncoder(model, ColPaliProcessor(tokenizer))

    rng = np.random.default_rng(0)
    docs = rng.normal(size=(300, 16, 32)).astype(np.float32)
    docs = list(docs / np.linalg.norm(docs, axis=-1, keepdims=True))
    for doc_id, q in zip(PLANTED, jax_encoder.encode(QUERIES)):
        docs[doc_id] = q
    kw = dict(dtype="int8", prefilter="binary", coarse_pool=2)
    files = [f"page_{i}" for i in range(len(docs))]
    jax_httpd, jax_url = _serve(jax_serve.make_handler(JaxIndex(docs, **kw), list(files), encoder=jax_encoder))
    index = CorpusIndex(docs, device="cpu", **kw)
    httpd, url = _serve(serve.make_handler(index, list(files), encoder=encoder))
    yield dict(jax_url=jax_url, url=url, encoder=encoder, jax_encoder=jax_encoder, index=index, model=model)
    jax_httpd.shutdown()
    httpd.shutdown()


def _same(a, b):
    assert a["doc_ids"] == b["doc_ids"]
    assert a["files"] == b["files"]
    np.testing.assert_allclose(a["scores"], b["scores"], rtol=RTOL)


@pytest.mark.parametrize("n", [1, 3])
def test_search_text_matches_jax_server(stacks, n):
    out = _post(stacks["url"], "/search_text", {"queries": QUERIES[:n], "k": 4})
    _same(out, _post(stacks["jax_url"], "/search_text", {"queries": QUERIES[:n], "k": 4}))
    assert [row[0] for row in out["doc_ids"]] == PLANTED[:n]


def test_search_embeddings_matches_jax_server(stacks):
    embs = [e.tolist() for e in stacks["jax_encoder"].encode(QUERIES[1:])]
    payload = {"embeddings": embs, "k": 5, "candidates": 96}
    out = _post(stacks["url"], "/search", payload)
    _same(out, _post(stacks["jax_url"], "/search", payload))
    assert [row[0] for row in out["doc_ids"]] == PLANTED[1:]


def test_encoder_matches_jax_encoder(stacks):
    for got, want in zip(stacks["encoder"].encode(QUERIES), stacks["jax_encoder"].encode(QUERIES)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-5)


def test_search_text_equals_encode_then_search(stacks):
    """Exact route: /search_text == encode + /search with the same batch."""
    url = stacks["url"]
    text = _post(url, "/search_text", {"queries": QUERIES, "k": 3, "mode": "exact"})
    embs = [e.tolist() for e in stacks["encoder"].encode(QUERIES)]
    emb = _post(url, "/search", {"embeddings": embs, "k": 3, "mode": "exact"})
    assert text["doc_ids"] == emb["doc_ids"]
    np.testing.assert_allclose(text["scores"], emb["scores"], rtol=RTOL)
    assert [row[0] for row in text["doc_ids"]] == PLANTED


def test_healthz_and_metrics(stacks):
    assert _get(stacks["url"], "/healthz") == _get(stacks["jax_url"], "/healthz") == \
        {"status": "ok", "num_docs": 300, "text_in": True}
    metrics = _get(stacks["url"], "/metrics")
    assert metrics["searches"] >= 1 and metrics["errors"] == 0


def test_tune_and_add(stacks):
    url = stacks["url"]
    embs = [e.tolist() for e in stacks["encoder"].encode(QUERIES)]
    tune = _post(url, "/tune", {"embeddings": embs, "k": 3, "target_recall": 1.0})
    assert tune["recall"] == 1.0 and tune["candidates"] >= 64
    new_q = stacks["encoder"].encode(["price of chip released"])[0]
    added = _post(url, "/add", {"embeddings": [new_q.tolist()], "files": ["new_page"]})
    assert added == {"num_docs": 301}
    out = _post(url, "/search", {"embeddings": [new_q.tolist()], "k": 1})
    assert out["doc_ids"] == [[300]] and out["files"] == [["new_page"]]


def test_search_text_without_encoder_is_an_error():
    docs = [np.ones((4, 32), np.float32)] * 3
    httpd, url = _serve(serve.make_handler(CorpusIndex(docs, dtype="int8", device="cpu"), ["a", "b", "c"]))
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, "/search_text", {"queries": ["q"]})
        assert err.value.code == 400 and "encoder" in json.loads(err.value.read())["error"]
    finally:
        httpd.shutdown()


def test_encode_batcher_merges_concurrent_requests(stacks):
    encoder = QueryEncoder(stacks["model"], stacks["encoder"].processor)
    calls = []
    inner = encoder.encode
    encoder.encode = lambda texts: (calls.append(len(texts)), inner(texts))[1]
    batcher = EncodeBatcher(encoder, window_ms=25.0)
    results = {}

    def worker(i):
        results[i] = batcher.encode([QUERIES[i % 3]])[0]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        batcher.close()
    assert len(results) == 6 and max(calls) > 1
    np.testing.assert_allclose(results[4], inner([QUERIES[1]])[0], atol=1e-5)


def test_query_encoder_padding_is_result_invariant(stacks):
    """Bucket padding (batch rows, token columns) leaves each query's
    embedding as the unpadded forward gives it."""
    encoder, model = stacks["encoder"], stacks["model"]
    batch = encoder.processor.process_queries(QUERIES)
    with torch.no_grad():
        out = model(torch.from_numpy(batch["input_ids"]), torch.from_numpy(batch["attention_mask"])).numpy()
    mask = batch["attention_mask"].astype(bool)
    for i, got in enumerate(encoder.encode(QUERIES)):
        np.testing.assert_allclose(got, out[i][mask[i]], atol=1e-5)


def test_micro_batcher_merges_concurrent_requests(stacks):
    """Concurrent requests of mixed k and mode merge into one sweep per
    (candidates, mode) group; each caller gets its own rows and its own k,
    a failing sweep raises in every caller, and a closed batcher refuses."""
    index = stacks["index"]
    planted = stacks["jax_encoder"].encode(QUERIES)
    groups = []

    class Spy(MicroBatcher):
        def _run(self, group):
            groups.append(len(group))
            super()._run(group)

    batcher = Spy(index, window_ms=100.0)
    requests = [(i, k, mode) for i in range(3) for k, mode in ((2, "auto"), (5, "exact"))]
    out, errors = {}, []
    barrier = threading.Barrier(len(requests) + 2)

    def client(i, k, mode):
        barrier.wait()
        out[(i, k)] = batcher.search([planted[i]], k=k, mode=mode)

    def bad_client():
        barrier.wait()
        try:
            # a group of its own (another shortlist size); wrong dim: its sweep raises
            batcher.search([np.ones((4, 7), np.float32)], k=2, candidates=96)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    threads = [threading.Thread(target=client, args=r) for r in requests]
    threads += [threading.Thread(target=bad_client) for _ in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        batcher.close()
    assert len(errors) == 2 and len(out) == len(requests) and max(groups) > 1
    for (i, k), (scores, ids) in out.items():
        assert ids.shape == scores.shape == (1, k) and ids[0, 0] == PLANTED[i]
    with pytest.raises(RuntimeError, match="closed"):
        batcher.search([planted[0]], k=1)


def test_micro_batcher_equals_index_search(stacks):
    index = stacks["index"]
    qs = stacks["encoder"].encode(QUERIES[:2])
    batcher = MicroBatcher(index, window_ms=0.0)
    try:
        scores, ids = batcher.search(qs, k=3)
    finally:
        batcher.close()
    want_s, want_i = index.search(qs, k=3, candidates=max(8 * 128, 64))
    np.testing.assert_array_equal(ids, want_i)
    np.testing.assert_allclose(scores, want_s, rtol=RTOL)
    assert route(index, 2) == "tiered" and route(index, 5) == "exact"
