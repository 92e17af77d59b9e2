"""Port parity: colpali_tpu_torch.retrieval.store.CorpusIndex against
colpali_tpu.retrieval.store.CorpusIndex.

The JAX index is built with ``force_kernel=True`` so that its exact sweep
runs the TPU kernel's math (the full-int8 Pallas kernel in interpret mode),
which is what the port's kernel K3 and its plain version compute. Its
two-tier path runs the XLA coarse pass and gather, which compute exactly
what the Pallas kernels do (tests/test_torch_maxsim_binary.py and
tests/test_torch_maxsim_tiled.py hold the port to both) and compile faster.

Tolerance: packed bytes (store, scales, sign words) are compared exactly,
doc ids exactly, scores with rtol=1e-5 (fp32 sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.retrieval.store import CorpusIndex as JaxIndex
from colpali_tpu.ops.maxsim_binary import binary_maxsim_xla_tiled
from colpali_tpu.retrieval.store import gather_rerank as jax_gather_rerank
from colpali_tpu.retrieval.store import DeviceIndexBuilder as JaxBuilder
from colpali_tpu_torch.retrieval.store import CorpusIndex, DeviceIndexBuilder, gather_rerank, top_k

RTOL, ATOL = 1e-5, 1e-5
DIM = 64


def _docs(seed: int, n: int, max_len: int = 14):
    rng = np.random.default_rng(seed)
    docs = []
    for _ in range(n):
        d = rng.normal(size=(int(rng.integers(3, max_len + 1)), DIM)).astype(np.float32)
        docs.append(d / np.linalg.norm(d, axis=-1, keepdims=True))
    return docs


DOCS = _docs(0, 300)  # 3 tiles, the last one partly filled
QUERIES = [DOCS[7][:5], DOCS[211], _docs(1, 1)[0]]


def _jax_kernels(docs, **kw):
    index = JaxIndex(docs, force_kernel=True, **kw)
    index._binary_fn = lambda: lambda qw, qv, bw: binary_maxsim_xla_tiled(qw, qv, bw, index.dim)
    index._rerank = lambda q, store, scales, cand: jax_gather_rerank(q, store, scales, cand)
    return index


def _bytes_equal(jax_index, index):
    store = index._store.cpu()
    if index.dtype == "bf16":
        np.testing.assert_array_equal(store.view(torch.int16).numpy().view(np.uint16),
                                      np.asarray(jax_index._store).view(np.uint16))
    else:
        np.testing.assert_array_equal(store.numpy(), np.asarray(jax_index._store))
    for ours, theirs in ((index._scales, jax_index._scales), (index._bwords, jax_index._bwords)):
        assert (ours is None) == (theirs is None)
        if ours is not None:
            np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def _same_results(a, b):
    (sa, ia), (sb, ib) = a, b
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
    np.testing.assert_allclose(np.asarray(sa), np.asarray(sb), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def pair():
    kw = dict(dtype="int8", prefilter="binary", coarse_pool=2, doc_tokens=16)
    return _jax_kernels(DOCS, **kw), CorpusIndex(DOCS, device="cpu", **kw)


@pytest.mark.parametrize("coarse_pool", [1, 4])
def test_packed_bytes_equal(coarse_pool):
    kw = dict(dtype="int8", prefilter="binary", coarse_pool=coarse_pool)
    _bytes_equal(JaxIndex(DOCS, **kw), CorpusIndex(DOCS, device="cpu", **kw))


def test_bf16_packed_bytes_equal():
    _bytes_equal(JaxIndex(DOCS, dtype="bf16"), CorpusIndex(DOCS, dtype="bf16", device="cpu"))


def test_exact_search_matches(pair):
    jax_index, index = pair
    _same_results(index.exact_search(QUERIES, k=7), jax_index.exact_search(QUERIES, k=7))
    _, ids = index.exact_search(QUERIES, k=1)
    assert ids[0, 0] == 7 and ids[1, 0] == 211


def test_tiered_search_matches(pair):
    jax_index, index = pair
    _same_results(index.search(QUERIES, k=5, candidates=70), jax_index.search(QUERIES, k=5, candidates=70))


def test_exact_index_search_matches():
    kw = dict(dtype="int8")
    jax_index, index = JaxIndex(DOCS, force_kernel=True, **kw), CorpusIndex(DOCS, device="cpu", **kw)
    _same_results(index.search(QUERIES, k=4), jax_index.search(QUERIES, k=4))


@pytest.mark.parametrize("dtype,quantize_queries", [("bf16", True), ("int8", False)])
def test_unported_kernel_paths_run_plain_on_cpu(dtype, quantize_queries):
    """bf16 indexes (K5) and unquantized queries (K4) run their plain
    versions on the CPU and agree with the JAX kernels' math (on the card
    they launch their kernels: tests/test_torch_cuda.py)."""
    kw = dict(dtype=dtype, quantize_queries=quantize_queries)
    jax_index, index = JaxIndex(DOCS, force_kernel=True, **kw), CorpusIndex(DOCS, device="cpu", **kw)
    _same_results(index.search(QUERIES, k=3), jax_index.search(QUERIES, k=3))


def test_tune_candidates_and_recall_match(pair):
    jax_index, index = pair
    assert index.tune_candidates(QUERIES, k=4, target_recall=1.0) == \
        jax_index.tune_candidates(QUERIES, k=4, target_recall=1.0)
    assert index.default_candidates == jax_index.default_candidates
    assert index.estimate_recall(QUERIES, k=4) == jax_index.estimate_recall(QUERIES, k=4)


def test_extend_matches():
    kw = dict(dtype="int8", prefilter="binary", coarse_pool=2, doc_tokens=16)
    jax_index, index = _jax_kernels(DOCS[:150], **kw), CorpusIndex(DOCS[:150], device="cpu", **kw)
    for part in (DOCS[150:170], DOCS[170:300]):
        jax_index.extend(part)
        index.extend(part)
    assert index.num_docs == jax_index.num_docs == 300
    assert index.padded_docs == jax_index.padded_docs
    _bytes_equal(jax_index, index)
    _same_results(index.search(QUERIES, k=5, candidates=80), jax_index.search(QUERIES, k=5, candidates=80))


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_npz_cross_load(tmp_path, writer, dtype):
    kw = dict(dtype=dtype, prefilter="binary", coarse_pool=2)
    path = str(tmp_path / "index.npz")
    saved = JaxIndex(DOCS, **kw) if writer == "jax" else CorpusIndex(DOCS, device="cpu", **kw)
    saved.save(path)
    loaded = CorpusIndex.load(path, device="cpu") if writer == "jax" else JaxIndex.load(path)
    jax_index, index = (saved, loaded) if writer == "jax" else (loaded, saved)
    assert (index.num_docs, index.doc_tokens, index.dim, index.dtype, index.coarse_pool, index.nbytes) == \
        (jax_index.num_docs, jax_index.doc_tokens, jax_index.dim, jax_index.dtype, jax_index.coarse_pool,
         jax_index.nbytes)
    _bytes_equal(jax_index, index)
    # the two-tier search is the same math on the JAX CPU path and in the port
    _same_results(index.search(QUERIES, k=3, candidates=64), jax_index.search(QUERIES, k=3, candidates=64))


def test_top_k_breaks_ties_like_lax():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -np.inf]], np.float32)
    import jax

    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 4)
    got_v, got_i = top_k(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_gather_rerank_of_planted_doc():
    index = CorpusIndex(DOCS, dtype="int8", device="cpu")
    q = torch.from_numpy(np.stack([DOCS[7][:5], DOCS[7][:5]]))
    cand = torch.tensor([[7, 8], [8, 7]], dtype=torch.int32)
    s = gather_rerank(q, index._store, index._scales, cand).numpy()
    assert s[0, 0] > s[0, 1] and s[1, 1] > s[1, 0]
    np.testing.assert_allclose(s[0, 0], 5.0, rtol=1e-2)  # 5 tokens, each matching itself


def test_validation_errors():
    with pytest.raises(ValueError, match="dtype"):
        CorpusIndex(DOCS, dtype="fp8", device="cpu")
    with pytest.raises(ValueError, match="coarse_pool > 1 requires"):
        CorpusIndex(DOCS, dtype="int8", coarse_pool=2, device="cpu")
    with pytest.raises(ValueError, match="truncate"):
        CorpusIndex(DOCS, dtype="int8", doc_tokens=4, device="cpu")
    with pytest.raises(ValueError, match="candidates="):
        CorpusIndex(DOCS[:10], dtype="int8", device="cpu").search(QUERIES, candidates=8)
    with pytest.raises(ValueError, match=".npz"):
        CorpusIndex(DOCS[:10], dtype="int8", device="cpu").save("index.bin")


def _padded_batches():
    """300 ragged docs as padded (B, 14, D) batches with masks, cut so that
    the adds straddle the 128-doc tile boundaries: 100 + 60 + 140."""
    padded = np.zeros((len(DOCS), 14, DIM), np.float32)
    mask = np.zeros((len(DOCS), 14), np.float32)
    for i, d in enumerate(DOCS):
        padded[i, : len(d)], mask[i, : len(d)] = d, 1.0
    padded += (1 - mask)[..., None] * 0.5  # garbage under the mask: add() must zero it
    return [(padded[a:b], mask[a:b]) for a, b in ((0, 100), (100, 160), (160, 300))]


@pytest.mark.parametrize("kw", [dict(dtype="int8", prefilter="binary", coarse_pool=1),
                                dict(dtype="int8", prefilter="binary", coarse_pool=2),
                                dict(dtype="int8"), dict(dtype="bf16")], ids=str)
def test_device_index_builder_bytes_equal_the_jax_builder(kw):
    ours, theirs = DeviceIndexBuilder(doc_tokens=14, dim=DIM, **kw), JaxBuilder(doc_tokens=14, dim=DIM, **kw)
    for emb, mask in _padded_batches():
        ours.add(torch.from_numpy(emb), mask=torch.from_numpy(mask))
        theirs.add(jnp.asarray(emb), mask=jnp.asarray(mask))
    index, jax_index = ours.build(), theirs.build()
    assert (index.num_docs, index.doc_tokens, index.padded_docs, index.nbytes) == \
        (jax_index.num_docs, jax_index.doc_tokens, jax_index.padded_docs, jax_index.nbytes) == (300, 16, 384, index.nbytes)
    _bytes_equal(jax_index, index)
    (scores, ids), (host_scores, host_ids) = index.search(QUERIES, k=5), \
        CorpusIndex(DOCS, device="cpu", doc_tokens=16, **kw).search(QUERIES, k=5)
    np.testing.assert_array_equal(ids, host_ids)  # the device-built index serves like the host-packed one
    np.testing.assert_allclose(scores, host_scores, rtol=1e-4)
    with pytest.raises(RuntimeError, match="finalized"):
        ours.add(torch.zeros(1, 14, DIM))


def test_device_index_builder_validation():
    with pytest.raises(ValueError, match="pool_method must be 'ward' or 'kmeans'"):
        DeviceIndexBuilder(doc_tokens=16, dim=DIM, pool_factor=2, pool_method="max")
    with pytest.raises(ValueError, match="pool_method must be"):
        JaxBuilder(doc_tokens=16, dim=DIM, pool_factor=2, pool_method="max")
    with pytest.raises(ValueError, match="coarse_pool must be >= 1"):
        DeviceIndexBuilder(doc_tokens=16, dim=DIM, prefilter="binary", coarse_pool=0)
    with pytest.raises(ValueError, match="requires prefilter"):
        DeviceIndexBuilder(doc_tokens=16, dim=DIM, coarse_pool=2)
    with pytest.raises(ValueError, match="must divide"):
        DeviceIndexBuilder(doc_tokens=16, dim=DIM, prefilter="binary", coarse_pool=3)
    index_builder = DeviceIndexBuilder(doc_tokens=16, dim=DIM)
    with pytest.raises(ValueError, match="No documents"):
        index_builder.build()
    with pytest.raises(ValueError, match="tokens > doc_tokens"):
        index_builder.add(torch.zeros(2, 17, DIM))
    with pytest.raises(ValueError, match="dim mismatch"):
        index_builder.add(torch.zeros(2, 16, DIM + 1))


@pytest.mark.parametrize("dtype,quantize_queries", [("int8", True), ("int8", False), ("bf16", True)])
def test_score_matches_jax(dtype, quantize_queries):
    """The full (n_queries, num_docs) matrix by the exact sweep of search
    (K3, K4 or K5), against JAX's score through its Pallas kernels."""
    kw = dict(dtype=dtype, quantize_queries=quantize_queries)
    jax_index, index = JaxIndex(DOCS, force_kernel=True, **kw), CorpusIndex(DOCS, device="cpu", **kw)
    got, want = index.score(QUERIES), jax_index.score(QUERIES)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(QUERIES), len(DOCS))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    scores, ids = index.search(QUERIES, k=3)
    np.testing.assert_array_equal(np.take_along_axis(got, ids, axis=1), scores)
