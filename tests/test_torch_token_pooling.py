"""Port parity: token pooling (colpali_tpu_torch.compression) and the pooled
DeviceIndexBuilder against colpali_tpu.

Inputs are seeded numpy draws; both packages run on the CPU. Ward is held
partition-identical to JAX's ``ward_pool_padded`` (and so to scipy), k-means
assignment-identical to ``kmeans_pool_padded``; pooled rows and cluster
masks at atol 1e-5 (fp32 sums in another order). The scipy pooler calls
the same scipy on both sides: its maps are equal and its rows within 1e-5.
The pooled builder is held as tests/test_torch_store.py holds the unpooled
one: the same ids, scores at rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.compression import token_pooling as jtp
from colpali_tpu.retrieval.store import DeviceIndexBuilder as JaxBuilder
from colpali_tpu_torch.compression import (
    DeviceWardTokenPooler,
    HierarchicalTokenPooler,
    KMeansTokenPooler,
    LambdaTokenPooler,
    TokenPoolingOutput,
    kmeans_pool_padded,
    ward_pool_padded,
)
from colpali_tpu_torch.retrieval.store import DeviceIndexBuilder

ATOL = 1e-5
_WARD = jax.jit(jtp.ward_pool_padded, static_argnames=("pool_factor",))
_KMEANS = jax.jit(jtp.kmeans_pool_padded, static_argnames=("pool_factor", "iters"))


def _unit_docs(rng, lens, dim=16):
    docs = [rng.normal(size=(n, dim)).astype(np.float32) for n in lens]
    return [d / np.linalg.norm(d, axis=-1, keepdims=True) for d in docs]


def _pad(docs, t, left=False):
    padded = np.zeros((len(docs), t, docs[0].shape[1]), np.float32)
    mask = np.zeros((len(docs), t), np.float32)
    for i, doc in enumerate(docs):
        rows = slice(t - len(doc), t) if left else slice(0, len(doc))
        padded[i, rows], mask[i, rows] = doc, 1
    return padded, mask


def _partition(assign_row, valid):
    groups = {}
    for tok in np.where(valid)[0]:
        groups.setdefault(int(assign_row[tok]), []).append(int(tok))
    return {frozenset(g) for g in groups.values()}


def _both(fn, jfn, padded, mask, pool_factor, **kw):
    want = [np.asarray(x) for x in jfn(jnp.asarray(padded), jnp.asarray(mask), pool_factor=pool_factor, **kw)]
    got = [x.numpy() for x in fn(torch.from_numpy(padded), torch.from_numpy(mask), pool_factor, **kw)]
    return got, want


def _with_ties(rng, lens, dim=16):
    """Unit docs whose tokens repeat: every third token copies an earlier one,
    so exact ties between duplicate pairs decide merges."""
    docs = _unit_docs(rng, lens, dim)
    for d in docs:
        for t in range(3, len(d), 3):
            d[t] = d[int(rng.integers(0, t))]
    return docs


@pytest.mark.parametrize("pool_factor", [2, 3])
@pytest.mark.parametrize("case", ["random", "ties", "left_padded"])
def test_ward_matches_jax(case, pool_factor):
    rng = np.random.default_rng(pool_factor)
    lens = [24, 37, 48]
    for _ in range(2):
        docs = _with_ties(rng, lens) if case == "ties" else _unit_docs(rng, lens)
        padded, mask = _pad(docs, 48, left=case == "left_padded")
        (pooled, cmask, assign), (jpooled, jcmask, jassign) = _both(ward_pool_padded, _WARD, padded, mask,
                                                                    pool_factor)
        assert pooled.shape == (3, 48 // pool_factor, 16) and assign.shape == (3, 48)
        np.testing.assert_array_equal(cmask, jcmask)
        for i in range(3):
            assert _partition(assign[i], mask[i] > 0) == _partition(jassign[i], mask[i] > 0)
        np.testing.assert_allclose(pooled, jpooled, atol=ATOL)


def test_ward_keeps_bf16_and_cuts_nothing_at_factor_one():
    docs = _unit_docs(np.random.default_rng(3), [10, 7])
    padded, mask = _pad(docs, 10)
    x = torch.from_numpy(padded).bfloat16()
    pooled, cmask, assign = ward_pool_padded(x, torch.from_numpy(mask), 2)
    want = _WARD(jnp.asarray(padded, jnp.bfloat16), jnp.asarray(mask), pool_factor=2)
    assert pooled.dtype == torch.bfloat16 and pooled.shape == (2, 5, 16)
    np.testing.assert_allclose(pooled.float().numpy(), np.asarray(want[0], np.float32), atol=8e-3)  # a bf16 ulp
    same, smask, sassign = ward_pool_padded(x, torch.from_numpy(mask), 1)
    assert same is x and smask.tolist() == (mask > 0).tolist() and sassign.tolist() == [list(range(10))] * 2


@pytest.mark.parametrize("pool_factor", [2, 3])
def test_kmeans_matches_jax(pool_factor):
    rng = np.random.default_rng(10 + pool_factor)
    docs = _unit_docs(rng, [24, 37, 48]) + [np.zeros((0, 16), np.float32)]  # the last doc is fully masked
    padded, mask = _pad([d if len(d) else np.zeros((1, 16), np.float32) for d in docs], 48)
    mask[3] = 0
    padded[3] = 0
    for iters in (0, 10):
        (pooled, cmask, assign), (jpooled, jcmask, jassign) = _both(kmeans_pool_padded, _KMEANS, padded, mask,
                                                                    pool_factor, iters=iters)
        np.testing.assert_array_equal(cmask, jcmask)
        np.testing.assert_array_equal(assign[mask > 0], jassign[mask > 0])
        np.testing.assert_allclose(pooled, jpooled, atol=ATOL)
        assert not cmask[3].any() and not pooled[3].any()  # a fully masked doc has no valid cluster


def test_kmeans_empty_clusters_are_invalid():
    """Duplicate tokens: farthest-point picks seeds that coincide, so some
    clusters end empty; they are invalid and zeroed as in JAX."""
    rng = np.random.default_rng(5)
    base = _unit_docs(rng, [3])[0]
    doc = base[rng.integers(0, 3, size=24)]
    padded, mask = _pad([doc], 24)
    (pooled, cmask, assign), (jpooled, jcmask, jassign) = _both(kmeans_pool_padded, _KMEANS, padded, mask, 2,
                                                                iters=10)
    assert 0 < cmask.sum() <= 3 < cmask.shape[1]
    np.testing.assert_array_equal(cmask, jcmask)
    np.testing.assert_array_equal(assign, jassign)
    np.testing.assert_allclose(pooled, jpooled, atol=ATOL)
    assert not pooled[0, ~cmask[0]].any()


def _ours(cls, **kw):
    return {"ward": DeviceWardTokenPooler, "kmeans": KMeansTokenPooler, "scipy": HierarchicalTokenPooler}[cls](
        device="cpu", **kw)


def _theirs(cls, **kw):
    return {"ward": jtp.DeviceWardTokenPooler, "kmeans": jtp.KMeansTokenPooler,
            "scipy": jtp.HierarchicalTokenPooler}[cls](**kw)


def _same_maps(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for cid in g:
            np.testing.assert_array_equal(g[cid][0], w[cid][0])


@pytest.mark.parametrize("cls", ["ward", "kmeans", "scipy"])
def test_pooler_container_api_matches_jax(cls):
    rng = np.random.default_rng(20)
    docs = _unit_docs(rng, [9, 14, 5])
    got = _ours(cls).pool_embeddings(docs, pool_factor=2, return_dict=True)
    want = _theirs(cls).pool_embeddings(docs, pool_factor=2, return_dict=True)
    assert isinstance(got, TokenPoolingOutput) and len(got.pooled_embeddings) == 3
    for g, w in zip(got.pooled_embeddings, want.pooled_embeddings):
        assert isinstance(g, np.ndarray) and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)
    _same_maps(got.cluster_id_to_indices, want.cluster_id_to_indices)
    # tensors in, numpy out, the same rows
    again = _ours(cls).pool_embeddings([torch.from_numpy(d) for d in docs], pool_factor=2, num_workers=2)
    for g, w in zip(again, got.pooled_embeddings):
        np.testing.assert_allclose(g, w, atol=ATOL)
    # a padded 3-D batch (left padding) comes back padded the same way
    padded, _ = _pad(docs, 14, left=True)
    got3 = _ours(cls).pool_embeddings(padded, pool_factor=2, padding=True, padding_side="left")
    want3 = _theirs(cls).pool_embeddings(padded, pool_factor=2, padding=True, padding_side="left")
    assert got3.shape == want3.shape and got3.ndim == 3
    np.testing.assert_allclose(got3, want3, atol=ATOL)
    # pool_factor 1 hands the docs back
    same = _ours(cls).pool_embeddings(docs, pool_factor=1, return_dict=True)
    for g, d in zip(same.pooled_embeddings, docs):
        np.testing.assert_array_equal(g, d)
    assert [sorted(m) for m in same.cluster_id_to_indices] == [[0]] * 3
    with pytest.raises(ValueError, match="more than one token"):
        _ours(cls).pool_embeddings([docs[0], docs[0][:1]], pool_factor=2)
    with pytest.raises(ValueError, match="list of 2D arrays or a 3D array"):
        _ours(cls).pool_embeddings([docs[0][0]], pool_factor=2)
    assert _ours(cls).pool_embeddings([], pool_factor=2).pooled_embeddings == []


@pytest.mark.parametrize("cls", ["ward", "kmeans"])
def test_device_poolers_extend_t_for_short_docs(cls):
    """Short documents after a long one do not shrink K: the batch of 5- and
    3-token docs pads T to pool_factor x the longest doc's clusters, and a
    doc of 2 tokens at factor 3 keeps one cluster."""
    rng = np.random.default_rng(30)
    docs = _unit_docs(rng, [5, 3, 2])
    got = _ours(cls).pool_embeddings(docs, pool_factor=3, return_dict=True)
    want = _theirs(cls).pool_embeddings(docs, pool_factor=3, return_dict=True)
    assert [len(p) for p in got.pooled_embeddings] == [len(p) for p in want.pooled_embeddings] == [1, 1, 1]
    for g, w in zip(got.pooled_embeddings, want.pooled_embeddings):
        np.testing.assert_allclose(g, w, atol=ATOL)
    _same_maps(got.cluster_id_to_indices, want.cluster_id_to_indices)
    docs = _unit_docs(rng, [7, 2])  # 7 // 2 = 3 clusters need T = 6 at least: no extension; 2 // 2 = 1
    got = _ours(cls).pool_embeddings(docs, pool_factor=2, return_dict=True)
    want = _theirs(cls).pool_embeddings(docs, pool_factor=2, return_dict=True)
    _same_maps(got.cluster_id_to_indices, want.cluster_id_to_indices)


def test_device_ward_matches_scipy_pooler():
    rng = np.random.default_rng(40)
    docs = _unit_docs(rng, [24, 37, 48], dim=32)
    for pool_factor in (2, 3):
        got = _ours("ward").pool_embeddings(docs, pool_factor=pool_factor, return_dict=True)
        ref = _ours("scipy").pool_embeddings(docs, pool_factor=pool_factor, return_dict=True)
        for g, r in zip(got.cluster_id_to_indices, ref.cluster_id_to_indices):
            assert {frozenset(v[0].tolist()) for v in g.values()} == \
                {frozenset(v[0].tolist()) for v in r.values() if len(v[0])}


def test_lambda_pooler_matches_jax():
    docs = _unit_docs(np.random.default_rng(50), [6, 4])
    fn = lambda e: e[::2]  # noqa: E731
    got = LambdaTokenPooler(fn).pool_embeddings(docs, return_dict=True, num_workers=2)
    want = jtp.LambdaTokenPooler(fn).pool_embeddings(docs, return_dict=True)
    assert got.cluster_id_to_indices is None and want.cluster_id_to_indices is None
    for g, w in zip(got.pooled_embeddings, want.pooled_embeddings):
        np.testing.assert_array_equal(g, w)


DIM = 64


def _page_batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for b in (4, 4):  # one shape: JAX compiles its pooling once
        x = rng.normal(size=(b, 21, DIM)).astype(np.float32)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        mask = np.ones((b, 21), np.float32)
        mask[1, 15:] = 0
        x[1, 15:] = 0
        out.append((x, mask))
    return out


@pytest.mark.parametrize("pool_method", ["ward", "kmeans"])
@pytest.mark.parametrize("pool_factor", [2, 3])
def test_pooled_device_index_builder_matches_jax(pool_method, pool_factor):
    kw = dict(doc_tokens=21 // pool_factor, dim=DIM, dtype="int8", prefilter="binary", pool_factor=pool_factor,
              pool_method=pool_method)
    ours, theirs = DeviceIndexBuilder(**kw), JaxBuilder(**kw)
    batches = _page_batches(pool_factor)
    for i, (x, mask) in enumerate(batches):
        ours.add(torch.from_numpy(x), torch.from_numpy(mask) if i == 0 else None)
        theirs.add(jnp.asarray(x), jnp.asarray(mask) if i == 0 else None)
    index, jax_index = ours.build(), theirs.build()
    assert (index.num_docs, index.doc_tokens) == (jax_index.num_docs, jax_index.doc_tokens) == (8, 16)
    queries = [batches[0][0][2, :4], batches[1][0][0, 3:9], batches[0][0][3]]
    # JAX's tiered route on XLA; its exact sweep in the int8 kernel's math (force_kernel, read when a route is
    # first searched), which the port's K3 computes
    for route, force_kernel in (("search", None), ("exact_search", True)):
        jax_index.force_kernel = force_kernel
        (scores, ids), (jscores, jids) = getattr(index, route)(queries, k=5), getattr(jax_index, route)(queries, k=5)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(scores, np.asarray(jscores), rtol=1e-4)
    assert [int(i) for i in ids[:, 0]] == [2, 4, 3]  # each query's own doc first


def test_device_index_builder_rejects_an_unknown_pool_method():
    with pytest.raises(ValueError, match="pool_method must be 'ward' or 'kmeans'") as ours:
        DeviceIndexBuilder(doc_tokens=16, dim=DIM, pool_factor=2, pool_method="mean")
    with pytest.raises(ValueError) as theirs:
        JaxBuilder(doc_tokens=16, dim=DIM, pool_factor=2, pool_method="mean")
    assert str(ours.value) == str(theirs.value)
    DeviceIndexBuilder(doc_tokens=16, dim=DIM, pool_factor=1, pool_method="mean")  # no pooling: not read
