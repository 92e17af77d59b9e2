"""Port parity: hard-negative mining (colpali_tpu_torch.retrieval.hardneg and
``python -m colpali_tpu_torch.compute_hardnegs``) against colpali_tpu's
``mine_hard_negatives`` and ``scripts/compute_hardnegs.py``.

Seeded numpy embeddings on the CPU. The mined doc ids and flags are equal;
scores at rtol 1e-5 (fp32 sums in another order). The index routes build
JAX's ``CorpusIndex`` with ``force_kernel=True``, so that its exact sweep
computes the int8 kernel's math, which the port's K3 computes; dense
vectors mine through an index of 1-token docs (16 tokens a doc once
padded).
"""

import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

import colpali_tpu.retrieval as jax_retrieval
from colpali_tpu.retrieval.hardneg import mine_hard_negatives as jax_mine
from colpali_tpu.retrieval.store import CorpusIndex as JaxIndex
from colpali_tpu_torch import compute_hardnegs
from colpali_tpu_torch.retrieval import CorpusIndex, mine_hard_negatives

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5
DIM = 64


def _unit(rng, *shape):
    x = rng.normal(size=(*shape, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _corpus(seed=0, n_docs=40, n_queries=6):
    rng = np.random.default_rng(seed)
    docs = [_unit(rng, int(rng.integers(4, 12))) for _ in range(n_docs)]
    gold = [int(g) for g in rng.choice(n_docs, n_queries, replace=False)]
    queries = [docs[g][: int(rng.integers(2, 4))] + 0.1 * _unit(rng, 1) for g in gold]
    return queries, docs, gold, rng


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["negative_passages"] == w["negative_passages"]
        assert g["gold_in_top_100"] == w["gold_in_top_100"]
        np.testing.assert_allclose(g["top_scores"], w["top_scores"], rtol=RTOL)


def test_dense_route_matches_jax():
    rng = np.random.default_rng(1)
    docs = _unit(rng, 50)
    docs[7] = docs[3]  # a tie: the lower index first, as lax.top_k
    gold = [3, 11, 40, 7]
    queries = docs[gold] + 0.05 * _unit(rng, 4)
    got = mine_hard_negatives(queries, docs, gold, k=10)
    _same(got, jax_mine(queries, docs, gold, k=10))
    assert all(r["gold_in_top_100"] for r in got) and all(len(r["top_scores"]) == 10 for r in got)
    assert got[0]["negative_passages"][0] == 7 and 3 not in got[0]["negative_passages"]
    _same(mine_hard_negatives(list(queries), list(docs), gold, k=200), jax_mine(list(queries), list(docs), gold, k=200))


def test_multi_vector_route_matches_jax():
    queries, docs, gold, _ = _corpus()
    got = mine_hard_negatives(queries, docs, gold, k=8, multi_vector=True, batch_size=16)
    _same(got, jax_mine(queries, docs, gold, k=8, multi_vector=True, batch_size=16))
    assert all(r["gold_in_top_100"] for r in got)
    assert all(g not in r["negative_passages"] and len(r["negative_passages"]) == 7 for g, r in zip(gold, got))


@pytest.mark.parametrize("multi_vector", [True, False])
def test_index_route_matches_jax(multi_vector):
    queries, docs, gold, rng = _corpus(seed=2)
    if not multi_vector:  # dense vectors as an index of 1-token docs
        docs = [d[:1] for d in docs]
        queries = [d[0] + 0.05 * _unit(rng, 1)[0] for d in (docs[g] for g in gold)]
    index = CorpusIndex(docs, dtype="int8", device="cpu")
    assert index.doc_tokens == (16 if not multi_vector else index.doc_tokens)
    got = mine_hard_negatives(queries, None, gold, k=12, multi_vector=multi_vector, index=index)
    want = jax_mine(queries, None, gold, k=12, multi_vector=multi_vector,
                    index=JaxIndex(docs, dtype="int8", force_kernel=True))
    _same(got, want)
    assert all(r["gold_in_top_100"] for r in got)
    # k past the corpus is cut to it
    assert len(mine_hard_negatives(queries, None, gold, k=500, multi_vector=multi_vector, index=index)[0]
               ["top_scores"]) == len(docs)


def _write(tmp_path, queries, docs, gold, dense):
    qp, dp, gp = tmp_path / "q.npz", tmp_path / "d.npz", tmp_path / "gold.json"
    if dense:
        np.savez(qp, embeddings=np.stack(queries))
        np.savez(dp, embeddings=np.stack(docs))
    else:
        np.savez(qp, **{f"emb_{i}": q for i, q in enumerate(queries)})
        np.savez(dp, **{f"emb_{i}": d for i, d in enumerate(docs)})
    gp.write_text(json.dumps(gold))
    return [str(qp), str(dp), str(gp)]


def _jax_script(args):
    sys.path.insert(0, str(REPO / "scripts"))
    try:
        import compute_hardnegs as jax_cli
    finally:
        sys.path.pop(0)
    index = lambda docs, **kw: JaxIndex(docs, force_kernel=True, **kw)  # noqa: E731
    with mock.patch.object(sys, "argv", ["compute_hardnegs.py", *args]), \
            mock.patch.object(jax_retrieval, "CorpusIndex", index):
        jax_cli.main()


@pytest.mark.parametrize("flags", [["--multi-vector"], ["--multi-vector", "--via-index"], [], ["--via-index"]])
def test_cli_writes_the_same_jsonl_as_jax(tmp_path, flags, capsys):
    queries, docs, gold, rng = _corpus(seed=3, n_docs=30)
    dense = "--multi-vector" not in flags
    if dense:
        docs = [d[0] for d in docs]
        queries = [docs[g] + 0.05 * _unit(rng, 1)[0] for g in gold]
    inputs = _write(tmp_path, queries, docs, gold, dense)
    compute_hardnegs.main([*inputs, str(tmp_path / "ours.jsonl"), "--k", "9", "--device", "cpu", *flags])
    assert capsys.readouterr().out.strip() == f"Mined {len(gold)} queries; gold_in_top_100 for {len(gold)}/{len(gold)}"
    _jax_script([*inputs, str(tmp_path / "theirs.jsonl"), "--k", "9", *flags])
    got = [json.loads(line) for line in (tmp_path / "ours.jsonl").read_text().splitlines()]
    want = [json.loads(line) for line in (tmp_path / "theirs.jsonl").read_text().splitlines()]
    _same(got, want)
    assert set(got[0]) == {"negative_passages", "gold_in_top_100", "top_scores"}


def test_load_embeddings_orders_ragged_keys(tmp_path):
    arrays = {f"emb_{i}": np.full((i + 1, 4), i, np.float32) for i in range(12)}
    np.savez(tmp_path / "x.npz", **arrays)
    loaded = compute_hardnegs.load_embeddings(str(tmp_path / "x.npz"))
    assert [a.shape[0] for a in loaded] == list(range(1, 13))
