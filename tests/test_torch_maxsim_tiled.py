"""Port parity: the plain versions of K3 (full-int8 exact sweep) and K2
(candidate gather + rerank) in colpali_tpu_torch.ops.maxsim_tiled against
colpali_tpu's Pallas kernels in interpret mode and its XLA paths.

Tolerance: rtol=1e-5 (atol=1e-5 near zero). The int8 dot products are exact
on both sides; only the fp32 sums over query tokens and over the
dimension run in another order. Layout helpers are compared exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.ops import maxsim_pallas as jp
from colpali_tpu.ops import quant as jq
from colpali_tpu.retrieval.store import gather_rerank as jax_gather_rerank
from colpali_tpu_torch.ops import maxsim_tiled as tt

RTOL, ATOL = 1e-5, 1e-5


def _store(seed: int, n_tiles: int, np_: int, d: int):
    rng = np.random.default_rng(seed)
    docs = rng.normal(size=(n_tiles * 128, np_, d)).astype(np.float32)
    docs[:, np_ - 3 :] = 0.0  # zero-padded doc tokens: value 0, scale 1
    tiled = docs.reshape(n_tiles, 128, np_, d).transpose(0, 2, 1, 3)
    q, s = jq.quantize_per_token(jnp.asarray(tiled))
    return np.asarray(q), np.asarray(s)


def _queries(seed: int, b: int, nq: int, d: int) -> np.ndarray:
    q = np.random.default_rng(seed).normal(size=(b, nq, d)).astype(np.float32)
    q[:, -2:] = 0.0  # padded query tokens
    return q


@pytest.fixture(scope="module")
def corpus():
    return _store(0, 3, 8, 64)


@pytest.mark.parametrize("b,nq", [(1, 8), (2, 5)])
def test_k3_plain_matches_pallas_interpret(corpus, b, nq):
    store, scales = corpus
    qi, qs = jq.quantize_per_token(jnp.asarray(_queries(b, b, nq, 64)))
    want = np.asarray(jp.maxsim_pallas_int8mxu_tiled(qi, qs, jnp.asarray(store), jnp.asarray(scales),
                                                     interpret=True))
    got = tt.maxsim_int8mxu_tiled(torch.from_numpy(np.array(qi)), torch.from_numpy(np.array(qs)),
                                  torch.from_numpy(store), torch.from_numpy(scales))
    assert got.shape == (b, 3 * 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_k3_plain_chunking_does_not_change_scores(corpus, monkeypatch):
    store, scales = corpus
    qi, qs = (torch.from_numpy(np.array(a)) for a in jq.quantize_per_token(jnp.asarray(_queries(9, 2, 4, 64))))
    args = (qi, qs, torch.from_numpy(store), torch.from_numpy(scales))
    whole = tt.maxsim_int8mxu_tiled_plain(*args)
    monkeypatch.setattr(tt, "_tile_step", lambda per_tile: 1)
    np.testing.assert_array_equal(tt.maxsim_int8mxu_tiled_plain(*args).numpy(), whole.numpy())


@pytest.mark.parametrize("use_kernel", [True, False])
def test_k2_plain_matches_gather_rerank(corpus, use_kernel):
    store, scales = corpus
    rng = np.random.default_rng(3)
    q = _queries(4, 2, 6, 64)
    cand = rng.integers(0, 3 * 128, size=(2, 12)).astype(np.int32)
    cand[0, 0], cand[1, 0] = 0, 3 * 128 - 1
    want = np.asarray(jax_gather_rerank(jnp.asarray(q), jnp.asarray(store), jnp.asarray(scales),
                                        jnp.asarray(cand), use_kernel=use_kernel, interpret=True))
    got = tt.gather_rerank_int8(torch.from_numpy(q), torch.from_numpy(store), torch.from_numpy(scales),
                                torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_k2_rerank_of_k3_candidates_equals_dequantized_maxsim(corpus):
    """K2 on every doc equals the fp32 MaxSim of the dequantized corpus."""
    store, scales = corpus
    q = _queries(5, 1, 4, 64)
    cand = np.arange(3 * 128, dtype=np.int32)[None]
    got = tt.gather_rerank_int8(torch.from_numpy(q), torch.from_numpy(store), torch.from_numpy(scales),
                                torch.from_numpy(cand))
    deq = store.astype(np.float32) * scales[..., None]
    docs = deq.transpose(0, 2, 1, 3).reshape(-1, 8, 64)
    want = np.einsum("qd,cnd->qcn", q[0], docs).max(-1).sum(0)
    np.testing.assert_allclose(got.numpy()[0], want, rtol=RTOL, atol=ATOL)


def test_tile_major_layouts_match():
    rng = np.random.default_rng(6)
    tm = rng.normal(size=(5, 256, 32)).astype(np.float32)
    scales_tm = rng.random((5, 256)).astype(np.float32)
    np.testing.assert_array_equal(tt.to_tile_major(torch.from_numpy(tm)).numpy(),
                                  np.asarray(jp.to_tile_major(jnp.asarray(tm))))
    np.testing.assert_array_equal(tt.scales_to_tile_major(torch.from_numpy(scales_tm)).numpy(),
                                  np.asarray(jp.scales_to_tile_major(jnp.asarray(scales_tm))))


def test_k4_plain_matches_pallas_interpret(corpus):
    """int8 store with bf16 queries (TPU kernel K4): plain version only."""
    store, scales = corpus
    q = _queries(7, 2, 4, 64)
    want = np.asarray(jp.maxsim_pallas_int8_tiled(jnp.asarray(q, jnp.bfloat16), jnp.asarray(store),
                                                  jnp.asarray(scales), interpret=True))
    got = tt.maxsim_int8_tiled(torch.from_numpy(q), torch.from_numpy(store), torch.from_numpy(scales))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_k5_plain_matches_pallas_interpret():
    """bf16 store and queries (TPU kernel K5): plain version only."""
    rng = np.random.default_rng(8)
    store = rng.normal(size=(2, 8, 128, 64)).astype(np.float32)
    q = _queries(9, 2, 4, 64)
    store_bf16 = jnp.asarray(store, jnp.bfloat16)
    want = np.asarray(jp.maxsim_pallas_tiled(jnp.asarray(q, jnp.bfloat16), store_bf16, interpret=True))
    got = tt.maxsim_tiled(torch.from_numpy(q), torch.from_numpy(store).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_wrappers_check_shapes(corpus):
    store, scales = corpus
    qi = torch.zeros((1, 4, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="does not match"):
        tt.maxsim_int8mxu_tiled(qi, torch.ones(1, 4), torch.from_numpy(store), torch.from_numpy(scales))
    with pytest.raises(ValueError, match="cand"):
        tt.gather_rerank_int8(torch.zeros(2, 4, 64), torch.from_numpy(store), torch.from_numpy(scales),
                              torch.zeros(3, 5, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        tt.maxsim_tiled(torch.zeros(1, 4, 64, device="meta"), torch.zeros(1, 8, 128, 64, device="meta"))


def test_plain_maxsim_and_score_multi_vector_match():
    """The plain MaxSim oracle (colpali_tpu_torch.ops.maxsim) against JAX's."""
    import importlib

    # both packages re-export a function of the module's name
    tm = importlib.import_module("colpali_tpu_torch.ops.maxsim")
    jm = importlib.import_module("colpali_tpu.ops.maxsim")

    rng = np.random.default_rng(10)
    q = rng.normal(size=(2, 5, 32)).astype(np.float32)
    d = rng.normal(size=(7, 9, 32)).astype(np.float32)
    np.testing.assert_allclose(tm.maxsim(torch.from_numpy(q), torch.from_numpy(d)).numpy(),
                               np.asarray(jm.maxsim(jnp.asarray(q), jnp.asarray(d))), rtol=RTOL, atol=ATOL)
    qs = [rng.normal(size=(n, 32)).astype(np.float32) for n in (3, 6)]
    ps = [rng.normal(size=(n, 32)).astype(np.float32) for n in (4, 11, 2)]
    np.testing.assert_allclose(tm.score_multi_vector(qs, ps, batch_size=2),
                               jm.score_multi_vector(qs, ps, batch_size=2), rtol=RTOL, atol=ATOL)


def test_k2_plain_matches_gather_rerank_at_full_page():
    """256 docs of 1,040 tokens (a ColPali page rounded up to 16), D=128:
    the length at which the card kernel streams its doc tokens in chunks."""
    store, scales = _store(11, 2, 1040, 128)
    rng = np.random.default_rng(12)
    q = _queries(13, 2, 16, 128)
    cand = rng.integers(0, 256, size=(2, 24)).astype(np.int32)
    want = np.asarray(jax_gather_rerank(jnp.asarray(q), jnp.asarray(store), jnp.asarray(scales),
                                        jnp.asarray(cand), use_kernel=False))
    got = tt.gather_rerank_int8(torch.from_numpy(q), torch.from_numpy(store), torch.from_numpy(scales),
                                torch.from_numpy(cand))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def split_bf16_terms(x: torch.Tensor) -> tuple:
    """fp32 ``x`` as three bf16 terms ``hi + mid + lo`` that hold its 24
    bits (each rounded to nearest; the two differences are exact in fp32):
    the split K2 makes of every query element on the card."""
    x = x.float()
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def test_k2_query_split_holds_fp32_bits():
    """The three bf16 terms K2 makes of each fp32 query element add back to
    it within 2^-24 of its magnitude, over 6 decades of magnitude."""
    rng = np.random.default_rng(14)
    x = rng.normal(size=(4, 64, 128)) * 10.0 ** rng.uniform(-3, 3, size=(4, 64, 128))
    q = torch.from_numpy(x.astype(np.float32))
    hi, mid, lo = split_bf16_terms(q)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert ((total - q.double()).abs() <= q.double().abs() * 2.0**-24).all()


@pytest.mark.parametrize("scaled", [False, True], ids=["unit", "six_decades"])
def test_k2_rerank_through_the_query_split_matches_plain_at_full_page(scaled):
    """K2's arithmetic in plain PyTorch: the three bf16 query terms against
    the int8 values (exact in bf16), products summed in fp32, each doc
    token's scale applied before the max; held to gather_rerank_plain at
    Np = 1,040 within K2's rtol 1e-5, atol 1e-4."""
    store, scales = _store(15, 1, 1040, 128)
    store_t, scales_t = torch.from_numpy(store), torch.from_numpy(scales)
    rng = np.random.default_rng(16)
    q = _queries(17, 2, 64, 128)
    if scaled:
        q = (q * 10.0 ** rng.uniform(-3, 3, size=q.shape)).astype(np.float32)
    q_t = torch.from_numpy(q)
    cand = torch.from_numpy(rng.integers(0, 128, size=(2, 6)).astype(np.int32))
    want = tt.gather_rerank_plain(q_t, store_t, scales_t, cand)
    tile, lane = cand.long() // 128, cand.long() % 128
    values = store_t[tile, :, lane, :].to(torch.bfloat16).float()  # (B, c, Np, D), exact
    sims = sum(torch.einsum("bqd,bcnd->bqcn", term.float(), values) for term in reversed(split_bf16_terms(q_t)))
    got = (sims * scales_t[tile, :, lane][:, None]).amax(dim=-1).sum(dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4)
