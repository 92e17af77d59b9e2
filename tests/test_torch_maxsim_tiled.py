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


# -- K4/K5 (and K8/K9) on the card: the plan of a launch, checked here ----------------

H100_SMS = 132
# (B, Nq, Np, D, n_tiles): the eval index (B=128 Nq=16 Np=1,040, one tile), the corpora at B=1, B=8 and the
# served B=8 Nq=64, long and odd queries, each side of the thresholds (one slot or two: B * Nq = 64 and 65 rows;
# segments = SMs: 132 tiles at B=1)
PLAN_SHAPES = [(128, 16, 1040, 128, 1), (1, 32, 64, 128, 2048), (8, 32, 64, 128, 7812), (8, 64, 64, 128, 2048),
               (1, 200, 16, 128, 3), (5, 7, 9, 256, 4), (70, 1, 33, 128, 1), (2, 32, 64, 128, 131),
               (3, 32, 64, 128, 131), (1, 64, 64, 320, 132), (1, 64, 64, 64, 133), (8, 64, 1040, 128, 2),
               (1, 32, 1, 128, 5), (130, 1, 64, 128, 1)]


def _walk(plan: "tt.SweepPlan", np_: int, n_tiles: int):
    """The units of every CTA as ``csrc/maxsim_bf16.cu::for_each_unit`` walks
    them: (cta, tile, lane, t0, t1, k)."""
    work = plan.segments * np_
    for cta in range(plan.ctas):
        if not plan.split:
            for seg in range(cta, plan.segments, plan.ctas):
                yield cta, seg // plan.lanes, seg % plan.lanes, 0, np_, 0
            continue
        pos, end = cta * work // plan.ctas, (cta + 1) * work // plan.ctas
        while pos < end:
            seg, t0 = divmod(pos, np_)
            t1 = min(np_, t0 + end - pos)
            yield cta, seg % n_tiles, seg // n_tiles, t0, t1, cta - tt._cta_of(seg * np_, plan.ctas, work)
            pos += t1 - t0


def _coverage(plan, np_: int, n_tiles: int) -> np.ndarray:
    """How many times each (tile, query row, doc, doc token) is taken, and
    that every split slot a segment's rows read was written."""
    rows = plan.b * plan.nq
    seen = np.zeros((n_tiles, rows, 2, np_), dtype=np.int32)  # doc halves: a consumer takes 64 or 128 docs
    slots_written = {}
    for cta, tile, lane, t0, t1, k in _walk(plan, np_, n_tiles):
        for consumer in (0, 1):
            slot = 2 * lane + consumer if plan.pair else lane
            halves = (0, 1) if plan.pair else (consumer,)
            first = slot * plan.qpc
            n_queries = max(0, min(plan.qpc, plan.b - first))
            r0, r1 = first * plan.nq, (first + n_queries) * plan.nq
            for h in halves:
                seen[tile, r0:r1, h, t0:t1] += 1
            if n_queries:
                slots_written.setdefault((tile, slot), set()).add(k)
    if plan.split:  # the second kernel reads slots 0 .. n_k - 1 of each segment: each was written
        work = plan.segments * np_
        for (tile, slot), ks in slots_written.items():
            lane = slot // 2 if plan.pair else slot
            first = (lane * n_tiles + tile) * np_
            n_k = tt._cta_of(first + np_ - 1, plan.ctas, work) - tt._cta_of(first, plan.ctas, work) + 1
            assert ks == set(range(n_k)) and n_k <= plan.k_max
    return seen


@pytest.mark.parametrize("b,nq,np_,d,n_tiles", PLAN_SHAPES)
@pytest.mark.parametrize("split_ctas", [None, 0, 37])
def test_sweep_plan_covers_every_tile_row_and_token_once(b, nq, np_, d, n_tiles, split_ctas):
    plan = tt.maxsim_bf16_plan(b, nq, np_, d, n_tiles, H100_SMS, split_ctas)
    assert plan.qpc * plan.nq <= tt.SWEEP_ROWS and plan.b == b * plan.pieces
    assert plan.pieces * plan.nq >= nq and plan.slots * plan.qpc >= plan.b
    assert not (plan.pair and d > 128)  # 128 accumulators, 128 maxima and D / 4 query registers a thread
    if n_tiles * plan.lanes * np_ > 4_000_000:  # the full corpora: count their segments only
        assert plan.segments == n_tiles * plan.lanes and not plan.split and plan.ctas == H100_SMS
        return
    assert (_coverage(plan, np_, n_tiles) == 1).all()


def test_sweep_plan_fills_the_card_at_the_eval_shape_and_keeps_its_scratch_bounded():
    eval_plan = tt.maxsim_bf16_plan(128, 16, 1040, 128, 1, H100_SMS)
    assert eval_plan.split and eval_plan.pair and eval_plan.lanes == 16
    assert eval_plan.ctas >= H100_SMS  # one equal range of the 16 x 1,040 blocks a CTA: 126 or 127 each
    tokens = [t1 - t0 for _, _, _, t0, t1, _ in _walk(eval_plan, 1040, 1)]
    per_cta = np.bincount([cta for cta, *_ in _walk(eval_plan, 1040, 1)], weights=tokens)
    assert per_cta.max() - per_cta.min() <= 1
    # a split run holds at most (ctas + 2 segments) x 128 rows x 128 docs of fp32 maxima
    for b, nq, np_, d, n_tiles in PLAN_SHAPES + [(256, 64, 1040, 128, 1), (1024, 1, 4096, 128, 1)]:
        plan = tt.maxsim_bf16_plan(b, nq, np_, d, n_tiles, H100_SMS)
        assert plan.scratch_bytes <= min(plan.ctas + 2 * plan.segments, 3 * H100_SMS) * 128 * 128 * 4
        assert plan.split == (plan.segments < H100_SMS) and plan.ctas <= H100_SMS


def test_split_of_doc_tokens_with_a_max_merge_gives_bit_equal_scores():
    """The property the second kernel rests on: the max over a split of the
    doc tokens, taken again over the pieces, is the max over all of them,
    bit for bit, so the sums in one order are equal too."""
    rng = np.random.default_rng(20)
    store = torch.from_numpy(rng.normal(size=(2, 40, 128, 64)).astype(np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(_queries(21, 3, 7, 64)).to(torch.bfloat16).float()
    sim = torch.einsum("bqd,ktcd->bqktc", q, store.float())  # (B, Nq, tiles, Np, 128)
    whole = sim.amax(dim=3)
    for cuts in ([13], [1, 2, 39], list(range(1, 40))):
        parts = [p.amax(dim=3) for p in torch.tensor_split(sim, cuts, dim=3)]
        merged = torch.stack(parts).amax(dim=0)
        assert torch.equal(merged, whole)
        sums = [torch.zeros_like(merged[:, 0]) for _ in range(2)]
        for i in range(q.shape[1]):  # 0 + m[0] + m[1] + ...: the order both kernels add in
            sums[0] += whole[:, i]
            sums[1] += merged[:, i]
        assert torch.equal(sums[0], sums[1])
    want = tt.maxsim_tiled_plain(q, store)
    np.testing.assert_allclose(sums[0].reshape(3, -1).numpy(), want.numpy(), rtol=RTOL, atol=1e-4)


@pytest.mark.parametrize("nq", [1, 7, 64, 65, 200])
def test_query_pieces_keep_the_plain_scores(nq):
    """Queries cut into pieces of 64 tokens (zero-padded), their scores
    summed: the plain scores within K5's rtol 1e-5, atol 1e-4."""
    rng = np.random.default_rng(22)
    store = torch.from_numpy(rng.normal(size=(2, 8, 128, 64)).astype(np.float32) / 8).to(torch.bfloat16)
    q = torch.from_numpy(_queries(23, 3, nq, 64))
    pieces = tt.query_pieces(q)
    n = -(-nq // 64)
    assert tuple(pieces.shape) == ((3, nq, 64) if nq <= 64 else (3 * n, 64, 64))
    got = tt.maxsim_tiled_plain(pieces, store).reshape(3, n, -1).sum(dim=1)
    np.testing.assert_allclose(got.numpy(), tt.maxsim_tiled_plain(q, store).numpy(), rtol=1e-5, atol=1e-4)
    plan = tt.maxsim_bf16_plan(3, nq, 8, 64, 2, H100_SMS)
    assert (plan.pieces, plan.b, plan.nq) == (n, 3 * n, min(nq, 64))
