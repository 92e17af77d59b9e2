"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips
without one. On a machine with a card (which has no jax, so skip the
JAX-side conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``-k "k1 or k2"`` for the two-tier search's kernels alone.)

Tolerance: K1 exactly equal; K2 to K5 and K8 to K10 rtol=1e-5, atol=1e-4
(fp32 sums in another order than the plain versions; K2 takes each fp32
query element as three bf16 terms on the tensor cores), and K8, K9 and K10
bit-equal to K5, K4 and K3 on the same data in tile-major layout (one
template each, so the same order of sums); K4/K5 bit-equal across two
calls and under any split of the doc tokens over the CTAs; K11 by K6's forward rule below;
K6's backward by the forward's
rule (rtol=1.6e-2, atol=2e-2 times the RMS of the gradient) against
``flash_attention_backward_plain``, the backward written out with the
kernels' own roundings (Delta from the forward's bf16 output, P and dS
rounded to bf16 for the tensor-core products) on the forward's output and
log-sum-exp: they differ only in the order of fp32 sums, up to 0.45 of that
tolerance on the H100. Against the exact gradient (autograd through the
plain version on the inputs upcast to fp32) both sit at the same distance,
to two digits in every case here, up to 1.7 times the 2% on random data with
few keys per row (a peaky softmax, or the first rows under a causal mask),
where outputs are of order 1 and single terms of dS are tens of times the
gradient's RMS; that check stays at atol=6e-2 times the RMS (at the
model's own shapes ``chip_smoke.py`` holds the backward to 2%); K6's
forward elementwise rtol=1.6e-2 (two bf16 ulps: both round the output, the
kernel rounds unnormalized probabilities to bf16 and divides at the end, the
plain version rounds normalized ones) and atol=2e-2 times the RMS of the
plain output (random q, k and v give outputs of RMS about sqrt(e / S), far
below 1). K11, and K6 under a causal mask with left padding (the decoder of the
Qwen2-VL family), are held by the same rule with the RMS taken per query row
(over its heads and dims): under a causal mask row i attends to i + 1 keys,
so the first rows have outputs of order 1 while the RMS over all rows is set
by the long ones (11 of 2.4 M elements of the causal GQA case missed the
global-RMS rule on the H100, all in the first rows: rounding, not a fault).
Q1a (the int8 row quantizer) and Q1b (the int8 GEMM and its epilogue) are
bit-equal to their plain versions: the int32 sums are exact and every
rounding is the same.
"""

import numpy as np
import pytest
import torch

from colpali_tpu_torch.ops.flash_attention import (
    BACKWARD_LAUNCHES_BY_HEAD_DIM,
    FLASH_ATTENTION,
    FLASH_ATTENTION_BWD,
    _forward_cuda,
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_plain,
)
from colpali_tpu_torch.ops.flash_seqmajor import FLASH_SEQMAJOR, flash_seqmajor, flash_seqmajor_plain
from colpali_tpu_torch.ops.maxsim_binary import BINARY_MAXSIM, binary_maxsim_tiled, binary_maxsim_tiled_plain
from colpali_tpu_torch.ops import maxsim_token_major as tm
from colpali_tpu_torch.ops.maxsim_tiled import (
    GATHER_RERANK,
    GATHER_RERANK_BF16,
    MAXSIM_BF16,
    MAXSIM_INT8,
    MAXSIM_INT8_BF16,
    _maxsim_bf16_cuda,
    gather_rerank_int8,
    gather_rerank_plain,
    maxsim_int8_tiled,
    maxsim_int8_tiled_plain,
    maxsim_int8mxu_tiled,
    maxsim_int8mxu_tiled_plain,
    maxsim_tiled,
    maxsim_tiled_plain,
    scales_to_tile_major,
    to_tile_major,
)
from colpali_tpu_torch.ops import quant_dense as qd
from colpali_tpu_torch.ops.quant import quantize_per_token
from colpali_tpu_torch.retrieval.store import CorpusIndex, DeviceIndexBuilder

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-4
K6_RTOL, K6_ATOL_RMS = 1.6e-2, 2e-2
K6_BWD_ORACLE_ATOL_RMS = 6e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _store(dev, n_tiles, np_, d, seed=0):
    g = _gen(dev, seed)
    store = torch.randint(-127, 128, (n_tiles, np_, 128, d), generator=g, device=dev, dtype=torch.int8)
    store[:, -2:] = 0  # zero-padded tokens, scale 1
    scales = torch.rand((n_tiles, np_, 128), generator=g, device=dev) + 0.5
    scales[:, -2:] = 1.0
    return store, scales


@pytest.mark.parametrize("b,nq,w,npc", [(1, 32, 4, 16), (4, 64, 4, 16), (2, 5, 2, 64), (64, 64, 4, 16),
                                        (4, 64, 4, 260), (3, 50, 4, 1040), (1, 7, 2, 33)])
def test_k1_equals_plain(dev, b, nq, w, npc):
    g = _gen(dev, b + nq)
    qw = torch.randint(-(2**31), 2**31 - 1, (b, nq, w), generator=g, device=dev, dtype=torch.int32)
    qv = (torch.rand((b, nq), generator=g, device=dev) > 0.2).float()
    dw = torch.randint(-(2**31), 2**31 - 1, (5, w, npc, 128), generator=g, device=dev, dtype=torch.int32)
    got = binary_maxsim_tiled(qw, qv, dw, 32 * w)
    assert torch.equal(got, binary_maxsim_tiled_plain(qw, qv, dw, 32 * w))


@pytest.mark.parametrize("d,b,nq,np_", [(64, 2, 8, 16), (128, 3, 64, 64), (256, 1, 5, 8), (128, 2, 200, 16)])
def test_k3_matches_plain(dev, d, b, nq, np_):
    store, scales = _store(dev, 4, np_, d)
    q = torch.randn((b, nq, d), generator=_gen(dev, 1), device=dev)
    qi, qs = quantize_per_token(q)
    got = maxsim_int8mxu_tiled(qi, qs, store, scales)
    torch.testing.assert_close(got, maxsim_int8mxu_tiled_plain(qi, qs, store, scales), rtol=RTOL, atol=ATOL)


# K3 and K10 on the tensor cores: every B, Nq and D of the grid at a short Np, then
# doc lengths 1 to 1,040 and tile counts (1, 131, 133) around the card's 132 SMs
K3_GRID = [(b, nq, d, 7, 3) for b in (1, 3, 8) for nq in (16, 32, 64) for d in (64, 128, 256)]
K3_SHAPES = [(8, 64, 128, 1, 131), (8, 64, 128, 64, 133), (1, 32, 128, 64, 131), (3, 16, 256, 1040, 1),
             (8, 64, 128, 1040, 2), (8, 32, 64, 64, 133), (1, 64, 256, 7, 1), (8, 16, 128, 64, 1)]
# D=320 (ColQwen3's head: five 64-byte swizzle chunks a row) on each side of every plan threshold: B * Nq of 32,
# 40 and 64 (whole blocks, N = 32 / 64), 128 (N = 128, one slot), then 3 and 8 queries of 64 and 2 of 128 (half
# blocks, 2 to 4 slots), a query of 200 tokens (two pieces), tile counts around the 132 SMs, up to 1,040 doc tokens
K3_D320 = [(1, 32, 320, 7, 3), (1, 40, 320, 7, 3), (1, 64, 320, 64, 131), (2, 64, 320, 7, 3), (1, 128, 320, 7, 2),
           (3, 64, 320, 64, 133), (8, 64, 320, 64, 3), (2, 128, 320, 7, 3), (1, 200, 320, 16, 2),
           (8, 16, 320, 1040, 1)]


@pytest.mark.parametrize("b,nq,d,np_,nt", K3_GRID + K3_SHAPES + K3_D320)
def test_k3_and_k10_match_plain_bit_equal_and_repeatable(dev, b, nq, d, np_, nt):
    store, scales = _store(dev, nt, np_, d, seed=b + nq + d + np_)
    q = torch.randn((b, nq, d), generator=_gen(dev, 7), device=dev)
    q[:, -1] = 0.0  # a padded query token
    qi, qs = quantize_per_token(q)
    got = maxsim_int8mxu_tiled(qi, qs, store, scales)
    torch.testing.assert_close(got, maxsim_int8mxu_tiled_plain(qi, qs, store, scales), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, maxsim_int8mxu_tiled(qi, qs, store, scales))
    docs_tm = store.permute(1, 0, 2, 3).reshape(np_, nt * 128, d).contiguous()
    scales_tm = scales.permute(1, 0, 2).reshape(np_, nt * 128).contiguous()
    assert torch.equal(tm.maxsim_pallas_int8mxu_tm(qi, qs, docs_tm, scales_tm), got)


@pytest.mark.parametrize("d,b,nq,np_,c", [(128, 1, 32, 64, 300), (64, 3, 7, 16, 50), (128, 2, 64, 64, 1),
                                           (128, 1, 64, 1040, 200), (128, 4, 64, 1040, 30), (64, 2, 9, 65, 40)])
def test_k2_matches_plain(dev, d, b, nq, np_, c):
    store, scales = _store(dev, 6, np_, d)
    q = torch.randn((b, nq, d), generator=_gen(dev, 2), device=dev)
    cand = torch.randint(0, 6 * 128, (b, c), generator=_gen(dev, 3), device=dev, dtype=torch.int32)
    got = gather_rerank_int8(q, store, scales, cand)
    torch.testing.assert_close(got, gather_rerank_plain(q, store, scales, cand), rtol=RTOL, atol=ATOL)


def test_k2_out_of_range_id_gives_nan(dev):
    store, scales = _store(dev, 2, 8, 64)
    q = torch.randn((1, 4, 64), device=dev)
    out = gather_rerank_int8(q, store, scales, torch.tensor([[0, 256, -1]], dtype=torch.int32, device=dev))
    assert torch.isfinite(out[0, 0]) and torch.isnan(out[0, 1:]).all()


# K1 on the single-bit tensor cores: (tiles, Npc, W, B, Nq) around the card's 132 SMs and 8-warp
# blocks, doc-token splits (Npc 1 to 1,040), words 2/4/8/10/12 (dim 320 is 10), B * Nq 1 to 256 and a query
# longer than 64 tokens
K1_CASES = [(1, 1, 4, 1, 1), (1, 16, 2, 1, 32), (64, 260, 4, 1, 64), (64, 260, 4, 4, 64), (131, 33, 4, 2, 7),
            (133, 16, 8, 1, 32), (7812, 16, 4, 1, 32), (7812, 16, 4, 4, 64), (3, 1040, 4, 3, 50), (2, 33, 8, 4, 64),
            (133, 1, 2, 8, 32), (5, 16, 4, 1, 200), (131, 260, 2, 1, 9), (64, 1040, 8, 1, 16), (1, 260, 4, 4, 64),
            (64, 260, 10, 1, 64), (131, 33, 10, 4, 65), (7812, 16, 10, 1, 32), (3, 1, 12, 2, 7), (133, 1040, 12, 1, 9)]


@pytest.mark.parametrize("nt,npc,w,b,nq", K1_CASES)
def test_k1_tensor_cores_equal_plain_and_repeat(dev, nt, npc, w, b, nq):
    g = _gen(dev, nt + npc + w + b + nq)
    qw = torch.randint(-(2**31), 2**31 - 1, (b, nq, w), generator=g, device=dev, dtype=torch.int32)
    qv = (torch.rand((b, nq), generator=g, device=dev) > 0.2).float()
    qw[:, -1], qv[:, -1] = 0, 0.0  # a padded query token
    dw = torch.randint(-(2**31), 2**31 - 1, (nt, w, npc, 128), generator=g, device=dev, dtype=torch.int32)
    dw[0, :, :, 5] = 0  # an empty doc
    got = binary_maxsim_tiled(qw, qv, dw, 32 * w)
    assert torch.equal(got, binary_maxsim_tiled_plain(qw, qv, dw, 32 * w))
    assert torch.equal(got, binary_maxsim_tiled(qw, qv, dw, 32 * w))


# K2 on the bf16 tensor cores, both stores: (D, B, Nq, Np, c) over query lengths 1 to 200, doc lengths 1 to
# 1,040 (tiles of 128 doc tokens, 32 at D=256, 16 at D=320) and candidate counts around two per CTA of 132
K2_CASES = [(128, 1, 1, 1, 1), (128, 1, 7, 9, 131), (128, 1, 64, 64, 1024), (128, 4, 64, 1040, 133),
            (64, 8, 65, 65, 131), (256, 2, 200, 257, 133), (128, 3, 200, 1040, 64), (64, 5, 7, 1040, 1),
            (256, 1, 64, 1040, 131), (128, 8, 64, 64, 1024), (64, 1, 1, 257, 1024), (256, 4, 65, 9, 1024),
            (128, 1, 64, 1040, 1024), (320, 1, 64, 1040, 131), (320, 4, 65, 9, 133), (320, 2, 1, 17, 1024),
            (320, 1, 200, 257, 1)]


def _rerank_inputs(dev, d, b, nq, np_, c, bf16, seed):
    nt = 3
    store, scales = _store(dev, nt, np_, d, seed=seed)
    if bf16:
        store, scales = (store.float() * (scales / 127)[..., None]).to(torch.bfloat16), None
    q = torch.randn((b, nq, d), generator=_gen(dev, seed + 1), device=dev)
    cand = torch.randint(0, nt * 128, (b, c), generator=_gen(dev, seed + 2), device=dev, dtype=torch.int32)
    return q, store, scales, cand


@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
@pytest.mark.parametrize("d,b,nq,np_,c", K2_CASES)
def test_k2_tensor_cores_match_plain_and_repeat(dev, d, b, nq, np_, c, bf16):
    q, store, scales, cand = _rerank_inputs(dev, d, b, nq, np_, c, bf16, seed=d + b + nq + np_ + c)
    q[:, -1] = 0.0  # a padded query token
    got = gather_rerank_int8(q, store, scales, cand)
    torch.testing.assert_close(got, gather_rerank_plain(q, store, scales, cand), rtol=RTOL, atol=ATOL)
    assert torch.equal(got, gather_rerank_int8(q, store, scales, cand))


@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
def test_k2_tensor_cores_keep_fp32_accuracy_over_six_decades(dev, bf16):
    """Query elements from 1e-3 to 1e3 in magnitude: a split of the fp32
    query that dropped low bits would miss the tolerance here."""
    q, store, scales, cand = _rerank_inputs(dev, 128, 2, 64, 1040, 256, bf16, seed=11)
    q = q * 10.0 ** (6 * torch.rand(q.shape, generator=_gen(dev, 12), device=dev) - 3)
    got = gather_rerank_int8(q, store, scales, cand)
    torch.testing.assert_close(got, gather_rerank_plain(q, store, scales, cand), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["int8", "bf16"])
def test_k2_tensor_cores_give_nan_for_ids_outside_the_store(dev, bf16):
    q, store, scales, cand = _rerank_inputs(dev, 128, 3, 64, 65, 133, bf16, seed=13)
    cand[0, 5], cand[1, 0], cand[2, 132] = -1, 3 * 128, 2**31 - 1
    got = gather_rerank_int8(q, store, scales, cand)
    bad = torch.zeros_like(got, dtype=torch.bool)
    bad[0, 5] = bad[1, 0] = bad[2, 132] = True
    assert torch.isnan(got[bad]).all() and torch.isfinite(got[~bad]).all()
    fixed = torch.where(bad, torch.zeros_like(cand), cand)
    torch.testing.assert_close(got[~bad], gather_rerank_plain(q, store, scales, fixed)[~bad], rtol=RTOL, atol=ATOL)


def test_launch_counters_count_kernel_launches_only(dev):
    store, scales = _store(dev, 2, 8, 128)
    q = torch.randn((1, 4, 128), device=dev)
    qi, qs = quantize_per_token(q)
    cand = torch.zeros((1, 3), dtype=torch.int32, device=dev)
    before = (MAXSIM_INT8.launches, GATHER_RERANK.launches, BINARY_MAXSIM.launches)
    maxsim_int8mxu_tiled(qi, qs, store, scales)
    gather_rerank_int8(q, store, scales, cand)
    maxsim_int8mxu_tiled_plain(qi, qs, store, scales)
    gather_rerank_plain(q, store, scales, cand)
    assert (MAXSIM_INT8.launches, GATHER_RERANK.launches, BINARY_MAXSIM.launches) == \
        (before[0] + 1, before[1] + 1, before[2])


def test_wrappers_reject_bad_inputs(dev):
    store, scales = _store(dev, 2, 8, 128)
    qi, qs = quantize_per_token(torch.randn((1, 4, 128), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        maxsim_int8mxu_tiled(qi, qs, store.transpose(0, 1).contiguous().transpose(0, 1), scales)
    with pytest.raises(TypeError, match="dtype"):
        maxsim_int8mxu_tiled(qi, qs.double(), store, scales)
    with pytest.raises(ValueError, match="is on"):
        maxsim_int8mxu_tiled(qi.cpu(), qs, store, scales)
    with pytest.raises(TypeError, match="dtype"):
        maxsim_tiled(torch.zeros((1, 4, 128), device=dev), store)  # an int8 store is K4's
    for d in (40, 96):  # K4/K5 on the card: D 64, 128, 256 or 320 (96 is a multiple of 16 all the same)
        with pytest.raises(ValueError, match="built for dims"):
            maxsim_tiled(torch.zeros((1, 4, d), device=dev), torch.zeros((1, 4, 128, d), device=dev).bfloat16())
    with pytest.raises(ValueError, match="are on"):
        maxsim_int8_tiled(torch.zeros((1, 4, 128)), store, scales)
    with pytest.raises(ValueError, match="built for dims"):  # K2 on the card: D 64, 128, 256 or 320
        gather_rerank_int8(torch.zeros((1, 4, 96), device=dev), torch.zeros((1, 8, 128, 96), device=dev).to(torch.int8),
                           torch.ones((1, 8, 128), device=dev), torch.zeros((1, 2), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="up to 12 words"):  # K1 on the card: dim 384 at most
        binary_maxsim_tiled(torch.zeros((1, 4, 13), dtype=torch.int32, device=dev), torch.ones((1, 4), device=dev),
                            torch.zeros((1, 13, 4, 128), dtype=torch.int32, device=dev), 416)
    with pytest.raises(TypeError, match="dtype"):  # scales go with an int8 store only
        gather_rerank_int8(torch.zeros((1, 4, 128), device=dev), store.to(torch.bfloat16), scales,
                           torch.zeros((1, 2), dtype=torch.int32, device=dev))
    with pytest.raises(TypeError, match="bfloat16 corpus"):  # K8 on the card: bf16 only
        tm.maxsim_pallas_tm(torch.zeros((1, 4, 128), device=dev), torch.zeros((8, 256, 128), device=dev))
    q = torch.zeros((1, 8, 1, 80), device=dev, dtype=torch.bfloat16, requires_grad=True)
    seg = torch.ones((1, 8), dtype=torch.int32, device=dev)
    q96 = torch.zeros((1, 8, 1, 96), device=dev, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(ValueError, match="built for head dims"):
        flash_attention(q96, q96, q96, seg, 0.1)  # K6: D 64, 72, 80, 128 and 256 only
    q64 = torch.zeros((1, 8, 1, 64), device=dev, dtype=torch.bfloat16, requires_grad=True)
    before = FLASH_ATTENTION_BWD.launches
    flash_attention(q64, q64, q64, seg, 0.1).sum().backward()  # its backward: every head dim of the forward
    assert FLASH_ATTENTION_BWD.launches == before + 1 and torch.isfinite(q64.grad).all()
    with pytest.raises(ValueError, match="forward only"):
        flash_seqmajor(q, q, q, seg, 0.1)


@pytest.mark.parametrize("coarse_pool", [1, 4])
def test_index_on_card_matches_index_on_cpu(dev, coarse_pool):
    rng = np.random.default_rng(0)
    docs = rng.normal(size=(700, 32, 128)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    docs[::7, 20:] = 0.0  # shorter docs
    kw = dict(dtype="int8", prefilter="binary", coarse_pool=coarse_pool)
    # built in two parts through extend (the /add path) on both devices: a
    # repacked tail tile's sign sketch may differ from a one-shot build
    cpu, gpu = CorpusIndex(list(docs[:500]), device="cpu", **kw), CorpusIndex(list(docs[:500]), device=dev, **kw)
    for index in (cpu, gpu):
        index.extend(list(docs[500:]))
    for ours, theirs in ((gpu._store, cpu._store), (gpu._scales, cpu._scales), (gpu._bwords, cpu._bwords)):
        assert torch.equal(ours.cpu(), theirs)
    queries = [docs[3][:12], docs[650][:20], rng.normal(size=(9, 128)).astype(np.float32)]
    for search in ("exact_search", "search"):
        (s_cpu, i_cpu), (s_gpu, i_gpu) = getattr(cpu, search)(queries, k=8), getattr(gpu, search)(queries, k=8)
        np.testing.assert_array_equal(i_gpu, i_cpu)
        np.testing.assert_allclose(s_gpu, s_cpu, rtol=RTOL, atol=ATOL)
    assert i_gpu[0, 0] == 3 and i_gpu[1, 0] == 650


def test_index_save_load_on_card(dev, tmp_path):
    rng = np.random.default_rng(1)
    docs = list(rng.normal(size=(300, 16, 128)).astype(np.float32))
    index = CorpusIndex(docs, dtype="int8", prefilter="binary", coarse_pool=2, device=dev)
    index.save(str(tmp_path / "index.npz"))
    loaded = CorpusIndex.load(str(tmp_path / "index.npz"), device=dev)
    assert loaded._store.device == dev and loaded.nbytes == index.nbytes
    for a, b in zip(loaded.search(docs[:2], k=5), index.search(docs[:2], k=5)):
        np.testing.assert_array_equal(a, b)


K6_CASES = [
    # b, s, h, hkv, d, pad, causal
    (2, 1024, 16, 16, 72, 0, False),  # SigLIP-So400m
    (2, 1029, 8, 1, 256, 0, False),  # Gemma-2B over a page
    (8, 32, 8, 1, 256, 13, False),  # a padded query batch
    (2, 200, 4, 2, 72, 17, True),  # GQA, causal, ragged last tile
    (3, 33, 2, 2, 256, 4, False),  # one partial tile
    (2, 200, 6, 2, 256, 0, False),  # GQA groups of 3 heads: the last CTA's second consumer is idle
    (2, 300, 6, 2, 72, 0, True),  # the same at D=72, causal
    (2, 256, 4, 4, 80, 0, False),  # D=80: the 16-dim chunk holds data, no zero-fill
    (8, 14, 8, 1, 256, 3, False),  # fewer rows than one consumer's 64
    (1, 2464, 16, 16, 80, 0, False),  # ColQwen2's vision tower: many key tiles through the ring
]


def _assert_k6_close(got, want, atol_rms=K6_ATOL_RMS):
    atol = atol_rms * want.float().pow(2).mean().sqrt().item()
    torch.testing.assert_close(got, want, rtol=K6_RTOL, atol=atol)


@pytest.mark.parametrize("b,s,h,hkv,d,pad,causal", K6_CASES)
def test_k6_matches_plain(dev, b, s, h, hkv, d, pad, causal):
    g = _gen(dev, s + d)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev).to(torch.bfloat16) for n in (h, hkv, hkv))
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    if pad:
        seg[-1, s - pad :] = 0  # pad keys and rows in segment 0
    got = flash_attention(q, k, v, seg, d**-0.5, causal)
    _assert_k6_close(got, flash_attention_plain(q, k, v, seg, d**-0.5, causal))


def test_k6_reads_strided_views_and_counts_launches(dev):
    """q, k and v as head slices of one fused projection (no copies)."""
    b, s, h, hkv, d = 2, 130, 8, 1, 256
    qkv = torch.randn((b, s, h + 2 * hkv, d), generator=_gen(dev, 5), device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h : h + hkv], qkv[:, :, h + hkv :]
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    before = FLASH_ATTENTION.launches
    got = flash_attention(q, k, v, seg, d**-0.5)
    want = flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), seg, d**-0.5)
    assert FLASH_ATTENTION.launches == before + 1
    _assert_k6_close(got, want)
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.float(), k.float(), v.float(), seg, d**-0.5)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :96], k[..., :96], v[..., :96], seg, 96**-0.5)
    assert FLASH_ATTENTION.launches == before + 1


def test_k6_reads_a_fused_projection_at_d72(dev):
    """16 query heads and one KV head as slices of one fused q|k|v
    projection at D=72: a row stride of 18 * 72 elements and head bases 144
    bytes apart, which the tensor maps take as they are."""
    b, s, h, d = 2, 300, 16, 72
    qkv = torch.randn((b, s, h + 2, d), generator=_gen(dev, 13), device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :h], qkv[:, :, h : h + 1], qkv[:, :, h + 1 :]
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    seg[1, 250:] = 0
    got = flash_attention(q, k, v, seg, d**-0.5)
    _assert_k6_close(got, flash_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), seg, d**-0.5))


# K4/K5 shapes (nt, Np, B, Nq, D): the first cut's, then the eval index (one tile of 1,040 tokens, B=128 Nq=16) and
# the served B=8 Nq=64; D 64/128/256/320; Nq 1/7/16/64/65/200; each side of the plan's thresholds: one query slot or
# two (B*Nq 64 / 96 rows at Nq=32), a pair of slots at D <= 128 or one at 256, an odd slot count (a consumer idle),
# and segments (tiles x CTAs a tile) below the card's SMs (split doc tokens) or at and above it (whole segments)
K45_SHAPES = [(6, 64, 1, 32, 128), (6, 64, 8, 32, 128), (2, 1040, 8, 32, 128), (4, 16, 3, 7, 64),
              (3, 16, 2, 200, 128), (4, 9, 5, 16, 256), (1, 33, 70, 1, 128),
              (1, 1040, 128, 16, 128), (6, 64, 8, 64, 128), (3, 40, 4, 64, 320), (5, 24, 3, 16, 64),
              (2, 16, 2, 65, 256), (2, 32, 2, 32, 128), (2, 32, 3, 32, 128), (2, 32, 5, 32, 128),
              (131, 8, 1, 64, 128), (132, 8, 1, 64, 128), (133, 8, 2, 64, 128), (66, 8, 3, 32, 128),
              (67, 8, 3, 32, 64), (1, 1, 200, 1, 320), (7, 64, 1, 7, 256)]


@pytest.mark.parametrize("nt,np_,b,nq,d", K45_SHAPES)
def test_k4_and_k5_match_plain(dev, nt, np_, b, nq, d):
    store, scales = _store(dev, nt, np_, d, seed=nq)
    scales = scales / (127 * d**0.5)
    scales[:, -2:] = 1.0
    q = torch.randn((b, nq, d), generator=_gen(dev, 4), device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    q[:, -1] = 0.0  # a padded query token
    before = (MAXSIM_INT8_BF16.launches, MAXSIM_BF16.launches)
    torch.testing.assert_close(maxsim_int8_tiled(q, store, scales), maxsim_int8_tiled_plain(q, store, scales),
                               rtol=RTOL, atol=ATOL)
    bf16_store = (store.float() * scales[..., None]).to(torch.bfloat16)
    torch.testing.assert_close(maxsim_tiled(q, bf16_store), maxsim_tiled_plain(q, bf16_store), rtol=RTOL, atol=ATOL)
    assert (MAXSIM_INT8_BF16.launches, MAXSIM_BF16.launches) == (before[0] + 1, before[1] + 1)


# bit for bit: forced splits of the doc tokens over the CTAs (never, the plan's choice, 37 CTAs, one a block), two
# calls, and K8/K9 against K5/K4 in tile-major layout
K45_BITS = [(1, 1040, 128, 16, 128), (3, 40, 4, 64, 320), (2, 16, 2, 65, 256), (5, 24, 3, 16, 64),
            (6, 64, 8, 64, 128), (1, 33, 70, 1, 128)]


@pytest.mark.parametrize("nt,np_,b,nq,d", K45_BITS)
def test_k4_and_k5_bit_equal_across_splits_calls_and_layouts(dev, nt, np_, b, nq, d):
    store, scales = _store(dev, nt, np_, d, seed=nq + d)
    scales = scales / (127 * d**0.5)
    bstore = (store.float() * scales[..., None]).to(torch.bfloat16)
    q = torch.randn((b, nq, d), generator=_gen(dev, 5), device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    for kernel, st, sc, tm_kernel in ((MAXSIM_INT8_BF16, store, scales, tm.MAXSIM_INT8_BF16_TM),
                                      (MAXSIM_BF16, bstore, None, tm.MAXSIM_BF16_TM)):
        runs = [_maxsim_bf16_cuda(kernel, q, st, sc, np_, nt, split_ctas=k) for k in (0, None, 37, nt * np_, None)]
        for other in runs[1:]:
            assert torch.equal(runs[0], other)
        docs_tm = st.transpose(0, 1).reshape(np_, nt * 128, d).contiguous()  # (Np, C, D)
        scales_tm = None if sc is None else sc.transpose(0, 1).reshape(np_, nt * 128).contiguous()
        assert torch.equal(_maxsim_bf16_cuda(tm_kernel, q, docs_tm, scales_tm, np_, nt), runs[0])
        want = maxsim_tiled_plain(q, st) if sc is None else maxsim_int8_tiled_plain(q, st, sc)
        torch.testing.assert_close(runs[0], want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype,quantize_queries", [("bf16", True), ("int8", False)])
def test_bf16_and_unquantized_indexes_search_on_card(dev, dtype, quantize_queries):
    rng = np.random.default_rng(2)
    docs = rng.normal(size=(300, 24, 128)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    kw = dict(dtype=dtype, quantize_queries=quantize_queries)
    cpu, gpu = CorpusIndex(list(docs), device="cpu", **kw), CorpusIndex(list(docs), device=dev, **kw)
    queries = [docs[5][:9], docs[222][:16]]
    (s_cpu, i_cpu), (s_gpu, i_gpu) = cpu.search(queries, k=6), gpu.search(queries, k=6)
    np.testing.assert_array_equal(i_gpu, i_cpu)
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=RTOL, atol=ATOL)
    assert i_gpu[0, 0] == 5 and i_gpu[1, 0] == 222


@pytest.mark.parametrize("kw", [dict(dtype="int8", prefilter="binary", coarse_pool=2), dict(dtype="bf16")], ids=str)
def test_device_index_builder_on_card_matches_host_packed_index(dev, kw):
    rng = np.random.default_rng(3)
    docs = rng.normal(size=(300, 32, 128)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    mask = np.ones((300, 32), np.float32)
    mask[::5, 20:] = 0.0
    index_builder = DeviceIndexBuilder(doc_tokens=32, dim=128, **kw)
    for a, b in ((0, 100), (100, 160), (160, 300)):  # adds that straddle the 128-doc tiles
        index_builder.add(torch.from_numpy(docs[a:b]).to(dev), mask=torch.from_numpy(mask[a:b]).to(dev))
    index = index_builder.build()
    host = CorpusIndex([d[m > 0] for d, m in zip(docs, mask)], device=dev, doc_tokens=32, **kw)
    assert index._store.device == dev and index.num_docs == host.num_docs and index.nbytes == host.nbytes
    if kw["dtype"] == "bf16":
        assert torch.equal(index._store, host._store)
    else:  # the device scale is absmax * fp32(1/127), the host's absmax / 127: a last-bit gap
        assert (index._store.int() - host._store.int()).abs().max().item() <= 1
        torch.testing.assert_close(index._scales, host._scales, rtol=2e-7, atol=0)
    queries = [docs[3][:12], docs[250][:20]]
    (s_a, i_a), (s_b, i_b) = index.search(queries, k=5), host.search(queries, k=5)
    np.testing.assert_array_equal(i_a, i_b)
    np.testing.assert_allclose(s_a, s_b, rtol=1e-4)


K6_BWD_CASES = K6_CASES + [
    (2, 130, 8, 2, 256, 0, True),
    (2, 200, 16, 2, 128, 0, True),  # Qwen2.5-VL-3B's decoder: GQA 16/2, causal
    (2, 130, 12, 2, 128, 9, False),  # Qwen2-VL-2B's heads, padded, a token alone in its segment
    (3, 33, 4, 4, 80, 4, False),  # D=80, one partial tile
]


@pytest.mark.parametrize("b,s,h,hkv,d,pad,causal", K6_BWD_CASES)
def test_k6_backward_matches_plain_and_is_deterministic(dev, b, s, h, hkv, d, pad, causal):
    g = _gen(dev, s + d + 1)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
               for n in (h, hkv, hkv))
    d_out = torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16)
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    if pad:
        seg[-1, s - pad :] = 0
        seg[0, 3] = 7  # a token alone in its segment: its only key is itself
    before = FLASH_ATTENTION_BWD.launches
    got = torch.autograd.grad(flash_attention(q, k, v, seg, d**-0.5, causal), (q, k, v), d_out)
    again = torch.autograd.grad(flash_attention(q, k, v, seg, d**-0.5, causal), (q, k, v), d_out)
    assert FLASH_ATTENTION_BWD.launches == before + 2
    # the oracle in fp32: autograd through the plain version on the upcast inputs
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(flash_attention_plain(qf, kf, vf, seg, d**-0.5, causal), (qf, kf, vf), d_out.float())
    # the same arithmetic in plain PyTorch, from what the forward kernel wrote
    with torch.no_grad():
        out, lse = _forward_cuda(q, k, v, seg, d**-0.5, causal, True)
        rounded = flash_attention_backward_plain(q, k, v, seg, d_out, d**-0.5, causal, out=out, lse=lse)
    shares = []  # of the 2% rule at the worst element: kernels~rounded plain, kernels~exact, rounded plain~exact
    for a, a2, r, w in zip(got, again, rounded, want):
        assert torch.equal(a, a2)  # no atomics: two calls agree bit for bit
        assert a.dtype == torch.bfloat16 and a.shape == w.shape and torch.isfinite(a).all()
        a, r, atol = a.float(), r.float(), K6_ATOL_RMS * w.pow(2).mean().sqrt().item()
        shares.append(tuple(round(((x - y).abs() / (atol + K6_RTOL * y.abs())).max().item(), 2)
                            for x, y in ((a, r), (a, w), (r, w))))
        torch.testing.assert_close(a, r, rtol=K6_RTOL, atol=atol)
        _assert_k6_close(a, w, K6_BWD_ORACLE_ATOL_RMS)
    print(f"K6 backward B={b} S={s} H={h}/{hkv} D={d} pad={pad} causal={causal}: shares of the 2% rule (kernels~rounded "
          f"plain, kernels~exact, rounded plain~exact) dq {shares[0]} dk {shares[1]} dv {shares[2]}")
    if pad and not causal:  # softmax over one key: dq is zero up to the rounding of rowsum(dO * o)
        assert got[0][0, 3].float().abs().max().item() <= 1e-4


def test_k6_backward_reads_strided_inputs_and_any_d_out(dev):
    b, s, h, hkv, d = 2, 130, 8, 1, 256
    qkv = torch.randn((b, s, h + 2 * hkv, d), generator=_gen(dev, 6), device=dev).to(torch.bfloat16).requires_grad_()
    q, k, v = qkv[:, :, :h], qkv[:, :, h : h + hkv], qkv[:, :, h + hkv :]
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    d_out = torch.randn((b, h, s, d), generator=_gen(dev, 7), device=dev).to(torch.bfloat16).transpose(1, 2)
    assert not d_out.is_contiguous()
    (got,) = torch.autograd.grad(flash_attention(q, k, v, seg, d**-0.5), qkv, d_out)
    qf = qkv.detach().float().requires_grad_()
    out = flash_attention_plain(qf[:, :, :h], qf[:, :, h : h + hkv], qf[:, :, h + hkv :], seg, d**-0.5)
    (want,) = torch.autograd.grad(out, qf, d_out.float())
    _assert_k6_close(got.float(), want, K6_BWD_ORACLE_ATOL_RMS)
    with torch.no_grad():
        before = FLASH_ATTENTION_BWD.launches
        flash_attention(q, k, v, seg, d**-0.5)  # no gradient wanted: the forward alone
        assert FLASH_ATTENTION_BWD.launches == before


@pytest.mark.parametrize("d,b,nq,np_,c", [(128, 1, 32, 64, 256), (128, 8, 32, 64, 384), (128, 2, 64, 1040, 128),
                                           (64, 3, 7, 16, 512), (256, 5, 16, 9, 256)])
def test_k2_over_a_bf16_store_matches_plain(dev, d, b, nq, np_, c):
    store, scales = _store(dev, 4, np_, d)
    bstore = (store.float() * (scales / 127)[..., None]).to(torch.bfloat16)
    q = torch.randn((b, nq, d), generator=_gen(dev, 8), device=dev)
    cand = torch.randint(0, 4 * 128, (b, c), generator=_gen(dev, 9), device=dev, dtype=torch.int32)
    before = (GATHER_RERANK.launches, GATHER_RERANK_BF16.launches)
    got = gather_rerank_int8(q, bstore, None, cand)
    assert (GATHER_RERANK.launches, GATHER_RERANK_BF16.launches) == (before[0], before[1] + 1)
    torch.testing.assert_close(got, gather_rerank_plain(q, bstore, None, cand), rtol=RTOL, atol=ATOL)


def test_bf16_two_tier_index_searches_on_card(dev):
    """A bf16 index with the binary prefilter (the default dtype on the
    two-tier route) searches through K1 and K2 on the card."""
    rng = np.random.default_rng(4)
    docs = rng.normal(size=(400, 40, 128)).astype(np.float32)
    docs /= np.linalg.norm(docs, axis=-1, keepdims=True)
    kw = dict(dtype="bf16", prefilter="binary", coarse_pool=4)
    cpu, gpu = CorpusIndex(list(docs), device="cpu", **kw), CorpusIndex(list(docs), device=dev, **kw)
    queries = [docs[7][:10], docs[333][:25]]
    before = GATHER_RERANK_BF16.launches
    (s_cpu, i_cpu), (s_gpu, i_gpu) = cpu.search(queries, k=5), gpu.search(queries, k=5)
    assert GATHER_RERANK_BF16.launches == before + 1
    np.testing.assert_array_equal(i_gpu, i_cpu)
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=RTOL, atol=ATOL)
    assert i_gpu[0, 0] == 7 and i_gpu[1, 0] == 333


def _token_major(dev, n_tiles, np_, d, seed):
    """A token-major int8 corpus (Np, C, D) with (Np, C) scales (zero-padded
    last tokens, scale 1) and its bf16 dequantization."""
    g = _gen(dev, seed)
    c = n_tiles * 128
    docs = torch.randint(-127, 128, (np_, c, d), generator=g, device=dev, dtype=torch.int8)
    scales = (torch.rand((np_, c), generator=g, device=dev) + 0.5) / (127 * d**0.5)
    docs[-2:], scales[-2:] = 0, 1.0
    return docs, scales, (docs.float() * scales[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("nt,np_,b,nq,d", [(6, 64, 1, 32, 128), (6, 64, 8, 32, 128), (2, 1040, 8, 32, 128),
                                           (4, 16, 3, 7, 64), (3, 16, 2, 200, 128), (4, 9, 5, 16, 256)])
def test_k8_k9_k10_match_plain_and_their_tile_major_kernels(dev, nt, np_, b, nq, d):
    docs, scales, bdocs = _token_major(dev, nt, np_, d, seed=nq + d)
    q = torch.randn((b, nq, d), generator=_gen(dev, 10), device=dev)
    q = q / q.norm(dim=-1, keepdim=True)
    q[:, -1] = 0.0  # a padded query token
    qi, qs = quantize_per_token(q)
    counters = (tm.MAXSIM_BF16_TM, tm.MAXSIM_INT8_BF16_TM, tm.MAXSIM_INT8_TM, MAXSIM_BF16, MAXSIM_INT8_BF16, MAXSIM_INT8)
    before = [k.launches for k in counters]
    k8 = tm.maxsim_pallas_tm(q, bdocs)
    k9 = tm.maxsim_pallas_int8_tm(q, docs, scales)
    k10 = tm.maxsim_pallas_int8mxu_tm(qi, qs, docs, scales)
    assert [k.launches - n for k, n in zip(counters, before)] == [1, 1, 1, 0, 0, 0]
    torch.testing.assert_close(k8, tm.maxsim_pallas_tm_plain(q, bdocs), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(k9, tm.maxsim_pallas_int8_tm_plain(q, docs, scales), rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(k10, tm.maxsim_pallas_int8mxu_tm_plain(qi, qs, docs, scales), rtol=RTOL, atol=ATOL)
    store, tscales = to_tile_major(docs).contiguous(), scales_to_tile_major(scales).contiguous()
    assert torch.equal(k8, maxsim_tiled(q, to_tile_major(bdocs).contiguous()))
    assert torch.equal(k9, maxsim_int8_tiled(q, store, tscales))
    assert torch.equal(k10, maxsim_int8mxu_tiled(qi, qs, store, tscales))


def test_k8_top_k_and_doc_major_entry(dev):
    _, _, bdocs = _token_major(dev, 3, 16, 128, seed=11)
    q = torch.randn((2, 8, 128), generator=_gen(dev, 12), device=dev)
    scores, ids = tm.maxsim_topk_tm(q, bdocs, k=20)
    want = tm.maxsim_pallas_tm(q, bdocs)
    assert ids.dtype == torch.int32 and torch.equal(scores, torch.gather(want, 1, ids.long()))
    assert torch.equal(torch.sort(want, dim=1, descending=True, stable=True)[1][:, :20].int(), ids)
    assert torch.equal(tm.maxsim_pallas(q, tm.to_token_major(bdocs)), want)  # doc-major in, made token-major


K11_CASES = [
    # b, s, h, hkv, d, pad, causal
    (2, 1024, 16, 16, 80, 31, False),  # the seq-major probe's validation shape
    (2, 300, 16, 16, 72, 0, False),
    (2, 768, 12, 2, 128, 0, False),  # GQA 12/2
    (2, 768, 12, 2, 128, 0, True),
    (1, 200, 4, 2, 80, 17, True),
]


@pytest.mark.parametrize("b,s,h,hkv,d,pad,causal", K11_CASES)
def test_k11_matches_plain(dev, b, s, h, hkv, d, pad, causal):
    g = _gen(dev, s + d + 2)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev).to(torch.bfloat16) for n in (h, hkv, hkv))
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    if pad:
        seg[0, s - pad :] = 0
    before = (FLASH_SEQMAJOR.launches, FLASH_ATTENTION.launches)
    got = flash_seqmajor(q, k, v, seg.long(), d**-0.5, causal)
    assert (FLASH_SEQMAJOR.launches, FLASH_ATTENTION.launches) == (before[0] + 1, before[1])
    rows = seg.bool()
    got, want = got[rows].float(), flash_seqmajor_plain(q, k, v, seg, d**-0.5, causal)[rows].float()
    atol = K6_ATOL_RMS * want.pow(2).mean(dim=(1, 2), keepdim=True).sqrt()  # per query row
    share = ((got - want).abs() / (atol + K6_RTOL * want.abs())).max().item()
    assert share <= 1.0, f"K11 vs plain: {share:.2f} of the tolerance at the worst element"


@pytest.mark.parametrize("hw,size", [((40, 30), 28), ((1650, 1275), 448), ((300, 200), 448)])
def test_device_resize_on_card_matches_its_cpu_run(dev, hw, size):
    from colpali_tpu_torch.processors.image_processing import preprocess_images_fixed

    pages = [np.random.default_rng(s).integers(0, 256, size=(*hw, 3), dtype=np.uint8) for s in range(2)]
    on_card = preprocess_images_fixed(pages, size=(size, size), device=dev)
    assert on_card.device == dev and on_card.shape == (2, size, size, 3)
    cpu = preprocess_images_fixed(pages, size=(size, size))
    np.testing.assert_allclose(on_card.cpu().numpy(), cpu, atol=1e-5)


def _activations(dev, m, k, dtype, seed):
    """Rows of scale 3, a zero row and a row of exact .5 ties (absmax 254:
    scale 254 * fp32(1/127), the values multiples of it plus a half)."""
    x = torch.randn((m, k), generator=_gen(dev, seed), device=dev) * 3
    if m > 2:
        x[1] = 0.0
        s = torch.tensor(254.0) * qd._INV_127
        x[2] = ((torch.arange(k, device=dev) % 21) - 9.5) * s
        x[2, 0] = 127.0 * s
    return x.to(dtype)


@pytest.mark.parametrize("m,k", [(1, 1152), (17, 4304), (32, 2048), (256, 16384), (8232, 16384), (3, 40), (5, 4302),
                                 (23808, 1176), (17, 3420), (5952, 3420)])  # Qwen: bf16 rows on 16 bytes, and not
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_q1a_quantize_rows_equals_plain(dev, m, k, dtype):
    x = _activations(dev, m, k, dtype, seed=m + k)
    q, s = qd.quantize_rows(x)
    want_q, want_s = qd.quantize_rows_plain(x)
    assert q.dtype == torch.int8 and s.shape == (m, 1) and (m == 1 or q.stride(0) == qd.row_stride(k))
    assert torch.equal(s, want_s) and torch.equal(q, want_q)


# every (K, N) of ColPali-3B's quantized projections, the page and query batch sizes, and odd edges
Q1B_CASES = [(m, k, n) for k, n in ((1152, 1152), (1152, 4304), (4304, 1152), (1152, 2048), (2048, 2048),
                                   (2048, 16384), (16384, 2048)) for m in (1, 17, 256)]
Q1B_CASES += [(8232, 2048, 16384), (8192, 4304, 1152), (130, 48, 130), (5, 32, 7), (129, 144, 257)]


@pytest.mark.parametrize("m,k,n", Q1B_CASES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_q1b_int8_gemm_equals_plain(dev, m, k, n, out_dtype):
    g = _gen(dev, m + k + n)
    a, a_scale = qd.quantize_rows(_activations(dev, m, k, torch.bfloat16, seed=m))
    b = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    b_scale = torch.rand((n,), generator=g, device=dev) * 0.01 + 1e-4
    bias = torch.randn((n,), generator=g, device=dev).to(out_dtype)
    for bias_ in (None, bias):
        got = qd.int8_gemm(a, a_scale.reshape(m, 1), b, b_scale, bias_, out_dtype)
        want = qd.int8_gemm_plain(a, a_scale.reshape(m, 1), b, b_scale, bias_, out_dtype)
        assert got.dtype == out_dtype and got.shape == (m, n)
        assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()


def test_q1_layers_launch_their_kernels_and_never_the_plain_versions(dev):
    from unittest import mock

    from colpali_tpu_torch.models.layers import QDense, quantized_acts

    layer = QDense(1152, 4304, device=dev, dtype=torch.bfloat16)
    x = torch.randn((2, 9, 1152), generator=_gen(dev), device=dev).to(torch.bfloat16)
    refuse = mock.Mock(side_effect=AssertionError("a plain version ran on a CUDA tensor"))
    with mock.patch.object(qd, "quantize_rows_plain", refuse), mock.patch.object(qd, "int8_gemm_plain", refuse), \
            torch.no_grad():
        qd.QUANTIZE_ROWS.reset()
        qd.INT8_GEMM.reset()
        with quantized_acts():  # dynamic: the activations and the weight, then the product
            dynamic = layer(x)
        assert (qd.QUANTIZE_ROWS.launches, qd.INT8_GEMM.launches) == (2, 1)
        qd.quantize_params(layer)
        assert layer.stored and layer.weight.device == dev and layer.weight_scale.dtype == torch.float32
        stored = layer(x)
        assert (qd.QUANTIZE_ROWS.launches, qd.INT8_GEMM.launches) == (3, 2)
    assert dynamic.dtype == stored.dtype == torch.bfloat16 and torch.isfinite(stored.float()).all()
    with pytest.raises(ValueError, match="start on 16 bytes"):  # K = 40 packed: rows 40 bytes apart
        qd.int8_gemm(torch.zeros((2, 40), dtype=torch.int8, device=dev), torch.ones((2, 1), device=dev),
                     torch.zeros((8, 40), dtype=torch.int8, device=dev), torch.ones(8, device=dev))
    a, b = (qd.int8_rows((r, 40), dev, fill=torch.ones((r, 40), dtype=torch.int8, device=dev)) for r in (2, 8))
    assert torch.equal(qd.int8_gemm(a, torch.ones((2, 1), device=dev), b, torch.ones(8, device=dev)),
                       torch.full((2, 8), 40.0, dtype=torch.bfloat16, device=dev))  # the same K in 48-byte rows
    with pytest.raises(TypeError):
        qd.quantize_rows(torch.zeros((2, 64), dtype=torch.float16, device=dev))


# -- the Qwen2-VL family -------------------------------------------------------------

# (M, K, N): Qwen's patch embedding (K = 1,176), Qwen2.5-VL's vision gate/up (N = 3,420: bf16 rows of 6,840
# bytes, stored from the registers) and down_proj (K = 3,420), at one token, a few, a query batch and 8 pages
Q1_QWEN_CASES = [(m, k, n) for k, n in ((1176, 1280), (1280, 3420), (3420, 1280)) for m in (1, 17, 256)]
Q1_QWEN_CASES += [(23808, 1176, 1280), (23808, 1280, 3420), (23808, 3420, 1280)]


@pytest.mark.parametrize("m,k,n", Q1_QWEN_CASES)
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_q1_at_qwen_widths_equals_plain(dev, m, k, n, out_dtype):
    """K not a multiple of 16: the operands' rows padded to 16 bytes in
    their buffers (``int8_rows``), bit-equal to the plain versions."""
    g = _gen(dev, m + k + n)
    x = _activations(dev, m, k, torch.bfloat16, seed=m)
    a, a_scale = qd.quantize_rows(x)
    want_a, want_s = qd.quantize_rows_plain(x)
    assert torch.equal(a, want_a) and torch.equal(a_scale, want_s)
    b = qd.int8_rows((n, k), dev, fill=torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8))
    b_scale = torch.rand((n,), generator=g, device=dev) * 0.01 + 1e-4
    bias = torch.randn((n,), generator=g, device=dev).to(out_dtype)
    for bias_ in (None, bias):
        got = qd.int8_gemm(a, a_scale, b, b_scale, bias_, out_dtype)
        assert torch.equal(got, qd.int8_gemm_plain(a, a_scale, b, b_scale, bias_, out_dtype))


def test_stored_qdense_at_qwen_widths_survives_moves(dev):
    """A stored layer at K = 1,176 made on the CPU and moved to the card
    keeps 16-byte rows and gives its plain result there."""
    from colpali_tpu_torch.models.layers import QDense

    layer = QDense(1176, 1280, device="cpu", dtype=torch.bfloat16)
    qd.quantize_params(layer)
    x = torch.randn((3, 7, 1176), generator=_gen(dev, 3), device=dev).to(torch.bfloat16)
    want = qd.stored_int8_apply(x.cpu(), layer.weight, layer.weight_scale, torch.bfloat16, layer.bias)
    layer.to(dev)
    assert layer.weight.stride(0) == qd.row_stride(1176) and layer.weight_scale.dtype == torch.float32
    assert torch.equal(layer(x).cpu(), want)
    # the dynamic w8a8 mode at the same widths: the weight quantized on the call, into 16-byte rows
    w = torch.randn((3420, 1176), generator=_gen(dev, 4), device=dev).to(torch.bfloat16) * 0.02
    assert torch.equal(qd.int8_linear(x, w).cpu(), qd.int8_linear(x.cpu(), w.cpu()))


def _window_segments(dev, b, grid=(20, 24), pad=0):
    """Qwen2.5-VL's window ids (-1 on padding) of ``b`` pages of ``grid``
    patches, the last ``pad`` patches of the last page cut off as padding:
    windows of 4 x 4 merged units interleaved in merge order, so a 128-key
    tile holds several windows and a window is absent from most tiles."""
    from colpali_tpu_torch.processors.qwen2_5_vl import window_ids_from_positions
    from colpali_tpu_torch.processors.qwen2_vl import vision_positions

    thw = (1, *grid)
    ids = window_ids_from_positions(*vision_positions(thw), thw, 2, 4)
    seg = torch.from_numpy(np.tile(ids, (b, 1))).to(dev)
    if pad:
        seg[-1, -pad:] = -1
    return seg.contiguous()


@pytest.mark.parametrize("pad", [0, 100])
def test_k6_with_window_segments_matches_plain(dev, pad):
    b, h, d = 3, 16, 80
    seg = _window_segments(dev, b, pad=pad)
    s = seg.shape[1]
    g = _gen(dev, 80 + pad)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    for segments in (seg, torch.where(seg >= 0, 1, -1).to(torch.int32).contiguous()):  # windowed, then full blocks
        got = flash_attention(q, k, v, segments, d**-0.5)
        want = flash_attention_plain(q, k, v, segments, d**-0.5)
        rows = segments >= 0
        _assert_k6_close(got[rows], want[rows])


@pytest.mark.parametrize("h,hkv", [(12, 2), (16, 2), (32, 8)])
@pytest.mark.parametrize("s", [64, 760])
def test_k6_causal_gqa_with_left_padding_matches_plain(dev, h, hkv, s):
    """The decoder's attention: causal, D=128, rows left-padded by 0 to
    7 x 17 tokens (segment 0) and a query bucket's right padding; GQA 12/2
    and 16/2 (Qwen2-VL-2B, Qwen2.5-VL-3B) and 32/8 (Qwen3-VL-4B)."""
    b, d = 8, 128
    g = _gen(dev, h + s)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev).to(torch.bfloat16) for n in (h, hkv, hkv))
    pos = torch.arange(s, device=dev)[None]
    seg = ((pos >= 17 * torch.arange(b, device=dev)[:, None]) & (pos < s - 5)).to(torch.int32).contiguous()
    rows = seg.bool()
    got = flash_attention(q, k, v, seg, d**-0.5, True)[rows].float()
    want = flash_attention_plain(q, k, v, seg, d**-0.5, True)[rows].float()
    atol = K6_ATOL_RMS * want.pow(2).mean(dim=(1, 2), keepdim=True).sqrt()  # per query row, K11's causal rule
    share = ((got - want).abs() / (atol + K6_RTOL * want.abs())).max().item()
    assert share <= 1.0, f"K6 causal vs plain: {share:.2f} of the tolerance at the worst element"


def _assert_close_per_row(got, want, rows):
    """K6's rule with the RMS per query row (over heads and dims), on the rows that are not padding."""
    got, want = got[rows].float(), want[rows].float()
    atol = K6_ATOL_RMS * want.pow(2).mean(dim=(1, 2), keepdim=True).sqrt()
    share = ((got - want).abs() / (atol + K6_RTOL * want.abs())).max().item()
    assert share <= 1.0, f"{share:.2f} of the tolerance at the worst element"


QWEN_BWD_CASES = [
    # b, s, h, hkv, d, segments, causal
    (8, 64, 16, 2, 128, "left", True),  # the collated queries of Qwen2.5-VL-3B
    (8, 760, 16, 2, 128, "left", True),  # its decoder over pages, rows left-padded
    (8, 760, 12, 2, 128, "left", True),  # Qwen2-VL-2B's decoder
    (8, 64, 32, 8, 128, "left", True),  # Qwen3-VL-4B's collated queries: GQA ratio 4
    (8, 800, 32, 8, 128, "left", True),  # its decoder over pages
    (3, 480, 16, 16, 80, "window", False),  # the vision towers' windowed blocks
    (3, 480, 16, 16, 80, "full", False),  # their full-attention blocks (pad patches in segment -1)
]


@pytest.mark.parametrize("b,s,h,hkv,d,kind,causal", QWEN_BWD_CASES)
def test_k6_backward_at_qwen_shapes_matches_plain_per_row(dev, b, s, h, hkv, d, kind, causal):
    """K6's backward where LoRA and full fine-tuning of the Qwen2-VL family
    put it, against ``flash_attention_backward_plain`` by the forward's
    rule per query row (causal rows after left padding see few keys), and
    bit-equal on a second call."""
    g = _gen(dev, s + d + h)
    if kind == "left":
        pos = torch.arange(s, device=dev)[None]
        seg = ((pos >= 17 * torch.arange(b, device=dev)[:, None]) & (pos < s - 5)).to(torch.int32).contiguous()
    else:
        seg = _window_segments(dev, b, pad=100)
        if kind == "full":
            seg = torch.where(seg >= 0, 1, -1).to(torch.int32).contiguous()
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
               for n in (h, hkv, hkv))
    rows = seg > 0 if kind == "left" else seg >= 0
    d_out = torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16) * rows[:, :, None, None]
    before = FLASH_ATTENTION_BWD.launches
    got = torch.autograd.grad(flash_attention(q, k, v, seg, d**-0.5, causal), (q, k, v), d_out)
    again = torch.autograd.grad(flash_attention(q, k, v, seg, d**-0.5, causal), (q, k, v), d_out)
    assert FLASH_ATTENTION_BWD.launches == before + 2
    with torch.no_grad():
        out, lse = _forward_cuda(q, k, v, seg, d**-0.5, causal, True)
        want = flash_attention_backward_plain(q, k, v, seg, d_out, d**-0.5, causal, out=out, lse=lse)
    # a row whose only key is itself has dq = 0 up to the rounding of rowsum(dO * o): held apart, absolutely
    keys = seg[:, :, None] == seg[:, None, :]
    if causal:
        keys &= torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    alone = rows & (keys.sum(-1) == 1)
    for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(a, a2) and torch.isfinite(a).all()
        if name == "dq":
            assert a[alone].float().abs().max().item() <= 1e-4 if alone.any() else True
            _assert_close_per_row(a, w, rows & ~alone)
        else:
            _assert_close_per_row(a, w, rows)


def test_colqwen2_5_stored_int8_on_card_matches_cpu_route(dev, tmp_path):
    """``load_retriever(family="colqwen2_5", quantize=True)`` on a
    checkpoint written by the port (1,176-wide patch embedding, 3,420-wide
    vision MLP, D=80 vision and D=128 text heads), on the card against the
    same checkpoint on the CPU route, per token: K6 and Q1a/Q1b launched,
    their plain versions never run on the card."""
    from unittest import mock

    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.evaluation.evaluator import embed_dataset
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.qwen2_5_vl import ColQwen2_5, Qwen25VLConfig, Qwen25VLVisionConfig
    from colpali_tpu_torch.models.qwen2_vl import Qwen2TextConfig
    from colpali_tpu_torch.retrieval.serving import QueryEncoder
    from colpali_tpu_torch.utils.testing import qwen_word_tokenizer, write_qwen_checkpoint

    cfg = Qwen25VLConfig(vision=Qwen25VLVisionConfig(depth=2, hidden_size=640, num_heads=8, intermediate_size=3420,
                                                     out_hidden_size=512, fullatt_block_indexes=(1,)),
                         text=Qwen2TextConfig(vocab_size=151936, hidden_size=512, intermediate_size=1024,
                                              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                                              head_dim=128))
    model = ColQwen2_5(cfg, device="cpu", dtype=torch.bfloat16)
    hf_init_(model, torch.Generator().manual_seed(0))
    words = "find the page with revenue figures user Describe image.".split()
    write_qwen_checkpoint(str(tmp_path), model, qwen_word_tokenizer(words))
    pages = [np.random.default_rng(i).integers(0, 256, size=(420, 300, 3), dtype=np.uint8) for i in range(3)]
    queries = ["find the page", "revenue figures"]
    out = {}
    refuse = mock.Mock(side_effect=AssertionError("a plain version ran on a CUDA tensor"))
    for where in ("cpu", dev):
        m, proc = load_retriever(str(tmp_path), family="colqwen2_5", device=where, quantize=True)
        counts = (FLASH_ATTENTION.launches, qd.QUANTIZE_ROWS.launches, qd.INT8_GEMM.launches)
        patches = [] if where == "cpu" else [mock.patch.object(qd, "quantize_rows_plain", refuse),
                                             mock.patch.object(qd, "int8_gemm_plain", refuse)]
        for p in patches:
            p.start()
        try:
            out[str(where)] = (embed_dataset(m, proc, pages, batch_size=2) + QueryEncoder(m, proc).encode(queries))
        finally:
            for p in patches:
                p.stop()
        grew = [after - before for after, before in zip((FLASH_ATTENTION.launches, qd.QUANTIZE_ROWS.launches,
                                                         qd.INT8_GEMM.launches), counts)]
        assert all(grew) if where != "cpu" else not any(grew)
    a, b = np.concatenate(out[str(dev)]), np.concatenate(out["cpu"])
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
    assert np.isfinite(a).all() and cos.mean() >= 0.998 and cos.min() >= 0.99, (cos.mean(), cos.min())


def test_qwen_lora_step_on_card_matches_plain_route(dev):
    """One LoRA step of a small ColQwen2.5 in bf16 on the card (D=80 vision
    heads over windows, a causal GQA 4/2 decoder at D=128, remat): the loss
    and the adapter gradient through K6 and its backward kernels against the
    plain route (K6's plain version, autograd through it), on the smooth
    probe, phase 9's rule: loss within 1e-2 relative, gradient cosine >=
    0.99. The backward runs twice a decoder layer (queries and pages) at
    D=128 and never at D=80 (the tower is frozen)."""
    from unittest import mock

    from colpali_tpu_torch.data.collator import VisualRetrieverCollator
    from colpali_tpu_torch.losses import ColbertLoss
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.qwen2_5_vl import ColQwen2_5, Qwen25VLConfig, Qwen25VLVisionConfig
    from colpali_tpu_torch.models.qwen2_vl import Qwen2TextConfig
    from colpali_tpu_torch.ops import flash_attention as fa
    from colpali_tpu_torch.processors.qwen2_5_vl import ColQwen2_5Processor
    from colpali_tpu_torch.training import trainer
    from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec
    from colpali_tpu_torch.utils.testing import qwen_word_tokenizer

    cfg = Qwen25VLConfig(vision=Qwen25VLVisionConfig(depth=2, hidden_size=640, num_heads=8, intermediate_size=3420,
                                                     out_hidden_size=512, fullatt_block_indexes=(1,)),
                         text=Qwen2TextConfig(hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
                                              num_attention_heads=4, num_key_value_heads=2, head_dim=128))
    model = ColQwen2_5(cfg, device=dev, dtype=torch.bfloat16, remat=True)
    gen = _gen(dev, 11)
    hf_init_(model, gen)
    words = "find the page with revenue figures user Describe image.".split()
    proc = ColQwen2_5Processor(qwen_word_tokenizer(words), max_num_visual_tokens=256, device=dev)
    pages = [np.random.default_rng(i).integers(0, 256, size=(420, 300, 3), dtype=np.uint8) for i in range(4)]
    examples = [{"query": q, "pos_target": p} for q, p in zip(["find the page", "revenue figures", "the page",
                                                                  "figures"], pages)]
    batch = trainer.to_device(VisualRetrieverCollator(proc)(examples), dev)
    peft = LoraSpec(rank=8, alpha=16, dropout=0.1)
    adapters = LoraAdapters(model, peft)
    with torch.no_grad():
        for b in adapters.b:  # off zero, so that a takes a gradient too
            b.normal_(0.0, 0.02, generator=gen)
    state = trainer.create_train_state(model, trainer.TrainConfig(), adapters)
    loss_fn = ColbertLoss(use_smooth_max=True)

    def step():
        trainer.begin_step(state, peft, 0)
        loss, _, _ = trainer.compute_loss(model, batch, loss_fn, False)
        loss.backward()
        grad = torch.cat([p.grad.flatten().double() for p in state.params])
        state.optimizer.zero_grad(set_to_none=True)
        return loss.item(), grad

    before = dict(fa.BACKWARD_LAUNCHES_BY_HEAD_DIM)
    loss, grad = step()
    launched = {d: fa.BACKWARD_LAUNCHES_BY_HEAD_DIM[d] - before[d] for d in before}
    assert launched[128] == 2 * cfg.text.num_hidden_layers and launched[80] == 0, launched
    with mock.patch.object(fa, "flash_attention", fa.flash_attention_plain):
        plain_loss, plain_grad = step()
    cos = (grad @ plain_grad / (grad.norm() * plain_grad.norm())).item()
    assert np.isfinite(loss) and abs(loss - plain_loss) <= 1e-2 * abs(plain_loss), (loss, plain_loss)
    assert cos >= 0.99, cos
    adapters.detach()


# -- K6 at D=64: the Idefics3 (colSmol-256M) towers --------------------------------------------------------------------

D64_CASES = [
    # b, s, h, hkv, key padding (valid lengths of the rows), causal
    (16, 1024, 12, 12, None, False),  # the vision tower over 512 px tiles (16 of a batch's 104)
    (8, 880, 9, 3, (880, 870, 860, 850, 840, 830, 700, 600), True),  # the decoder over pages, right-padded
    (8, 32, 9, 3, (9, 12, 7, 20, 15, 11, 14, 10), True),  # the query encoder's bucket, right-padded
]


@pytest.mark.parametrize("b,s,h,hkv,lengths,causal", D64_CASES)
def test_k6_d64_matches_plain_and_is_bit_equal(dev, b, s, h, hkv, lengths, causal):
    """K6 at D=64 against its plain version, by K11's rule per query row
    under a causal mask; the decoder's rows under the key-padding mask
    (every query id 1, the keys' ids the validity mask: pad rows attend to
    the valid keys, as JAX's additive bias has it), so every row is held.
    Two calls agree bit for bit."""
    from colpali_tpu_torch.ops import flash_attention as fa

    d = 64
    g = _gen(dev, s + h)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev).to(torch.bfloat16) for n in (h, hkv, hkv))
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    keys = None
    if lengths is not None:
        keys = (torch.arange(s, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)
    before = fa.FORWARD_LAUNCHES_BY_HEAD_DIM[64]
    got = flash_attention(q, k, v, seg, d**-0.5, causal, kv_segments=keys)
    again = flash_attention(q, k, v, seg, d**-0.5, causal, kv_segments=keys)
    assert fa.FORWARD_LAUNCHES_BY_HEAD_DIM[64] == before + 2 and torch.equal(got, again)
    want = flash_attention_plain(q, k, v, seg, d**-0.5, causal, kv_segments=keys)
    if causal:
        _assert_close_per_row(got, want, torch.ones((b, s), dtype=torch.bool, device=dev))
    else:
        _assert_k6_close(got, want)


# K6's backward at D=64: colSmol's decoder (queries id 1, keys the validity mask) and vision tower
D64_BWD_CASES = [
    # b, s, h, hkv, key padding (valid lengths of the rows), causal, the keys' own ids
    (8, 866, 9, 3, (866, 858, 850, 842, 834, 826, 818, 810), True, True),  # the decoder over pages, under LoRA
    (8, 32, 9, 3, (9, 12, 7, 20, 15, 11, 14, 10), True, True),  # the collated queries, under LoRA
    (8, 866, 9, 3, (866, 858, 850, 842, 834, 826, 818, 810), True, False),  # one id array: pad rows see pad keys
    (16, 1024, 12, 12, None, False, False),  # the vision tower (16 of a batch's 104 tiles), full fine-tuning only
]


@pytest.mark.parametrize("b,s,h,hkv,lengths,causal,own_keys", D64_BWD_CASES)
def test_k6_d64_backward_matches_plain_per_row(dev, b, s, h, hkv, lengths, causal, own_keys):
    """K6's backward at D=64 against ``flash_attention_backward_plain`` by
    the forward's rule per query row (key row for dk and dv), bit-equal on
    a second call (a row whose only key is itself, the first under a causal
    mask, has dq = 0 up to rounding and is held at 1e-4 absolutely). With
    the keys' own ids every query row is held (pad rows
    attend to the valid keys, and their dO reaches those keys' dk and dv:
    ``last`` pooling reads such a row), and a pad key takes no gradient at
    all."""
    d = 64
    g = _gen(dev, s + h + own_keys)
    q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
               for n in (h, hkv, hkv))
    valid = torch.ones((b, s), dtype=torch.bool, device=dev)
    if lengths is not None:
        valid = torch.arange(s, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]
    mask = valid.to(torch.int32).contiguous()
    seg, keys = (torch.ones_like(mask), mask) if own_keys else (mask, None)
    rows = torch.ones_like(valid) if own_keys else valid  # query rows whose output is read
    allowed = seg[:, :, None] == (seg if keys is None else keys)[:, None, :]
    if causal:
        allowed &= torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    alone = rows & (allowed.sum(-1) == 1)  # its only key is itself: dq = 0 up to rounding, held absolutely
    d_out = torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16) * rows[:, :, None, None]
    before = (FLASH_ATTENTION_BWD.launches, BACKWARD_LAUNCHES_BY_HEAD_DIM[64])
    got = torch.autograd.grad(flash_attention(q, k, v, seg, d**-0.5, causal, kv_segments=keys), (q, k, v), d_out)
    again = torch.autograd.grad(flash_attention(q, k, v, seg, d**-0.5, causal, kv_segments=keys), (q, k, v), d_out)
    assert (FLASH_ATTENTION_BWD.launches, BACKWARD_LAUNCHES_BY_HEAD_DIM[64]) == (before[0] + 2, before[1] + 2)
    with torch.no_grad():
        out, lse = _forward_cuda(q, k, v, seg, d**-0.5, causal, True, kv_segments=keys)
    for i in range(0, b, 4):  # the plain backward's fp32 (B, H, S, S) terms, four rows at a time
        sl = slice(i, i + 4)
        with torch.no_grad():
            want = flash_attention_backward_plain(q[sl], k[sl], v[sl], seg[sl], d_out[sl], d**-0.5, causal,
                                                  out=out[sl], lse=lse[sl],
                                                  kv_segments=None if keys is None else keys[sl])
        for name, a, a2, w in zip(("dq", "dk", "dv"), got, again, want):
            a, a2 = a[sl], a2[sl]
            assert torch.equal(a, a2) and torch.isfinite(a).all(), name
            _assert_close_per_row(a, w, rows[sl] & ~alone[sl] if name == "dq" else valid[sl])
            if name == "dq":
                assert a[alone[sl]].float().abs().max().item() <= 1e-4 if alone[sl].any() else True
            else:
                assert not a[~valid[sl]].any(), f"{name} of a key that no query attends"
        del want


def test_k6_backward_reads_the_queries_and_the_keys_ids_apart(dev):
    """Ids that differ between queries and keys everywhere: the backward
    must match the plain version given the same two arrays, and the plain
    version with the arrays swapped must not (so a kernel that read one
    array in place of the other could not pass), at D=64 and 128."""
    b, s = 2, 200
    g = _gen(dev, 21)
    for d, h, hkv in ((64, 9, 3), (128, 4, 2)):
        q, k, v = (torch.randn((b, s, n, d), generator=g, device=dev).to(torch.bfloat16).requires_grad_()
                   for n in (h, hkv, hkv))
        seg = torch.randint(1, 4, (b, s), generator=g, device=dev, dtype=torch.int32)
        keys = torch.randint(1, 4, (b, s), generator=g, device=dev, dtype=torch.int32)
        d_out = torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16)
        got = torch.autograd.grad(flash_attention(q, k, v, seg, d**-0.5, kv_segments=keys), (q, k, v), d_out)
        with torch.no_grad():
            out, lse = _forward_cuda(q, k, v, seg, d**-0.5, False, True, kv_segments=keys)
            want = flash_attention_backward_plain(q, k, v, seg, d_out, d**-0.5, out=out, lse=lse, kv_segments=keys)
            swapped = flash_attention_backward_plain(q, k, v, keys, d_out, d**-0.5, kv_segments=seg)
        rows = torch.ones((b, s), dtype=torch.bool, device=dev)
        for a, w, x in zip(got, want, swapped):
            _assert_close_per_row(a, w, rows)
            with pytest.raises(AssertionError):
                _assert_close_per_row(a, x, rows)


def test_colsmol_lora_step_on_card_matches_cpu_route(dev, tmp_path):
    """One LoRA step of a small ColIdefics3 at head dim 64 (2 + 2 layers,
    GQA 3/1, remat) in bf16 on the card against the same checkpoint in fp32
    on the CPU route (autograd through K6's plain version), on the smooth
    probe over right-padded queries and pages of 13, 7 and 1 tiles: loss
    within 1e-2 relative, adapter-gradient cosine >= 0.99. On the card the
    backward runs at D=64 twice a decoder layer (queries and pages) and
    never through the plain version; the frozen tower takes none."""
    import contextlib
    from unittest import mock

    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.data.collator import VisualRetrieverCollator
    from colpali_tpu_torch.losses import ColbertLoss
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.models.idefics3 import ColIdefics3
    from colpali_tpu_torch.ops import flash_attention as fa
    from colpali_tpu_torch.training import trainer
    from colpali_tpu_torch.training.lora import LoraAdapters, LoraSpec
    from colpali_tpu_torch.utils.testing import (IDEFICS3_TRAIN_QUERIES, idefics3_training_examples,
                                                 idefics3_word_tokenizer, tiny_idefics3_config,
                                                 write_idefics3_checkpoint)

    cfg = tiny_idefics3_config(64)
    base = ColIdefics3(cfg, device="cpu", dtype=torch.bfloat16)
    hf_init_(base, torch.Generator().manual_seed(3))
    words = "User: Describe the image. Assistant:".split() + " ".join(IDEFICS3_TRAIN_QUERIES).split()
    write_idefics3_checkpoint(str(tmp_path), base, idefics3_word_tokenizer(words))
    examples = idefics3_training_examples(4)
    peft = LoraSpec(rank=8, alpha=16, dropout=0.1)
    loss_fn = ColbertLoss(use_smooth_max=True)
    runs = {}
    for where, dtype in ((dev, torch.bfloat16), ("cpu", torch.float32)):
        model, proc = load_retriever(str(tmp_path), family="colidefics3", device=where, dtype=dtype, remat=True)
        batch = trainer.to_device(VisualRetrieverCollator(proc)(examples), where)
        adapters = LoraAdapters(model, peft)
        with torch.no_grad():
            for i, b in enumerate(adapters.b):  # off zero (the same values on both), so that a takes a gradient too
                b.copy_(torch.randn(b.shape, generator=torch.Generator().manual_seed(i)) * 0.02)
        state = trainer.create_train_state(model, trainer.TrainConfig(), adapters)
        before = dict(fa.BACKWARD_LAUNCHES_BY_HEAD_DIM)
        refuse = mock.Mock(side_effect=AssertionError("K6's plain version ran on the card"))
        with mock.patch.object(fa, "flash_attention_plain", refuse) if where == dev else contextlib.nullcontext():
            trainer.begin_step(state, peft, 0)
            loss, _, _ = trainer.compute_loss(model, batch, loss_fn, False)
            loss.backward()
        launched = {d: fa.BACKWARD_LAUNCHES_BY_HEAD_DIM[d] - before[d] for d in before}
        assert launched == {d: 2 * cfg.text.num_hidden_layers if where == dev and d == 64 else 0 for d in before}
        runs[str(where)] = loss.item(), torch.cat([p.grad.flatten().double().cpu() for p in state.params])
        adapters.detach()
    (loss, grad), (cpu_loss, cpu_grad) = runs[str(dev)], runs["cpu"]
    cos = (grad @ cpu_grad / (grad.norm() * cpu_grad.norm())).item()
    assert np.isfinite(loss) and abs(loss - cpu_loss) <= 1e-2 * abs(cpu_loss), (loss, cpu_loss)
    assert cos >= 0.99, cos


# -- Gemma3: SigLIP at 896 px (K6 at D=72, S=4,096) and the biased text attention ------------------------------------

GEMMA3_VISION_CASES = [
    # b, s, h, key padding (valid lengths of the rows)
    (2, 4096, 16, None),  # the tower over two pages at 896 px (a batch of 8 in chip_smoke.py)
    (2, 4096, 16, (4096, 3001)),  # the same with padded keys and rows, past the 2,976 tested before
]


@pytest.mark.parametrize("b,s,h,lengths", GEMMA3_VISION_CASES)
def test_k6_at_gemma3_vision_shape_matches_plain_and_is_bit_equal(dev, b, s, h, lengths):
    """K6 at D=72 and S=4,096 (Gemma3-4B's SigLIP-So400m over 64 x 64
    patches) against its plain version by K6's rule, two calls bit-equal."""
    from colpali_tpu_torch.ops import flash_attention as fa

    d = 72
    g = _gen(dev, s + d)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    seg = torch.ones((b, s), dtype=torch.int32, device=dev)
    if lengths is not None:
        seg = (torch.arange(s, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)
    before = fa.FORWARD_LAUNCHES_BY_HEAD_DIM[72]
    got = flash_attention(q, k, v, seg, d**-0.5)
    again = flash_attention(q, k, v, seg, d**-0.5)
    assert fa.FORWARD_LAUNCHES_BY_HEAD_DIM[72] == before + 2 and torch.equal(got, again)
    _assert_k6_close(got, flash_attention_plain(q, k, v, seg, d**-0.5))


QWEN3_VISION_CASES = [
    # b, s, valid patches of each row (the patch mask as segment ids: pad patches see pad patches)
    (2, 3072, (3072, 2001)),  # Qwen3-VL-4B's tower over a 1,275 x 1,650 page (768 merged tokens) and a smaller one
    (3, 1040, (1040, 1040, 16)),  # three pages of unequal sizes, one nearly all padding
]


@pytest.mark.parametrize("b,s,lengths", QWEN3_VISION_CASES)
def test_k6_at_qwen3_vision_shape_matches_plain_and_is_bit_equal(dev, b, s, lengths):
    """K6 at D=72 over Qwen3-VL-4B's vision tower (16 heads), the patch mask
    as the segments, against its plain version by K6's rule with the RMS per
    query row (a page of 16 patches gives rows of order 1 beside long pages'
    rows of RMS ~sqrt(e / S), as the causal rows do), two calls bit-equal."""
    from colpali_tpu_torch.ops import flash_attention as fa

    h, d = 16, 72
    g = _gen(dev, s + b)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=dev).to(torch.bfloat16) for _ in range(3))
    seg = (torch.arange(s, device=dev)[None] < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)
    before = fa.FORWARD_LAUNCHES_BY_HEAD_DIM[72]
    got = flash_attention(q, k, v, seg, d**-0.5)
    again = flash_attention(q, k, v, seg, d**-0.5)
    assert fa.FORWARD_LAUNCHES_BY_HEAD_DIM[72] == before + 2 and torch.equal(got, again)
    _assert_close_per_row(got, flash_attention_plain(q, k, v, seg, d**-0.5), torch.ones_like(seg, dtype=torch.bool))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_chunk", [None, 96])
def test_biased_attention_on_card_matches_cpu(dev, dtype, q_chunk):
    """The biased text attention (``models.layers.biased_attention``, no
    kernel) on the card against the same call on the CPU, over Gemma3's
    bias (a sliding window, image blocks, left padding) at Gemma3-4B's
    heads (8/4 x 256): fp32 at atol 1e-5 (sums in another order), bf16
    within two bf16 ulps of the output's scale."""
    from colpali_tpu_torch.models.gemma3 import gemma3_attention_bias
    from colpali_tpu_torch.models.layers import biased_attention

    b, s, h, hkv, d = 4, 280, 8, 4, 256
    g = torch.Generator().manual_seed(14)
    q, k, v = (torch.randn((b, s, n, d), generator=g).to(dtype) for n in (h, hkv, hkv))
    mask = (torch.arange(s)[None] >= torch.tensor([0, 5, 17, 40])[:, None]).to(torch.int32)
    image = torch.zeros((b, s), dtype=torch.bool)
    for row, start in enumerate((4, 9, 21, 44)):  # a block of 200 image tokens at each row's own offset
        image[row, start:start + 200] = True
    bias = gemma3_attention_bias(mask, image, 64)
    want = biased_attention(q, k, v, bias, 256**-0.5, q_chunk)
    got = biased_attention(q.to(dev), k.to(dev), v.to(dev), bias.to(dev), 256**-0.5, q_chunk).cpu()
    assert got.dtype == dtype and torch.isfinite(got).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    else:
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=1.6e-2 * scale)


def test_colgemma3_forward_on_card_matches_plain_route(dev):
    """A small ColGemma3 (SigLIP at head dim 72: 2 layers of 144 wide over
    112 px pages; 2 text layers, 4/2 heads of 64, a window of 8) in bf16 on
    the card, through K6 and through its plain version: per-token cosine
    mean >= 0.998, min >= 0.995; K6 launches one a vision layer at D=72 for
    pages and none for queries (the text attention is biased)."""
    from unittest import mock

    from colpali_tpu_torch.models.configs import SiglipVisionConfig
    from colpali_tpu_torch.models.gemma3 import ColGemma3, Gemma3Config, Gemma3TextConfig
    from colpali_tpu_torch.models.common import hf_init_
    from colpali_tpu_torch.ops import flash_attention as fa
    from colpali_tpu_torch.processors.gemma3 import ColGemma3Processor
    from colpali_tpu_torch.utils.testing import gemma3_word_tokenizer

    cfg = Gemma3Config(
        vision=SiglipVisionConfig(hidden_size=144, intermediate_size=288, num_hidden_layers=2, num_attention_heads=2,
                                  image_size=112, patch_size=14),
        text=Gemma3TextConfig(vocab_size=128, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2, head_dim=64, query_pre_attn_scalar=48.0,
                              sliding_window=8, sliding_window_pattern=2, rope_scaling_factor=2.0),
        mm_tokens_per_image=16, image_token_index=7)
    model = ColGemma3(cfg, device=dev, dtype=torch.bfloat16).eval()
    gen = torch.Generator(device=dev).manual_seed(15)
    hf_init_(model, gen)
    with torch.no_grad():
        model.model.mm_input_projection.normal_(0.0, 0.02, generator=gen)
    queries = ["what is the total revenue ?", "a", "find the quarterly report"]
    proc = ColGemma3Processor(gemma3_word_tokenizer(" ".join(queries).split()), image_size=112, image_seq_length=16,
                              device=dev)
    pages = [np.random.default_rng(i).integers(0, 256, size=(150 + 20 * i, 120, 3), dtype=np.uint8) for i in range(3)]
    for batch, launches in ((proc.process_images(pages, device_pixels=True), cfg.vision.num_hidden_layers),
                            (proc.process_queries(queries), 0)):
        feed = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        before = fa.FORWARD_LAUNCHES_BY_HEAD_DIM[72]
        with torch.inference_mode():
            got = model(**feed).float()
            assert fa.FORWARD_LAUNCHES_BY_HEAD_DIM[72] == before + launches
            with mock.patch.object(fa, "flash_attention", fa.flash_attention_plain):
                want = model(**feed).float()
        valid = feed["attention_mask"].bool()
        cos = torch.nn.functional.cosine_similarity(got[valid], want[valid], dim=-1)
        assert torch.isfinite(got).all() and cos.mean() >= 0.998 and cos.min() >= 0.995, (cos.mean(), cos.min())


# -- ModernVBert: SigLIP on K6 at D=64, the bidirectional ModernBERT encoder on the biased route ---------------------

def test_colmodernvbert_forward_on_card_matches_plain_route(dev, tmp_path):
    """A small ColModernVBert (SigLIP at head dim 64: 2 layers of 128 over
    64 px tiles; a ModernBERT encoder of 3 layers, 2 heads of 64 and a
    window of 8) written by ``write_modernvbert_checkpoint`` and read by
    ``load_retriever`` in bf16 on the card, through K6 and through its
    plain version: per-token cosine mean >= 0.998, min >= 0.995; K6 runs
    one launch a vision layer a page forward at D=64, over every tile of
    the padded batch, and none for queries (the text attention is biased)."""
    from unittest import mock

    from colpali_tpu_torch.auto import load_retriever
    from colpali_tpu_torch.models.configs import SiglipVisionConfig
    from colpali_tpu_torch.models.modernvbert import ModernBertTextConfig, ModernVBertConfig
    from colpali_tpu_torch.ops import flash_attention as fa
    from colpali_tpu_torch.utils.testing import idefics3_training_examples, write_modernvbert_checkpoint

    cfg = ModernVBertConfig(
        vision=SiglipVisionConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2,
                                  image_size=64, patch_size=16),
        text=ModernBertTextConfig(vocab_size=128, hidden_size=128, intermediate_size=192, num_hidden_layers=3,
                                  num_attention_heads=2, local_attention=8),
        pixel_shuffle_factor=2, additional_vocab_size=32, image_token_id=140)
    queries = ["what is the total revenue ?", "a", "find the quarterly report"]
    write_modernvbert_checkpoint(str(tmp_path), cfg, seed=16, words=" ".join(queries).split(), device=dev)
    model, proc = load_retriever(str(tmp_path), family="colmodernvbert", device=dev)
    pages = [e["pos_target"] for e in idefics3_training_examples(3)]
    for batch, pages_forward in ((proc.process_images(pages, device_pixels=True), True),
                                 (proc.process_queries(queries), False)):
        feed = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        launches = cfg.vision.num_hidden_layers if pages_forward else 0
        before = fa.FORWARD_LAUNCHES_BY_HEAD_DIM[64]
        with torch.inference_mode():
            got = model(**feed).float()
            assert fa.FORWARD_LAUNCHES_BY_HEAD_DIM[64] == before + launches
            with mock.patch.object(fa, "flash_attention", fa.flash_attention_plain):
                want = model(**feed).float()
        valid = feed["attention_mask"].bool()
        cos = torch.nn.functional.cosine_similarity(got[valid], want[valid], dim=-1)
        assert torch.isfinite(got).all() and cos.mean() >= 0.998 and cos.min() >= 0.995, (cos.mean(), cos.min())


def test_training_stopped_early_releases_the_model(dev, tmp_path):
    """``ColModelTraining`` stopped by ``max_steps`` before its epoch ends
    leaves its prefetch thread nothing to hold: after ``close()`` and the
    last reference the model's memory on the card is released."""
    import gc

    from colpali_tpu_torch.losses import ColbertPairwiseCELoss
    from colpali_tpu_torch.models.configs import GemmaConfig, PaliGemmaConfig, SiglipVisionConfig
    from colpali_tpu_torch.models.paligemma import ColPali
    from colpali_tpu_torch.training.lora import LoraSpec
    from colpali_tpu_torch.training.orchestrator import ColModelTraining, ColModelTrainingConfig
    from colpali_tpu_torch.utils.testing import DUMMY_IMAGE_TOKEN_ID, DummyProcessor, load_dummy_dataset

    cfg = PaliGemmaConfig(  # the dummy processor's 28 px images and 4 image tokens, K6 at head dim 64
        vision=SiglipVisionConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=1, num_attention_heads=2,
                                  image_size=28, patch_size=14),
        text=GemmaConfig(vocab_size=64, hidden_size=128, intermediate_size=256, num_hidden_layers=1,
                         num_attention_heads=2, num_key_value_heads=1, head_dim=64),
        projection_dim=128, image_token_index=DUMMY_IMAGE_TOKEN_ID)
    gc.collect()
    start = torch.cuda.memory_allocated(dev)
    model = ColPali(cfg, device=dev, dtype=torch.bfloat16)
    model.register_buffer("ballast", torch.zeros(256 * 2**20, dtype=torch.uint8, device=dev))  # 256 MiB to miss
    app = ColModelTraining(ColModelTrainingConfig(
        model=model, processor=DummyProcessor(), loss_func=ColbertPairwiseCELoss(), output_dir=str(tmp_path),
        train_datasets=[load_dummy_dataset(16)], global_batch_size=2, max_steps=1, peft=LoraSpec(rank=2),
        report_to="none", device=dev))
    assert app.train()["final_step"] == 1  # one batch of the epoch's eight
    app.close()
    del app, model
    gc.collect()
    assert torch.cuda.memory_allocated(dev) - start < 64 * 2**20  # cuBLAS workspaces may stay; the ballast may not


# token pooling on the card (colpali_tpu_torch.compression): the regime of the JAX package's
# tests/compression/test_device_ward.py, random unit docs of 24, 37 and 48 tokens at pool factors 2 and 3
def _unit_docs(seed, lens, dim):
    rng = np.random.default_rng(seed)
    docs = [rng.normal(size=(n, dim)).astype(np.float32) for n in lens]
    return [d / np.linalg.norm(d, axis=-1, keepdims=True) for d in docs]


@pytest.mark.parametrize("dim", [16, 128])
@pytest.mark.parametrize("pool_factor", [2, 3])
def test_device_ward_on_the_card_partitions_as_scipy(dev, pool_factor, dim):
    """Partition-identical to the scipy pooler with TF32 on for the process:
    the pooler turns it off around its own products and back on after."""
    from colpali_tpu_torch.compression import DeviceWardTokenPooler, HierarchicalTokenPooler

    for trial in range(3):
        docs = _unit_docs(trial, [24, 37, 48], dim)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            got = DeviceWardTokenPooler(device=dev).pool_embeddings(docs, pool_factor=pool_factor, return_dict=True)
            assert torch.backends.cuda.matmul.allow_tf32
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        ref = HierarchicalTokenPooler(device="cpu").pool_embeddings(docs, pool_factor=pool_factor, return_dict=True)
        for g, r in zip(got.cluster_id_to_indices, ref.cluster_id_to_indices):
            assert {frozenset(v[0].tolist()) for v in g.values()} == \
                {frozenset(v[0].tolist()) for v in r.values() if len(v[0])}
        for g, r in zip(got.pooled_embeddings, ref.pooled_embeddings):
            np.testing.assert_allclose(g[np.lexsort(g.T)], r[np.lexsort(r.T)], atol=5e-6)


@pytest.mark.parametrize("pool_factor", [2, 3])
def test_kmeans_and_ward_on_the_card_match_the_cpu(dev, pool_factor):
    """The padded device functions on the card against themselves on the
    CPU (the CPU route is held to JAX in tests/test_torch_token_pooling.py):
    the same assignments, pooled rows at 1e-5."""
    from colpali_tpu_torch.compression import kmeans_pool_padded, ward_pool_padded

    docs = _unit_docs(9, [24, 37, 48], 128)
    x = torch.zeros((3, 48, 128))
    mask = torch.zeros((3, 48))
    for i, d in enumerate(docs):
        x[i, : len(d)], mask[i, : len(d)] = torch.from_numpy(d), 1
    for fn in (ward_pool_padded, kmeans_pool_padded):
        got = fn(x.to(dev), mask.to(dev), pool_factor)
        want = fn(x, mask, pool_factor)
        assert torch.equal(got[1].cpu(), want[1])
        assert torch.equal(got[2].cpu()[mask > 0], want[2][mask > 0])
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-5)


# the lengths that pooling gives K1-K3: a ColPali page pooled by 3 (343 tokens padded to Np = 352, its sign
# sketch pooled by 2 to 176 groups of 4 words), and dense vectors as 1-token docs (Np = 16)
@pytest.mark.parametrize("b,nq", [(1, 64), (4, 64), (8, 32)])
def test_k1_k2_k3_at_the_pooled_page_length(dev, b, nq):
    nt, np_ = 9, 352
    g = _gen(dev, b + nq)
    qw = torch.randint(-(2**31), 2**31 - 1, (b, nq, 4), generator=g, device=dev, dtype=torch.int32)
    qv = (torch.rand((b, nq), generator=g, device=dev) > 0.2).float()
    dw = torch.randint(-(2**31), 2**31 - 1, (nt, 4, np_ // 2, 128), generator=g, device=dev, dtype=torch.int32)
    assert torch.equal(binary_maxsim_tiled(qw, qv, dw, 128), binary_maxsim_tiled_plain(qw, qv, dw, 128))
    store, scales = _store(dev, nt, np_, 128, seed=b)
    q = torch.randn((b, nq, 128), generator=_gen(dev, 5), device=dev)
    cand = torch.randint(0, nt * 128, (b, 1024), generator=_gen(dev, 6), device=dev, dtype=torch.int32)
    torch.testing.assert_close(gather_rerank_int8(q, store, scales, cand), gather_rerank_plain(q, store, scales, cand),
                               rtol=RTOL, atol=ATOL)
    qi, qs = quantize_per_token(q)
    torch.testing.assert_close(maxsim_int8mxu_tiled(qi, qs, store, scales),
                               maxsim_int8mxu_tiled_plain(qi, qs, store, scales), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b", [1, 8, 64])
def test_k3_over_one_token_docs(dev, b):
    """Dense vectors mined through an index of 1-token docs: each doc one
    valid token and 15 zero ones of scale 1, queries one token each."""
    store, scales = _store(dev, 8, 16, 128, seed=b)
    store[:, 1:], scales[:, 1:] = 0, 1.0
    q = torch.randn((b, 1, 128), generator=_gen(dev, b), device=dev)
    qi, qs = quantize_per_token(q)
    got = maxsim_int8mxu_tiled(qi, qs, store, scales)
    torch.testing.assert_close(got, maxsim_int8mxu_tiled_plain(qi, qs, store, scales), rtol=RTOL, atol=ATOL)
    index = CorpusIndex(list(q[:, 0, None].cpu().numpy()) * 3, dtype="int8", device=dev)
    assert index.doc_tokens == 16
    launches = MAXSIM_INT8.launches
    _, ids = index.search(list(q.cpu().numpy()), k=1)
    assert MAXSIM_INT8.launches > launches and (ids[:, 0] % b).tolist() == list(range(b))


def test_ward_on_the_card_beside_a_thread_that_pins_memory(dev):
    """The device Ward's CUDA graph while another thread allocates pinned
    host buffers and uploads from them, as the fused page pipeline's
    prefetch thread does beside DeviceIndexBuilder.add(): every call gives
    the labels of a call made alone, and no call empties the allocator's
    cache."""
    import threading

    from colpali_tpu_torch.compression import ward_pool_padded

    docs = _unit_docs(11, [96, 120, 128, 77], 128)
    x = torch.zeros((4, 128, 128), device=dev)
    mask = torch.zeros((4, 128), device=dev)
    for i, d in enumerate(docs):
        x[i, : len(d)], mask[i, : len(d)] = torch.from_numpy(d), 1
    want = ward_pool_padded(x, mask, 3)[2]
    stop, errors = threading.Event(), []

    def pin():
        try:
            stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(stream):
                while not stop.is_set():
                    host = torch.empty((1 << 20,), dtype=torch.uint8, pin_memory=True)
                    host.to(dev, non_blocking=True)
                    del host
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    thread = threading.Thread(target=pin)
    thread.start()
    try:
        ballast = torch.empty((256 << 20,), dtype=torch.uint8, device=dev)
        del ballast  # freed into the allocator's cache
        reserved = torch.cuda.memory_reserved(dev)
        for _ in range(10):
            got = ward_pool_padded(x, mask, 3)[2]
            assert torch.equal(got[mask > 0], want[mask > 0])
        assert torch.cuda.memory_reserved(dev) >= reserved
    finally:
        stop.set()
        thread.join()
    assert not errors, errors


# Q2, the chunked gated delta rule: fp32 inputs within 1e-4 of the plain output's RMS (fp32 sums in another order,
# the substitution in place of the triangular solve); bf16 inputs by K6's forward rule (both round the fp32 result
# to bf16 once)
Q2_FP32_ATOL_RMS = 1e-4
Q2_CASES = [  # b, s, hk, hv, dv, log-decay per token
    (2, 150, 2, 4, 128, 0.1), (1, 1, 1, 1, 64, 0.1), (8, 32, 16, 32, 128, 0.1), (2, 200, 2, 4, 192, 2.0),
    (1, 753, 16, 32, 128, 0.3)]


def _q2_inputs(dev, b, s, hk, hv, dv, log_decay, dtype, seed=0):
    """q, k and v as views of one conv-output row per token, as GatedDeltaNet passes them."""
    g_ = _gen(dev, seed)
    key_dim = hk * 128
    mixed = torch.randn((b, s, 2 * key_dim + hv * dv), generator=g_, device=dev).to(dtype)
    q = mixed[..., :key_dim].view(b, s, hk, 128)
    k = mixed[..., key_dim:2 * key_dim].view(b, s, hk, 128)
    v = mixed[..., 2 * key_dim:].view(b, s, hv, dv)
    g = -log_decay * (0.5 + torch.rand((b, s, hv), generator=g_, device=dev))
    beta = torch.rand((b, s, hv), generator=g_, device=dev).to(dtype)
    return q, k, v, g, beta


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,hk,hv,dv,log_decay", Q2_CASES)
def test_q2_gated_delta_rule_matches_plain(dev, b, s, hk, hv, dv, log_decay, dtype):
    from colpali_tpu_torch.ops.gated_delta_rule import (
        GATED_DELTA_RULE,
        chunk_gated_delta_rule,
        chunk_gated_delta_rule_plain,
    )

    q, k, v, g, beta = _q2_inputs(dev, b, s, hk, hv, dv, log_decay, dtype)
    before = GATED_DELTA_RULE.launches
    got = chunk_gated_delta_rule(q, k, v, g, beta)
    torch.cuda.synchronize()
    assert GATED_DELTA_RULE.launches == before + 1 and got.dtype == dtype and got.shape == (b, s, hv, dv)
    want = chunk_gated_delta_rule_plain(q, k, v, g, beta)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    rms = want.float().square().mean().sqrt().item()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=Q2_FP32_ATOL_RMS * rms)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=K6_RTOL, atol=K6_ATOL_RMS * rms)
    assert torch.equal(chunk_gated_delta_rule(q, k, v, g, beta), got)  # one order of sums


def test_q2_takes_a_gradient_and_refuses_what_it_does_not_take(dev):
    from colpali_tpu_torch.ops.gated_delta_rule import GATED_DELTA_RULE_BWD, chunk_gated_delta_rule

    q, k, v, g, beta = _q2_inputs(dev, 1, 70, 2, 4, 128, 0.1, torch.bfloat16)
    before = GATED_DELTA_RULE_BWD.launches
    v = v.detach().requires_grad_()
    chunk_gated_delta_rule(q, k, v, g, beta).float().sum().backward()
    assert GATED_DELTA_RULE_BWD.launches == before + 1 and v.grad.shape == v.shape
    with torch.no_grad():
        chunk_gated_delta_rule(q, k, v, g, beta)
    with pytest.raises(ValueError, match="Dk"):
        chunk_gated_delta_rule(q[..., :64], k[..., :64], v, g, beta)
    with pytest.raises(TypeError):
        chunk_gated_delta_rule(q, k, v, g.bfloat16(), beta)


# Q2's backward against chunk_gated_delta_rule_backward_plain (the same reverse scan in PyTorch) on the same inputs:
# each of the five gradients within 1e-3 of its own RMS (fp32 sums in another order over a reverse scan of up to 12
# chunks and a fixed-order sum over the value heads of a key head), and with bf16 inputs one bf16 ulp of the value
# more (the kernel writes dq, dk, dv and dbeta in bf16); bit-equal on a second call (no atomics)
Q2_BWD_ATOL_RMS = 1e-3
Q2_BWD_CASES = [  # b, s, hk, hv, dv, log-decay per token: the page and query shapes of Qwen3.5's default config,
    # B=1 with a padded last chunk, a high decay over Dv=192 (three column blocks), one token
    (8, 753, 16, 32, 128, 0.3), (8, 32, 16, 32, 128, 0.3), (1, 150, 2, 4, 128, 0.1), (2, 200, 2, 4, 192, 2.0),
    (1, 1, 1, 1, 64, 0.1)]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element's magnitude (8 bits of mantissa)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _q2_grads(dev, q, k, v, g, beta, d_out):
    """(dq, dk, dv, dg, dbeta) through chunk_gated_delta_rule's autograd Function, q/k/v as views of one leaf."""
    from colpali_tpu_torch.ops.gated_delta_rule import chunk_gated_delta_rule

    mixed = torch.cat([x.flatten(2) for x in (q, k, v)], dim=-1).detach().requires_grad_()
    hk, hv, dv = q.shape[2], v.shape[2], v.shape[3]
    key_dim = hk * 128
    g, beta = g.detach().requires_grad_(), beta.detach().requires_grad_()
    out = chunk_gated_delta_rule(mixed[..., :key_dim].view(q.shape), mixed[..., key_dim:2 * key_dim].view(k.shape),
                                 mixed[..., 2 * key_dim:].view(v.shape), g, beta)
    out.backward(d_out)
    dm = mixed.grad
    return (dm[..., :key_dim].reshape(q.shape), dm[..., key_dim:2 * key_dim].reshape(k.shape),
            dm[..., 2 * key_dim:].reshape(*v.shape[:2], hv, dv), g.grad, beta.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,s,hk,hv,dv,log_decay", Q2_BWD_CASES)
def test_q2_backward_matches_plain(dev, b, s, hk, hv, dv, log_decay, dtype):
    from colpali_tpu_torch.ops.gated_delta_rule import (
        GATED_DELTA_RULE_BWD,
        chunk_gated_delta_rule_backward_plain,
    )

    q, k, v, g, beta = _q2_inputs(dev, b, s, hk, hv, dv, log_decay, dtype, seed=3)
    d_out = torch.randn((b, s, hv, dv), generator=_gen(dev, 4), device=dev).to(dtype)
    before = GATED_DELTA_RULE_BWD.launches
    got = _q2_grads(dev, q, k, v, g, beta, d_out)
    torch.cuda.synchronize()
    assert GATED_DELTA_RULE_BWD.launches == before + 1
    want = chunk_gated_delta_rule_backward_plain(q, k, v, g, beta, d_out)
    for name, x, w in zip(("dq", "dk", "dv", "dg", "dbeta"), got, want):
        assert torch.isfinite(x).all() and torch.isfinite(w).all(), name
        rms = w.square().mean().sqrt().item()
        limit = Q2_BWD_ATOL_RMS * rms + (_bf16_ulp(w) if x.dtype == torch.bfloat16 else 0.0)
        err = (x.float() - w).abs()
        assert bool((err <= limit).all()), (name, err.max().item(), rms)
    again = _q2_grads(dev, q, k, v, g, beta, d_out)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # one order of sums


def test_q2_gradient_through_gated_delta_net_launches_the_kernel(dev):
    """A GatedDeltaNet at Qwen3.5's head widths (2/4 heads of 128) on the card in fp32 against the same layer on
    the CPU (autograd through the plain version): the input's and the fp32 parameters' gradients within 1e-3 of
    their RMS; on the card the backward kernel runs once and no plain version is called."""
    from unittest import mock

    from colpali_tpu_torch.models.qwen3_5 import GatedDeltaNet, Qwen35TextConfig
    from colpali_tpu_torch.ops import gated_delta_rule as gdr

    cfg = Qwen35TextConfig(hidden_size=256, linear_num_key_heads=2, linear_num_value_heads=4)
    torch.manual_seed(0)
    cpu = GatedDeltaNet(cfg, device="cpu")
    with torch.no_grad():
        for p in cpu.parameters():
            p.add_(torch.randn(p.shape) * 0.02)
    card = GatedDeltaNet(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((2, 150, 256)) * 0.5
    mask = torch.ones((2, 150), dtype=torch.int32)
    mask[1, :40] = 0  # left padding: zeroed rows, l2norm(0) = 0
    grads = []
    for layer, device in ((cpu, "cpu"), (card, dev)):
        xi = x.to(device).detach().requires_grad_()
        if device == dev:
            before = gdr.GATED_DELTA_RULE_BWD.launches
            with mock.patch.object(gdr, "chunk_gated_delta_rule_plain", side_effect=AssertionError("plain forward")), \
                    mock.patch.object(gdr, "chunk_gated_delta_rule_backward_plain",
                                      side_effect=AssertionError("plain backward")):
                layer(xi, mask.to(device)).square().sum().backward()
            torch.cuda.synchronize()
            assert gdr.GATED_DELTA_RULE_BWD.launches == before + 1
        else:
            layer(xi, mask).square().sum().backward()
        grads.append([xi.grad, layer.A_log.grad, layer.dt_bias.grad, layer.conv1d_kernel.grad])
    for want, got in zip(*grads):
        rms = want.square().mean().sqrt().item()
        assert torch.isfinite(got).all() and (got.cpu() - want).abs().max().item() <= 1e-3 * rms
