"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU: it is marked ``cuda`` and skips
without one. On a machine with a card (which has no jax, so skip the
JAX-side conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerance: K1 exactly equal; K2 and K3 rtol=1e-5, atol=1e-4 (fp32 sums in
another order than the plain versions); K6 elementwise rtol=1.6e-2 (two bf16
ulps: both round the output, the kernel rounds unnormalized probabilities to
bf16 and divides at the end, the plain version rounds normalized ones) and
atol=2e-2 times the RMS of the plain output (random q, k and v give outputs
of RMS about sqrt(e / S), far below 1).
"""

import numpy as np
import pytest
import torch

from colpali_tpu_torch.ops.flash_attention import FLASH_ATTENTION, flash_attention, flash_attention_plain
from colpali_tpu_torch.ops.maxsim_binary import BINARY_MAXSIM, binary_maxsim_tiled, binary_maxsim_tiled_plain
from colpali_tpu_torch.ops.maxsim_tiled import (
    GATHER_RERANK,
    MAXSIM_INT8,
    gather_rerank_int8,
    gather_rerank_plain,
    maxsim_int8_tiled,
    maxsim_int8mxu_tiled,
    maxsim_int8mxu_tiled_plain,
    maxsim_tiled,
)
from colpali_tpu_torch.ops.quant import quantize_per_token
from colpali_tpu_torch.retrieval.store import CorpusIndex

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-4
K6_RTOL, K6_ATOL_RMS = 1.6e-2, 2e-2


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
    with pytest.raises(NotImplementedError, match="K4"):
        maxsim_int8_tiled(torch.zeros((1, 4, 128), device=dev), store, scales)
    with pytest.raises(NotImplementedError, match="K5"):
        maxsim_tiled(torch.zeros((1, 4, 128), device=dev), store.to(torch.bfloat16))
    with pytest.raises(NotImplementedError, match="K5"):
        gather_rerank_int8(torch.zeros((1, 4, 128), device=dev), store.to(torch.bfloat16), None,
                           torch.zeros((1, 2), dtype=torch.int32, device=dev))


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
]


def _assert_k6_close(got, want):
    atol = K6_ATOL_RMS * want.float().pow(2).mean().sqrt().item()
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
        flash_attention(q[..., :64], k[..., :64], v[..., :64], seg, 64**-0.5)
    assert FLASH_ATTENTION.launches == before + 1
