"""Port parity: the single-vector (Bi) models, their head and processors in
colpali_tpu_torch against colpali_tpu, on the CPU, fp32, on JAX's einsum
route (no Pallas).

- ``DenseHead`` over every pooling mode (mean, cls, last) x projection (none
  or 24 wide) x Matryoshka cut (none or 12) on a right-padded batch: atol
  2e-5 (mean pooling sums in fp32 in both packages).
- ``BiPali``, ``BiPaliProj``, ``BiQwen2``, ``BiQwen2_5``, ``BiQwen3_5`` (a
  GatedDeltaNet layer and a gated attention layer) and ``BiIdefics3`` at
  toy width, the JAX parameters carried over by ``core/from_jax.py``, on
  pages and queries: atol 2e-5 on the L2-normalized vectors.
- The Bi processors' ``score`` (``score_single_vector``) against JAX's:
  atol 1e-6 (the same fp32 products); a Bi model's HF export (by its
  config's family exporter) read back bit for bit.
- The reference quirk ``last`` pooling carries: ColIdefics3's processor pads
  on the right, so on a batch of unequal queries BiIdefics3 reads a pad
  position for the shorter rows. The port gives JAX's vector there (its
  decoder runs pad rows under JAX's key-padding mask), which is not the
  query's own vector when it is embedded alone.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colpali_tpu.models import idefics3 as ji
from colpali_tpu.models import paligemma as jp
from colpali_tpu.models import qwen2_5_vl as jq25
from colpali_tpu.models import qwen2_vl as jq
from colpali_tpu.models import qwen3_5 as jq35
from colpali_tpu.models import qwen3_vl as jq3
from colpali_tpu.models.common import DenseHead as JaxDenseHead
from colpali_tpu.models.configs import DenseHeadConfig as JaxDenseHeadConfig
from colpali_tpu.processors import bi as jbi
from colpali_tpu.utils.testing import tiny_colpali_config as jax_tiny_colpali_config
from colpali_tpu_torch.core.from_jax import state_dict_from_jax
from colpali_tpu_torch.core.hf_loader import load_colidefics3_params
from colpali_tpu_torch.models import idefics3 as ti
from colpali_tpu_torch.models import paligemma as tp
from colpali_tpu_torch.models import qwen2_5_vl as tq25
from colpali_tpu_torch.models import qwen2_vl as tq
from colpali_tpu_torch.models import qwen3_5 as tq35
from colpali_tpu_torch.models import qwen3_vl as tq3
from colpali_tpu_torch.models.common import DenseHead
from colpali_tpu_torch.models.configs import DenseHeadConfig
from colpali_tpu_torch.processors import bi
from colpali_tpu_torch.training.checkpointing import save_pretrained
from colpali_tpu_torch.utils.testing import DummyProcessor, tiny_colpali_config

ATOL = 2e-5
QUERIES = ["what is the total revenue ?", "a", "find the quarterly report"]


class StubTokenizer:
    """Words and ``<...>`` specials to ids (specials pinned, words from 16 in
    order of first sight), padded on the side asked for with ``<pad>`` (0)."""

    def __init__(self, specials: dict):
        self.vocab = {"<pad>": 0, **specials}
        self.pad_token = "<pad>"

    def convert_tokens_to_ids(self, token):
        return self.vocab[token]

    def _encode(self, text):
        ids = []
        for part in re.split(r"(<[^<>]+>|\n)", text):
            for word in ([part] if part.startswith("<") or part == "\n" else part.split()):
                if word not in self.vocab:
                    self.vocab[word] = 16 + sum(v >= 16 for v in self.vocab.values())
                ids.append(self.vocab[word])
        return ids

    def __call__(self, texts, padding=None, padding_side="right", add_special_tokens=False, return_tensors=None):
        enc = [self._encode(t) for t in texts]
        m = max(len(e) for e in enc)
        ids = np.zeros((len(enc), m), np.int64)
        mask = np.zeros((len(enc), m), np.int64)
        for i, e in enumerate(enc):
            cols = slice(m - len(e), m) if padding_side == "left" else slice(0, len(e))
            ids[i, cols], mask[i, cols] = e, 1
        return {"input_ids": ids, "attention_mask": mask}


QWEN_SPECIALS = {"<|vision_start|>": 4, "<|image_pad|>": 5, "<|video_pad|>": 6, "<|vision_end|>": 7,
                 "<|im_start|>": 8, "<|im_end|>": 9, "<|endoftext|>": 10}
IDEFICS3_SPECIALS = {"<image>": 5, "<fake_token_around_image>": 6, "<global-img>": 7, "<end_of_utterance>": 8,
                     "<|im_start|>": 9}
TEXT = dict(vocab_size=64, hidden_size=48, intermediate_size=96, num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=2, head_dim=12)
QWEN2_VISION = dict(depth=1, embed_dim=32, num_heads=2, mlp_ratio=2.0, hidden_size=48)
QWEN25_VISION = dict(depth=2, hidden_size=32, num_heads=2, intermediate_size=64, out_hidden_size=48, window_size=56,
                     fullatt_block_indexes=(1,))
IDEFICS3_VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=2,
                       image_size=32, patch_size=8)


def _pages(shapes):
    return [np.random.default_rng(s).integers(0, 256, size=(*hw, 3), dtype=np.uint8) for s, hw in enumerate(shapes)]


def _torch(batch: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items() if k != "image_grid_thw"}


def _jax(batch: dict) -> dict:
    return {k: jnp.asarray(np.asarray(v)) for k, v in batch.items() if k != "image_grid_thw"}


@pytest.mark.parametrize("embedding_dim", [None, 12])
@pytest.mark.parametrize("projection_dim", [None, 24])
@pytest.mark.parametrize("pooling", ["mean", "cls", "last"])
def test_dense_head_matches_jax(pooling, projection_dim, embedding_dim):
    rng = np.random.default_rng(0)
    hidden = rng.normal(size=(3, 7, 16)).astype(np.float32)
    mask = (np.arange(7)[None] < np.array([[7], [4], [1]])).astype(np.int32)  # right padding
    jax_head = JaxDenseHead(JaxDenseHeadConfig(pooling, projection_dim, embedding_dim))
    variables = jax_head.init(jax.random.PRNGKey(1), jnp.asarray(hidden), jnp.asarray(mask))
    want = np.asarray(jax_head.apply(variables, jnp.asarray(hidden), jnp.asarray(mask)))
    head = DenseHead(DenseHeadConfig(pooling, projection_dim, embedding_dim), 16, device="cpu")
    if projection_dim is not None:
        state = state_dict_from_jax({"head": jax.tree.map(np.asarray, variables["params"])})
        head.load_state_dict({k.removeprefix("head."): v for k, v in state.items()})
    with torch.no_grad():
        got = head(torch.from_numpy(hidden), torch.from_numpy(mask)).numpy()
    assert got.shape == want.shape == (3, embedding_dim or projection_dim or 16)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    if pooling == "last" and projection_dim is None and embedding_dim is None:  # the literal last position
        np.testing.assert_allclose(got[2], hidden[2, -1] / np.linalg.norm(hidden[2, -1]), atol=1e-6)
    with pytest.raises(ValueError, match="Unknown pooling"):
        DenseHead(DenseHeadConfig("max"), 16, device="cpu")


def _port_from_jax(jax_model, port_model, batch):
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), **_jax(batch))
    port_model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables["params"])))
    return jax.jit(jax_model.apply), variables, port_model.eval()


def _assert_matches(jax_apply, variables, model, batch):
    want = np.asarray(jax_apply(variables, **_jax(batch)))
    with torch.no_grad():
        got = model(**_torch(batch)).numpy()
    assert got.ndim == 2 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    return got


@pytest.mark.parametrize("proj", [False, True])
def test_bipali_matches_jax(proj):
    proc = DummyProcessor()
    pages = proc.process_images(_pages(((28, 28), (40, 30))))
    jax_cls, cls = (jp.BiPaliProj, tp.BiPaliProj) if proj else (jp.BiPali, tp.BiPali)
    jax_apply, variables, model = _port_from_jax(jax_cls(jax_tiny_colpali_config()),
                                                 cls(tiny_colpali_config(), device="cpu"), pages)
    assert _assert_matches(jax_apply, variables, model, pages).shape == (2, 1024 if proj else 16)
    _assert_matches(jax_apply, variables, model, proc.process_queries(QUERIES))


@pytest.mark.parametrize("family", ["qwen2", "qwen2_5"])
def test_biqwen_matches_jax(family):
    if family == "qwen2":
        jax_cfg = jq.Qwen2VLConfig(vision=jq.Qwen2VLVisionConfig(**QWEN2_VISION),
                                   text=jq.Qwen2TextConfig(**TEXT, mrope_section=(2, 2, 2)),
                                   image_token_id=5, vision_start_token_id=4, video_token_id=6)
        cfg = tq.Qwen2VLConfig(vision=tq.Qwen2VLVisionConfig(**QWEN2_VISION),
                               text=tq.Qwen2TextConfig(**TEXT, mrope_section=(2, 2, 2)),
                               image_token_id=5, vision_start_token_id=4, video_token_id=6)
        jax_model, model, proc_cls = jq.BiQwen2(jax_cfg), tq.BiQwen2(cfg, device="cpu"), bi.BiQwen2Processor
    else:
        jax_cfg = jq25.Qwen25VLConfig(vision=jq25.Qwen25VLVisionConfig(**QWEN25_VISION),
                                      text=jq.Qwen2TextConfig(**TEXT, mrope_section=(2, 2, 2)),
                                      image_token_id=5, vision_start_token_id=4, video_token_id=6)
        cfg = tq25.Qwen25VLConfig(vision=tq25.Qwen25VLVisionConfig(**QWEN25_VISION),
                                  text=tq.Qwen2TextConfig(**TEXT, mrope_section=(2, 2, 2)),
                                  image_token_id=5, vision_start_token_id=4, video_token_id=6)
        jax_model, model = jq25.BiQwen2_5(jax_cfg), tq25.BiQwen2_5(cfg, device="cpu")
        proc_cls = bi.BiQwen2_5_Processor
    proc = proc_cls(StubTokenizer(QWEN_SPECIALS), max_num_visual_tokens=16, device="cpu")
    pages = proc.process_images(_pages(((56, 84), (56, 56))))
    jax_apply, variables, model = _port_from_jax(jax_model, model, pages)
    _assert_matches(jax_apply, variables, model, pages)
    _assert_matches(jax_apply, variables, model, proc.process_queries(QUERIES))


QWEN3_VISION = dict(depth=1, hidden_size=32, num_heads=2, intermediate_size=64, out_hidden_size=48, patch_size=14,
                    num_position_embeddings=16, deepstack_visual_indexes=(0,))
QWEN35_TEXT = dict(vocab_size=64, hidden_size=48, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=16, linear_num_value_heads=4, linear_num_key_heads=2,
                   linear_key_head_dim=8, linear_value_head_dim=8, linear_conv_kernel_dim=2, full_attention_interval=2)


def test_biqwen3_5_matches_jax_and_its_processor_scores():
    jax_cfg = jq35.Qwen35VLConfig(vision=jq3.Qwen3VLVisionConfig(**QWEN3_VISION),
                                  text=jq35.Qwen35TextConfig(**QWEN35_TEXT), image_token_id=5, vision_start_token_id=4)
    cfg = tq35.Qwen35VLConfig(vision=tq3.Qwen3VLVisionConfig(**QWEN3_VISION), text=tq35.Qwen35TextConfig(**QWEN35_TEXT),
                              image_token_id=5, vision_start_token_id=4)
    proc = bi.BiQwen3_5Processor(StubTokenizer(QWEN_SPECIALS), patch_size=14, num_grid_per_side=4,
                                 max_num_visual_tokens=16, device="cpu")
    pages = proc.process_images(_pages(((56, 84), (56, 56))))
    jax_apply, variables, model = _port_from_jax(jq35.BiQwen3_5(jax_cfg), tq35.BiQwen3_5(cfg, device="cpu"), pages)
    assert [layer.linear for layer in model.model.language_model.layers] == [True, False]
    got = _assert_matches(jax_apply, variables, model, pages)
    queries = _assert_matches(jax_apply, variables, model, proc.process_queries(QUERIES[:2]))
    assert got.shape == (2, 48)
    np.testing.assert_allclose(proc.score(list(queries), list(got)), queries @ got.T, atol=1e-5)


@pytest.fixture(scope="module")
def biidefics3():
    jax_cfg = ji.Idefics3Config(vision=ji.Idefics3VisionConfig(**IDEFICS3_VISION),
                                text=jq.Qwen2TextConfig(**TEXT, mrope_section=(6,), attention_bias=False),
                                scale_factor=2, image_token_id=5)
    cfg = ti.Idefics3Config(vision=ti.Idefics3VisionConfig(**IDEFICS3_VISION),
                            text=tq.Qwen2TextConfig(**TEXT, mrope_section=(6,), attention_bias=False),
                            scale_factor=2, image_token_id=5)
    proc = bi.BiIdefics3Processor(StubTokenizer(IDEFICS3_SPECIALS), tile_size=32, longest_edge=64, image_seq_len=4,
                                  device="cpu")
    pages = proc.process_images(_pages(((70, 50), (30, 20))))
    return (*_port_from_jax(ji.BiIdefics3(jax_cfg), ti.BiIdefics3(cfg, device="cpu"), pages), proc, pages)


def test_biidefics3_matches_jax_and_exports_by_its_config(biidefics3, tmp_path):
    jax_apply, variables, model, proc, pages = biidefics3
    assert np.asarray(pages["tile_mask"]).sum(1).tolist() == [5, 1]
    _assert_matches(jax_apply, variables, model, pages)
    # a Bi model exports as its family's Col model does (the exporter follows the config)
    save_pretrained(str(tmp_path), model.state_dict(), config=model.config)
    back = load_colidefics3_params(str(tmp_path))
    assert set(back) == set(model.state_dict())
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())


def test_biidefics3_last_pooling_reads_a_pad_position_on_right_padded_rows(biidefics3):
    """The reference's ``last`` pooling assumes left padding; Idefics3 pads
    on the right. The port pins JAX's result: the short query's vector is
    that of its batch's last (pad) position, not its own."""
    jax_apply, variables, model, proc, _ = biidefics3
    batch = proc.process_queries(QUERIES[:2])
    assert batch["attention_mask"][1, -1] == 0  # the second query is right-padded
    padded = _assert_matches(jax_apply, variables, model, batch)
    alone = _assert_matches(jax_apply, variables, model, proc.process_queries(QUERIES[1:2]))
    np.testing.assert_allclose(padded[0], _assert_matches(jax_apply, variables, model,
                                                          proc.process_queries(QUERIES[:1]))[0], atol=ATOL)
    assert np.abs(padded[1] - alone[0]).max() > 1e-3  # a pad position's vector, not the query's own


@pytest.mark.parametrize("name", ["BiPaliProcessor", "BiQwen2Processor", "BiQwen2_5_Processor",
                                  "BiIdefics3Processor"])
def test_bi_processor_score_matches_jax(name):
    specials = QWEN_SPECIALS if "Qwen" in name else IDEFICS3_SPECIALS
    kwargs = {} if "Pali" in name else {"device": "cpu"}
    proc = getattr(bi, name)(StubTokenizer(specials), **kwargs)
    jax_proc = getattr(jbi, name)(StubTokenizer(specials))
    rng = np.random.default_rng(2)
    qs, ps = rng.normal(size=(3, 16)).astype(np.float32), rng.normal(size=(5, 16)).astype(np.float32)
    got = proc.score(list(qs), list(ps))
    np.testing.assert_allclose(got, np.asarray(jax_proc.score(list(qs), list(ps))), atol=1e-6)
    np.testing.assert_allclose(got, qs @ ps.T, atol=1e-5)
    assert isinstance(proc, getattr(bi, name).__mro__[1])  # the family's Col processor
