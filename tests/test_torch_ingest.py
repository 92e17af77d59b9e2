"""Port parity: page staging, decoding, the ColPali processor's page side
and ``embed_pages_fused`` (colpali_tpu_torch) against colpali_tpu.

Host staging is numpy and PIL on both sides: bytes must be equal. The
device decode (YUV420 -> RGB, normalize) is fp32 arithmetic: atol=1e-4 on
0..255 values, 1e-6 once normalized. Page embeddings come from the tiny
ColPali of ``__graft_entry__._tiny_colpali`` (56 px pages) in fp32 through
``chip_smoke.WordTokenizer``: atol=2e-5, as for the page forward.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from __graft_entry__ import _tiny_colpali  # noqa: E402
from chip_smoke import WordTokenizer  # noqa: E402
from colpali_tpu.models.paligemma import ColPali as JaxColPali  # noqa: E402
from colpali_tpu.processors import image_processing as jip  # noqa: E402
from colpali_tpu.processors.colpali import ColPaliProcessor as JaxProcessor  # noqa: E402
from colpali_tpu.retrieval.ingest import embed_pages_fused as jax_embed_pages_fused  # noqa: E402
from colpali_tpu_torch.core.from_jax import state_dict_from_jax  # noqa: E402
from colpali_tpu_torch.models.paligemma import ColPali  # noqa: E402
from colpali_tpu_torch.processors import image_processing as tip  # noqa: E402
from colpali_tpu_torch.processors.colpali import ColPaliProcessor  # noqa: E402
from colpali_tpu_torch.retrieval.ingest import embed_pages_fused  # noqa: E402
from test_torch_colpali import port_config  # noqa: E402

IMAGE_TOKEN = 100  # below the tiny vocab, clear of the tokenizer's pinned ids
SIZE = 56


def _page(seed: int, h: int = 90, w: int = 70) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8)


def _images():
    rgb = _page(0)
    return {
        "array": rgb,
        "rgba": Image.fromarray(np.concatenate([rgb, rgb[..., :1]], axis=-1), "RGBA"),
        "palette": Image.fromarray(rgb).convert("P"),
        "gray": Image.fromarray(rgb[..., 0], "L"),
        "target_size": _page(1, SIZE, SIZE),
    }


@pytest.mark.parametrize("kind", ["array", "rgba", "palette", "gray", "target_size"])
@pytest.mark.parametrize("reducing_gap", [None, 1.0])
def test_host_staging_bytes_equal(kind, reducing_gap):
    image = _images()[kind]
    size = (SIZE, SIZE)
    np.testing.assert_array_equal(tip.to_rgb_array(image), jip.to_rgb_array(image))
    rgb = tip.host_resize_rgb(image, size, reducing_gap)
    np.testing.assert_array_equal(rgb, jip.host_resize_rgb(image, size, reducing_gap))
    for got, want in zip(tip.stage_yuv420(image, size, reducing_gap), jip.stage_yuv420(image, size, reducing_gap)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tip.stage_gray(image, size, reducing_gap), jip.stage_gray(image, size, reducing_gap))
    for got, want in zip(tip.rgb_to_yuv420(rgb), jip.rgb_to_yuv420(rgb)):
        np.testing.assert_array_equal(got, want)


def test_pack_and_device_decode_match():
    planes = [tip.stage_yuv420(_page(s), (SIZE, SIZE)) for s in range(4)]
    shape = (2, 2, SIZE * SIZE * 3 // 2)
    buf = tip.pack_yuv420_group(planes, np.empty(shape, np.uint8), SIZE)
    np.testing.assert_array_equal(buf, jip.pack_yuv420_group(planes, np.empty(shape, np.uint8), SIZE))
    y, uv = tip.unpack_yuv420(torch.from_numpy(buf[0]), SIZE)
    jy, juv = jip.unpack_yuv420(jnp.asarray(buf[0]), SIZE)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(juv))
    rgb = tip.yuv420_to_rgb(y, uv)
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jip.yuv420_to_rgb(jy, juv)), atol=1e-4)
    mean, std = (0.48, 0.45, 0.40), (0.26, 0.26, 0.27)
    np.testing.assert_allclose(tip.normalize_pixels(rgb, mean, std).numpy(),
                               np.asarray(jip.normalize_pixels(jnp.asarray(rgb.numpy()), mean, std)), atol=1e-6)


@pytest.fixture(scope="module")
def stacks():
    jax_model, jax_cfg = _tiny_colpali(jnp.float32)
    jax_cfg = dataclasses.replace(jax_cfg, image_token_index=IMAGE_TOKEN)
    jax_model = JaxColPali(jax_cfg, dim=jax_model.dim, dtype=jnp.float32)
    n_img = jax_cfg.vision.num_patches
    ids = jnp.full((1, n_img + 4), IMAGE_TOKEN, jnp.int32)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), ids, jnp.ones_like(ids), jnp.zeros((1, SIZE, SIZE, 3)))
    model = ColPali(port_config(jax_cfg), dim=jax_model.dim, device="cpu")
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    kw = dict(image_size=SIZE, image_seq_length=n_img)
    tokenizer = WordTokenizer(IMAGE_TOKEN)
    return (jax_model, variables, JaxProcessor(tokenizer, **kw), model.eval(),
            ColPaliProcessor(tokenizer, device="cpu", **kw))


def test_process_images_matches_jax(stacks):
    _, _, jax_proc, _, proc = stacks
    pages = [_page(2), _page(3, 60, 80)]
    got, want = proc.process_images(pages, host_resize=True), jax_proc.process_images(pages, host_resize=True)
    assert set(got) == set(want) == {"input_ids", "attention_mask", "pixel_values"}
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])
    np.testing.assert_allclose(got["pixel_values"], want["pixel_values"], atol=1e-6)
    np.testing.assert_array_equal(proc.get_image_mask(got), jax_proc.get_image_mask(want))
    assert proc.get_image_mask(got).sum(axis=1).tolist() == [16, 16]
    # the default resizes on the device, as jax.image.resize does (tests/test_torch_processor_surface.py)
    default, jax_default = proc.process_images(pages), jax_proc.process_images(pages)
    np.testing.assert_allclose(default["pixel_values"], jax_default["pixel_values"], atol=1e-5)


@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("transport", ["rgb-u8", "yuv420", "gray"])
def test_embed_pages_fused_matches_jax(stacks, transport, chunk):
    jax_model, variables, jax_proc, model, proc = stacks
    pages = [_page(10 + i) for i in range(5)]  # the last group is padded
    want = jax_embed_pages_fused(jax_model.apply, variables, jax_proc, pages, transport=transport, batch_size=2,
                                 chunk=chunk)
    got = embed_pages_fused(model, proc, pages, transport=transport, batch_size=2, chunk=chunk)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape == (16 + 5, 32)  # image tokens, two <bos>, 3 words
        np.testing.assert_allclose(g, w, atol=2e-5)


@pytest.mark.parametrize("chunk,groups", [(1, 3), (2, 2), (3, 1)])
def test_embed_pages_fused_downloads_once_a_group(stacks, monkeypatch, chunk, groups):
    """Five pages at batch 2 make three forward batches: the host takes the
    embeddings and their mask once for each group of ``chunk`` of them."""
    model, proc = stacks[3], stacks[4]
    pages = [_page(10 + i) for i in range(5)]
    want = embed_pages_fused(model, proc, pages, transport="rgb-u8", batch_size=2)
    calls = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: calls.append(tuple(t.shape)) or cpu(t, *a, **k))
    got = embed_pages_fused(model, proc, pages, transport="rgb-u8", batch_size=2, chunk=chunk)
    assert len(calls) == 2 * groups
    assert [np.array_equal(g, w) for g, w in zip(got, want)] == [True] * 5


def test_embed_pages_fused_rejects_unknown_transport(stacks):
    with pytest.raises(ValueError, match="transport"):
        embed_pages_fused(stacks[3], stacks[4], [_page(0)], transport="jpeg")
    assert embed_pages_fused(stacks[3], stacks[4], []) == []


def test_embed_pages_fused_with_a_prompt_matches_jax_and_process_images(stacks):
    """``prompt=`` replaces the processor's prefix: the page embeds as
    ``process_images(context_prompts=[prompt])`` does through the model
    (rgb-u8: the same PIL resize on both routes)."""
    jax_model, variables, jax_proc, model, proc = stacks
    pages = [_page(20 + i) for i in range(3)]
    prompt = "<image><bos>Describe the chart on this page"
    got = embed_pages_fused(model, proc, pages, transport="rgb-u8", batch_size=2, prompt=prompt)
    want = jax_embed_pages_fused(jax_model.apply, variables, jax_proc, pages, transport="rgb-u8", batch_size=2,
                                 prompt=prompt)
    default = embed_pages_fused(model, proc, pages[:1], transport="rgb-u8", batch_size=2)
    assert got[0].shape == (16 + 8, 32) and default[0].shape == (16 + 5, 32)  # 6 prompt words against 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=2e-5)
    batch = proc.process_images(pages, context_prompts=[prompt] * 3, host_resize=True)
    with torch.no_grad():
        direct = model(input_ids=torch.from_numpy(batch["input_ids"]).long(),
                       attention_mask=torch.from_numpy(batch["attention_mask"]),
                       pixel_values=torch.from_numpy(batch["pixel_values"])).numpy()
    for row, g in zip(direct, got):
        np.testing.assert_allclose(g, row[batch["attention_mask"][0].astype(bool)], atol=2e-5)


def test_collator_device_pixels_matches_jax(stacks):
    """``VisualRetrieverCollator(device_pixels=True)`` keeps the pages'
    pixels a tensor where the processor lies (resized on the host first, as
    JAX's passes ``host_resize``), equal to JAX's device route and to the
    processor's own host-resize pixels; ``to_device`` takes the tensor as
    it is. A processor without the parameter ignores the flag."""
    from colpali_tpu.data.collator import VisualRetrieverCollator as JaxCollator
    from colpali_tpu_torch.data.collator import VisualRetrieverCollator
    from colpali_tpu_torch.training.trainer import to_device

    _, _, jax_proc, _, proc = stacks
    pages = [_page(30 + i) for i in range(3)]
    examples = [{"query": f"query {i}", "pos_target": p, "neg_target": [pages[(i + 1) % 3]]}
                for i, p in enumerate(pages)]
    got = VisualRetrieverCollator(proc, device_pixels=True)(examples)
    want = JaxCollator(jax_proc, device_pixels=True)(examples)
    plain = VisualRetrieverCollator(proc)(examples)
    assert set(got) == set(want) == set(plain)
    for key in ("doc_pixel_values", "neg_doc_pixel_values"):
        assert isinstance(got[key], torch.Tensor) and got[key].device == proc.device
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-6)
    assert got["neg_doc_pixel_values"].shape == (3, 1, SIZE, SIZE, 3)
    np.testing.assert_allclose(got["doc_pixel_values"].numpy(),
                               proc.process_images(pages, host_resize=True)["pixel_values"], atol=1e-6)
    assert isinstance(plain["doc_pixel_values"], np.ndarray)
    for key in ("query_input_ids", "doc_input_ids", "doc_attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    moved = to_device(got, proc.device)
    assert moved["doc_pixel_values"] is got["doc_pixel_values"] and moved["doc_input_ids"].dtype == torch.int64

    class NoDevicePixels:
        def __init__(self, proc):
            self.proc = proc

        def __getattr__(self, name):
            return getattr(self.proc, name)

        def process_images(self, images):
            return self.proc.process_images(images)

    assert not VisualRetrieverCollator(NoDevicePixels(proc), device_pixels=True).device_pixels
