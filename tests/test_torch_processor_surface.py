"""Port parity: the processor's surface (colpali_tpu_torch against
colpali_tpu): ``from_pretrained`` reading ``preprocessor_config.json``,
``save_pretrained`` round trips, ``get_n_patches``, ``process_queries``
with JAX's signature, ``load_tokenizer``, and the default device resize of
``process_images`` (``jax.image.resize``: Keys cubic a = -0.5, antialiased).

Pixels are normalized floats in [-1, 1] computed in fp32. Against JAX's
own pixels: 1e-5 (measured up to 4.7e-6 on these pages). Against JAX's
weight matrices (``jax._src.image.scale.compute_weight_mat``, the function
``jax.image.resize`` calls) contracted in fp64: 1e-5 at every size. At 448
px from a 1,650 x 1,275 page JAX's own CPU result sits 4.7e-5 from that fp64
value (1.7e-5 from a 300 x 200 one): inside its compiled resize XLA
normalizes the weights with a low-precision reciprocal (its effective
weights differ from ``compute_weight_mat``'s by up to 2.1e-5), so those
cases are held to the fp64 oracle at 1e-5 and to JAX's pixels at 1e-4.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from jax._src.image import scale as jax_scale

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

from colpali_tpu.processors import image_processing as jip  # noqa: E402
from colpali_tpu.processors.colpali import ColPaliProcessor as JaxProcessor  # noqa: E402
from colpali_tpu_torch.processors import image_processing as tip  # noqa: E402
from colpali_tpu_torch.processors.base import load_tokenizer  # noqa: E402
from colpali_tpu_torch.processors.colpali import ColPaliProcessor  # noqa: E402


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    """A tokenizer and preprocessor config as make_synth_colpali writes them (28 px pages)."""
    import validate_checkpoint as vc

    path = tmp_path_factory.mktemp("processor")
    vc._save_paligemma_word_tokenizer(str(path))
    with open(path / "preprocessor_config.json", "w") as f:
        json.dump({"size": {"height": 28, "width": 28}, "image_mean": [0.5, 0.5, 0.5], "image_std": [0.5, 0.5, 0.5]},
                  f)
    return str(path)


@pytest.fixture(scope="module")
def pair(ckpt_dir):
    return ColPaliProcessor.from_pretrained(ckpt_dir, device="cpu"), JaxProcessor.from_pretrained(ckpt_dir)


def _page(seed, h, w):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3), dtype=np.uint8)


def test_from_pretrained_honours_the_preprocessor_config(pair):
    proc, jax_proc = pair
    assert (proc.image_size, proc.image_seq_length, proc.patch_size) == (28, 4, 14)
    assert (jax_proc.image_size, jax_proc.image_seq_length) == (28, 4)
    assert proc.image_mean == jax_proc.image_mean and proc.image_std == jax_proc.image_std
    batch = proc.process_images([_page(0, 40, 30)])
    assert batch["pixel_values"].shape == (1, 28, 28, 3) and proc.get_image_mask(batch).sum() == 4


def test_save_pretrained_round_trips(pair, tmp_path):
    proc, jax_proc = pair
    proc.save_pretrained(str(tmp_path / "ours"))
    jax_proc.save_pretrained(str(tmp_path / "theirs"))
    assert (tmp_path / "ours" / "preprocessor_config.json").read_text() == (
        tmp_path / "theirs" / "preprocessor_config.json").read_text()
    assert (tmp_path / "ours" / "tokenizer.json").exists() and not (tmp_path / "ours" / "processor_config.json").exists()
    again = ColPaliProcessor.from_pretrained(str(tmp_path / "ours"), device="cpu", image_size=56)
    assert (again.image_size, again.image_seq_length) == (56, 4)  # kwargs last, as in JAX
    again = ColPaliProcessor.from_pretrained(str(tmp_path / "ours"), device="cpu")
    assert (again.image_size, again.image_seq_length, again.image_mean) == (28, 4, proc.image_mean)
    np.testing.assert_array_equal(again.process_queries(["a b"])["input_ids"], proc.process_queries(["a b"])["input_ids"])


def test_get_n_patches_and_process_queries_match_jax(pair):
    proc, jax_proc = pair
    for size, patch in (((1650, 1275), None), ((40, 30), 7)):
        assert proc.get_n_patches(size, patch) == jax_proc.get_n_patches(size, patch)
    kw = dict(max_length=12, contexts=["ctx one", "ctx two"])
    got = proc.process_queries(["find page", "what revenue"], **kw)
    want = jax_proc.process_queries(["find page", "what revenue"], **kw)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_array_equal(proc.process_queries(queries=["x"], suffix="!")["input_ids"],
                                  jax_proc.process_queries(queries=["x"], suffix="!")["input_ids"])
    with pytest.raises(ValueError):
        proc.process_queries(texts=["a"], queries=["b"])


def test_load_tokenizer_reads_the_checkpoint(ckpt_dir, pair):
    tok = load_tokenizer(ckpt_dir)
    assert tok.convert_tokens_to_ids("<image>") == pair[0].image_token_id


@pytest.mark.parametrize("hw", [(40, 30), (1650, 1275)])
def test_process_images_default_matches_jax(pair, hw):
    """The checkpoint's 28-px pages from both sizes, and a mixed batch (grouped by shape, order restored)."""
    proc, jax_proc = pair
    pages = [_page(1, *hw), _page(2, 50, 70), _page(3, *hw)]
    got, want = proc.process_images(pages), jax_proc.process_images(pages)
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_allclose(got["pixel_values"], want["pixel_values"], atol=1e-5)
    host = proc.process_images(pages, host_resize=True)["pixel_values"]
    np.testing.assert_allclose(host, jax_proc.process_images(pages, host_resize=True)["pixel_values"], atol=1e-6)
    tensor = proc.process_images(pages, device_pixels=True)["pixel_values"]
    assert tensor.device.type == "cpu" and np.array_equal(tensor.numpy(), got["pixel_values"])


def _fp64_oracle(image, size, method="bicubic"):
    kernel = jax_scale._kernels[jax_scale.ResizeMethod.from_string(method)]
    x = image.astype(np.float64)
    for axis, n in ((0, size), (1, size)):
        m = x.shape[axis]
        w = np.asarray(jax_scale.compute_weight_mat(m, n, jnp.float32(n / m), jnp.float32(0.0), kernel, True),
                       np.float64)
        x = np.moveaxis(np.tensordot(w, np.moveaxis(x, axis, 0), axes=([0], [0])), 0, axis)
    return (x / 255.0 - 0.5) / 0.5


@pytest.mark.parametrize("hw,size,tol_jax", [((40, 30), 448, 1e-5), ((300, 200), 448, 1e-4), ((825, 640), 448, 1e-4)])
def test_device_resize_matches_jax_weights_in_fp64(hw, size, tol_jax):
    page = _page(4, *hw)
    got = tip.preprocess_images_fixed([page], size=(size, size))[0]
    np.testing.assert_allclose(got, _fp64_oracle(page, size), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jip.preprocess_images_fixed([page], size=(size, size)))[0],
                               atol=tol_jax)


@pytest.mark.parametrize("method", ["linear", "lanczos3", "lanczos5", "nearest"])
def test_other_resize_methods_match_jax(method):
    pages = [_page(5, 40, 30), _page(6, 90, 120)]
    got = tip.preprocess_images_fixed(pages, size=(56, 56), method=method)
    want = np.asarray(jip.preprocess_images_fixed(pages, size=(56, 56), method=method))
    np.testing.assert_allclose(got, want, atol=1e-5)
    with pytest.raises(ValueError, match="unknown resize method"):
        tip.preprocess_images_fixed(pages, size=(56, 56), method="gaussian")


def test_restore_group_order():
    import torch

    parts = [torch.tensor([[0.0], [2.0]]), torch.tensor([[1.0]])]
    assert tip.restore_group_order(parts, [[0, 2], [1]]).flatten().tolist() == [0.0, 1.0, 2.0]
    assert tip.restore_group_order(parts[:1], [[0, 1]]).flatten().tolist() == [0.0, 2.0]
