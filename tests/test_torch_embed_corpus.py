"""Port parity: ``python -m colpali_tpu_torch.embed_corpus`` against
``scripts/embed_corpus.py`` on ``scripts/validate_checkpoint.py::
make_synth_colpali``'s offline checkpoint.

Both scripts run on the CPU in fp32 (each package's ``load_retriever``
patched to ``dtype=float32``; the scripts load bf16 by default). Pages are
pooled by factor 2 with the scipy Ward pooler on both sides: the ``emb_<i>``
arrays agree at atol 1e-5 (the forwards' fp32 sums in another order, as in
tests/test_torch_checkpoint.py), ``files.json`` is equal, and the packed
index each writes loads in the other package and returns the same ids.
"""

import functools
import json
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import colpali_tpu.auto as jax_auto  # noqa: E402
from colpali_tpu.models.paligemma import ColPali as JaxColPali  # noqa: E402
from colpali_tpu.retrieval.store import CorpusIndex as JaxIndex  # noqa: E402
from colpali_tpu_torch import auto, embed_corpus  # noqa: E402
from colpali_tpu_torch.retrieval.store import CorpusIndex  # noqa: E402

ATOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import validate_checkpoint as vc

    root = tmp_path_factory.mktemp("embed_corpus")
    init = JaxColPali.init
    JaxColPali.init = lambda self, rng, *args: jax.jit(lambda r, *a: init(self, r, *a))(rng, *args)  # compiled once
    try:
        vc.make_synth_colpali(str(root / "ckpt"))
    finally:
        JaxColPali.init = init
    pages = root / "pages"
    pages.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, size=(40 + 3 * i, 30, 3), dtype=np.uint8)).save(pages / f"p{i}.png")
    (pages / "notes.txt").write_text("not a page")
    return root


def _ours(args):
    with mock.patch.object(auto, "load_retriever", functools.partial(auto.load_retriever, dtype=torch.float32)):
        embed_corpus.main([*args, "--device", "cpu"])


def _theirs(args):
    import embed_corpus as jax_cli

    with mock.patch.object(sys, "argv", ["embed_corpus.py", *args]), \
            mock.patch.object(jax_auto, "load_retriever",
                              functools.partial(jax_auto.load_retriever, dtype=jnp.float32)):
        jax_cli.main()


def _arrays(path):
    with np.load(path) as data:
        return [data[f"emb_{i}"] for i in range(len(data.files))]


@pytest.mark.parametrize("route", [[], ["--transport", "rgb-u8"]], ids=["embed_dataset", "fused"])
def test_embeddings_and_packed_index_match_jax(corpus, tmp_path, route, capsys):
    common = ["colpali", str(corpus / "ckpt"), str(corpus / "pages")]
    flags = ["--pool-factor", "2", "--index-prefilter", "--batch-size", "2", *route]
    _ours([*common, str(tmp_path / "ours.npz"), "--save-index", str(tmp_path / "ours_idx.npz"), *flags])
    out = capsys.readouterr().out
    assert "Pooled" in out and "Embedded 5 pages" in out and "Packed index" in out
    _theirs([*common, str(tmp_path / "theirs.npz"), "--save-index", str(tmp_path / "theirs_idx.npz"), *flags])
    got, want = _arrays(tmp_path / "ours.npz"), _arrays(tmp_path / "theirs.npz")
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape and g.shape[0] < 16 + 5  # pooled by 2
        np.testing.assert_allclose(g, w, atol=ATOL)
    files = json.loads((tmp_path / "ours.npz.files.json").read_text())
    assert files == json.loads((tmp_path / "theirs.npz.files.json").read_text()) == [f"p{i}.png" for i in range(5)]
    assert json.loads((tmp_path / "ours_idx.npz.files.json").read_text()) == files

    queries = [g[:3] for g in got]
    ours_in_jax = JaxIndex.load(str(tmp_path / "ours_idx.npz"))
    jax_in_ours = CorpusIndex.load(str(tmp_path / "theirs_idx.npz"), device="cpu")
    ours = CorpusIndex.load(str(tmp_path / "ours_idx.npz"), device="cpu")
    assert (ours.num_docs, ours.prefilter) == (5, "binary") and ours.doc_tokens == jax_in_ours.doc_tokens
    ids = ours.search(queries, k=3)[1]
    for other in (ours_in_jax, jax_in_ours):
        np.testing.assert_array_equal(np.asarray(other.search(queries, k=3)[1]), ids)
    assert ids[:, 0].tolist() == list(range(5))


class _NoImagePipeline:
    """A processor of another family: no fixed image size, no audio or video."""

    visual_prompt_prefix = "<image>"


@pytest.mark.parametrize("flags, message", [
    (["--transport", "yuv420"], "--transport requires a fixed-resolution processor (the ColPali/PaliGemma family)"),
    (["--modality", "audio"], "--modality audio requires an audio-capable family (ColQwen-Omni); "
                              "_NoImagePipeline has no process_audios"),
    (["--modality", "video"], "--modality video requires a video-capable family (ColQwen-Omni); "
                              "_NoImagePipeline has no process_videos"),
])
def test_refusals_match_jax(corpus, tmp_path, flags, message, capsys):
    args = ["colqwen2", str(corpus / "ckpt"), str(corpus / "pages"), str(tmp_path / "out.npz"), *flags]
    with mock.patch.object(auto, "load_retriever", lambda *a, **k: (torch.nn.Linear(1, 1), _NoImagePipeline())), \
            pytest.raises(SystemExit) as ours:
        embed_corpus.main(args)
    ours_err = capsys.readouterr().err
    import embed_corpus as jax_cli

    with mock.patch.object(sys, "argv", ["embed_corpus.py", *args]), \
            mock.patch.object(jax_auto, "load_retriever", lambda *a, **k: (None, None, _NoImagePipeline())), \
            pytest.raises(SystemExit) as theirs:
        jax_cli.main()
    theirs_err = capsys.readouterr().err
    assert ours.value.code == theirs.value.code == 2
    assert ours_err.strip().endswith(message) and theirs_err.strip().endswith(message)
    assert not (tmp_path / "out.npz").exists()
