"""Port parity: colpali_tpu_torch.data (sampler, collator, dataset) and the
dummy processor against colpali_tpu's. The sampler and dataset are pure
Python copies, so orders and values are compared exactly; the dummy
processor's image resize goes through ``F.interpolate`` in place of
``jax.image.resize`` (both an antialiased triangle filter) and is held to
atol=1e-4 on pixels in [-1, 1].
"""

import random

import numpy as np
import pytest
import torch

from colpali_tpu.data.collator import VisualRetrieverCollator as JaxCollator
from colpali_tpu.data.dataset import ColPaliEngineDataset as JaxDataset
from colpali_tpu.data.sampler import SingleDatasetBatchSampler as JaxSampler
from colpali_tpu.utils.dataset_loading import load_dummy_dataset as jax_dummy_dataset
from colpali_tpu.utils.testing import DummyProcessor as JaxDummyProcessor
from colpali_tpu_torch.data.collator import VisualRetrieverCollator, _pad_axis, pick_bucket
from colpali_tpu_torch.data.dataset import ColPaliEngineDataset, Corpus
from colpali_tpu_torch.data.sampler import SingleDatasetBatchSampler
from colpali_tpu_torch.utils.testing import DummyProcessor, load_dummy_dataset


@pytest.mark.parametrize("seed", [0, 7])
def test_sampler_order_equals_jax(seed):
    datasets = [list(range(10)), list(range(7)), list(range(2))]
    ours, theirs = SingleDatasetBatchSampler(datasets, 3, seed=seed), JaxSampler(datasets, 3, seed=seed)
    assert len(ours) == len(theirs) == 5
    for epoch in (0, 1, 5):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        assert list(ours) == list(theirs)
    ours.set_epoch(0)
    first = list(ours)
    ours.set_epoch(1)
    assert list(ours) != first
    with pytest.raises(NotImplementedError):
        SingleDatasetBatchSampler(datasets, 3, drop_last=False)


def _examples(n, negatives):
    rng = np.random.default_rng(0)
    image = lambda: rng.integers(0, 255, size=(28, 28, 3), dtype=np.uint8)  # noqa: E731
    rows = [{"query": f"find the page number {i} please", "pos_target": image()} for i in range(n)]
    if negatives:
        for row in rows:
            row["neg_target"] = [image(), image()]
    return rows


@pytest.mark.parametrize("negatives", [False, True])
def test_collator_equals_jax(negatives):
    rows = _examples(4, negatives)
    kw = dict(neg_target_column_name="neg_target") if negatives else {}
    ours = VisualRetrieverCollator(DummyProcessor())([ColPaliEngineDataset(rows, **kw)[i] for i in range(4)])
    theirs = JaxCollator(JaxDummyProcessor())([JaxDataset(rows, **kw)[i] for i in range(4)])
    assert ours.keys() == theirs.keys()
    assert ("neg_doc_pixel_values" in ours) == negatives
    for key in ours:
        assert ours[key].dtype == theirs[key].dtype and ours[key].shape == theirs[key].shape, key
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ours["query_input_ids"].shape == (4, 6)  # the 10 augmentation tokens hash to nothing
    if negatives:
        assert ours["neg_doc_pixel_values"].shape == (4, 2, 28, 28, 3)
        assert ours["neg_doc_input_ids"].shape == (4, 2, 6)


def test_static_padding_equals_jax_and_pads_tensors_in_place():
    rows = _examples(3, False)
    ours = VisualRetrieverCollator(DummyProcessor(), pad_seq_to=[4, 16])([ColPaliEngineDataset(rows)[i] for i in range(3)])
    theirs = JaxCollator(JaxDummyProcessor(), pad_seq_to=[4, 16])([JaxDataset(rows)[i] for i in range(3)])
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])
    assert ours["query_input_ids"].shape == (3, 16) and ours["query_attention_mask"][:, 6:].sum() == 0
    assert pick_bucket(5, [4, 16]) == 16 and pick_bucket(5, 6, multiple=4) == 8
    with pytest.raises(ValueError, match="largest pad bucket"):
        pick_bucket(17, [4, 16])
    t = torch.ones(2, 3, 5)
    padded = _pad_axis(t, -2, 6)
    assert isinstance(padded, torch.Tensor) and padded.shape == (2, 6, 5) and padded[:, 3:].abs().sum() == 0
    assert _pad_axis(t, -2, 2) is t


def test_collator_rejects_bad_examples():
    collate = VisualRetrieverCollator(DummyProcessor())
    with pytest.raises(KeyError, match="query"):
        collate([{"pos_target": "x"}])
    with pytest.raises(ValueError, match="strings"):
        collate([{"query": 3, "pos_target": "x"}])
    with pytest.raises(ValueError, match="Unsupported"):
        collate([{"query": "q", "pos_target": 3.5}])


def test_dataset_with_corpus_and_negative_subsampling():
    corpus = Corpus([{"doc": f"doc {i}"} for i in range(6)])
    data = [{"query": "q", "pos_target": 2, "neg_target": [0, 1, 3, 4, 5]}]
    kw = dict(neg_target_column_name="neg_target", num_negatives=3)
    ours = ColPaliEngineDataset(data, corpus, rng=random.Random(0), **kw)[0]
    from colpali_tpu.data.dataset import Corpus as JaxCorpus

    theirs = JaxDataset(data, JaxCorpus([{"doc": f"doc {i}"} for i in range(6)]), rng=random.Random(0), **kw)[0]
    assert ours == theirs and ours["pos_target"] == ["doc 2"] and len(ours["neg_target"]) == 3
    with pytest.raises(ValueError, match="Empty"):
        ColPaliEngineDataset([])


def test_dummy_dataset_and_processor_follow_jax():
    ours, theirs = load_dummy_dataset(5, image_size=64), jax_dummy_dataset(5, image_size=64)
    assert len(ours) == len(theirs) == 5
    for i in range(5):
        assert ours[i]["query"] == theirs[i]["query"] == f"synthetic query {i}"
        np.testing.assert_array_equal(ours[i]["pos_target"][0], theirs[i]["pos_target"][0])
    images = [ours[i]["pos_target"][0] for i in range(2)]
    a, b = DummyProcessor().process_images(images), JaxDummyProcessor().process_images(images)
    np.testing.assert_array_equal(a["input_ids"], b["input_ids"])
    np.testing.assert_allclose(a["pixel_values"], b["pixel_values"], atol=1e-4)  # 64 -> 28: resized on both sides
    texts = ["one two three", "four"]
    for key, value in DummyProcessor().process_queries(queries=texts).items():
        np.testing.assert_array_equal(value, JaxDummyProcessor().process_queries(queries=texts)[key])


def test_prefetch_lets_go_of_its_source_when_the_consumer_stops():
    """A consumer that stops early (``ColModelTraining`` at ``max_steps``)
    leaves no producer thread blocked on the full queue holding the source
    and what it refers to."""
    import gc
    import threading
    import time
    import weakref

    from colpali_tpu_torch.data.prefetch import prefetch

    class Source:
        def batches(self):
            yield from range(10)

    source = Source()
    alive = weakref.ref(source)
    it = prefetch(source.batches(), buffer_size=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    del it, source
    deadline = time.monotonic() + 5
    while alive() is not None and time.monotonic() < deadline:
        gc.collect()
        time.sleep(0.01)
    assert alive() is None and not [t for t in threading.enumerate() if "producer" in t.name]
    assert list(prefetch(iter(range(5)))) == list(range(5))  # a consumer that reads to the end
