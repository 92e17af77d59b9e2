from colpali_tpu_torch.data.collator import VisualRetrieverCollator  # noqa: F401
from colpali_tpu_torch.data.dataset import ColPaliEngineDataset, Corpus  # noqa: F401
from colpali_tpu_torch.data.sampler import SingleDatasetBatchSampler  # noqa: F401
