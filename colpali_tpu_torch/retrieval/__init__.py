from colpali_tpu_torch.retrieval.hardneg import mine_hard_negatives  # noqa: F401
from colpali_tpu_torch.retrieval.ingest import embed_pages_fused  # noqa: F401
from colpali_tpu_torch.retrieval.store import CorpusIndex, DeviceIndexBuilder  # noqa: F401
