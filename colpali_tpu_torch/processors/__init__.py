from colpali_tpu_torch.processors.base import BaseVisualRetrieverProcessor  # noqa: F401
from colpali_tpu_torch.processors.bi import (  # noqa: F401
    BiIdefics3Processor,
    BiPaliProcessor,
    BiQwen2_5_Processor,
    BiQwen2Processor,
    BiQwen3_5Processor,
    BiQwen3Processor,
)
from colpali_tpu_torch.processors.colpali import ColPaliProcessor  # noqa: F401
from colpali_tpu_torch.processors.gemma3 import (  # noqa: F401
    BiGemma3Processor,
    BiGemmaProcessor3,
    ColGemma3Processor,
    ColGemmaProcessor3,
)
from colpali_tpu_torch.processors.idefics3 import ColIdefics3Processor  # noqa: F401
from colpali_tpu_torch.processors.modernvbert import BiModernVBertProcessor, ColModernVBertProcessor  # noqa: F401
from colpali_tpu_torch.processors.qwen2_5_vl import ColQwen2_5_Processor, ColQwen2_5Processor  # noqa: F401
from colpali_tpu_torch.processors.qwen2_vl import ColQwen2Processor  # noqa: F401
from colpali_tpu_torch.processors.qwen3_vl import ColQwen3_5Processor, ColQwen3Processor  # noqa: F401
