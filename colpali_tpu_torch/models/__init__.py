"""The port's retrievers (counterpart of :mod:`colpali_tpu.models`): the
reference's flat exports of the ported families."""

from colpali_tpu_torch.models.configs import (  # noqa: F401
    DenseHeadConfig,
    GemmaConfig,
    MultiVectorHeadConfig,
    PaliGemmaConfig,
    SiglipVisionConfig,
)
from colpali_tpu_torch.models.gemma3 import (  # noqa: F401
    BiGemma3,
    ColGemma3,
    Gemma3Backbone,
    Gemma3Config,
    Gemma3TextConfig,
)
from colpali_tpu_torch.models.idefics3 import (  # noqa: F401
    BiIdefics3,
    ColIdefics3,
    Idefics3Backbone,
    Idefics3Config,
    Idefics3VisionConfig,
)
from colpali_tpu_torch.models.modernvbert import (  # noqa: F401
    BiModernVBert,
    ColModernVBert,
    ModernBertTextConfig,
    ModernVBertConfig,
    ModernVBertForMaskedLM,
    ModernVBertModel,
)
from colpali_tpu_torch.models.paligemma import BiPali, BiPaliProj, ColPali, PaliGemmaBackbone  # noqa: F401
from colpali_tpu_torch.models.qwen2_5_vl import (  # noqa: F401
    BiQwen2_5,
    ColQwen2_5,
    Qwen25VLBackbone,
    Qwen25VLConfig,
    Qwen25VLVisionConfig,
)
from colpali_tpu_torch.models.qwen2_vl import (  # noqa: F401
    BiQwen2,
    ColQwen2,
    Qwen2TextConfig,
    Qwen2VLBackbone,
    Qwen2VLConfig,
    Qwen2VLVisionConfig,
)
from colpali_tpu_torch.models.qwen3_5 import (  # noqa: F401
    BiQwen3_5,
    ColQwen3_5,
    Qwen35TextConfig,
    Qwen35VLBackbone,
    Qwen35VLConfig,
)
from colpali_tpu_torch.models.qwen3_vl import (  # noqa: F401
    BiQwen3,
    ColQwen3,
    Qwen3TextConfig,
    Qwen3VLBackbone,
    Qwen3VLConfig,
    Qwen3VLVisionConfig,
)
