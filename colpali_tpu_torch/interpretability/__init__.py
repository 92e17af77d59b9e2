from colpali_tpu_torch.interpretability.similarity_maps import (  # noqa: F401
    get_similarity_maps_from_embeddings,
    normalize_similarity_map,
    plot_all_similarity_maps,
    plot_similarity_map,
)
from colpali_tpu_torch.interpretability.split_image import (  # noqa: F401
    get_split_image_similarity_maps,
    rearrange_image_embeddings,
)
