from colpali_tpu_torch.compression.token_pooling import (  # noqa: F401
    DeviceWardTokenPooler,
    HierarchicalTokenPooler,
    KMeansTokenPooler,
    LambdaTokenPooler,
    TokenPoolingOutput,
    kmeans_pool_padded,
    ward_pool_padded,
)
