from .embedding_cache import (cache_embeddings, embedding_cache_dir,
                              load_embedding_cache)
from .feature_cache import (cache_features_from_loader,
                            canonical_backbone_name, feature_cache_dir,
                            feature_cache_exists,
                            feature_cache_exists_sharded,
                            read_preprojection_cache,
                            write_preprojection_cache)

__all__ = [
    "cache_embeddings",
    "cache_features_from_loader",
    "canonical_backbone_name",
    "embedding_cache_dir",
    "feature_cache_dir",
    "feature_cache_exists",
    "feature_cache_exists_sharded",
    "load_embedding_cache",
    "read_preprojection_cache",
    "write_preprojection_cache",
]
