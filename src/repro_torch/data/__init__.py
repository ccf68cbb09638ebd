from .pipeline import (DataConfig, TokenPipeline, frontend_features,
                       make_batch, shard_batch)

__all__ = ["DataConfig", "TokenPipeline", "frontend_features", "make_batch",
           "shard_batch"]
