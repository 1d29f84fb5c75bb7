from parallel_hnsw_tpu_torch.parallel.sharded import (
    Mesh,
    ShardedHnsw,
    ShardedQuantizedHnsw,
    default_mesh,
)

__all__ = ["Mesh", "ShardedHnsw", "ShardedQuantizedHnsw", "default_mesh"]
