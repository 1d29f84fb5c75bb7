"""Index model families (counterpart of ``parallel_hnsw_tpu.models``): the
plain layered graph (``Hnsw``), the two-level product-quantized index
(``QuantizedHnsw``), and the mesh-sharded corpus index (``ShardedHnsw``).
"""

from parallel_hnsw_tpu_torch.index import Hnsw
from parallel_hnsw_tpu_torch.pq import HnswQuantizer, QuantizedHnsw
from parallel_hnsw_tpu_torch.parallel.sharded import ShardedHnsw

__all__ = ["Hnsw", "HnswQuantizer", "QuantizedHnsw", "ShardedHnsw"]
