"""Core id/sentinel conventions, shared with :mod:`parallel_hnsw_tpu.constants`.

* ids (both vector ids and node ids) are ``int32``
* the empty id sentinel is ``EMPTY_ID = 2**31 - 1`` (int32 max) so that empty
  slots sort *after* every real id under an ascending ``(distance, id)`` sort
* the empty distance sentinel is ``+inf`` so empty slots sort last
"""

from __future__ import annotations

import torch

# int32 max: sorts after every valid id; analogous to the reference's `!0`.
EMPTY_ID: int = 2**31 - 1

# f32 +inf: sorts after every valid distance; the reference uses f32::MAX.
EMPTY_DIST: float = float("inf")

ID_DTYPE = torch.int32
DIST_DTYPE = torch.float32

# Epsilon used by self-match tests (reference: src/search.rs:173-187).  It
# needs full fp32 distances: TF32 matmuls (~1e-3 relative) would break it.
MATCH_EPSILON: float = 1e-5
