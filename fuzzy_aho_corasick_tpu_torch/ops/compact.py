"""Device stream compaction.

The JAX package compacts with a prefix sum built from matmuls and a 128-ary
search, because XLA needs static output shapes and its gathers were slow on
the TPU. On the GPU ``torch.nonzero`` returns the exact count and the
positions in ascending order, so there is no capacity to size and nothing to
retry.
"""

from __future__ import annotations

import torch


def compact_indices(flags: torch.Tensor) -> torch.Tensor:
    """Ascending int64 positions of the non-zero entries of a 1-D tensor."""
    return torch.nonzero(flags).reshape(-1)
