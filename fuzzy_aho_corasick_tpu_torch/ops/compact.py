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


def dilate_any(flags: torch.Tensor, span: int) -> torch.Tensor:
    """``out[i] = any(flags[i : i + span])`` for a 1-D bool or integer tensor
    (positions past the end read as 0): ceil(log2(span)) shifted ORs."""
    if span <= 1:
        return flags
    f, d = flags, 1
    while d < span:
        s = min(d, span - d)
        g = f.clone()
        g[:-s] |= f[s:]
        f = g
        d += s
    return f
