"""The reference's "upper" median ``sorted[n // 2]`` (gKL2.cu:396-398).

The JAX package computes it with a sort, or on the TPU with a 32-pass
bit search that returns the same value (``eig_kl_tpu/ops/select.py``).
Here it is one order statistic, ``torch.kthvalue``, whose rank is
1-based.  The value is bit-identical to the sorted element, except that
-0.0 and +0.0 may stand in for each other; they compare equal in
``median > v``, the only place the median is used.
"""

from __future__ import annotations

import torch


def upper_median(v: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """``sort(v)[n // 2]`` as a 0-d tensor on ``v``'s device."""
    if n is None:
        n = v.shape[0]
    return torch.kthvalue(v, n // 2 + 1).values
