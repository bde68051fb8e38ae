"""Sums in one fixed order, the same on every device.

The power solver's sign exit compares median splits of iterates in
which hundreds of nodes tie with the median to the last bit (symmetric
positions in the graph converge to equal values).  A one-ulp change in
the step's norm moves nodes across the median, and the split and the KL
pass that follow differ.  A fixed summation order removes that:
:func:`tree_sum` adds in the order XLA's CPU backend uses for a 1-D sum
(its tree-reduction rewrite), so that, with the SpMV's fixed row order
(:mod:`eig_kl_tpu_torch.ops.spmv`), the port's iterate on the CPU and on
the card equals the JAX package's CPU iterate bit for bit.

The order: zero-pad the vector to a multiple of 32, the padding split
between the two ends (the smaller half in front); add each window of 32
in sequence; repeat until at most 32 values remain; add those in
sequence.
"""

from __future__ import annotations

import torch

_WINDOW = 32


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of the 1-D tensor ``v`` in the fixed order above (0-d tensor)."""
    while v.numel() > _WINDOW:
        m = -(-v.numel() // _WINDOW)
        lo = (m * _WINDOW - v.numel()) // 2
        w = torch.zeros(m * _WINDOW, dtype=v.dtype, device=v.device)
        w[lo : lo + v.numel()] = v
        w = w.view(m, _WINDOW)
        acc = torch.zeros(m, dtype=v.dtype, device=v.device)
        for k in range(_WINDOW):
            acc = acc + w[:, k]
        v = acc
    acc = torch.zeros((), dtype=v.dtype, device=v.device)
    for x in v.unbind():
        acc = acc + x
    return acc


def tree_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x . y`` with the products summed by :func:`tree_sum`."""
    return tree_sum(x * y)


def tree_norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm with the squares summed by :func:`tree_sum`.

    An f32 root is taken in f64 and rounded once, which gives the
    correctly rounded f32 root on every device (PyTorch's f32 ``sqrt`` on
    the CPU is sometimes an ulp off; XLA's is correctly rounded).
    """
    s = tree_sum(x * x)
    if s.dtype == torch.float32:
        return torch.sqrt(s.double()).float()
    return torch.sqrt(s)
