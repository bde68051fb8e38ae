"""Cut-size and KL-gain semantics as dense vector algebra (the port of
``eig_kl_tpu/ops/partition.py``).

Encode the partition as a signed side vector ``s in {+1, -1}^n`` (side 0
-> +1, side 1 -> -1).  With the symmetric weighted adjacency ``A``:

* ``D = E - I = -s * (A s)``: every node's KL D-value is one SpMV;
* ``E_i = (deg_i - s_i (A s)_i) / 2`` and
  ``cut = (sum_i deg_i - s^T A s) / 4``;
* swapping a (side 0) with b (side 1) changes the cut by
  ``-(D_a + D_b - 2 w_ab)`` (cKL.cpp:360, gKL.cu:384-414).
"""

from __future__ import annotations

import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph
from eig_kl_tpu_torch.ops.reduce import tree_dot, tree_sum
from eig_kl_tpu_torch.ops.spmv import spmv


def sides_to_signs(sides: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """0/1 side labels -> +1/-1 signs (side 0 -> +1.0)."""
    return (1.0 - 2.0 * sides.to(dtype)).to(dtype)


def signs_to_sides(s: torch.Tensor) -> torch.Tensor:
    """+1/-1 signs -> 0/1 side labels."""
    return (s < 0).to(torch.int8)


def gains(
    g: DeviceGraph, s: torch.Tensor, a_s: torch.Tensor | None = None
) -> torch.Tensor:
    """KL D-values for all nodes: ``D = E - I = -s * (A s)``."""
    if a_s is None:
        a_s = spmv(g, s)
    return -s * a_s


def external_costs(
    g: DeviceGraph, s: torch.Tensor, a_s: torch.Tensor | None = None
) -> torch.Tensor:
    """Per-node external weight E_i = (deg_i - s_i (A s)_i) / 2."""
    if a_s is None:
        a_s = spmv(g, s)
    return 0.5 * (g.degrees - s * a_s)


def cut_size(
    g: DeviceGraph, s: torch.Tensor, a_s: torch.Tensor | None = None
) -> torch.Tensor:
    """Total cut weight, evaluated from scratch (the reference's
    termination oracle, gKL.cu:524-530).  Both sums add in the fixed
    order of :mod:`eig_kl_tpu_torch.ops.reduce`."""
    if a_s is None:
        a_s = spmv(g, s)
    return 0.25 * (tree_sum(g.degrees) - tree_dot(s, a_s))


def edge_weight(g: DeviceGraph, u: int, v: int) -> torch.Tensor:
    """w(u, v), 0 if absent (getEdgeWeight, cKL.cpp:75-82)."""
    lo, hi = int(g.indptr[u]), int(g.indptr[u + 1])
    row = g.indices[lo:hi]
    return torch.where(row == v, g.data[lo:hi], 0.0).sum()


def swap_gain(g: DeviceGraph, d: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Cut reduction from swapping nodes a and b across the cut:
    ``gain = D_a + D_b - 2 w_ab`` (cKL.cpp:360; gKL.cu:384-414)."""
    return d[a] + d[b] - 2.0 * edge_weight(g, a, b)
