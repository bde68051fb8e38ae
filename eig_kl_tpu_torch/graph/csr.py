"""Graph containers: host-side symmetric CSR and device-side CSR.

:class:`Graph` is the port's copy of the host container of
``eig_kl_tpu/graph/csr.py``.  :class:`DeviceGraph` differs from the JAX
package's: that one holds a padded ELL layout, because XLA wants static
shapes and the TPU gathers whole rows.  Here the device holds the CSR
arrays themselves, which is what the hand-written kernels read: the
SpMV walks each row's span, and the KL pass updates exactly the entries
of the two swapped rows.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from eig_kl_tpu_torch.ops.spmv_plan import V1Layout, V2Layout
    from eig_kl_tpu_torch.ops.spmv_v3 import SpmvPlanV3


#: The JAX package's plan rule runs its v1 SpMV kernel at or below this many
#: stored entries and its v2 kernels above (``ops/spmv_pallas.py:569``).
V1_MAX_NNZ = 32_768
#: Its plans pad the state to a multiple of this (``spmv_pallas.py:54``).
PLAN_WINDOW = 1024


@dataclasses.dataclass(frozen=True)
class CsrPlan:
    """The port's counterpart of the JAX package's v1 or v2 chunk plan
    (``eig_kl_tpu/ops/spmv_pallas.py:plan_for_graph``), attached by
    ``to_device(with_plan=True)``: the plan's layout
    (:mod:`eig_kl_tpu_torch.ops.spmv_plan`), which holds what the plan
    decides for the port, the padded length of the power solve's
    ``(P/128, 128)`` state and the order in which its TPU kernel adds each
    row.  A graph with a plan takes every f32 SpMV in that order, as the
    JAX package's graph does (``ops/partition.py:spmv``): the KL engine's,
    and the power solve's on the padded state.  :meth:`kernel_for` is the
    port's one copy of the JAX rule for v1 or v2.  Only v2 has the
    bf16-intermediate mode: a v1 plan ignores ``inter_dtype``
    (``spmv_pallas_2d`` ends in ``_spmv_call``), and so does the port; v2
    also falls back to f32 for a plan whose ``g1`` is not a multiple of
    2,048 (``spmv_pallas.py:474``), which :meth:`runs_bf16` reads."""

    layout: "V1Layout | V2Layout"

    @property
    def padded_nodes(self) -> int:
        return self.layout.padded_nodes

    @property
    def kernel(self) -> str:
        """"v1" or "v2": the TPU kernel whose order the plan's SpMV takes."""
        from eig_kl_tpu_torch.ops.spmv_plan import V1Layout

        return "v1" if isinstance(self.layout, V1Layout) else "v2"

    @staticmethod
    def kernel_for(nnz: int) -> str:
        """The kernel the JAX package's rule picks for a graph of ``nnz``
        stored entries."""
        return "v1" if nnz <= V1_MAX_NNZ else "v2"

    @classmethod
    def for_graph(cls, g: "DeviceGraph", kernel: str | None = None, **geometry) -> "CsrPlan":
        """The plan of ``g``'s matrix (its weights in f32) on ``g``'s device:
        the kernel of :meth:`kernel_for` unless ``kernel`` names one;
        ``geometry`` (``rblock``, ``quantum``) pins a v2 plan's.  The CSR
        arrays are read back to the host, where the plan is built."""
        return cls.from_csr(g.indptr.cpu().numpy(), g.indices.cpu().numpy(), g.data.cpu().numpy(), g.device,
                            kernel, **geometry)

    @classmethod
    def from_csr(cls, indptr: np.ndarray, indices: np.ndarray, data: np.ndarray, device: torch.device | str,
                 kernel: str | None = None, **geometry) -> "CsrPlan":
        """:meth:`for_graph` from the host's CSR arrays, the plan built on
        the host and its layout uploaded to ``device``."""
        from eig_kl_tpu_torch.ops.spmv_plan import build_v1_layout, build_v2_layout

        n = len(indptr) - 1
        kernel = kernel or cls.kernel_for(len(indices))
        if kernel not in ("v1", "v2"):
            raise ValueError(f"the plan kernel is 'v1' or 'v2', got {kernel!r}")
        coo = (np.repeat(np.arange(n, dtype=np.int64), np.diff(np.asarray(indptr, np.int64))), indices,
               np.asarray(data).astype(np.float32))
        if kernel == "v1":
            return cls(build_v1_layout(n, *coo, device))
        return cls(build_v2_layout(n, *coo, device, **geometry))

    def runs_bf16(self, inter_dtype: str) -> bool:
        """Whether the power solve's matvec rounds its products to bf16
        (``inter_dtype`` "bfloat16" on a v2 plan whose ``g1`` is a multiple
        of 2,048)."""
        if inter_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"inter_dtype is 'float32' or 'bfloat16', got {inter_dtype!r}")
        return inter_dtype == "bfloat16" and self.kernel == "v2" and self.layout.g1 % 2048 == 0


def ell_width(max_degree: int, pad_multiple: int = 8) -> int:
    """Row width of the JAX package's padded ELL (``Graph.to_device``)."""
    return max(-(-max_degree // pad_multiple) * pad_multiple, pad_multiple)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Symmetric weighted graph in CSR form (host / NumPy).

    Attributes:
      num_nodes: node count n.
      indptr: int64[n+1] CSR row offsets (both edge directions stored,
        like the flattened adjacency at gKL.cu:248-268).
      indices: int32[nnz] column indices, sorted within each row.
      data: float64[nnz] edge weights.
    """

    num_nodes: int
    indptr: np.ndarray
    indices: np.ndarray
    data: np.ndarray

    @classmethod
    def from_upper_coo(
        cls, n: int, rows: np.ndarray, cols: np.ndarray, weights: np.ndarray
    ) -> "Graph":
        """Build from deduplicated upper-triangular COO (rows < cols)."""
        r = np.concatenate([rows, cols]).astype(np.int64)
        c = np.concatenate([cols, rows]).astype(np.int64)
        w = np.concatenate([weights, weights])
        order = np.lexsort((c, r))
        r, c, w = r[order], c[order], w[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(r, minlength=n), out=indptr[1:])
        return cls(
            num_nodes=n,
            indptr=indptr,
            indices=c.astype(np.int32),
            data=np.asarray(w),
        )

    @classmethod
    def from_arrays(
        cls, indptr: np.ndarray, indices: np.ndarray, data: np.ndarray
    ) -> "Graph":
        """Wrap existing CSR arrays (for example the JAX package's
        ``Graph`` fields) without re-deriving them."""
        indptr = np.asarray(indptr, dtype=np.int64)
        return cls(
            num_nodes=int(indptr.shape[0] - 1),
            indptr=indptr,
            indices=np.asarray(indices, dtype=np.int32),
            data=np.asarray(data),
        )

    @property
    def nnz(self) -> int:
        """Stored entries (2x the undirected edge count)."""
        return int(self.indices.shape[0])

    @property
    def degrees(self) -> np.ndarray:
        """Unweighted degree (neighbors per node)."""
        return np.diff(self.indptr)

    @property
    def weighted_degrees(self) -> np.ndarray:
        """deg_i = sum_j w_ij."""
        out = np.zeros(self.num_nodes, dtype=self.data.dtype)
        np.add.at(out, np.repeat(np.arange(self.num_nodes), self.degrees), self.data)
        return out

    @property
    def total_weight(self) -> float:
        """Sum of undirected edge weights T = sum_{i<j} w_ij."""
        return float(self.data.sum()) / 2.0

    @property
    def max_degree(self) -> int:
        d = self.degrees
        return int(d.max()) if d.size else 0

    def relabel(self, perm: np.ndarray) -> "Graph":
        """Relabel nodes: old node ``perm[p]`` becomes new node ``p``
        (reproduces cKL's shuffled tie-break order, cKL.cpp:175-193)."""
        n = self.num_nodes
        new_id = np.empty(n, dtype=np.int64)
        new_id[perm] = np.arange(n, dtype=np.int64)
        rows = new_id[np.repeat(np.arange(n, dtype=np.int64), self.degrees)]
        cols = new_id[self.indices.astype(np.int64)]
        order = np.lexsort((cols, rows))
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        return Graph(
            num_nodes=n,
            indptr=indptr,
            indices=cols[order].astype(np.int32),
            data=self.data[order],
        )

    def to_device(
        self, device: torch.device | str, dtype: torch.dtype = torch.float32, with_plan: bool = False
    ) -> "DeviceGraph":
        """Upload the CSR arrays.  Weights, weighted degrees and the total
        weight are derived in float64 on the host and rounded once to
        ``dtype``, as the JAX package's ``Graph.to_device`` does.
        ``with_plan`` attaches the :class:`CsrPlan` the JAX package's rule
        picks (its ``to_device(with_plan=True)``, ``graph/csr.py:228``): the
        f32 SpMVs then take its order, and an f32 power solve iterates on
        the padded state."""
        if self.nnz >= 2**31:
            raise ValueError(f"nnz {self.nnz} does not fit int32 CSR offsets")
        np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
        g = DeviceGraph(
            indptr=torch.as_tensor(self.indptr.astype(np.int32)).to(device),
            indices=torch.as_tensor(self.indices.astype(np.int32)).to(device),
            data=torch.as_tensor(self.data.astype(np_dtype)).to(device),
            degrees=torch.as_tensor(
                np.asarray(self.weighted_degrees, dtype=np_dtype)
            ).to(device),
            total_weight=torch.as_tensor(
                np.asarray(self.total_weight, dtype=np_dtype)
            ).to(device),
            row_width=ell_width(self.max_degree),
        )
        if not with_plan:
            return g
        return dataclasses.replace(g, plan=CsrPlan.from_csr(self.indptr, self.indices, self.data, device))


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Device-resident CSR adjacency.

    Attributes:
      indptr: int32[n+1] row offsets.
      indices: int32[nnz] neighbor ids, sorted within each row.
      data: float[nnz] edge weights.
      degrees: float[n] weighted degrees (sum_j w_ij).
      total_weight: float scalar, T = sum_{i<j} w_ij.
      row_width: the JAX package's ELL width for this graph (the largest
        degree rounded up to a multiple of 8).  The SpMV's summation
        order follows it (:mod:`eig_kl_tpu_torch.ops.spmv`).
      plan: the JAX package's ``DeviceGraph.plan``: None, a
        :class:`CsrPlan` (``Graph.to_device(with_plan=True)``), or a v3 SpMV
        plan of the same matrix.  With a plan an f32 power solve iterates
        on the padded ``(P/128, 128)`` state (``spectral/power.py``), and
        every f32 SpMV takes the plan's route: a CSR plan's TPU kernel order,
        or the v3 route.  Attach one with ``dataclasses.replace(g,
        plan=CsrPlan.for_graph(g))`` or ``dataclasses.replace(g,
        plan=build_plan_v3_for_graph(host, dev))``.
    """

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    degrees: torch.Tensor
    total_weight: torch.Tensor
    row_width: int
    plan: "SpmvPlanV3 | CsrPlan | None" = None

    @property
    def num_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @functools.cached_property
    def plan_layout(self) -> "V1Layout | V2Layout | None":
        """The layout of the JAX package's v1 or v2 plan of this matrix
        (:mod:`eig_kl_tpu_torch.ops.spmv_plan`), whose order the mega
        engine's ``A @ s`` takes: the attached :class:`CsrPlan`'s, else the
        one the JAX rule picks (:meth:`CsrPlan.kernel_for`), built on the
        host at the first use and kept with the graph, as the JAX
        ``MegaGraph`` keeps its ``spmv_plan``; None for an f64 graph (the TPU
        kernels are f32 only)."""
        if self.dtype != torch.float32:
            return None
        plan = self.plan if isinstance(self.plan, CsrPlan) else CsrPlan.for_graph(self)
        return plan.layout


def device_graph_from_jax(
    ell_indices: np.ndarray,
    ell_weights: np.ndarray,
    degrees: np.ndarray,
    total_weight: np.ndarray,
    device: torch.device | str,
) -> DeviceGraph:
    """The port's CSR :class:`DeviceGraph` from the arrays of a JAX
    package ``DeviceGraph`` (passed as numpy).

    ELL rows are padded with ``(row, 0.0)``; those pads are dropped.  The
    graph has no self-loops, so a ``(row, 0.0)`` entry is always a pad.
    Row order and each row's entry order are kept, so the CSR holds the
    same values in the same order as the host ``Graph`` the ELL was
    built from.
    """
    idx = np.asarray(ell_indices)
    w = np.asarray(ell_weights)
    n = idx.shape[0]
    keep = ~((idx == np.arange(n)[:, None]) & (w == 0))
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    return DeviceGraph(
        indptr=torch.as_tensor(indptr).to(device),
        indices=torch.as_tensor(idx[keep].astype(np.int32)).to(device),
        data=torch.as_tensor(np.ascontiguousarray(w[keep])).to(device),
        degrees=torch.as_tensor(np.array(degrees)).to(device),
        total_weight=torch.as_tensor(np.array(total_weight)).to(device),
        row_width=int(idx.shape[1]),
    )
