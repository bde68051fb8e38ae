"""Owner-computes node-sharded KL refinement: scalars per swap (the port
of ``eig_kl_tpu/parallel/sharded_kl2.py``, the engine of the CLI's ``kl
--sharded``).

The broadcast engine (:mod:`eig_kl_tpu_torch.parallel.sharded_kl`) sends
the two chosen adjacency rows to every rank each swap.  Here a rank also
holds the transpose of its rows (:func:`_transpose_partition`): for every
node ``v``, the (local row, weight) pairs of its rows' edges to ``v``, in
a dense level of at most :data:`_CMAX_DENSE` slots per column and a flat
overflow list for the tails of high-degree columns.  A swap then takes
one gather of 4 values per rank (both sides' candidates, :func:`select2`)
and one scalar sum for ``w_ab``, which only b's owner holds; each rank
updates its own rows of ``A @ s`` from its own entries of columns a and b,
and nothing else crosses between ranks.

The trajectory is the single-card engine's and the broadcast engine's:
the same selection ties, the same floating-point operations in the same
order.  The loop runs on the host, as :mod:`sharded_kl`'s does.
"""

from __future__ import annotations

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import Graph
from eig_kl_tpu_torch.kl.result import KLResult
from eig_kl_tpu_torch.parallel.mesh import Mesh
from eig_kl_tpu_torch.parallel.sharded_kl import sharded_pass
from eig_kl_tpu_torch.utils.config import KLConfig
from eig_kl_tpu_torch.utils.tracing import Tracer

# Dense-slot ceiling of the per-rank column lists: a column's entries
# past this many on one rank go to the rank's overflow list, so that one
# high-degree column does not widen every column's slots.
_CMAX_DENSE = 16


def _transpose_partition(g: Graph, n_pad: int, n_shards: int, dtype: torch.dtype, shard: int):
    """Shard ``shard``'s part of the two-level per-shard CSC of the shards'
    row ranges (``sharded_kl2.py:78``, whose arrays hold every shard's
    along a leading axis).

    Dense level: ``colT_rows[v, k]`` = the k-th local row of the shard
    with an edge to node v, for ``k < cmax`` (pad row 0, weight 0).
    Overflow level: the shard's other (local row, column, weight) entries,
    padded to the longest shard's list (column -1, weight 0).

    Returns ``(colT_rows int32[n_pad, cmax], colT_w [n_pad, cmax] of dtype,
    ov_rows int32[ov_max], ov_cols int32[ov_max], ov_w [ov_max], cmax)``;
    ``cmax`` and ``ov_max`` are the whole partition's.
    """
    n = g.num_nodes
    n_l = n_pad // n_shards
    rows = np.repeat(np.arange(n, dtype=np.int64), g.degrees)
    cols = g.indices.astype(np.int64)
    sh = rows // n_l
    key = sh * n_pad + cols
    uniq, counts = np.unique(key, return_counts=True)
    cmax = min(max(int(counts.max()) if counts.size else 1, 1), _CMAX_DENSE)
    order = np.argsort(key, kind="stable")
    rank = np.arange(rows.shape[0]) - np.repeat(np.searchsorted(key[order], uniq), counts)
    sh_o, co_o, ro_o = sh[order], cols[order], rows[order]
    w_o = torch.as_tensor(g.data[order]).to(dtype)
    dense = rank < cmax
    ov = ~dense
    ov_counts = np.bincount(sh_o[ov], minlength=n_shards)
    ov_max = max(int(ov_counts.max()) if ov_counts.size else 0, 1)
    ov_pos = np.zeros(rows.shape[0], dtype=np.int64)
    if ov.any():
        # Position of each overflow entry within its shard's list.
        ov_idx = np.flatnonzero(ov)
        ov_idx = ov_idx[np.argsort(sh_o[ov_idx], kind="stable")]
        ov_pos[ov_idx] = np.arange(ov_idx.size) - np.repeat(
            np.concatenate([[0], np.cumsum(ov_counts)[:-1]]), ov_counts
        )
    colT_rows = np.zeros((n_pad, cmax), np.int32)
    colT_w = torch.zeros((n_pad, cmax), dtype=dtype)
    d = dense & (sh_o == shard)
    colT_rows[co_o[d], rank[d]] = (ro_o[d] - shard * n_l).astype(np.int32)
    colT_w[co_o[d], rank[d]] = w_o[d]
    o = ov & (sh_o == shard)
    ov_rows = np.zeros(ov_max, np.int32)
    ov_cols = np.full(ov_max, -1, np.int32)
    ov_w = torch.zeros(ov_max, dtype=dtype)
    ov_rows[ov_pos[o]] = (ro_o[o] - shard * n_l).astype(np.int32)
    ov_cols[ov_pos[o]] = co_o[o].astype(np.int32)
    ov_w[ov_pos[o]] = w_o[o]
    return colT_rows, colT_w, ov_rows, ov_cols, ov_w, cmax


def sharded_refine_oc(
    g: Graph,
    sides: np.ndarray,
    mesh: Mesh,
    config: KLConfig = KLConfig(),
    *,
    dtype: torch.dtype = torch.float32,
    tracer: Tracer | None = None,
) -> KLResult:
    """Owner-computes sharded KL pass over the mesh's ``"mp"`` ranks:
    :func:`~eig_kl_tpu_torch.parallel.sharded_kl.sharded_refine`'s
    contract and trajectory, with 4 values per rank and one scalar of
    communication per swap.  ``dtype`` is f32, f64 or bf16; the node ids
    of the swap log are exact in each (the candidates' carrier,
    ``sharded_kl.py:_carrier``).  ``tracer`` receives the spans "kl.pass"
    and "kl.finalize"."""
    mp = mesh.axis_names[1]

    def prepare(sh):
        dev = sh.graph.device
        rows_h, w, ov_rows_h, ov_cols_h, ov_w, _cmax = _transpose_partition(
            g, sh.n_pad, mesh.shape[mp], dtype, shard=mesh.coords[mp]
        )
        w_h, ov_w_h = w.double().numpy(), ov_w.double().numpy()
        rows, w = torch.as_tensor(rows_h).long().to(dev), w.to(dev)
        ov_rows, ov_cols, ov_w = (torch.as_tensor(ov_rows_h).long().to(dev), torch.as_tensor(ov_cols_h).to(dev),
                                  ov_w.to(dev))
        zero = torch.zeros((), dtype=dtype, device=dev)
        b_lo, b_hi = sh.r0, sh.r0 + sh.n_l

        def swap(a, b, c_a, c_b, a_s_l):
            # w_ab: only b's owner holds the (b, a) entry of column a; it
            # reads it from its host copy (the one nonzero of the sum over
            # ranks, exact in any order).
            wab_l = 0.0
            if b_lo <= b < b_hi:
                hit = (rows_h[a] == b - b_lo) & (w_h[a] != 0)
                ov_hit = (ov_rows_h == b - b_lo) & (ov_cols_h == a)
                wab_l = float(w_h[a][hit].sum() + ov_w_h[ov_hit].sum())
            w_ab = float(mesh.sum(torch.tensor([wab_l], dtype=torch.float64), mp)[0])
            # Owner-computes A @ s: this rank's entries of columns a and b
            # into its own rows (each row holds at most one edge to a, one
            # to b; the dense and overflow lists touch disjoint rows).
            a_s_l.index_add_(0, rows[a], c_a * w[a])
            a_s_l.index_add_(0, rows[b], c_b * w[b])
            a_s_l.index_add_(0, ov_rows, c_a * torch.where(ov_cols == a, ov_w, zero))
            a_s_l.index_add_(0, ov_rows, c_b * torch.where(ov_cols == b, ov_w, zero))
            return w_ab

        return swap

    return sharded_pass(g, sides, mesh, config, dtype, tracer, prepare)
