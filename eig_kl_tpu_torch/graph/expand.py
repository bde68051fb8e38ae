"""Clique expansion: hypergraph -> weighted graph (the port's copy of
``eig_kl_tpu/graph/expand.py``: a NumPy expansion, and the native C++
builder of :mod:`eig_kl_tpu_torch.io.native_io`, which gives the same
arrays).

Each k-pin net is expanded into all k(k-1)/2 node pairs; weights of
duplicate pairs accumulate.  Two weight conventions exist in the
reference and both are kept:

* ``"eig"``: weight ``2/k`` per pair (cEIG.cpp:110), the spectral
  Laplacian's weighting.
* ``"kl"``: weight ``1/(k-1)`` per pair (cKL.cpp:117, gKL.cu:602), used
  by KL refinement and by the power solver (gKL2.cu:262-303).

Nets with fewer than 2 pins contribute nothing (gKL.cu:622).  Nets are
grouped by size so each group becomes one reshape + fancy-index, and
duplicate accumulation is one ``np.unique`` + ``np.bincount``.
"""

from __future__ import annotations

import numpy as np

from eig_kl_tpu_torch.graph.csr import Graph
from eig_kl_tpu_torch.io import native_io
from eig_kl_tpu_torch.io.hgr import Hypergraph

_WEIGHTINGS = ("eig", "kl")


def _pair_weight(weighting: str, k: int) -> float:
    if weighting == "eig":
        return 2.0 / float(k)
    if weighting == "kl":
        return 1.0 / (float(k) - 1.0)
    raise ValueError(f"weighting must be one of {_WEIGHTINGS}, got {weighting!r}")


def expand_pairs(
    hg: Hypergraph, weighting: str = "kl"
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand every net into (u, v, w) pair triples with u, v unordered
    and duplicates *not yet* merged.  Returns int64 u, v and float64 w.
    """
    sizes = hg.net_sizes.astype(np.int64)
    us, vs, ws = [], [], []
    for k in np.unique(sizes):
        if k < 2:
            continue
        sel = np.nonzero(sizes == k)[0]
        starts = hg.net_offsets[sel]
        pk = hg.pins[starts[:, None] + np.arange(k)[None, :]].astype(np.int64)
        ju, ku = np.triu_indices(int(k), 1)
        us.append(pk[:, ju].ravel())
        vs.append(pk[:, ku].ravel())
        w = _pair_weight(weighting, int(k))
        ws.append(np.full(pk.shape[0] * ju.size, w, dtype=np.float64))
    if not us:
        z = np.zeros(0, dtype=np.int64)
        return z, z.copy(), np.zeros(0, dtype=np.float64)
    return np.concatenate(us), np.concatenate(vs), np.concatenate(ws)


def clique_expand(
    hg: Hypergraph,
    weighting: str = "kl",
    *,
    dtype=np.float64,
    use_native: bool | None = None,
) -> Graph:
    """Clique-expand a hypergraph into a symmetric weighted :class:`Graph`.

    Duplicate pairs are weight-accumulated (Eigen's ``setFromTriplets``
    dup-sum at cEIG.cpp:124, the ``+=`` insert at cKL.cpp:128);
    self-loops from repeated pins within one net are dropped.
    ``use_native``: force (True) or forbid (False) the native builder;
    None = use it if the host library builds, else NumPy.  A failure of
    the built library raises.
    """
    if weighting not in _WEIGHTINGS:
        raise ValueError(f"weighting must be one of {_WEIGHTINGS}, got {weighting!r}")
    if use_native or (use_native is None and native_io.available()):
        return native_io.clique_expand_native(hg, weighting, dtype=dtype)
    u, v, w = expand_pairs(hg, weighting)
    keep = u != v
    u, v, w = u[keep], v[keep], w[keep]
    n = hg.num_nodes
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    key = lo * n + hi
    uniq, inv = np.unique(key, return_inverse=True)
    acc = np.bincount(inv, weights=w, minlength=uniq.size)
    lo = (uniq // n).astype(np.int32)
    hi = (uniq % n).astype(np.int32)
    return Graph.from_upper_coo(n, lo, hi, acc.astype(dtype))
