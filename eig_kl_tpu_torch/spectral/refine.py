"""Host f64 Krylov polish for a device-computed f32 Fiedler pair (the
port's own copy of ``eig_kl_tpu/spectral/refine.py:37-144``).

It serves an f32 solve (``eig --f32``, or ``dtype=torch.float32``): the
card solves in f64 by default, as the JAX package does off the TPU, and
then no refinement runs.  An f32 solve still has to meet the parity bar,
Spectra's double-precision lambda_2 to 1e-6 (cEIG.cpp:193-207,
pre_saved_EIG/*_out.txt:1).  Iterative refinement splits the work by
precision requirement:

* the *convergence* work -- O(100s) of SpMVs at n ~ 10^5-10^6 -- runs
  on the card in f32
  (:func:`eig_kl_tpu_torch.spectral.lanczos.lanczos_fiedler`), which
  lands the Ritz vector within ~1e-3 of the true Fiedler vector;
* the *precision* work -- a ~25-step f64 Lanczos seeded with that
  vector -- runs on host CSR (scipy / numpy), costing ~25 sparse
  matvecs (~tens of ms at 1M nnz) and converging lambda_2 to well
  below 1e-6 because the seed already overlaps the target eigenvector
  at ~0.999.

This is the refinement pass SURVEY.md section 7 calls for ("f64 only in
the eigensolve convergence path ... to meet the 1e-6 bar").
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from eig_kl_tpu_torch.graph.csr import Graph


class RefineResult(NamedTuple):
    eigenvalue: float      # lambda_2 in f64
    vector: np.ndarray     # refined Fiedler vector, f64, unit norm
    residual: float        # ||L v - lambda v|| in f64
    steps: int


def _host_laplacian_matvec(graph: Graph):
    """Return a closure computing L x = deg * x - A x in f64 on host."""
    try:
        import scipy.sparse as sp

        A = sp.csr_matrix(
            (
                graph.data.astype(np.float64),
                graph.indices.astype(np.int64),
                graph.indptr,
            ),
            shape=(graph.num_nodes, graph.num_nodes),
        )
        wdeg = np.asarray(A.sum(axis=1)).reshape(-1)

        def matvec(x):
            return wdeg * x - A @ x

    except ImportError:  # numpy fallback: bincount scatter-add
        n = graph.num_nodes
        rows = np.repeat(np.arange(n, dtype=np.int64), graph.degrees)
        cols = graph.indices.astype(np.int64)
        w = graph.data.astype(np.float64)
        wdeg = np.bincount(rows, weights=w, minlength=n)

        def matvec(x):
            return wdeg * x - np.bincount(
                rows, weights=w * x[cols], minlength=n
            )

    return matvec


def refine_fiedler_host(
    graph: Graph,
    v0: np.ndarray,
    *,
    steps: int = 25,
    tol: float = 1e-9,
) -> RefineResult:
    """Polish an approximate Fiedler vector to f64 accuracy.

    Runs a fully-reorthogonalized f64 Lanczos on the host Laplacian,
    seeded with ``v0`` (deflated against the constant nullvector), and
    returns the smallest Ritz pair of the Krylov subspace.  Because the
    seed is already a good approximation, a ~25-dim subspace reduces
    the residual by many orders of magnitude.

    Args:
      graph: host CSR graph with the "eig" (2/k) weighting.
      v0: approximate Fiedler vector (any float dtype).
      steps: max Krylov dimension.
      tol: stop early once ||L v - lambda v|| <= tol * max(1, |lambda|).
    """
    matvec = _host_laplacian_matvec(graph)
    n = graph.num_nodes
    m = min(steps, max(n - 1, 1))

    v = np.asarray(v0, dtype=np.float64)
    v = v - v.mean()
    nrm = np.linalg.norm(v)
    if nrm == 0:  # degenerate seed: fall back to a fixed random start
        rng = np.random.default_rng(0)
        v = rng.standard_normal(n)
        v = v - v.mean()
        nrm = np.linalg.norm(v)
    v = v / nrm

    V = np.zeros((m + 1, n))
    T = np.zeros((m, m))
    V[0] = v
    lam = 0.0
    vec = v
    res = np.inf
    j_done = 0
    for j in range(m):
        w = matvec(V[j])
        w -= w.mean()  # deflate the exact nullvector
        # Full reorthogonalization (two passes) against the basis.
        c1 = V[: j + 1] @ w
        w -= V[: j + 1].T @ c1
        c2 = V[: j + 1] @ w
        w -= V[: j + 1].T @ c2
        w -= w.mean()
        c = c1 + c2
        T[: j + 1, j] = c
        T[j, : j + 1] = c
        j_done = j + 1
        # Ritz pair of the current subspace + explicit residual.
        theta, Y = np.linalg.eigh(T[:j_done, :j_done])
        lam = float(theta[0])
        vec = V[:j_done].T @ Y[:, 0]
        vec -= vec.mean()
        vec /= np.linalg.norm(vec)
        r = matvec(vec) - lam * vec
        r -= r.mean()
        res = float(np.linalg.norm(r))
        if res <= tol * max(1.0, abs(lam)):
            break
        beta = np.linalg.norm(w)
        if beta <= 1e-14:
            break
        V[j + 1] = w / beta
        if j + 1 < m:
            T[j + 1, j] = beta
            T[j, j + 1] = beta

    return RefineResult(eigenvalue=lam, vector=vec, residual=res, steps=j_done)
