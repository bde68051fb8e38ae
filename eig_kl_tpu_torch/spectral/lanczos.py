"""Thick-restart Lanczos for the Fiedler pair (lambda_2, v_2) (the port of
``eig_kl_tpu/spectral/lanczos.py:44-207``).

The reference's spectral phase uses Spectra's implicitly restarted
Lanczos on the clique-expansion Laplacian with nev=2,
ncv=min(100, n/2) (cEIG.cpp:193-207).  This is the JAX package's
thick-restart Lanczos (TRLan, mathematically equivalent to implicit
restarting):

* the exact zero eigenpair (the constant vector) is deflated
  analytically: every operator output is projected onto the complement
  of ``ones``, so the solver targets lambda_2 directly;
* full two-pass reorthogonalization against the basis (``V @ w``,
  ``V.T @ c``, ``torch.matmul`` on the graph's device);
* ``L x = deg * x - A x`` is K1's Laplacian entry point on the card
  (:func:`eig_kl_tpu_torch.ops.spmv.laplacian`), one launch per step.

The m-step pass is a Python loop over tensors on the graph's device; the
restart loop reads one pair of scalars (the residual and lambda) per
restart, and keeps the JAX package's restart, stagnation and tolerance
rules.  The mean of ``_deflate`` and the vector norms add in XLA's order
(:mod:`eig_kl_tpu_torch.ops.reduce`, K6 on the card); ``eigh`` runs on
the graph's device in the solve's dtype.  In f32 the matrix products add
in another order than XLA's CPU dot, so the trajectory is not the JAX
package's bit for bit: the contract is numerical (``tests/test_torch_lanczos.py``).

Caveat (as in the JAX package and the reference's Spectra solve): a
disconnected graph has lambda_2 = 0 with the multiplicity of its
components, and the "Fiedler vector" is then an arbitrary null vector.
The generator's circuits are disconnected; run the solver on a connected
graph, or use the power init.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph
from eig_kl_tpu_torch.ops.reduce import tree_norm, tree_sum
from eig_kl_tpu_torch.ops.spmv import laplacian
from eig_kl_tpu_torch.utils.config import SpectralConfig
from eig_kl_tpu_torch.utils.threefry import normal


class LanczosResult(NamedTuple):
    eigenvalue: torch.Tensor  # lambda_2, 0-d on the graph's device
    vector: torch.Tensor  # Fiedler vector, unit norm
    residual: torch.Tensor  # ||L v - lambda v||
    restarts: int
    converged: bool


def with_dtype(g: DeviceGraph, dtype: torch.dtype) -> DeviceGraph:
    """The graph with its weights, degrees and total weight in ``dtype``."""
    if g.dtype == dtype:
        return g
    return dataclasses.replace(
        g, data=g.data.to(dtype), degrees=g.degrees.to(dtype), total_weight=g.total_weight.to(dtype)
    )


def laplacian_matvec(g: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """L x = deg * x - A x (L = D - A, the PSD clique-expansion Laplacian
    built at cEIG.cpp:86-133)."""
    return laplacian(g, x)


def _deflate(x: torch.Tensor) -> torch.Tensor:
    """Project out the constant nullvector: x - mean(x)."""
    return x - tree_sum(x) / x.shape[0]


def _lanczos_pass(g: DeviceGraph, V: torch.Tensor, H: torch.Tensor, j_start: int, m: int):
    """Extend the Lanczos factorization from basis size ``j_start`` to ``m``
    in place: ``V`` is ``(m + 1, n)``, ``H`` the ``(m, m)`` Rayleigh-Ritz
    matrix ``V^T L V``, whose full projection coefficients subsume both the
    tridiagonal part and the arrow head after a thick restart."""
    for j in range(j_start, m):
        # The exact nullvector is handled by deflation alone: every operator
        # output is projected off `ones` here and again after the
        # orthogonalization, so rounding cannot regrow a spurious lambda ~ 0.
        w = _deflate(laplacian_matvec(g, V[j]))
        # Two-pass full reorthogonalization.  Rows j+1.. of V are zero here,
        # so the JAX package's products over the whole V add only exact
        # zeros more than these over V[:j+1].
        Vj = V[: j + 1]
        c1 = Vj @ w
        w = w - Vj.T @ c1
        c2 = Vj @ w
        w = w - Vj.T @ c2
        w = _deflate(w)
        c = c1 + c2
        # Column j and row j of the symmetric Rayleigh-Ritz matrix (its
        # entries past j are zero until set below).
        H[: j + 1, j] = c
        H[j, : j + 1] = c
        beta = tree_norm(w)
        safe = beta > 1e-30
        V[j + 1] = torch.where(safe, w / torch.where(safe, beta, 1.0), 0.0)
        if j + 1 < m:
            H[j + 1, j] = beta
            H[j, j + 1] = beta
    return V, H


def lanczos_fiedler(
    g: DeviceGraph,
    config: SpectralConfig = SpectralConfig(),
    *,
    dtype: torch.dtype = torch.float64,
) -> LanczosResult:
    """Compute (lambda_2, v_2) of the clique-expansion Laplacian.

    Args:
      g: DeviceGraph built with the "eig" weighting (2/k).
      config: tolerances; ``num_lanczos`` defaults to min(100, n//2) like
        Spectra's ncv (cEIG.cpp:195).
      dtype: float64 (the default, on the card and on the CPU) for
        Spectra parity; float32 with the host refinement of
        :func:`eig_partition`.
    """
    n = g.num_nodes
    m = config.num_lanczos or min(100, max(n // 2, 2))
    m = min(m, n - 1)
    keep = max(2, min(16, m // 3))
    tol = config.tolerance
    g = with_dtype(g, dtype)
    dev = g.device

    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    v0 = _deflate(torch.as_tensor(normal(config.seed, (n,), np_dtype)).to(dev))
    v0 = v0 / tree_norm(v0)

    V = torch.zeros(m + 1, n, dtype=dtype, device=dev)
    V[0] = v0
    H = torch.zeros(m, m, dtype=dtype, device=dev)
    j_start = 0

    lam = torch.zeros((), dtype=dtype, device=dev)
    vec = v0
    res_norm = torch.full((), torch.inf, dtype=dtype, device=dev)
    converged = False
    restarts = 0

    prev_res = float("inf")
    stagnant = 0
    max_restarts = max(config.max_iterations // m, 30)
    for restarts in range(1, max_restarts + 1):
        V, H = _lanczos_pass(g, V, H, j_start, m)
        theta, Y = torch.linalg.eigh(H)
        # The true residual of the wanted Ritz pair, recovered explicitly
        # (one more Laplacian).
        vec = _deflate(V[:m].T @ Y[:, 0])
        vec = vec / tree_norm(vec)
        lam = theta[0]
        r = _deflate(laplacian_matvec(g, vec)) - lam * vec
        res_norm = tree_norm(r)
        res_host, lam_host = torch.stack([res_norm, lam]).tolist()  # the sync
        if res_host < tol * max(1.0, abs(lam_host)):
            converged = True
            break
        # Stagnation stop: f32 residuals floor out far above f64
        # tolerances; return the current (good) Ritz pair.
        if res_host > 0.7 * prev_res:
            stagnant += 1
            if stagnant >= 2:
                break
        else:
            stagnant = 0
        prev_res = res_host
        # Thick restart: lock the `keep` smallest Ritz vectors, then
        # re-append the residual direction as the next basis vector.
        U = (V[:m].T @ Y[:, :keep]).T
        U = U - U.mean(dim=1, keepdim=True)
        U = U / torch.linalg.vector_norm(U, dim=1, keepdim=True)
        r_vec = _deflate(V[m])
        r_norm = tree_norm(r_vec)
        ok = r_norm > 1e-30
        r_vec = torch.where(ok, r_vec / torch.where(ok, r_norm, 1.0), V[m])
        V_new = torch.zeros_like(V)
        V_new[:keep] = U
        V_new[keep] = r_vec
        H = torch.zeros_like(H)
        H[range(keep), range(keep)] = theta[:keep]
        V = V_new
        j_start = keep

    return LanczosResult(
        eigenvalue=lam, vector=vec, residual=res_norm, restarts=restarts, converged=converged
    )
