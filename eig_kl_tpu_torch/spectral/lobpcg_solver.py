"""Preconditioned block LOBPCG for the smallest nontrivial Laplacian pair
(the port of ``eig_kl_tpu/spectral/lobpcg_solver.py:35-130``).

Knyazev's locally optimal basis ``[X | W | P]`` with Rayleigh-Ritz on the
orthonormalized 3k-column subspace, aimed at the smallest end of the
spectrum, with a Jacobi (inverse-degree) preconditioner and analytic
deflation of the constant nullvector.  Per iteration: two blocked
Laplacians ``deg * X - A X`` (K1's blocked entry point on the card,
:func:`eig_kl_tpu_torch.ops.spmv.spmm`, one launch over the k = 4 columns
of X and one over the 3k = 12 of the Rayleigh-Ritz basis, where the JAX
package ``vmap``s its SpMV), one ``(n, 3k)`` QR and one ``(3k, 3k)``
``eigh`` on the graph's device.  The JAX package's ``while_loop`` is a host
loop with the same condition, one scalar read per iteration.

``qr`` and ``eigh`` take their signs and the completion of a rank-deficient
basis (the first iteration's zero ``P``) from LAPACK on the CPU and
cuSOLVER on the card, so the trajectory is held to the JAX package's
numerically, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph
from eig_kl_tpu_torch.ops.spmv import spmm
from eig_kl_tpu_torch.spectral.lanczos import with_dtype
from eig_kl_tpu_torch.utils.config import SpectralConfig
from eig_kl_tpu_torch.utils.threefry import normal


class LobpcgResult(NamedTuple):
    eigenvalue: torch.Tensor  # lambda_2, 0-d on the graph's device
    vector: torch.Tensor  # Fiedler vector, unit norm
    iterations: int
    residual: torch.Tensor  # ||L v - lambda v|| of the returned pair


def _lobpcg_core(g: DeviceGraph, k: int, m: int, tol: float, seed: int, dtype: torch.dtype):
    n = g.num_nodes
    g = with_dtype(g, dtype)
    dev = g.device
    deg = g.degrees
    inv_deg = torch.where(deg > 0, 1.0 / torch.where(deg > 0, deg, 1.0), 1.0)

    def deflate(X):
        return X - X.mean(dim=0, keepdim=True)

    def lap(X):  # L X = deg * X - A X, one blocked launch
        return spmm(g, X.contiguous(), laplacian=True)

    def rayleigh_ritz(S):
        """Orthonormalize S, Rayleigh-Ritz, return the smallest-k pairs."""
        Q, _ = torch.linalg.qr(deflate(S))
        AQ = lap(Q)
        G = Q.T @ AQ
        theta, Y = torch.linalg.eigh(0.5 * (G + G.T))
        return Q, theta[:k], Y[:, :k]

    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    X0 = deflate(torch.as_tensor(normal(seed, (n, k), np_dtype)).to(dev))
    Q0, theta, Y0 = rayleigh_ritz(X0)
    X = Q0 @ Y0
    P = torch.zeros_like(X)
    res = torch.full((k,), torch.inf, dtype=dtype, device=dev)
    it = 0
    while it < m:
        # Converge on the wanted (smallest) pair only.
        r0, t0 = torch.stack([res[0], theta[0]]).tolist()  # the sync
        if r0 <= tol * max(1.0, abs(t0)):
            break
        AX = lap(X)
        R = AX - X * theta[None, :]
        res = torch.linalg.vector_norm(R, dim=0)
        W = deflate(inv_deg[:, None] * R)  # Jacobi-preconditioned step
        S = torch.cat([X, W, P], dim=1)
        Q, theta2, Y = rayleigh_ritz(S)
        X2 = Q @ Y
        # New conjugate direction: the part of X2 outside span(X).
        P2 = X2 - X @ (X.T @ X2)
        pn = torch.linalg.vector_norm(P2, dim=0)
        ok = pn[None, :] > 1e-12
        P = torch.where(ok, P2 / torch.where(pn > 1e-12, pn, 1.0)[None, :], 0.0)
        X, theta = X2, theta2
        it += 1
    vec = deflate(X[:, 0])
    vec = vec / torch.linalg.vector_norm(vec)
    Lv = lap(vec[:, None])[:, 0]
    lam = vec @ Lv
    resid = torch.linalg.vector_norm(Lv - lam * vec)
    return lam, vec, it, resid


def lobpcg_fiedler(
    g: DeviceGraph,
    config: SpectralConfig = SpectralConfig(solver="lobpcg"),
    *,
    dtype: torch.dtype = torch.float64,
) -> LobpcgResult:
    """Compute (lambda_2, v_2) of the clique-expansion Laplacian.

    Args:
      g: DeviceGraph built with the "eig" weighting (2/k).
      config: ``max_iterations`` caps LOBPCG iterations; ``tolerance`` is
        the relative residual bound on the wanted pair.
      dtype: f64 (the default, on the card and on the CPU) for golden
        parity; f32 with the host refinement of :func:`eig_partition`.
    """
    k = 4 if g.num_nodes >= 32 else 2  # the wanted pair + guard vectors
    lam, vec, iters, resid = _lobpcg_core(
        g, k=k, m=config.max_iterations, tol=config.tolerance, seed=config.seed, dtype=dtype
    )
    return LobpcgResult(eigenvalue=lam, vector=vec, iterations=iters, residual=resid)
