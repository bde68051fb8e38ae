"""Node-sharded power iteration over the ranks of a mesh (the port of
``eig_kl_tpu/parallel/sharded_power.py``).

Each rank computes its rows of the gKL2 step ``y = x - (L x) / shift``
(gKL2.cu:65-89, 335-353) from the whole iterate: K1's power step on the
rank's rows (:func:`~eig_kl_tpu_torch.ops.spmv.power_step` on a graph
that holds only them, in XLA's ELL order), its partial sum of squares as
XLA's vector dot (:func:`~eig_kl_tpu_torch.ops.reduce.fma_dot`), the sum
over ranks in rank order, the correctly rounded root, K6's scale, then one
``all_gather`` rebuilds the iterate on every rank.  The exit is the
"gkl2" rule, ``|nrm - prev| < tolerance`` after ``min_power_iters``
steps, read on the host every step; the Rayleigh quotient of the
normalised Laplacian is summed over ranks the same way.  Rows are padded
to a multiple of the ``"mp"`` size with zero-degree dummies, on which the
iterate stays 0.
"""

from __future__ import annotations

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import Graph
from eig_kl_tpu_torch.ops.reduce import fma_dot, normalize, sqrt_rn
from eig_kl_tpu_torch.ops.spmv import power_step, spmv
from eig_kl_tpu_torch.parallel.mesh import Mesh
from eig_kl_tpu_torch.parallel.sharded_kl import _shard
from eig_kl_tpu_torch.utils.config import SpectralConfig
from eig_kl_tpu_torch.utils.threefry import uniform

#: The iteration count of the most recent run (as the JAX module keeps it).
last_iterations: int = 0


def sharded_power_fiedler(
    g: Graph,
    mesh: Mesh,
    config: SpectralConfig = SpectralConfig(solver="power"),
    *,
    dtype: torch.dtype = torch.float32,
):
    """The gKL2 power iteration with its nodes split over the mesh's
    ``"mp"`` ranks; every rank of the mesh calls it and gets the same
    result.

    Args:
      g: host graph with the "kl" weighting (gKL2 reuses the KL adjacency
        for its Laplacian, gKL2.cu:262-303).
      mesh: rows are padded to a multiple of its ``"mp"`` size.
      dtype: f32 or f64.

    Returns:
      ``(rayleigh_quotient, fiedler_vector[n])``, a 0-d tensor and a vector
      on the rank's device: the contract of the single-card solve's "gkl2"
      exit.  The start is the JAX ``uniform(PRNGKey(seed)) - 0.5``
      (:func:`~eig_kl_tpu_torch.utils.threefry.uniform`).
    """
    global last_iterations
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the sharded power iteration runs f32 or f64, not {dtype}")
    mp, dev, n = mesh.axis_names[1], mesh.device, g.num_nodes
    sh = _shard(g, mesh, dtype, dev)
    r0, n_l = sh.r0, sh.n_l
    gl = sh.graph
    safe_deg = torch.where(gl.degrees > 0, gl.degrees, torch.ones((), dtype=dtype, device=dev))
    inv_shift = 1.0 / config.shift
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    x = torch.zeros(sh.n_pad, dtype=dtype)
    x[:n] = torch.as_tensor(uniform(config.seed, n, np_dtype) - np_dtype.type(0.5))
    x = x.to(dev)

    def step(x):
        y_l = power_step(gl, x, safe_deg, inv_shift)[r0 : r0 + n_l]
        nrm = sqrt_rn(mesh.sum(fma_dot(y_l, y_l).reshape(1), mp)[0])
        y_l = normalize(y_l, nrm)
        return mesh.all_gather(y_l, mp).reshape(-1), nrm

    x, nrm = step(x)
    prev = torch.zeros((), dtype=dtype, device=dev)
    it = 1
    while not (bool(torch.abs(nrm - prev) < config.tolerance) and it > config.min_power_iters):
        if it >= config.max_iterations:
            break
        x, nrm2 = step(x)
        prev, nrm = nrm, nrm2
        it += 1
    x_l = x[r0 : r0 + n_l]
    lx_l = 2.0 * x_l - 2.0 * spmv(gl, x)[r0 : r0 + n_l] / safe_deg[r0 : r0 + n_l]
    valid = torch.arange(r0, r0 + n_l, device=dev) < n
    lx_l = torch.where(valid, lx_l, torch.zeros((), dtype=dtype, device=dev))
    lam = mesh.sum(fma_dot(x_l.contiguous(), lx_l.contiguous()).reshape(1), mp)[0]
    last_iterations = it
    return lam, x[:n]
