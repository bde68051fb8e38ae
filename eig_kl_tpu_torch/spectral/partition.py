"""Median-split partitioning of the Fiedler vector, and the spectral
partition ("EIG") pipeline (the port of
``eig_kl_tpu/spectral/partition.py``).

Two median conventions exist in the reference and both are kept:

* ``"average"`` (cEIG.cpp:55-65): for even n the average of the two
  middle elements.
* ``"upper"`` (gKL2.cu:396-398): plain ``sorted[n/2]``.

Side assignment is ``side = (median > value)`` (cEIG.cpp:218,
gKL2.cu:403-414), i.e. values >= median go to side 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph
from eig_kl_tpu_torch.io.eigfile import EigResult
from eig_kl_tpu_torch.io.hgr import Hypergraph
from eig_kl_tpu_torch.utils.config import SpectralConfig, resolve_solver
from eig_kl_tpu_torch.utils.device import resolve_device
from eig_kl_tpu_torch.utils.tracing import Tracer


def median_split(values: torch.Tensor, convention: str = "average"):
    """Split node values at the median.

    Returns (median, sides) with ``sides[i] = median > values[i]``.
    """
    v = torch.sort(values).values
    n = values.shape[0]
    if convention == "average":
        med = v[n // 2] if n % 2 else 0.5 * (v[(n - 1) // 2] + v[n // 2])
    elif convention == "upper":
        med = v[n // 2]
    else:
        raise ValueError(f"unknown median convention {convention!r}")
    return med, (med > values).to(torch.int8)


class SpectralSolve(NamedTuple):
    """What the spectral phase's solver reports beside its split."""

    solver: str  # "power", "lanczos" or "lobpcg"
    #: power steps, Lanczos restarts or LOBPCG iterations.
    iterations: int
    #: the solver's own lambda (before the host refinement, if any).
    eigenvalue: float
    #: the solver's residual ||L v - lambda v|| (None for power).
    residual: float | None
    #: the host f64 refinement's (lambda, residual, steps), if it ran.
    refined: tuple[float, float, int] | None


def check_solver(config: SpectralConfig, num_nodes: int) -> SpectralConfig:
    """Resolve ``"auto"``; raise for an unknown solver."""
    config = resolve_solver(config, num_nodes)
    if config.solver not in ("power", "lanczos", "lobpcg"):
        raise ValueError(f"unknown spectral solver {config.solver!r}")
    return config


def eig_partition(
    hg: Hypergraph,
    config: SpectralConfig = SpectralConfig(),
    *,
    dtype: torch.dtype = torch.float32,
    graph: DeviceGraph | None = None,
    host_graph=None,
    device: str | torch.device | None = None,
):
    """The full spectral phase, ``./cEIG <file>`` (cEIG.cpp:138-229).

    Returns ``(EigResult, iterations)``: power steps, Lanczos restarts or
    LOBPCG iterations (:func:`eig_partition_solve` reports more)."""
    eig, solve = eig_partition_solve(
        hg, config, dtype=dtype, graph=graph, host_graph=host_graph, device=device
    )
    return eig, solve.iterations


def eig_partition_solve(
    hg: Hypergraph,
    config: SpectralConfig = SpectralConfig(),
    *,
    dtype: torch.dtype = torch.float32,
    graph: DeviceGraph | None = None,
    host_graph=None,
    device: str | torch.device | None = None,
    tracer: Tracer | None = None,
) -> tuple[EigResult, SpectralSolve]:
    """The spectral phase (``eig_kl_tpu/spectral/partition.py:44-126``):
    clique-expand, solve for the Fiedler pair, median-split.

    * ``solver="power"``: KL weights (gKL2 reuses the KL adjacency,
      gKL2.cu:262-303), the power solve, the "upper" median.
    * ``"lanczos"`` / ``"lobpcg"``: the "eig" (2/k) weighting, the solve in
      ``dtype`` on the device, then with ``host_refine`` (None = on for f32)
      the host f64 polish of :mod:`eig_kl_tpu_torch.spectral.refine` to
      ``tolerance * 1e-3``, and the "average" median.

    ``graph`` is a pre-built DeviceGraph of the matching weighting,
    ``host_graph`` its host CSR (built when needed).  ``tracer`` times the
    spans "spectral.graph" (the graph's build), "spectral" (the solve) and
    "spectral.refine" (the host refinement).  Returns the EigResult and a
    :class:`SpectralSolve`.
    """
    from eig_kl_tpu_torch.graph.expand import clique_expand

    tracer = tracer or Tracer()
    config = check_solver(config, hg.num_nodes)
    if config.solver == "power":
        from eig_kl_tpu_torch.spectral.power import power_partition_fiedler

        if graph is None:
            with tracer.span("spectral.graph"):
                graph = clique_expand(hg, "kl").to_device(resolve_device(device), dtype)
        with tracer.span("spectral"):
            lam, med, vec, sides, iters = power_partition_fiedler(graph, config, dtype=dtype)
        eig = EigResult(
            eigenvalue=lam, median=med, sides=sides, values=np.asarray(vec, dtype=np.float64)
        )
        return eig, SpectralSolve("power", iters, lam, None, None)

    refine = config.host_refine
    if refine is None:
        refine = dtype == torch.float32
    if graph is None:
        with tracer.span("spectral.graph"):
            if host_graph is None:
                host_graph = clique_expand(hg, "eig")
            graph = host_graph.to_device(resolve_device(device), dtype)
    with tracer.span("spectral"):
        if config.solver == "lanczos":
            from eig_kl_tpu_torch.spectral.lanczos import lanczos_fiedler

            res = lanczos_fiedler(graph, config, dtype=dtype)
            iters = res.restarts
        else:
            from eig_kl_tpu_torch.spectral.lobpcg_solver import lobpcg_fiedler

            res = lobpcg_fiedler(graph, config, dtype=dtype)
            iters = res.iterations
        lam, resid = (float(t) for t in torch.stack([res.eigenvalue, res.residual]).cpu())
    vec = res.vector
    refined = None
    if refine:
        from eig_kl_tpu_torch.spectral.refine import refine_fiedler_host

        with tracer.span("spectral.refine"):
            if host_graph is None:
                host_graph = clique_expand(hg, "eig")
            rf = refine_fiedler_host(host_graph, vec.cpu().numpy(), tol=config.tolerance * 1e-3)
        vec = torch.as_tensor(rf.vector)
        refined = (rf.eigenvalue, rf.residual, rf.steps)
    med, sides = median_split(vec, convention="average")
    eig = EigResult(
        eigenvalue=refined[0] if refined else lam,
        median=float(med),
        sides=sides.cpu().numpy(),
        values=vec.cpu().numpy().astype(np.float64),
    )
    return eig, SpectralSolve(config.solver, iters, lam, resid, refined)
