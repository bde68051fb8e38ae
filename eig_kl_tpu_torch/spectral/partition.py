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

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph
from eig_kl_tpu_torch.io.eigfile import EigResult
from eig_kl_tpu_torch.io.hgr import Hypergraph
from eig_kl_tpu_torch.utils.config import SpectralConfig, resolve_solver
from eig_kl_tpu_torch.utils.device import resolve_device


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


def check_solver(config: SpectralConfig, num_nodes: int) -> SpectralConfig:
    """Resolve ``"auto"``; raise for a solver the port does not have."""
    config = resolve_solver(config, num_nodes)
    if config.solver in ("lanczos", "lobpcg"):
        raise NotImplementedError(
            f"the {config.solver} solver is not yet ported to "
            "eig_kl_tpu_torch (ROADMAP.md A7)"
        )
    if config.solver != "power":
        raise ValueError(f"unknown spectral solver {config.solver!r}")
    return config


def eig_partition(
    hg: Hypergraph,
    config: SpectralConfig = SpectralConfig(),
    *,
    dtype: torch.dtype = torch.float32,
    graph: DeviceGraph | None = None,
    device: str | torch.device | None = None,
):
    """The spectral phase for ``solver="power"``: clique-expand with KL
    weights (gKL2 reuses the KL adjacency, gKL2.cu:262-303), power solve,
    "upper" median split.

    Returns ``(EigResult, power iterations)``.
    """
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.spectral.power import power_partition_fiedler

    config = check_solver(config, hg.num_nodes)
    if graph is None:
        graph = clique_expand(hg, "kl").to_device(resolve_device(device), dtype)
    lam, med, vec, sides, iters = power_partition_fiedler(graph, config, dtype=dtype)
    eig = EigResult(
        eigenvalue=lam,
        median=med,
        sides=sides,
        values=np.asarray(vec, dtype=np.float64),
    )
    return eig, iters
