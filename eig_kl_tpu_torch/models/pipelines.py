"""End-to-end partitioning pipelines (the port of
``eig_kl_tpu/models/pipelines.py``).

* :func:`spectral_partition`  == ``./cEIG <file>`` with the power solver
* :func:`kl_partition`        == ``./cKL|./gKL <file> [-EIG]``
* :func:`fused_partition`     == ``./gKL2 <file> [-EIG]`` (gKL2.cu:989-1033)

Every entry point runs on the card unless the caller passes
``device="cpu"``.  The port runs one start and one KL pass; multi-start,
passes, kicks, refresh and the lanczos/lobpcg solvers raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eig_kl_tpu_torch.graph.expand import clique_expand
from eig_kl_tpu_torch.io.eigfile import EigResult
from eig_kl_tpu_torch.io.hgr import Hypergraph
from eig_kl_tpu_torch.kl.init import random_split, reference_shuffle_init, split_from_eig
from eig_kl_tpu_torch.kl.megakernel import fused_refine_mega, refine_mega
from eig_kl_tpu_torch.models.run import PartitionRunData as PartitionRun
from eig_kl_tpu_torch.spectral.partition import check_solver, eig_partition
from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig
from eig_kl_tpu_torch.utils.device import resolve_device
from eig_kl_tpu_torch.utils.tracing import Tracer


def check_kl_config(config: KLConfig, starts: int = 1) -> None:
    """Raise for the refinement options the port does not have yet
    (``refresh_interval`` raises in :mod:`eig_kl_tpu_torch.kl.megakernel`)."""
    if starts != 1:
        raise NotImplementedError(
            "multi-start is not yet ported to eig_kl_tpu_torch (ROADMAP.md A6)"
        )
    if config.passes != 1 or config.kicks > 0:
        raise NotImplementedError(
            "multi-pass KL and kicks are not yet ported to eig_kl_tpu_torch "
            "(ROADMAP.md A6)"
        )


def spectral_partition(
    hg: Hypergraph,
    config: SpectralConfig = SpectralConfig(),
    *,
    dtype: torch.dtype | None = None,
    device: str | torch.device | None = None,
) -> PartitionRun:
    """Spectral phase only (power solver).  ``dtype`` None = f32 on the
    card, f64 on the CPU."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float32 if dev.type == "cuda" else torch.float64
    tracer = Tracer(dev)
    with tracer.span("spectral.total"):
        eig, iters = eig_partition(hg, config, dtype=dtype, device=dev)
    return PartitionRun(
        circuit=hg.name, eig=eig, kl=None, timings=dict(tracer.spans),
        spectral_iterations=iters,
    )


def kl_partition(
    hg: Hypergraph,
    *,
    init: EigResult | str | np.ndarray | None = None,
    kl_config: KLConfig = KLConfig(),
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    shuffled_ties: bool = False,
    device: str | torch.device | None = None,
) -> PartitionRun:
    """KL refinement from a random or spectral initial partition.

    Args:
      init: None -> random split (cKL.cpp:175-193); an EigResult or EIG
        file path -> the -EIG flow (cKL.cpp:155-174); an int8 array ->
        explicit initial sides.
      seed: RNG seed for the random init.
      shuffled_ties: random init only -- break equal-gain ties in the
        reference's shuffled scan order (kl.init.reference_shuffle_init);
        results are mapped back to original node ids.
    """
    dev = resolve_device(device)
    check_kl_config(kl_config)
    tracer = Tracer(dev)
    perm = None
    with tracer.span("graph.build"):
        g_host = clique_expand(hg, "kl")
        if shuffled_ties and init is None:
            g_host, shuffled_sides, perm = reference_shuffle_init(g_host, seed)
        g = g_host.to_device(dev, dtype)
    eig = init if isinstance(init, EigResult) else None
    with tracer.span("init"):
        if init is None:
            sides = shuffled_sides if perm is not None else random_split(hg.num_nodes, seed)
        elif isinstance(init, (EigResult, str)):
            sides = split_from_eig(init)
        else:
            sides = np.asarray(init, dtype=np.int8)
    result = refine_mega(g, sides, kl_config, tracer=tracer)
    if perm is not None:
        mapped = np.empty(len(perm), dtype=np.int8)
        mapped[perm] = result.sides
        mapped_best = np.empty(len(perm), dtype=np.int8)
        mapped_best[perm] = result.best_sides
        result = dataclasses.replace(result, sides=mapped, best_sides=mapped_best)
    return PartitionRun(
        circuit=hg.name, eig=eig, kl=result, timings=dict(tracer.spans), nnz=g_host.nnz
    )


def fused_partition(
    hg: Hypergraph,
    *,
    use_eig: bool = True,
    spectral_config: SpectralConfig = SpectralConfig(solver="power"),
    kl_config: KLConfig = KLConfig(gain_eps=1e-6),
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    starts: int = 1,
    device: str | torch.device | None = None,
) -> PartitionRun:
    """Fused spectral + KL pipeline (the gKL2 executable).

    Builds the KL-weighted graph once and shares it between the power
    iteration (gKL2 builds its Laplacian from the same adjacency,
    gKL2.cu:262-303) and the KL pass.  ``use_eig=False`` mirrors gKL2
    without ``-EIG`` (random init from ``seed``).  ``starts > 1`` is not
    yet ported and raises.
    """
    dev = resolve_device(device)
    check_kl_config(kl_config, starts)
    if use_eig:
        spectral_config = check_solver(spectral_config, hg.num_nodes)
    tracer = Tracer(dev)
    with tracer.span("graph.build"):
        g_host = clique_expand(hg, "kl")
        g = g_host.to_device(dev, dtype)
    eig, iters = None, None
    if use_eig:
        eig, result, iters = fused_refine_mega(g, spectral_config, kl_config, tracer=tracer)
    else:
        result = refine_mega(g, random_split(hg.num_nodes, seed), kl_config, tracer=tracer)
    return PartitionRun(
        circuit=hg.name,
        eig=eig,
        kl=result,
        timings=dict(tracer.spans),
        nnz=g_host.nnz,
        spectral_iterations=iters,
    )
