"""End-to-end partitioning pipelines (the port of
``eig_kl_tpu/models/pipelines.py``).

* :func:`spectral_partition`  == ``./cEIG <file>``
* :func:`kl_partition`        == ``./cKL|./gKL <file> [-EIG]``
* :func:`fused_partition`     == ``./gKL2 <file> [-EIG]`` (gKL2.cu:989-1033)

Every entry point runs on the card unless the caller passes
``device="cpu"``.  Refinement goes through one engine
(:mod:`eig_kl_tpu_torch.kl.megakernel`): one start or a batch of starts,
one pass or many (``KLConfig.passes``), with kicks and
``refresh_interval``.  The spectral phase runs the power solver on the
KL-weighted graph it shares with the refinement, or Lanczos / LOBPCG on
the "eig"-weighted graph they build.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph
from eig_kl_tpu_torch.graph.expand import clique_expand
from eig_kl_tpu_torch.io.eigfile import EigResult
from eig_kl_tpu_torch.io.hgr import Hypergraph
from eig_kl_tpu_torch.kl.init import (
    perturb_split,
    random_split,
    reference_shuffle_init,
    split_from_eig,
)
from eig_kl_tpu_torch.kl.megakernel import fused_refine_mega, refine_mega
from eig_kl_tpu_torch.kl.multipass import refine_ils, refine_multipass, resolved_passes
from eig_kl_tpu_torch.kl.result import KLResult
from eig_kl_tpu_torch.models.run import PartitionRunData as PartitionRun
from eig_kl_tpu_torch.spectral.partition import check_solver, eig_partition_solve
from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig
from eig_kl_tpu_torch.utils.device import resolve_device
from eig_kl_tpu_torch.utils.tracing import Tracer


def attaches_plan(device: torch.device) -> bool:
    """Whether the pipelines attach a :class:`CsrPlan` on ``device`` by
    default: the port's counterpart of the JAX package's rule,
    ``with_plan=jax.default_backend() == "tpu"``
    (``eig_kl_tpu/models/pipelines.py:128``, ``:192``).  No device attaches
    one until the card's quality A/B decides it (ROADMAP.md A, item 3); a
    caller asks for the plan path with ``fused_partition(...,
    with_plan=True)`` or ``Graph.to_device(..., with_plan=True)``."""
    # The JAX rule on the port reads: torch.device(device).type == "cuda".
    return False


#: The order of the refinement's initial ``A @ s`` and recount on every
#: pipeline: the JAX XLA engine's, which the JAX package's pipelines run
#: off the TPU (``models/pipelines.py:_use_mega``), so that a pipeline's
#: result is the JAX package's CPU result.
PIPELINE_SPMV_ORDER = "ell"


def refine_backend(g: DeviceGraph, config: KLConfig, tracer: Tracer | None = None):
    """Single-pass refinement closure on the port's one engine."""
    return lambda sides: refine_mega(g, sides, config, tracer=tracer, spmv_order=PIPELINE_SPMV_ORDER)


def _refine_dispatch(
    g: DeviceGraph, sides, config: KLConfig, seed: int = 0, tracer: Tracer | None = None
) -> KLResult:
    """One start: a single pass, multi-pass, or iterated local search."""
    backend = refine_backend(g, config, tracer)
    if config.kicks > 0:
        return refine_ils(
            backend, sides, config,
            kicks=config.kicks, kick_frac=config.kick_frac, seed=seed,
        )
    if resolved_passes(config) <= 1:
        return backend(sides)
    return refine_multipass(backend, sides, config)


def _multi_start_dispatch(
    g: DeviceGraph, sides, config: KLConfig, *,
    starts: int, perturb: float, seed: int, perturb_base: bool,
    tracer: Tracer | None = None,
    mesh=None,
):
    """Batched multi-start; returns ``(best KLResult, best cut per start)``.

    ``perturb_base=True``: start 0 is ``sides`` unperturbed, starts
    1..S-1 are balanced jitters of it with seeds ``seed + 1 + i``
    (spectral-seeded multi-start).  ``perturb_base=False``: independent
    random splits from ``seed``.  With ``config.kicks > 0`` the winning
    start, already converged, enters the iterated local search as its
    incumbent.  With a ``mesh`` the starts are split over its ``"dp"``
    ranks (:func:`~eig_kl_tpu_torch.parallel.multi_start.multi_start_refine_mega_sharded`).
    """
    from eig_kl_tpu_torch.parallel.multi_start import (
        multi_start_refine_mega,
        multi_start_refine_mega_sharded,
    )

    if perturb_base:
        base = np.asarray(sides, dtype=np.int8)
        init_sides = np.stack(
            [base] + [perturb_split(base, seed + 1 + i, perturb) for i in range(starts - 1)]
        )
    else:
        init_sides = None
    run = (multi_start_refine_mega if mesh is None
           else functools.partial(multi_start_refine_mega_sharded, mesh=mesh))
    best, cuts = run(
        g, starts, config=config, base_seed=seed, init_sides=init_sides, tracer=tracer,
        spmv_order=PIPELINE_SPMV_ORDER,
    )
    if config.kicks > 0:
        best = refine_ils(
            refine_backend(g, config, tracer),
            best.best_sides,
            config,
            kicks=config.kicks,
            kick_frac=config.kick_frac,
            seed=seed,
            incumbent=best,
        )
    return best, cuts


def spectral_partition(
    hg: Hypergraph,
    config: SpectralConfig = SpectralConfig(),
    *,
    dtype: torch.dtype | None = None,
    device: str | torch.device | None = None,
) -> PartitionRun:
    """Spectral phase only (the cEIG executable), any solver.  ``dtype``
    None = f64 on the card and on the CPU, the JAX package's default
    (``eig_kl_tpu/models/pipelines.py:87``) and its precision rule off the
    TPU (``eig_kl_tpu/cli/main.py:204-212``); f32 adds the host f64
    refinement for lanczos and lobpcg."""
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.float64
    tracer = Tracer(dev)
    with tracer.span("spectral.total"):
        eig, solve = eig_partition_solve(hg, config, dtype=dtype, device=dev, tracer=tracer)
    return PartitionRun(
        circuit=hg.name, eig=eig, kl=None, timings=dict(tracer.spans),
        spectral_iterations=solve.iterations if solve.solver == "power" else None,
        spectral_solve=solve,
    )


def unshuffle(result: KLResult, perm: np.ndarray) -> KLResult:
    """A result on the graph relabelled by
    :func:`~eig_kl_tpu_torch.kl.init.reference_shuffle_init`, with its
    partitions mapped back to the original node ids."""
    mapped = np.empty(len(perm), dtype=np.int8)
    mapped[perm] = result.sides
    mapped_best = np.empty(len(perm), dtype=np.int8)
    mapped_best[perm] = result.best_sides
    return dataclasses.replace(result, sides=mapped, best_sides=mapped_best)


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
    tracer = Tracer(dev)
    perm = None
    with tracer.span("graph.build"):
        g_host = clique_expand(hg, "kl")
        if shuffled_ties and init is None:
            g_host, shuffled_sides, perm = reference_shuffle_init(g_host, seed)
        g = g_host.to_device(dev, dtype, with_plan=attaches_plan(dev))
    eig = init if isinstance(init, EigResult) else None
    with tracer.span("init"):
        if init is None:
            sides = shuffled_sides if perm is not None else random_split(hg.num_nodes, seed)
        elif isinstance(init, (EigResult, str)):
            sides = split_from_eig(init)
        else:
            sides = np.asarray(init, dtype=np.int8)
    with tracer.span("kl.refine"):
        result = _refine_dispatch(g, sides, kl_config, seed, tracer)
    if perm is not None:
        result = unshuffle(result, perm)
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
    perturb: float = 0.05,
    device: str | torch.device | None = None,
    with_plan: bool | None = None,
) -> PartitionRun:
    """Fused spectral + KL pipeline (the gKL2 executable).

    Builds the KL-weighted graph once and shares it between the power
    iteration (gKL2 builds its Laplacian from the same adjacency,
    gKL2.cu:262-303) and the refinement engine.  ``use_eig=False``
    mirrors gKL2 without ``-EIG`` (random init from ``seed``).

    ``starts > 1`` runs spectral-seeded multi-start: the spectral solve
    runs once, start 0 refines the unperturbed median split, and each
    further start jitters it with :func:`kl.init.perturb_split`
    (``perturb`` = fraction of nodes pair-swapped) before refinement --
    all starts in one batched launch per pass, best kept; the run's
    ``start_cuts`` holds each start's best cut.  With random init the
    starts are independent random splits.

    ``spectral_config.solver`` "auto" resolves up front (lanczos at 256
    nodes or fewer).  The power solver shares the KL-weighted graph;
    lanczos and lobpcg build the "eig"-weighted one
    (``eig_kl_tpu/models/pipelines.py:196-240``).  With the power solver,
    one start, one pass, no refresh and no kicks take the one-launch route
    (:func:`fused_refine_mega`: the split never leaves the device);
    everything else runs the spectral phase and then the refinement
    dispatch.

    ``with_plan`` (None: :func:`attaches_plan`) attaches a :class:`CsrPlan`:
    the f32 power solve then iterates on the padded state, with bf16
    intermediates where ``spectral_config.inter_dtype`` is "bfloat16" (the
    default) and the plan is a v2 one (``CsrPlan.runs_bf16``).
    """
    dev = resolve_device(device)
    if with_plan is None:
        with_plan = attaches_plan(dev)
    if use_eig:
        spectral_config = check_solver(spectral_config, hg.num_nodes)
    tracer = Tracer(dev)
    with tracer.span("graph.build"):
        g_host = clique_expand(hg, "kl")
        g = g_host.to_device(dev, dtype, with_plan=with_plan)
    eig, iters, cuts, solve = None, None, None, None
    if (
        use_eig
        and spectral_config.solver == "power"
        and starts == 1
        and kl_config.refresh_interval == 0
        and kl_config.kicks == 0
        and resolved_passes(kl_config) <= 1
    ):
        eig, result, iters = fused_refine_mega(
            g, spectral_config, kl_config, tracer=tracer, spmv_order=PIPELINE_SPMV_ORDER
        )
    else:
        with tracer.span("init"):
            if use_eig:
                shared = g if spectral_config.solver == "power" else None
                with tracer.span("spectral.total"):
                    eig, solve = eig_partition_solve(
                        hg, spectral_config, dtype=dtype, graph=shared, device=dev, tracer=tracer
                    )
                if solve.solver == "power":
                    iters = solve.iterations
                sides = eig.sides
            else:
                sides = random_split(hg.num_nodes, seed)
        with tracer.span("kl.refine"):
            if starts > 1:
                result, cuts = _multi_start_dispatch(
                    g, sides, kl_config, starts=starts, perturb=perturb, seed=seed,
                    perturb_base=use_eig, tracer=tracer,
                )
            else:
                result = _refine_dispatch(g, sides, kl_config, seed, tracer)
    return PartitionRun(
        circuit=hg.name,
        eig=eig,
        kl=result,
        timings=dict(tracer.spans),
        nnz=g_host.nnz,
        start_cuts=None if cuts is None else cuts.tolist(),
        spectral_iterations=iters,
        spectral_solve=solve,
    )
