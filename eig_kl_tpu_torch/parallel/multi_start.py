"""Multi-start KL refinement (the port of
``eig_kl_tpu/parallel/multi_start.py``).

KL quality depends on the initial partition (the reference runs one
start per invocation and relies on the RNG, cKL.cpp:175-193).
Independent starts share nothing but the graph, so they run as the
blocks of one K2 launch, one persistent block per start
(:func:`eig_kl_tpu_torch.kl.megakernel.refine_mega_batch`).

The JAX package also has a ``vmap`` of its XLA engine over starts
(``multi_start_refine``, ``:44``, with ``kl/engine.py``) for backends
without the mega-kernel.  The port has one engine, whose plain version
plays that part on the CPU, so there is no separate counterpart.

:func:`multi_start_refine_mega_sharded` (``:275``) splits the starts over
the ``"dp"`` ranks of a mesh: each rank runs its share in one K2 launch
per pass, and the results are gathered on every rank.
"""

from __future__ import annotations

import warnings

import numpy as np

from eig_kl_tpu_torch.graph.csr import DeviceGraph
from eig_kl_tpu_torch.kl.init import random_split
from eig_kl_tpu_torch.kl.megakernel import refine_mega_batch
from eig_kl_tpu_torch.kl.multipass import refine_multipass_batch, resolved_passes
from eig_kl_tpu_torch.kl.result import KLResult
from eig_kl_tpu_torch.parallel.mesh import Mesh
from eig_kl_tpu_torch.utils.config import KLConfig
from eig_kl_tpu_torch.utils.tracing import Tracer


def multi_start_refine_mega(
    g: DeviceGraph,
    num_starts: int,
    *,
    config: KLConfig = KLConfig(),
    base_seed: int = 0,
    launch_chunk: int | None = None,
    init_sides: np.ndarray | None = None,
    tracer: Tracer | None = None,
    spmv_order: str = "plan",
) -> tuple[KLResult, np.ndarray]:
    """Run ``num_starts`` refinements batched over the start axis; return
    ``(best KLResult, best cut per start)``.

    Each pass of all starts is one kernel launch with batched set-up and
    one transfer of the results, instead of a host loop over starts.
    With ``config.passes != 1`` every pass re-runs the whole batch from
    each start's best partition
    (:func:`eig_kl_tpu_torch.kl.multipass.refine_multipass_batch`).

    Args:
      g: device graph, shared by the starts.
      base_seed: start ``i`` is ``random_split(n, base_seed + i)`` unless
        ``init_sides`` is given.
      launch_chunk: starts per launch; None (default) = the whole batch
        in one launch.  The JAX package splits large batches on its own
        (``_LAUNCH_NODE_STARTS``) to keep one TPU kernel under its
        worker's watchdog; that guard is not carried over.
      init_sides: (num_starts, n) explicit initial partitions (e.g.
        perturbed spectral splits,
        :func:`eig_kl_tpu_torch.kl.init.perturb_split`).
      tracer: receives the spans "kl.pass" and "kl.finalize".
      spmv_order: the order of each pass's initial ``A @ s`` and recount,
        :func:`~eig_kl_tpu_torch.kl.megakernel.refine_mega_batch`'s: "plan"
        (the JAX mega engine's) or "ell" (the JAX XLA engine's, which the
        pipelines take).
    """
    if launch_chunk is None:
        launch_chunk = max(num_starts, 1)

    def run_batch(batch: np.ndarray) -> list[KLResult]:
        out = []
        for s0 in range(0, len(batch), launch_chunk):
            out += refine_mega_batch(
                g, batch[s0 : s0 + launch_chunk], config, tracer=tracer, spmv_order=spmv_order
            )
        return out

    return _run_starts(run_batch, _init_batch(g.num_nodes, num_starts, base_seed, init_sides), config)


def _init_batch(n: int, num_starts: int, base_seed: int, init_sides) -> np.ndarray:
    """``init_sides``, or start ``i`` = ``random_split(n, base_seed + i)``."""
    if init_sides is None:
        return np.stack([random_split(n, base_seed + i) for i in range(num_starts)])
    init_batch = np.asarray(init_sides, dtype=np.int8)
    if len(init_batch) != num_starts:
        raise ValueError(f"init_sides has {len(init_batch)} starts, expected {num_starts}")
    return init_batch


def _run_starts(run_batch, init_batch: np.ndarray, config: KLConfig) -> tuple[KLResult, np.ndarray]:
    """One pass of every start, or passes until none improves, then the
    best start by ``argmin`` of the best cuts."""
    if resolved_passes(config) > 1:
        results = refine_multipass_batch(run_batch, init_batch, config)
    else:
        results = run_batch(init_batch)
    cuts = np.asarray([r.best_cut for r in results])
    best = results[int(np.argmin(cuts))]
    return best, cuts


def multi_start_refine_mega_sharded(
    g: DeviceGraph,
    num_starts: int,
    *,
    mesh: Mesh,
    config: KLConfig = KLConfig(),
    base_seed: int = 0,
    init_sides: np.ndarray | None = None,
    tracer: Tracer | None = None,
    spmv_order: str = "plan",
) -> tuple[KLResult, np.ndarray]:
    """:func:`multi_start_refine_mega` with the starts split over the
    mesh's ``"dp"`` ranks: rank ``k`` runs starts ``[k * S/dp, (k + 1) *
    S/dp)`` through :func:`refine_mega_batch` (one K2 launch per pass),
    then every rank gathers every start's result, in start order, and
    takes the best.  Every rank of the mesh calls it with the same
    arguments, ``g`` on its own device, and gets the same result, each
    start's equal to the one-card run's.

    ``num_starts`` must be divisible by the ``"dp"`` size.  With
    ``config.refresh_interval > 0`` each rank runs every start itself
    (:func:`multi_start_refine_mega`), with a warning, as the JAX function
    falls back to one chip.  ``spmv_order`` is :func:`refine_mega_batch`'s:
    "plan" (the JAX function's, its mega engine) by default.
    """
    dp_axis = mesh.axis_names[0]
    dp = mesh.shape[dp_axis]
    if num_starts % dp != 0:
        raise ValueError(f"num_starts={num_starts} must be divisible by dp={dp}")
    if config.refresh_interval > 0:
        warnings.warn(
            "refresh_interval > 0 is not supported by the dp-sharded batched launch; running all "
            "starts on each rank (~mesh-size x slower than requested)",
            stacklevel=2,
        )
        return multi_start_refine_mega(
            g, num_starts, config=config, base_seed=base_seed, init_sides=init_sides,
            tracer=tracer, spmv_order=spmv_order,
        )
    mesh._check_member()
    per = num_starts // dp
    mine = slice(mesh.coords[dp_axis] * per, (mesh.coords[dp_axis] + 1) * per)

    def run_batch(batch: np.ndarray) -> list[KLResult]:
        local = refine_mega_batch(g, batch[mine], config, tracer=tracer, spmv_order=spmv_order)
        return [r for part in mesh.all_gather_object(local, dp_axis) for r in part]

    return _run_starts(run_batch, _init_batch(g.num_nodes, num_starts, base_seed, init_sides), config)
