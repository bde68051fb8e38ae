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
plays that part on the CPU, so there is no separate counterpart.  The
start axis sharded over several devices
(``multi_start_refine_mega_sharded``, ``:275``) is ROADMAP.md A8b.
"""

from __future__ import annotations

import numpy as np

from eig_kl_tpu_torch.graph.csr import DeviceGraph
from eig_kl_tpu_torch.kl.init import random_split
from eig_kl_tpu_torch.kl.megakernel import refine_mega_batch
from eig_kl_tpu_torch.kl.multipass import refine_multipass_batch, resolved_passes
from eig_kl_tpu_torch.kl.result import KLResult
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

    if init_sides is None:
        init_batch = np.stack(
            [random_split(g.num_nodes, base_seed + i) for i in range(num_starts)]
        )
    else:
        init_batch = np.asarray(init_sides, dtype=np.int8)
        if len(init_batch) != num_starts:
            raise ValueError(
                f"init_sides has {len(init_batch)} starts, expected {num_starts}"
            )
    if resolved_passes(config) > 1:
        results = refine_multipass_batch(run_batch, init_batch, config)
    else:
        results = run_batch(init_batch)
    cuts = np.asarray([r.best_cut for r in results])
    best = results[int(np.argmin(cuts))]
    return best, cuts
