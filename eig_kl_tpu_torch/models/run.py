"""Result bundle of an end-to-end run (the port's copy of
``eig_kl_tpu/models/run.py``, plus what the spectral solver reports)."""

from __future__ import annotations

import dataclasses

from eig_kl_tpu_torch.io.eigfile import EigResult
from eig_kl_tpu_torch.kl.result import KLResult


@dataclasses.dataclass
class PartitionRunData:
    """Result bundle of an end-to-end run."""

    circuit: str
    eig: EigResult | None
    kl: KLResult | None
    timings: dict[str, float]
    #: adjacency nonzeros (both directions), for the matrix-statistics
    #: block (cKL.cpp:134-146); None when no graph was built.
    nnz: int | None = None
    #: per-start best cuts when the run was a multi-start (printed by
    #: the CLI as "Multi-start best cuts: ..."); None otherwise.
    start_cuts: list | None = None
    #: power-iteration steps of the spectral phase; None without a power
    #: solve.
    spectral_iterations: int | None = None
    #: the spectral solver's report (spectral.partition.SpectralSolve);
    #: None without a spectral phase or on the one-launch power route.
    spectral_solve: object | None = None
