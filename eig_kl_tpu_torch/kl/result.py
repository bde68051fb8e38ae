"""Host-side KL result container and swap-log replay (the port's copy
of ``eig_kl_tpu/kl/result.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class KLResult:
    """Host-side result of a KL refinement run.

    ``final_cut`` is the incrementally-tracked value; ``verified_cut``
    is the from-scratch recomputation at termination -- the invariant
    oracle the reference checks at gKL.cu:524-530.  ``best_sides`` is
    the partition at the minimum cut seen (the reference only tracks the
    number, cKL.cpp:363; we keep the argmin state too).
    """

    sides: np.ndarray
    best_sides: np.ndarray
    initial_cut: float
    final_cut: float
    best_cut: float
    verified_cut: float
    iterations: int
    cut_trajectory: np.ndarray
    gain_trajectory: np.ndarray

    @property
    def drift(self) -> float:
        """|incremental - from-scratch| cut discrepancy at termination."""
        return abs(self.final_cut - self.verified_cut)

    @property
    def improvement(self) -> float:
        """Fractional improvement of best cut over initial cut."""
        if self.initial_cut == 0:
            return 0.0
        return 1.0 - self.best_cut / self.initial_cut


def best_iteration(log_cut: np.ndarray, iterations: int) -> int:
    """Index of the minimum cut along the trajectory (first minimum)."""
    return int(np.argmin(log_cut[: iterations + 1]))


def replay_swaps(
    sides: np.ndarray, log_a: np.ndarray, log_b: np.ndarray, upto: int
) -> np.ndarray:
    """Reconstruct the partition after the first `upto` swaps.

    The loop logs the swapped pair per iteration (2 int32 scalars)
    instead of snapshotting the whole best partition on device (which
    would cost two O(n) HBM passes per swap); the best state is replayed
    here in O(upto) on host."""
    out = np.asarray(sides, dtype=np.int8).copy()
    out[log_a[1 : upto + 1]] = 1
    out[log_b[1 : upto + 1]] = 0
    return out
