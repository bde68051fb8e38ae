"""Iteration logging and result reporting (the port's copy of
``eig_kl_tpu/utils/logging.py``: the same file formats, byte for byte).

Reproduces the reference's observable artifacts:

* ``results/<base>_KL_CutSize[_EIG]_output.txt`` with one
  ``iter\\tcut\\tgain`` row per swap and a row 0 for the initial cut
  (cKL.cpp:315,380; file naming cKL.cpp:438-444).  Note the GPU
  references compute this filename but never write it (gKL.cu:689-690)
  -- we always write it.
* console iteration table and final-results block (cKL.cpp:323-330,
  397-404; gKL.cu:536-542).
"""

from __future__ import annotations

import os

from eig_kl_tpu_torch.kl.result import KLResult


def kl_results_path(
    input_path: str, eig_init: bool, out_dir: str = "results"
) -> str:
    base = os.path.basename(input_path)
    suffix = "_KL_CutSize_EIG_output.txt" if eig_init else "_KL_CutSize_output.txt"
    return os.path.join(out_dir, base + suffix)


def write_kl_trajectory(path: str, result: KLResult) -> None:
    """Write the per-swap trajectory in the reference format
    (``iter\\tcut\\tgain``, row 0 = initial cut with gain 0)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"0\t{result.cut_trajectory[0]}\t0\n")
        for i in range(1, result.iterations + 1):
            f.write(
                f"{i}\t{result.cut_trajectory[i]}\t{result.gain_trajectory[i]}\n"
            )


def format_final_results(result: KLResult, runtime_s: float) -> str:
    """Final-results block (cKL.cpp:397-403 layout)."""
    lines = [
        "=============== Final Results =================",
        f"{'Total iterations':<24}: {result.iterations}",
        f"{'Initial cut size':<24}: {result.initial_cut:.2f}",
        f"{'Best cut size achieved':<24}: {result.best_cut:.2f}",
        f"{'Final cut size':<24}: {result.final_cut:.2f}",
        f"{'Verified cut size':<24}: {result.verified_cut:.2f}",
        f"{'Overall improvement':<24}: {100.0 * result.improvement:.2f}%",
        f"{'Total runtime':<24}: {runtime_s:.3f} seconds",
    ]
    if result.drift > 1e-2:
        # The reference's termination oracle warning (gKL.cu:526-529).
        lines.append(
            f"Warning: cut size verification difference detected. "
            f"Incremental: {result.final_cut}, From-scratch: {result.verified_cut}"
        )
    return "\n".join(lines)


def format_iteration_table(
    result: KLResult, max_rows: int = 25, kl_seconds: float | None = None
) -> str:
    """Console iteration table (cKL.cpp:323-330 layout), sampled down to
    ``max_rows`` rows for long runs.

    When ``kl_seconds`` is given, a ``Time(us)`` column shows the mean
    per-swap wall time (cKL.cpp:368-378 prints a per-swap measurement;
    our swaps run device-resident with no host round-trip to time, so
    the whole-run mean is the honest equivalent).
    """
    n = result.iterations
    step = max(1, n // max_rows)
    us = 1e6 * kl_seconds / max(n, 1) if kl_seconds is not None else None
    head = f"{'Iter':>8} {'Cut size':>14} {'Gain':>12} {'Improve%':>9}"
    if us is not None:
        head += f" {'Time(us)':>9}"
    rows = [
        "==================== KL Iterations ====================",
        head,
    ]
    c0 = max(result.initial_cut, 1e-30)
    idx = list(range(0, n + 1, step))
    if idx[-1] != n:
        idx.append(n)
    for i in idx:
        cut = result.cut_trajectory[i]
        gain = result.gain_trajectory[i] if i > 0 else 0.0
        row = f"{i:>8} {cut:>14.2f} {gain:>12.4f} {100.0 * (1 - cut / c0):>8.2f}%"
        if us is not None:
            row += f" {0.0 if i == 0 else us:>9.2f}"
        rows.append(row)
    return "\n".join(rows)


def format_matrix_stats(num_nodes: int, nnz: int) -> str:
    """Matrix statistics block (cKL.cpp:134-146)."""
    full_mb = num_nodes * num_nodes * 4 / (1024.0 * 1024.0)
    sparse_mb = nnz * (4 + 2 * 4) / (1024.0 * 1024.0)
    density = 100.0 * nnz / max(num_nodes * num_nodes, 1)
    return "\n".join(
        [
            "============= Matrix Statistics ===============",
            f"  - Full matrix: {num_nodes} x {num_nodes}",
            f"  - Non-zero   : {nnz}",
            f"  - Density    : {density:.3f}%",
            f"  - Full matrix  : {full_mb:.3f} MB",
            f"  - Sparse matrix: {sparse_mb:.3f} MB",
        ]
    )
