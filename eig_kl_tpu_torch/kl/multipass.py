"""Multi-pass KL: restart refinement from the best partition so far (the
port's copy of ``eig_kl_tpu/kl/multipass.py``; host-side, engine-free).

The reference engines run a single KL pass and only *track* the best
cut along the swap trajectory -- they never roll the partition back to
it (cKL.cpp:288-406, min tracked at :363; gKL.cu:484 same).  Classic
KL/FM instead iterates: replay the best prefix, unlock every node, and
refine again until a pass stops improving.  Each pass is monotonically
non-increasing in best cut (pass p+1 starts AT pass p's best).

``KLConfig.passes`` selects the behavior: 1 (default) = reference
semantics, N > 1 = at most N passes, 0 = until converged (capped at
:data:`AUTO_PASS_CAP`).  The outer loop feeds ``KLResult.best_sides``
back into any single-pass backend: one start
(:func:`eig_kl_tpu_torch.kl.megakernel.refine_mega`) or the batched
launch over starts (:func:`refine_mega_batch`).

Pass p+1 recomputes ``A @ s`` and the cut of pass p's best partition
from scratch, so its ``initial_cut`` is a recount, not pass p's running
sum, and :data:`_IMPROVE_EPS` is absolute: both as in the JAX package, so
that the two run the same number of passes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from eig_kl_tpu_torch.kl.init import perturb_split
from eig_kl_tpu_torch.kl.result import KLResult
from eig_kl_tpu_torch.utils.config import KLConfig

#: Pass ceiling when ``KLConfig.passes == 0`` (run until converged).
AUTO_PASS_CAP = 16

#: A pass must beat the best cut by more than this to count as an
#: improvement (guards float noise in the tracked cut).
_IMPROVE_EPS = 1e-9


def resolved_passes(config: KLConfig) -> int:
    """The effective maximum number of passes for ``config``."""
    if config.passes < 0:
        raise ValueError(f"passes must be >= 0, got {config.passes}")
    return AUTO_PASS_CAP if config.passes == 0 else config.passes


def _merge(first: KLResult, best: KLResult, last: KLResult,
           total_iters: int, cut_traj, gain_traj) -> KLResult:
    """Combine per-pass results into one KLResult.

    ``best_cut``/``best_sides`` come from the winning pass;
    ``sides``/``final_cut``/``verified_cut`` from the last executed
    pass (so ``drift`` keeps its per-run oracle meaning);
    ``initial_cut`` from pass 1; trajectories concatenate with each
    later pass's leading entry dropped (it replays the previous best,
    not a swap).
    """
    return dataclasses.replace(
        last,
        best_sides=best.best_sides,
        best_cut=best.best_cut,
        initial_cut=first.initial_cut,
        iterations=total_iters,
        cut_trajectory=np.concatenate(cut_traj),
        gain_trajectory=np.concatenate(gain_traj),
    )


def refine_multipass(
    refine_fn: Callable[[np.ndarray], KLResult],
    sides: np.ndarray,
    config: KLConfig,
) -> KLResult:
    """Run up to ``resolved_passes(config)`` KL passes of ``refine_fn``.

    ``refine_fn`` maps an int8 sides array to a :class:`KLResult`
    (any single-pass backend).  Stops early when a pass fails to
    improve the best cut.
    """
    max_passes = resolved_passes(config)
    first = refine_fn(sides)
    if max_passes <= 1:
        return first
    best = last = first
    total_iters = first.iterations
    cut_traj = [first.cut_trajectory]
    gain_traj = [first.gain_trajectory]
    for _ in range(1, max_passes):
        r = refine_fn(best.best_sides)
        last = r
        total_iters += r.iterations
        cut_traj.append(r.cut_trajectory[1:])
        gain_traj.append(r.gain_trajectory[1:])
        if r.best_cut < best.best_cut - _IMPROVE_EPS:
            best = r
        else:
            break
    return _merge(first, best, last, total_iters, cut_traj, gain_traj)


def _kick_seed(seed: int, k: int) -> int:
    """Derive kick ``k``'s perturbation seed.  Hashed through a
    SeedSequence keyed on a kick-only constant so the stream never
    collides with the multi-start jitter seeds (``seed + 1 + i``) or
    the random-init base seeds — a raw ``seed + k`` would make kick 1
    replay start 1's jitter and re-descend an already-explored basin."""
    return int(
        np.random.SeedSequence([seed & 0x7FFFFFFF, 0x4B49434B, k])
        .generate_state(1)[0]
    )


def refine_ils(
    refine_fn: Callable[[np.ndarray], KLResult],
    sides: np.ndarray,
    config: KLConfig,
    *,
    kicks: int,
    kick_frac: float = 0.15,
    seed: int = 0,
    incumbent: KLResult | None = None,
) -> KLResult:
    """Iterated local search: multi-pass descent, then ``kicks`` rounds
    of perturb-the-best + re-descend, keeping the global best.  The
    reference has no analog — it cannot even roll back to its best
    state (cKL.cpp:363).

    ``incumbent``: a descent that already converged (e.g. the
    multi-start winner) to kick from directly, skipping the leading
    re-descent of an already-local-optimal partition (``sides`` is
    ignored then).

    The returned result is the winning descent with ``initial_cut``
    rewritten to the FIRST descent's initial cut, so ``improvement``
    and the reference-format report measure the whole run, not the
    winning kick's perturbed restart.  ``iterations`` and the
    trajectories stay the winner's own (self-consistent:
    ``iterations == len(cut_trajectory) - 1``); losing descents' work
    is visible only in wall time.
    """
    best = (
        incumbent
        if incumbent is not None
        else refine_multipass(refine_fn, sides, config)
    )
    initial_cut = best.initial_cut
    for k in range(kicks):
        kicked = perturb_split(best.best_sides, _kick_seed(seed, k), kick_frac)
        r = refine_multipass(refine_fn, kicked, config)
        if r.best_cut < best.best_cut - _IMPROVE_EPS:
            best = r
    if best.initial_cut != initial_cut:
        best = dataclasses.replace(best, initial_cut=initial_cut)
    return best


def refine_multipass_batch(
    run_batch: Callable[[np.ndarray], Sequence[KLResult]],
    init_batch: np.ndarray,
    config: KLConfig,
) -> list[KLResult]:
    """Multi-pass over a batch of starts, keeping the batch batched.

    ``run_batch`` maps an (S, n) int8 batch to S single-pass
    :class:`KLResult`\\ s (the single-launch grid over starts,
    :func:`eig_kl_tpu_torch.kl.megakernel.refine_mega_batch`).  Every
    pass re-runs the FULL batch from each start's best partition --
    starts that have converged terminate in ~``terminate_limit`` swaps
    inside the kernel.  Stops when no start improved.
    """
    max_passes = resolved_passes(config)
    firsts = list(run_batch(np.asarray(init_batch, dtype=np.int8)))
    if max_passes <= 1:
        return firsts
    S = len(firsts)
    best = list(firsts)
    last = list(firsts)
    total_iters = [r.iterations for r in firsts]
    cut_traj = [[r.cut_trajectory] for r in firsts]
    gain_traj = [[r.gain_trajectory] for r in firsts]
    for _ in range(1, max_passes):
        batch = np.stack([b.best_sides for b in best]).astype(np.int8)
        new = run_batch(batch)
        any_improved = False
        for k in range(S):
            r = new[k]
            last[k] = r
            total_iters[k] += r.iterations
            cut_traj[k].append(r.cut_trajectory[1:])
            gain_traj[k].append(r.gain_trajectory[1:])
            if r.best_cut < best[k].best_cut - _IMPROVE_EPS:
                best[k] = r
                any_improved = True
        if not any_improved:
            break
    return [
        _merge(firsts[k], best[k], last[k], total_iters[k],
               cut_traj[k], gain_traj[k])
        for k in range(S)
    ]
