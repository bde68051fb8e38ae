"""Initial partitioners (the port's copy of ``eig_kl_tpu/kl/init.py``).

* random: Fisher-Yates shuffle then split at n/2 (cKL.cpp:175-193,
  gKL.cu:304-319).
* spectral ("-EIG"): read sides from the EIG result file
  (cKL.cpp:155-174) -- here, directly from an :class:`EigResult` or the
  on-disk file.
* perturbed: a balanced jitter of an existing split, the seed of
  spectral multi-start and of the kicks (:func:`perturb_split`).
"""

from __future__ import annotations

import numpy as np

from eig_kl_tpu_torch.io.eigfile import EigResult, read_eig_file


def _rng(seed: int | np.random.Generator) -> np.random.Generator:
    return seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)


def random_split(num_nodes: int, seed: int | np.random.Generator = 0) -> np.ndarray:
    """Random balanced bipartition: int8[n] sides, exactly floor(n/2)
    nodes on side 0 (matching cKL.cpp:183-192's split at mid)."""
    perm = _rng(seed).permutation(num_nodes)
    sides = np.ones(num_nodes, dtype=np.int8)
    sides[perm[: num_nodes // 2]] = 0
    return sides


def reference_shuffle_init(g, seed: int | np.random.Generator = 0):
    """Random init reproducing the reference's tie-break ensemble: relabel
    the graph by a shuffle so that index order is the shuffle order
    cKL scans in (cKL.cpp:175-193), then split at n/2.

    Returns ``(relabeled_graph, sides, perm)``; map a partition ``p_new``
    back to original node ids with ``p_old[perm] = p_new``.
    """
    n = g.num_nodes
    perm = _rng(seed).permutation(n)
    sides = np.ones(n, dtype=np.int8)
    sides[: n // 2] = 0
    return g.relabel(perm), sides, perm


def split_from_eig(eig: EigResult | str) -> np.ndarray:
    """Sides from a spectral result (object or file path)."""
    if isinstance(eig, str):
        eig = read_eig_file(eig)
    return eig.sides.astype(np.int8)


def sides_balance(sides: np.ndarray) -> tuple[int, int]:
    right = int(np.asarray(sides).sum())
    return len(sides) - right, right


def perturb_split(
    sides: np.ndarray,
    seed: int | np.random.Generator = 0,
    frac: float = 0.05,
) -> np.ndarray:
    """Balanced perturbation of an existing partition: swap the sides of
    ``ceil(frac * n / 2)`` random cross pairs (one node from each side),
    preserving the balance exactly.

    This seeds spectral multi-start: each start jitters the spectral
    init into a different KL basin, and multi-pass refinement
    (:mod:`eig_kl_tpu_torch.kl.multipass`) descends each.  The draws are
    ``choice(side0)`` then ``choice(side1)`` on one ``default_rng(seed)``,
    so a seed gives the split the JAX package's ``perturb_split`` gives.
    """
    sides = np.asarray(sides, dtype=np.int8)
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"frac must be in [0, 1], got {frac}")
    rng = _rng(seed)
    side0 = np.flatnonzero(sides == 0)
    side1 = np.flatnonzero(sides == 1)
    k = min(int(np.ceil(frac * len(sides) / 2)), len(side0), len(side1))
    if k == 0:  # frac == 0 disables the jitter entirely
        return sides.copy()
    out = sides.copy()
    out[rng.choice(side0, size=k, replace=False)] = 1
    out[rng.choice(side1, size=k, replace=False)] = 0
    return out
