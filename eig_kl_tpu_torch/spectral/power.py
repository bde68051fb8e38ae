"""gKL2-flavor spectral partitioner: shift-inverted power iteration (the
port of ``eig_kl_tpu/spectral/power.py:_power_core_impl``, ``:122``).

The reference builds a row-degree-normalized Laplacian with off-diagonal
``-2 w_ij / deg_i`` and diagonal ``+2`` from the KL-weighted adjacency
(gKL2.cu:262-303) and iterates ``y = x - (L x) / shift`` with shift 2.0
(gKL2.cu:335-353), normalising every step.  The start vector is the JAX
package's ``jax.random.uniform(PRNGKey(seed)) - 0.5``, reproduced bit
for bit by :func:`eig_kl_tpu_torch.utils.threefry.uniform`.

The steps run on the device; the exit tests run on the host, which reads
one scalar per check (every ``check_interval`` steps for "sign", every
step for "gkl2").  Norms and dot products add in the fixed order of
:mod:`eig_kl_tpu_torch.ops.reduce`, which makes the iterate equal the JAX
package's CPU iterate bit for bit.  On the card an f32 CSR step is three
launches: K1's step entry point (``ops/spmv.py:power_step``), K6 for the
norm with its root, and K6's scale.  The "momentum" exit is not yet
ported.

An f32 graph with a v3 plan iterates on zero-padded ``(P/128, 128)``
state through the v3 SpMV, as the JAX package's plan branch does
(``power.py:140-165``): 1 in the padding of the degrees, the norm over
the padded state in XLA's order for a 2-D reduction, the Rayleigh
quotient as XLA's vector dot over the padded state (K4 on the card).
f64 ignores the plan.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph
from eig_kl_tpu_torch.ops.reduce import fma_dot, normalize, tree_dot, tree_norm, tree_norm_2d
from eig_kl_tpu_torch.ops.select import upper_median
from eig_kl_tpu_torch.ops.spmv import power_step, spmv
from eig_kl_tpu_torch.ops.spmv_v3 import spmv_v3_padded
from eig_kl_tpu_torch.utils.config import SpectralConfig
from eig_kl_tpu_torch.utils.threefry import uniform

#: Exits the port implements; "momentum" is ROADMAP.md A7.
CONVERGENCE_RULES = ("sign", "gkl2")


def resolve_convergence(convergence: str, dtype: torch.dtype) -> str:
    """"auto" -> "gkl2" for f64, "sign" otherwise (power.py's auto rule)."""
    if convergence == "auto":
        return "gkl2" if dtype == torch.float64 else "sign"
    if convergence not in CONVERGENCE_RULES:
        raise NotImplementedError(
            f"power convergence {convergence!r} is not yet ported to "
            "eig_kl_tpu_torch (ROADMAP.md A7)"
        )
    return convergence


@dataclasses.dataclass(frozen=True)
class PowerOperator:
    """The power solve's state and step for one graph and dtype: the state
    is the iterate itself, or with a v3 plan (f32) its zero-padded
    ``(P/128, 128)`` form."""

    to_state: Callable[[torch.Tensor], torch.Tensor]
    from_state: Callable[[torch.Tensor], torch.Tensor]
    #: L x, L = 2 I - 2 D^-1 A (row-normalized, gKL2.cu:262-303).
    norm_lap: Callable[[torch.Tensor], torch.Tensor]
    #: x -> (the next unit iterate, the norm it was divided by).
    step: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]]
    dot: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def power_operator(g: DeviceGraph, shift: float, dtype: torch.dtype) -> PowerOperator:
    """The state layout and the step ``y = x - L x / shift`` normalised
    (gKL2.cu:65-89 sparseMVKernel) of the power solve on ``g``."""
    n = g.num_nodes
    inv_shift = 1.0 / shift
    safe_deg = torch.where(g.degrees > 0, g.degrees, 1.0).to(dtype)

    if g.plan is not None and dtype == torch.float32:
        P = g.plan.padded_nodes

        def to_state(x):
            z = torch.zeros(P, dtype=dtype, device=g.device)
            z[:n] = x
            return z.view(P // 128, 128)

        def from_state(x2d):
            return x2d.reshape(-1)[:n]

        deg_used = to_state(safe_deg)
        deg_used.view(-1)[n:] = 1.0

        def norm_lap(x2d):
            return 2.0 * x2d - 2.0 * spmv_v3_padded(g.plan, x2d) / deg_used

        def step(x2d):
            # XLA's 2-D order is matched up to 32 rows of 128 and above
            # 1,024; in between, for row counts whose last block XLA
            # vectorizes, the norm (and so the iterate) can differ from the
            # JAX package's in the last bits (ops/reduce.py:tree_sum_2d).
            y = x2d - inv_shift * norm_lap(x2d)
            nrm = tree_norm_2d(y)
            return normalize(y, nrm), nrm

        def dot(x, y):
            return fma_dot(x.reshape(-1), y.reshape(-1))

        return PowerOperator(to_state, from_state, norm_lap, step, dot)

    g_csr = dataclasses.replace(g, plan=None)  # f64 ignores the plan

    def norm_lap(x):
        return 2.0 * x - 2.0 * spmv(g_csr, x.to(g.dtype)).to(dtype) / safe_deg

    def step(x):
        y = power_step(g_csr, x, safe_deg, inv_shift)
        nrm = tree_norm(y)
        return normalize(y, nrm), nrm

    return PowerOperator(lambda x: x, lambda x: x, norm_lap, step, tree_dot)


def _power_core(
    g: DeviceGraph,
    *,
    shift: float,
    tolerance: float,
    min_iters: int,
    max_iters: int,
    seed: int,
    dtype: torch.dtype,
    convergence: str = "gkl2",
    check_interval: int = 25,
    stable_checks: int = 2,
):
    """The power solve.  Returns ``(lam, v, iterations)`` with ``lam`` a
    0-d tensor and ``v`` the final iterate on the graph's device."""
    convergence = resolve_convergence(convergence, dtype)
    n = g.num_nodes
    op = power_operator(g, shift, dtype)
    step, from_state = op.step, op.from_state

    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    x0 = uniform(seed, n, np_dtype) - np_dtype.type(0.5)
    x, nrm = step(op.to_state(torch.as_tensor(x0).to(g.device)))
    iteration = 1

    if convergence == "sign":
        # f32-appropriate exit (eig_kl_tpu/spectral/power.py:193-262):
        # watch the median-split pattern every check_interval steps; stop
        # when it is stable for stable_checks checks, or when its change
        # rose 10% above its minimum (then the minimum's iterate wins).
        flip_tol = 1e-3

        def split_of(x):
            v = from_state(x)
            return upper_median(v, n) > v

        split = split_of(x)
        best_x, best_flips, flips, stable = x, n + 1, n + 1, 0
        f32 = np.float32
        while True:
            past_min = iteration > min_iters
            crisp = stable >= stable_checks and past_min
            rose = f32(flips) > f32(1.1) * f32(best_flips) and past_min
            if crisp or rose or iteration >= max_iters:
                break
            for _ in range(check_interval):
                x = step(x)[0]
            new_split = split_of(x)
            d = int((new_split != split).sum())
            flips = min(d, n - d)
            if flips < best_flips:
                best_x, best_flips = x, flips
            stable = stable + 1 if flips <= flip_tol * n else 0
            split = new_split
            iteration += check_interval
        v = best_x if flips > best_flips else x
    else:  # "gkl2": the reference's rule (gKL2.cu:26-27, 370-377)
        norm, prev = nrm, torch.zeros((), dtype=dtype, device=g.device)
        while True:
            done = bool(torch.abs(norm - prev) < tolerance) and iteration > min_iters
            if done or iteration >= max_iters:
                break
            x, nrm = step(x)
            prev, norm = norm, nrm
            iteration += 1
        v = x
    lam = op.dot(v, op.norm_lap(v))  # Rayleigh quotient
    return lam, from_state(v), iteration


def power_partition_fiedler(
    g: DeviceGraph,
    config: SpectralConfig = SpectralConfig(solver="power"),
    *,
    dtype: torch.dtype = torch.float32,
):
    """Power solve + "upper"-median split, fetched to the host.

    Returns ``(eigenvalue, median, values, sides, iterations)`` with
    ``sides[i] = median > values[i]`` (int8), the gKL2 split semantics
    (gKL2.cu:403-414)."""
    lam, v, iters = _power_core(
        g,
        shift=config.shift,
        tolerance=config.tolerance,
        min_iters=config.min_power_iters,
        max_iters=config.max_iterations,
        seed=config.seed,
        dtype=dtype,
        convergence=config.convergence,
        check_interval=config.check_interval,
        stable_checks=config.stable_checks,
    )
    med = upper_median(v)
    sides = (med > v).to(torch.int8)
    return float(lam), float(med), v.cpu().numpy(), sides.cpu().numpy(), iters
