"""gKL2-flavor spectral partitioner: shift-inverted power iteration (the
port of ``eig_kl_tpu/spectral/power.py:_power_core_impl``, ``:122``).

The reference builds a row-degree-normalized Laplacian with off-diagonal
``-2 w_ij / deg_i`` and diagonal ``+2`` from the KL-weighted adjacency
(gKL2.cu:262-303) and iterates ``y = x - (L x) / shift`` with shift 2.0
(gKL2.cu:335-353), normalising every step.  The start vector is the JAX
package's ``jax.random.uniform(PRNGKey(seed)) - 0.5``, reproduced bit
for bit by :func:`eig_kl_tpu_torch.utils.threefry.uniform`.

The steps run on the device; the exit tests run on the host, which reads
one scalar per check (every ``check_interval`` steps for "sign" and
"momentum", every step for "gkl2").  Norms and dot products add in the fixed order of
:mod:`eig_kl_tpu_torch.ops.reduce`, which makes the iterate equal the JAX
package's CPU iterate bit for bit (in f32; in f64 the port rounds each
product on its own, where XLA fuses some).  On the card a CSR step is three
launches, in f32 or in f64: K1's step entry point
(``ops/spmv.py:power_step``), K6 for the norm with its root, and K6's
scale.

The "momentum" exit (``power.py:263-391`` of the JAX package) runs a
Chebyshev/Polyak recurrence on the symmetrized lazy walk
``(I + D^-1/2 A D^-1/2) / 2``, K1's lazy-walk entry point on the card
(``ops/spmv.py:lazy_walk``).  Its dots are XLA's vector dot in the
iterate's dtype (:func:`fma_dot`, K4 on the card), its deflation ``w - c
q0`` one fused multiply-add per element in f32 (K6's axpy on the card),
its norms K6.

An f32 graph with a plan iterates on zero-padded ``(P/128, 128)`` state,
as the JAX package's plan branch does (``power.py:140-165``): through the
v3 SpMV with a v3 plan; with a CSR plan (``Graph.to_device(with_plan=True)``)
through the SpMV in its TPU kernel's order (``ops/spmv_plan.py``: K1's
``spmv_v1_f32`` for a v1 plan, ``spmv_v2_f32`` for a v2 one), whose products
are rounded to bf16 where ``inter_dtype`` is "bfloat16" and the plan runs
the v2 kernels' bf16 mode (``CsrPlan.runs_bf16``), and f32 otherwise, then
K6's padded step, as on the v3 path.  A v2 plan's SpMV takes the reduce
order that ``EIG_KL_TPU_REDUCE_IMPL`` names and, with bf16 products, the
plan's bf16 weights where it keeps them (``EIG_KL_TPU_BF16_W``), read when
the operator is made, as the JAX solve reads them where it traces its
SpMV.  1 in the
padding of the degrees, the norm over the padded state in XLA's order for
a 2-D reduction, the padded step ``x - c * lap`` one fused multiply-add,
as on the CSR path (K6's padded step on the card, ROADMAP.md C7).  Its
dots take a slice of the padded state, which XLA fuses into the dot below
4,096 values (``ops/reduce.py:fused_dot_batch``: "slice" for the
deflation, "lanes" for the Rayleigh quotients).  f64 ignores
the plan: the JAX package's plan branch is f32 only.  The dots of the CSR
momentum exit are XLA's vector dot, except its Rayleigh quotient, into
which XLA fuses the lazy walk below 4,096 values ("chain"), as it fuses the
Laplacian into the final f32 Rayleigh quotient of the CSR solve; on a graph
wider than 32 the row sums stay out of both dots (the check's "walk", the
final quotient's "laplacian"; the check's still parts from the JAX runs on
some graphs, ROADMAP.md C); from 4,096 values the check's walk, a fusion
of its own, fuses the product of the deflated iterate's scaling
(``ops/spmv.py:lazy_walk``, ``scaled``).  (The f64 solve's final quotient
keeps the fixed-order sum.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import CsrPlan, DeviceGraph
from eig_kl_tpu_torch.ops.reduce import (
    FUSED_DOT_BYTES, axpy, fma_dot, fma_dot_batch, fused_dot, fused_dot_batch, normalize, padded_step, sqrt_rn,
    tree_dot, tree_norm, tree_norm_2d,
)
from eig_kl_tpu_torch.ops.select import upper_median
from eig_kl_tpu_torch.ops.spmv import WINDOW, lazy_walk, power_step, spmv
from eig_kl_tpu_torch.ops.spmv_plan import plan_lazy_walk, plan_spmv, reduce_impl_from_env
from eig_kl_tpu_torch.ops.spmv_v3 import spmv_v3_padded
from eig_kl_tpu_torch.utils.config import SpectralConfig
from eig_kl_tpu_torch.utils.threefry import uniform

#: The power solve's exit rules ("auto" resolves to one of the first two).
CONVERGENCE_RULES = ("sign", "gkl2", "momentum")


def resolve_convergence(convergence: str, dtype: torch.dtype) -> str:
    """"auto" -> "gkl2" for f64, "sign" otherwise (power.py's auto rule)."""
    if convergence == "auto":
        return "gkl2" if dtype == torch.float64 else "sign"
    if convergence not in CONVERGENCE_RULES:
        raise ValueError(f"unknown power convergence {convergence!r}")
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
    #: the norm of a state.
    norm: Callable[[torch.Tensor], torch.Tensor]
    #: (w, dsinv as a state) -> 0.5 (w + dsinv A (dsinv w)), the lazy walk.
    lazy: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    #: (w, u, c, dsinv as a state) -> the momentum check's Rayleigh quotient
    #: ``w . lazy(w)`` of its deflated unit iterate ``w = u * c`` (a
    #: vector), which XLA makes in the same program as the dot.
    rayleigh: Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
    #: the degrees with 1 where a degree is 0, as a vector.
    safe_deg: torch.Tensor
    #: whether the state is the padded one (a plan's).
    padded: bool = False
    #: the solve's first step, where it differs from ``step``: on the CSR
    #: path its row sums keep 8 lanes at width 16 (``power_step``'s
    #: ``lanes``).
    first_step: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]] | None = None


def power_operator(g: DeviceGraph, shift: float, dtype: torch.dtype, inter_dtype: str = "float32") -> PowerOperator:
    """The state layout and the step ``y = x - L x / shift`` normalised
    (gKL2.cu:65-89 sparseMVKernel) of the power solve on ``g``.
    ``inter_dtype`` ("float32" or "bfloat16", ``SpectralConfig.inter_dtype``)
    is read only for an f32 solve on a graph with a :class:`CsrPlan`."""
    n = g.num_nodes
    inv_shift = 1.0 / shift
    safe_deg = torch.where(g.degrees > 0, g.degrees, 1.0).to(dtype)

    if g.plan is not None and dtype == torch.float32:
        P = g.plan.padded_nodes
        if isinstance(g.plan, CsrPlan):
            # The JAX solve reads the reduce kernel and the bf16 weights where
            # it traces spmv_pallas_2d: here.
            layout, bf16 = g.plan.layout, g.plan.runs_bf16(inter_dtype)
            form = dict(reduce=reduce_impl_from_env(), bf16_weights=bf16 and layout.weights_bf16 is not None)

            def matvec(x2d):
                return plan_spmv(layout, x2d, bf16, **form)

            def lazy(w2d, dsinv2d):
                return plan_lazy_walk(layout, w2d, dsinv2d, bf16, **form)
        else:

            def matvec(x2d):
                return spmv_v3_padded(g.plan, x2d)

            def lazy(w2d, dsinv2d):
                ax = spmv_v3_padded(g.plan, dsinv2d * w2d)
                return 0.5 * axpy(dsinv2d, ax, w2d)

        def to_state(x):
            z = torch.zeros(P, dtype=dtype, device=g.device)
            z[:n] = x
            return z.view(P // 128, 128)

        def from_state(x2d):
            return x2d.reshape(-1)[:n]

        deg_used = to_state(safe_deg)
        deg_used.view(-1)[n:] = 1.0

        def norm_lap(x2d):
            return 2.0 * x2d - 2.0 * matvec(x2d) / deg_used

        def step(x2d):
            y = padded_step(x2d, matvec(x2d), deg_used, inv_shift)
            nrm = tree_norm_2d(y)
            return normalize(y, nrm), nrm

        def dot(x, y):
            return fused_dot(x.reshape(-1), y.reshape(-1), "lanes")

        def rayleigh(w, u, c, dsinv2d):
            return fused_dot(w, from_state(lazy(to_state(w), dsinv2d)), "lanes")

        return PowerOperator(to_state, from_state, norm_lap, step, dot, tree_norm_2d, lazy, rayleigh, safe_deg,
                             True)

    g_csr = dataclasses.replace(g, plan=None)  # f64 ignores the plan

    def norm_lap(x):
        return 2.0 * x - 2.0 * spmv(g_csr, x.to(g.dtype)).to(dtype) / safe_deg

    def step(x, lanes=False):
        y = power_step(g_csr, x, safe_deg, inv_shift, lanes=lanes)
        nrm = tree_norm(y)
        return normalize(y, nrm), nrm

    def lazy(w, dsinv):
        return lazy_walk(g_csr, w, dsinv)

    def dot(x, y):
        # The Rayleigh quotient jnp.vdot(v, norm_lap(v)): XLA fuses the
        # Laplacian, row sums included, into the f32 dot below 4,096
        # values, a scalar chain of fused multiply-adds ("chain"); above
        # 32 columns the row sums stay out of it, and the loop over the
        # rest of the Laplacian, the safe degrees an operand, is vectorized
        # ("laplacian"; from three row windows, a longer loop body, LLVM
        # unrolls less: "windows3").  At ELL width 8 LLVM vectorizes the
        # chain's loop across rows ("rows").
        if g.row_width <= WINDOW:
            return fused_dot(x, y, "rows" if g.row_width == 8 else "chain")
        return fused_dot(x, y, "laplacian" if g.row_width <= 2 * WINDOW else "windows3")

    def rayleigh(w, u, c, dsinv):
        # jnp.vdot(w, opm_sym(w)) with w = u * c made in the same program.
        # Up to 32 columns XLA fuses the walk, row sums included, into the
        # dot below 4,096 values ("chain").  Above 32 the windowed row sums
        # are a fusion of their own.  Below 4,096 values the walk's
        # epilogue is fused into the dot's loop, which also reads w: LLVM
        # contracts the product dsinv * Ax into the add (the lazy walk's
        # own epilogue), and the loop's order is "walk".  From 4,096 the
        # dot is XLA's vector dot and the walk a fusion of its own, which
        # recomputes w and contracts its product (lazy_walk's scaled form;
        # ROADMAP.md C).  From three row windows the loop is "windows3"; at
        # ELL width 8 it is "rows", as for the final quotient.
        if g.row_width <= WINDOW:
            return fused_dot(w, lazy(w, dsinv), "rows" if g.row_width == 8 else "chain")
        order = "walk" if g.row_width <= 2 * WINDOW else "windows3"
        if w.numel() * w.element_size() < FUSED_DOT_BYTES:
            return fused_dot(w, lazy(w, dsinv), order)
        return fused_dot(w, lazy_walk(g_csr, w, dsinv, scaled=(u, c)), order)

    return PowerOperator(lambda x: x, lambda x: x, norm_lap, step, dot if dtype == torch.float32 else tree_dot,
                         tree_norm, lazy, rayleigh, safe_deg,
                         first_step=lambda x: step(x, lanes=g.row_width == 16))


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
    inter_dtype: str = "float32",
):
    """The power solve.  Returns ``(lam, v, iterations)`` with ``lam`` a
    0-d tensor and ``v`` the final iterate on the graph's device.
    ``inter_dtype`` as :func:`power_operator` reads it."""
    convergence = resolve_convergence(convergence, dtype)
    n = g.num_nodes
    op = power_operator(g, shift, dtype, inter_dtype)
    step, from_state = op.step, op.from_state

    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    x0 = uniform(seed, n, np_dtype) - np_dtype.type(0.5)
    x, nrm = (op.first_step or step)(op.to_state(torch.as_tensor(x0).to(g.device)))
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
    elif convergence == "momentum":
        v, iteration = _momentum(op, x, n, dtype, check_interval, stable_checks, max_iters)
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


def _reciprocal(nrm: torch.Tensor) -> torch.Tensor:
    """``1 / nrm`` where ``nrm > 0``, else 1."""
    return torch.where(nrm > 0, 1.0 / torch.where(nrm > 0, nrm, 1.0), 1.0)


def momentum_beta(mu: torch.Tensor) -> torch.Tensor:
    """The momentum exit's ``beta = (0.995 mu)^2 / 4`` as XLA computes it in
    the iterate's dtype: it folds the constants into ``mu * mu`` times one
    rounded constant (the programs' HLO: ``multiply(mu, mu) * 0.247506246``
    in f32, ``* 0.24750625`` in f64; ROADMAP.md C9)."""
    if mu.dtype == torch.float32:
        scale = np.float32(np.float32(0.995) * np.float32(0.995)) * np.float32(0.25)
    else:
        scale = 0.995 * 0.995 * 0.25
    return (mu * mu) * torch.tensor(scale, dtype=mu.dtype, device=mu.device)


def _momentum(op: PowerOperator, x0, n, dtype, check_interval, stable_checks, max_iters):
    """The "momentum" exit from the first step's iterate ``x0``
    (``eig_kl_tpu/spectral/power.py:263-391``): the recurrence
    ``u_{k+1} = B u_k - beta u_{k-1}`` on the symmetric lazy walk
    ``B = (I + D^-1/2 A D^-1/2) / 2``, the constant mode ``q0 ~ sqrt(deg)``
    projected off both carries at every check, ``beta = (0.995 mu / 2)^2``
    from the Rayleigh quotient ``mu`` of the deflated unit iterate, and the
    sign exit's split-stability rule without its dip exit.  Returns the
    unit iterate in the reference basis ``D^-1/2 w`` (as a state) and the
    iteration count."""
    flip_tol = 1e-3
    to_state, from_state = op.to_state, op.from_state
    dsq = sqrt_rn(op.safe_deg)  # correctly rounded, as XLA's root
    dsinv = 1.0 / dsq
    dsinv_st = to_state(dsinv)  # zero in a padded state's padding
    q0 = dsq / tree_norm(dsq)  # the top (constant) mode of B

    def deflate(w):
        return axpy(-fma_dot(q0, w), q0, w)

    def split_of_w(wv):
        v = wv * dsinv
        return upper_median(v, n) > v

    w0 = deflate(from_state(x0) * dsq)  # the reference draw, in the B basis
    nv0 = tree_norm(w0)
    w0 = w0 / torch.where(nv0 > 0, nv0, 1.0)
    x = to_state(w0)
    xp = to_state(torch.zeros_like(w0))
    beta = torch.zeros((), dtype=dtype, device=w0.device)
    split = split_of_w(w0)
    stable, iteration = 0, 1
    while True:
        # No dip exit: the constant mode is deflated at every check, and
        # beta's adaptation re-excites bulk modes between checks, which a
        # dip rule would misread.  Split stability or the cap decide.
        past_min = iteration > 2 * check_interval
        if (stable >= stable_checks and past_min) or iteration >= max_iters:
            break
        wp, w = xp, x
        for _ in range(check_interval):
            u = op.lazy(w, dsinv_st) - beta * wp
            inv = _reciprocal(op.norm(u))
            wp, w = w * inv, u * inv
        # Deflate the constant mode from both carries (by linearity the
        # projected pair still satisfies the recurrence): their two dots
        # are one K4 launch on the card, each its own chain.  On a padded
        # state XLA fuses the slice into them.
        w_flat, wp_flat = from_state(w), from_state(wp)
        if op.padded:
            c = fused_dot_batch((q0, q0), (w_flat, wp_flat), "slice")
        else:
            c = fma_dot_batch((q0, q0), (w_flat, wp_flat))
        defl = axpy(-c[0], q0, w_flat)
        inv = _reciprocal(tree_norm(defl))
        wv, wpv = defl * inv, axpy(-c[1], q0, wp_flat) * inv
        x = to_state(wv)
        # One more lazy walk per check: the symmetric Rayleigh quotient of
        # the deflated unit iterate, a lower bound on the Fiedler mode's mu.
        mu = torch.clamp(op.rayleigh(wv, defl, inv, dsinv_st), 0.05, 1.0 - 1e-7)
        beta = momentum_beta(mu)
        new_split = split_of_w(wv)
        d = int((new_split != split).sum())
        stable = stable + 1 if min(d, n - d) <= flip_tol * n else 0
        xp, split = to_state(wpv), new_split
        iteration += check_interval
    v_flat = from_state(x) * dsinv
    nvf = tree_norm(v_flat)
    return to_state(v_flat / torch.where(nvf > 0, nvf, 1.0)), iteration


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
        inter_dtype=config.inter_dtype,
    )
    med = upper_median(v)
    sides = (med > v).to(torch.int8)
    return float(lam), float(med), v.cpu().numpy(), sides.cpu().numpy(), iters
