"""Configuration for the two algorithm phases.

The port's own copy of ``eig_kl_tpu/utils/config.py``: the same fields,
defaults and rules, so that a configuration means the same thing in
both packages.  The reference's hard-coded constants, with their
origins:

* terminate limit ``log2(n) + 5`` (cKL.cpp:303, gKL.cu:443)
* gain epsilon: cKL stops counting on ``gain <= 0`` (cKL.cpp:382), the
  GPU versions on ``gain <= 1e-6`` (gKL.cu:26,495)
* power iteration: max 1000 iterations, convergence ``|delta norm| <
  1e-6`` only after iteration 100, shift 2.0, seed 42
  (gKL2.cu:26-27,322,335,370-377)
* Lanczos/Spectra: nev=2, ncv=min(100, n/2) (cEIG.cpp:195)
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class KLConfig:
    """KL refinement options.

    Attributes:
      gain_eps: swaps with gain <= gain_eps count toward termination
        (0.0 matches cKL.cpp:382; 1e-6 matches gKL.cu:495).
      terminate_extra: terminate after ``floor(log2(n)) + terminate_extra``
        consecutive non-improving swaps (5 in the reference).
      max_iterations: hard cap on swaps; None = min side size (the
        natural KL exhaustion point).
      refresh_interval: if > 0, recompute the cached ``A @ s`` and the
        incremental cut from scratch every this many swaps (the pass
        leaves the kernel and re-enters it); 0 = never (the reference's
        verifyAndCorrectCutSize is disabled, gKL.cu:368-382).
      use_pallas: engine selection of the JAX package; the port has one
        engine and ignores it.
      passes: number of KL passes.  1 = the reference's semantics (one
        pass, the best cut only tracked, cKL.cpp:363, gKL.cu:484); N > 1
        = up to N passes, each restarting from the previous pass's best
        partition with all nodes unlocked, stopping early when a pass
        does not improve; 0 = until converged
        (:mod:`eig_kl_tpu_torch.kl.multipass`).
      kicks: iterated-local-search rounds after the descent: perturb the
        best partition (a balanced random swap of ``kick_frac`` of the
        nodes), re-descend, keep the global best.  0 = off.
      kick_frac: kick size as a fraction of nodes.
    """

    gain_eps: float = 0.0
    terminate_extra: int = 5
    max_iterations: int | None = None
    refresh_interval: int = 0
    use_pallas: bool | None = None
    passes: int = 1
    kicks: int = 0
    kick_frac: float = 0.15

    def terminate_limit(self, num_nodes: int) -> int:
        return int(math.log2(max(num_nodes, 2))) + self.terminate_extra


@dataclasses.dataclass(frozen=True)
class SpectralConfig:
    """Spectral (Fiedler) phase options.

    Attributes:
      solver: "lanczos", "power", "lobpcg" or "auto" (lanczos when the
        circuit has at most ``auto_lanczos_max_nodes`` nodes, power
        otherwise).  Resolve with :func:`resolve_solver` before
        dispatching.
      num_lanczos: Krylov subspace size, min(100, n//2) if None
        (lanczos only; cEIG.cpp:195's ncv).
      max_iterations: power-iteration cap (gKL2.cu:26), LOBPCG's
        iteration cap, and Lanczos restarts at least this // ncv.
      tolerance: convergence tolerance (power: delta-norm, gKL2.cu:27;
        lanczos/lobpcg: the residual on lambda_2, relative to
        max(1, lambda_2)).
      min_power_iters: power iteration only tests convergence after this
        many steps (gKL2.cu:377).
      shift: power-iteration spectral shift (gKL2.cu:335).
      seed: RNG seed for the initial vector (srand(42), gKL2.cu:322).
      convergence: power-iteration exit rule.  "gkl2" = the reference's
        ``|delta norm| < tolerance`` (gKL2.cu:370-377); "sign" = stop when
        the median-split sign pattern is unchanged across
        ``stable_checks`` consecutive checks ``check_interval`` steps
        apart, or once its change rose past its minimum; "momentum" =
        Chebyshev/Polyak-accelerated iteration on the symmetrized lazy
        walk (I + D^-1/2 A D^-1/2)/2 with an adaptive ellipse edge and
        the sign rule's split-stability exit.  "auto" (default) = "sign"
        for f32, "gkl2" for f64.
      check_interval: power steps between sign-stability checks.
      stable_checks: consecutive unchanged checks required to stop.
      inter_dtype: dtype of the SpMV's intermediates in the f32 power
        solve on a graph with a CSR plan (``Graph.to_device(with_plan=True)``,
        the JAX package's plan path): "bfloat16" rounds every product to
        bf16 before the f32 sum where the plan is a v2 one (the JAX
        package's default on its accelerator, ``CsrPlan.runs_bf16``),
        "float32" keeps K1's f32 sums.  Without a plan (the default on
        every device) the port runs all-f32 and does not read it.
      host_refine: host f64 polish of lanczos/lobpcg pairs
        (:mod:`eig_kl_tpu_torch.spectral.refine`, to ``tolerance *
        1e-3``); None = on for f32 solves.
    """

    solver: str = "lanczos"
    num_lanczos: int | None = None
    max_iterations: int = 1000
    tolerance: float = 1e-6
    min_power_iters: int = 100
    shift: float = 2.0
    seed: int = 42
    convergence: str = "auto"
    check_interval: int = 25
    stable_checks: int = 2
    inter_dtype: str = "bfloat16"
    host_refine: bool | None = None
    auto_lanczos_max_nodes: int = 256


def resolve_solver(config: SpectralConfig, num_nodes: int) -> SpectralConfig:
    """Resolve ``solver="auto"`` to a concrete solver for this circuit:
    lanczos at ``auto_lanczos_max_nodes`` nodes or fewer, power above.
    No-op for concrete solvers."""
    if config.solver != "auto":
        return config
    solver = (
        "lanczos" if num_nodes <= config.auto_lanczos_max_nodes else "power"
    )
    return dataclasses.replace(config, solver=solver)
