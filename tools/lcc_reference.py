"""The JAX package's numbers on the largest connected component of the
generated circuit at 1.0x, seed 42 (184,406 nodes), on the CPU at f32,
or with ``--x64`` at f64: what ``chip_smoke.py``'s lanczos, lobpcg,
momentum and f64 phases hold the port to on the card.

Run from the repository root (a few minutes, some GiB of memory)::

    JAX_PLATFORMS=cpu python3 tools/lcc_reference.py
    JAX_PLATFORMS=cpu python3 tools/lcc_reference.py --x64

It prints, as JSON: the component's counts; ``eig_partition`` with
Lanczos and with LOBPCG at f32 plus the host f64 refinement (lambda_2,
balance, the solvers' own counts); one KL pass (``kl_partition``,
``KLConfig()``, the ``kl -EIG`` command's) from the Lanczos split; and the
momentum exit (``power_partition_fiedler``, ``convergence="momentum"``)
on the component's KL-weighted graph, with a digest of its split and
vector, beside the port's own run of it on the CPU (its kernels' plain
versions).

With ``--inter bf16`` it runs the JAX package's power solve with the v2
SpMV's bf16 intermediates instead: ``_power_core`` (the momentum exit,
seed 42, capped at ``BF16I_MAX_ITERS`` steps) on the largest connected
component of ``benchmarks/data/gen_0.02_42.hgr`` (3,694 nodes; the whole
0.02x circuit is disconnected, and its power iterate an arbitrary null
vector), its graph carrying a ``build_plan_v2`` plan and its v2 kernels
running in interpret mode, with ``inter_dtype="bfloat16"``.  It writes
the iterations, eigenvalue, median and vector to ``BF16I_FIXTURE``, which
``tests/test_torch_bf16i.py`` holds the port's plain bf16-intermediate
solve to, and prints them beside the port's own CPU run (the v2 order:
the same bits) and the plan's overflow tail (its entries added in f32 by
both); about a minute::

    JAX_PLATFORMS=cpu python3 tools/lcc_reference.py --inter bf16

With ``--x64`` (x64 enabled before anything is traced) it prints the f64
numbers instead: Lanczos and LOBPCG on the component at f64 (no host
refinement, the JAX package's rule off the TPU), the f64 momentum exit
on its KL-weighted graph beside the port's own f64 run of it on the CPU
(the split of the JAX run goes, bit-packed, to
``tools/lcc_momentum_f64_sides.bin``, which ``chip_smoke.py`` measures
the card's split against), and ``fused_partition(use_eig=True,
dtype=float64)`` on the whole circuit (its power iterations, cuts and
swaps).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import MOMENTUM_F64_SIDES, MULTIPLIER, SEED, largest_component  # noqa: E402


#: The bf16-intermediate solve's fixture (``--inter bf16``) and its cap.
BF16I_FIXTURE = os.path.join(ROOT, "tools", "gen002_lcc_bf16i.npz")
BF16I_MAX_ITERS = 300
GEN002 = os.path.join(ROOT, "benchmarks", "data", "gen_0.02_42.hgr")


def tail_entries(plan) -> int:
    """The stored entries of a v2 plan's overflow tail (0 without one)."""
    from eig_kl_tpu.ops.spmv_pallas import CooTail

    if plan.tail is None:
        return 0
    if isinstance(plan.tail, CooTail):
        return int(plan.tail.rows.shape[0])
    return int((np.asarray(plan.tail.weights) != 0).sum())


def main_bf16i() -> dict:
    """The bf16-intermediate power solve on gen 0.02x's largest component
    (``--inter bf16``)."""
    import dataclasses

    import torch

    from eig_kl_tpu.graph.expand import clique_expand as jax_expand
    from eig_kl_tpu.io.hgr import Hypergraph as JaxHypergraph
    from eig_kl_tpu.ops.spmv_pallas import build_plan_v2
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.graph.csr import CsrPlan, Graph
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.spectral.power import _power_core

    hg = largest_component(read_hgr(GEN002, use_native=False))
    g = jax_expand(JaxHypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets), "kl", use_native=False)
    n = g.num_nodes
    rows = np.repeat(np.arange(n, dtype=np.int64), g.degrees)
    plan = build_plan_v2(n, rows, g.indices.astype(np.int64), g.data.astype(np.float32))
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=BF16I_MAX_ITERS, seed=42,
              convergence="momentum", inter_dtype="bfloat16")
    t0 = time.perf_counter()
    lam, v, iters = jax_core(g.to_device()._replace(plan=plan), dtype="float32", **kw)
    v = np.asarray(v, np.float32)
    jax_s = time.perf_counter() - t0
    med = float(np.sort(v)[n // 2])
    np.savez(BF16I_FIXTURE, iterations=int(iters), eigenvalue=np.float32(lam), median=np.float32(med), values=v)
    base = Graph.from_arrays(g.indptr, g.indices, g.data).to_device("cpu")
    gd = dataclasses.replace(base, plan=CsrPlan.for_graph(base, kernel="v2"))
    t0 = time.perf_counter()
    p_lam, p_v, p_iters = _power_core(gd, dtype=torch.float32, **kw)
    p_v = p_v.numpy()
    d = int(((med > v) != (np.sort(p_v)[n // 2] > p_v)).sum())
    return {
        "component": {"nodes": n, "nnz": g.nnz, "P": plan.padded_nodes},
        "v2_tail_entries": tail_entries(plan),
        "jax": {"iterations": int(iters), "eigenvalue": float(lam), "median": med,
                "side_1": int((med > v).sum()), "s": jax_s,
                "fixture": os.path.relpath(BF16I_FIXTURE, ROOT)},
        "port_cpu": {"iterations": p_iters, "eigenvalue": float(p_lam), "hamming_to_jax": min(d, n - d),
                     "cos": float(p_v @ v / np.linalg.norm(p_v) / np.linalg.norm(v)),
                     "s": time.perf_counter() - t0},
    }


def digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def main_x64(hg, jhg) -> dict:
    """The f64 numbers (``--x64``)."""
    from eig_kl_tpu.graph.expand import clique_expand as jax_expand
    from eig_kl_tpu.io.hgr import Hypergraph as JaxHypergraph
    from eig_kl_tpu.models.pipelines import fused_partition as jax_fused
    from eig_kl_tpu.spectral.lanczos import lanczos_fiedler as jax_lanczos
    from eig_kl_tpu.spectral.lobpcg_solver import lobpcg_fiedler as jax_lobpcg
    from eig_kl_tpu.spectral.partition import eig_partition as jax_eig
    from eig_kl_tpu.spectral.power import power_partition_fiedler as jax_ppf
    import eig_kl_tpu.spectral.power as jax_power
    from eig_kl_tpu.utils.config import SpectralConfig as JaxSpec
    import torch

    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.models.generator import CircuitGenerator
    from eig_kl_tpu_torch.spectral.power import power_partition_fiedler
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    out = {}
    g_eig = jax_expand(jhg, "eig", use_native=False)
    g_dev = g_eig.to_device(dtype=jnp.float64)
    for solver, fn in (("lanczos", jax_lanczos), ("lobpcg", jax_lobpcg)):
        t0 = time.perf_counter()
        res = fn(g_dev, JaxSpec(solver=solver), dtype=jnp.float64)
        solve_s = time.perf_counter() - t0
        eig = jax_eig(jhg, JaxSpec(solver=solver), dtype=jnp.float64, host_graph=g_eig)
        out[solver] = {
            "solver_eigenvalue": float(res.eigenvalue),
            "solver_residual": float(res.residual),
            "count": int(res.restarts if solver == "lanczos" else res.iterations),
            "solver_s": solve_s,
            "eigenvalue": eig.eigenvalue,
            "median": eig.median,
            "balance": list(eig.balance()),
        }
    g_kl = jax_expand(jhg, "kl", use_native=False)
    t0 = time.perf_counter()
    lam, med, vals, sides = jax_ppf(
        g_kl.to_device(dtype=jnp.float64), JaxSpec(solver="power", convergence="momentum"),
        dtype=jnp.float64,
    )
    jax_s = time.perf_counter() - t0
    sides = np.asarray(sides, np.int8)
    with open(MOMENTUM_F64_SIDES, "wb") as f:
        f.write(np.packbits(sides).tobytes())
    t0 = time.perf_counter()
    p_lam, p_med, _, p_sides, p_iters = power_partition_fiedler(
        clique_expand(hg, "kl").to_device("cpu", torch.float64),
        SpectralConfig(solver="power", convergence="momentum"), dtype=torch.float64,
    )
    hamming = int((p_sides != sides).sum())
    out["momentum"] = {
        "iterations": jax_power.last_iterations, "median": med, "eigenvalue": lam,
        "side_1": int(sides.sum()), "sides_digest": digest(sides), "s": jax_s,
        "sides_file": os.path.relpath(MOMENTUM_F64_SIDES, ROOT),
        "port_cpu": {
            "iterations": p_iters, "median": p_med, "eigenvalue": p_lam,
            "side_1": int(p_sides.sum()), "sides_digest": digest(p_sides.astype(np.int8)),
            "hamming_to_jax": min(hamming, len(sides) - hamming), "s": time.perf_counter() - t0,
        },
    }
    full = CircuitGenerator(MULTIPLIER, SEED).generate()
    jfull = JaxHypergraph(full.num_nodes, full.num_nets, full.pins, full.net_offsets, name=full.name)
    t0 = time.perf_counter()
    run = jax_fused(jfull, use_eig=True, dtype=jnp.float64)
    kl = run.kl
    out["fused_f64_full"] = {
        "power_iterations": jax_power.last_iterations,
        "initial_cut": float(kl.initial_cut), "best_cut": float(kl.best_cut),
        "final_cut": float(kl.final_cut), "verified_cut": float(kl.verified_cut),
        "swaps": int(kl.iterations), "s": time.perf_counter() - t0,
    }
    return out


def main() -> int:
    import torch

    from eig_kl_tpu.graph.expand import clique_expand as jax_expand
    from eig_kl_tpu.io.hgr import Hypergraph as JaxHypergraph
    from eig_kl_tpu.models.pipelines import kl_partition as jax_kl
    from eig_kl_tpu.spectral.lanczos import lanczos_fiedler as jax_lanczos
    from eig_kl_tpu.spectral.lobpcg_solver import lobpcg_fiedler as jax_lobpcg
    from eig_kl_tpu.spectral.partition import eig_partition as jax_eig
    from eig_kl_tpu.spectral.power import power_partition_fiedler as jax_ppf
    import eig_kl_tpu.spectral.power as jax_power
    from eig_kl_tpu.utils.config import KLConfig as JaxKL, SpectralConfig as JaxSpec
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.models.generator import CircuitGenerator
    from eig_kl_tpu_torch.spectral.power import power_partition_fiedler
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    if sys.argv[1:3] == ["--inter", "bf16"]:
        print(json.dumps(main_bf16i(), indent=1))
        return 0
    out = {}
    hg = largest_component(CircuitGenerator(MULTIPLIER, SEED).generate())
    jhg = JaxHypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets, name=hg.name)
    out["component"] = {"nodes": hg.num_nodes, "nets": hg.num_nets, "pins": int(len(hg.pins))}
    if "--x64" in sys.argv[1:]:
        out.update(main_x64(hg, jhg))
        print(json.dumps(out, indent=1))
        return 0
    g_eig = jax_expand(jhg, "eig", use_native=False)
    g_dev = g_eig.to_device(dtype=jnp.float32)
    for solver, fn in (("lanczos", jax_lanczos), ("lobpcg", jax_lobpcg)):
        t0 = time.perf_counter()
        res = fn(g_dev, JaxSpec(solver=solver), dtype=jnp.float32)
        solve_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        eig = jax_eig(jhg, JaxSpec(solver=solver), dtype=jnp.float32, host_graph=g_eig)
        out[solver] = {
            "solver_eigenvalue": float(res.eigenvalue),
            "solver_residual": float(res.residual),
            "count": int(res.restarts if solver == "lanczos" else res.iterations),
            "solver_s": solve_s,
            "eigenvalue": eig.eigenvalue,
            "median": eig.median,
            "balance": list(eig.balance()),
            "eig_partition_s": time.perf_counter() - t0,
        }
        if solver == "lanczos":
            lanczos_eig = eig
    t0 = time.perf_counter()
    run = jax_kl(jhg, init=lanczos_eig, kl_config=JaxKL(), dtype=jnp.float32)
    kl = run.kl
    out["kl_from_lanczos"] = {
        "initial_cut": float(kl.initial_cut), "best_cut": float(kl.best_cut),
        "final_cut": float(kl.final_cut), "verified_cut": float(kl.verified_cut),
        "swaps": int(kl.iterations), "s": time.perf_counter() - t0,
    }
    g_kl = jax_expand(jhg, "kl", use_native=False)
    cfg = dict(solver="power", convergence="momentum")
    t0 = time.perf_counter()
    lam, med, vals, sides = jax_ppf(g_kl.to_device(dtype=jnp.float32), JaxSpec(**cfg), dtype=jnp.float32)
    jax_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_lam, p_med, p_vals, p_sides, p_iters = power_partition_fiedler(
        clique_expand(hg, "kl").to_device("cpu"), SpectralConfig(**cfg), dtype=torch.float32
    )
    out["momentum"] = {
        "iterations": jax_power.last_iterations, "median": med, "eigenvalue": lam,
        "side_1": int(np.asarray(sides).sum()), "sides_digest": digest(np.asarray(sides, np.int8)),
        "values_digest": digest(np.asarray(vals, np.float32)), "s": jax_s,
        "port_cpu": {
            "iterations": p_iters, "median": p_med, "eigenvalue": p_lam,
            "side_1": int(p_sides.sum()), "sides_digest": digest(p_sides.astype(np.int8)),
            "values_digest": digest(p_vals.astype(np.float32)), "s": time.perf_counter() - t0,
            "values_equal_bitwise": bool(np.array_equal(
                np.asarray(vals, np.float32).view(np.int32), p_vals.astype(np.float32).view(np.int32))),
        },
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    if "--x64" in sys.argv[1:]:
        import jax

        jax.config.update("jax_enable_x64", True)
    sys.exit(main())
