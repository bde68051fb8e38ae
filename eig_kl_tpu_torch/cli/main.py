"""Command-line interface of the port (``python -m eig_kl_tpu_torch ...``).

The subcommands, flags, output files and console blocks of
``eig_kl_tpu/cli/main.py``:

* ``eig <file> [--solver lanczos|lobpcg|power]`` == ``./cEIG`` (cEIG.cpp:138)
* ``kl <file> [-EIG]``           == ``./cKL|./gKL``  (cKL.cpp:424, gKL.cu:672)
* ``fused <file> [-EIG]``        == ``./gKL2``       (gKL2.cu:989)
* ``generate <mult> -o FILE``    == ``circuit_generator.py`` (:71-84)
* ``info``                       == printGPUInfo    (gKL.cu:555-571)

``--device {cuda,cpu}`` (default ``cuda``) takes the place of the JAX
CLI's ``--platform``.  ``--starts``, ``--perturb``, ``--passes``,
``--kicks`` and ``--kick-frac`` mean what they mean there.  Under several
ranks (``torchrun --nproc-per-node N -m eig_kl_tpu_torch ...``, one
process per card), ``kl --starts S`` on the card in f32 with ``S``
divisible by the rank count splits the starts over the ranks
(:func:`~eig_kl_tpu_torch.parallel.multi_start.multi_start_refine_mega_sharded`,
the JAX CLI's rule with ranks for chips); otherwise a multi-start run
takes one card per process.  ``kl --sharded`` splits the nodes over every
rank (the owner-computes engine, one rank in a plain ``python -m``).
Rank 0 alone prints and writes the output files.  ``--f64`` runs in f64
on the card and on the CPU, and ``eig`` computes in f64 unless given
``--f32``: the JAX package's precision rule off the TPU
(:func:`eig_dtype`).  With ``EIG_KL_TPU_PROFILE_DIR`` set, ``kl`` and
``fused`` record their pipeline with ``torch.profiler`` into one Chrome
trace there (:func:`~eig_kl_tpu_torch.utils.tracing.maybe_profile`).
Output lands in ``pre_saved_EIG/`` and ``results/`` relative to the
working directory.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="run on the card (default) or on the CPU with the kernels' "
        "plain PyTorch versions",
    )


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("input", help="path to .hgr circuit")
    _add_device(p)
    p.add_argument(
        "-EIG",
        dest="eig_init",
        action="store_true",
        help="initialize from pre_saved_EIG/<base>_out.txt (the reference -EIG flag)",
    )
    p.add_argument("--seed", type=int, default=0, help="random-init seed")
    p.add_argument("--f64", action="store_true", help="run in float64")
    p.add_argument(
        "--passes", type=int, default=1,
        help="KL passes: each pass after the first restarts from the best "
        "partition with all nodes unlocked (classic multi-pass KL; 1 = the "
        "reference's single-pass semantics, 0 = until converged)",
    )
    p.add_argument(
        "--kicks", type=int, default=0,
        help="iterated local search: after the descent, perturb the best "
        "partition and re-descend this many times, keeping the global best",
    )
    p.add_argument(
        "--kick-frac", type=float, default=0.15,
        help="kick size as a fraction of nodes (large kicks escape the basin)",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="eig_kl_tpu_torch",
        description="EIG+KL hypergraph partitioner on PyTorch and CUDA",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    p_eig = sub.add_parser("eig", help="spectral (Fiedler) partition, writes pre_saved_EIG/")
    p_eig.add_argument("input")
    _add_device(p_eig)
    p_eig.add_argument(
        "--solver", choices=["lanczos", "power", "lobpcg"], default="lanczos",
        help="eigensolver: thick-restart Lanczos (cEIG's, the default), "
        "LOBPCG, or gKL2's power iteration",
    )
    prec = p_eig.add_mutually_exclusive_group()
    prec.add_argument("--f32", action="store_true", help="force float32")
    prec.add_argument(
        "--f64", action="store_true",
        help="force float64 (the default, on the card and on the CPU)",
    )
    p_eig.add_argument("--tol", type=float, default=1e-6)

    p_kl = sub.add_parser("kl", help="KL refinement (random or -EIG init)")
    _add_common(p_kl)
    p_kl.add_argument(
        "--gain-eps", type=float, default=0.0,
        help="non-improving threshold (0.0 = cKL, 1e-6 = gKL)",
    )
    p_kl.add_argument(
        "--starts", type=int, default=1,
        help="multi-start: run N refinements in one batched launch per pass, "
        "keep the best.  Random inits, or with -EIG, perturbed spectral "
        "inits (start 0 unperturbed)",
    )
    p_kl.add_argument(
        "--perturb", type=float, default=0.05,
        help="with -EIG --starts: fraction of nodes pair-swapped to jitter "
        "each start's spectral init",
    )
    p_kl.add_argument(
        "--sharded", action="store_true",
        help="node-sharded KL over the ranks of the process group (one rank without torchrun)",
    )
    p_kl.add_argument(
        "--table", action="store_true",
        help="print the per-swap iteration table (cKL.cpp:323-330)",
    )
    p_kl.add_argument(
        "--shuffled-ties", action="store_true",
        help="random init only: break equal-gain ties in the reference's "
        "randomized scan order (cKL.cpp:175-193) instead of by node index",
    )

    p_fused = sub.add_parser(
        "fused", help="in-process power-iteration EIG + KL (gKL2 pipeline)"
    )
    _add_common(p_fused)
    p_fused.add_argument(
        "--starts", type=int, default=1,
        help="spectral-seeded multi-start: one spectral solve, N "
        "perturbed-init refinements in one batched launch per pass, best "
        "kept (random inits without -EIG)",
    )
    p_fused.add_argument(
        "--perturb", type=float, default=0.05,
        help="with -EIG --starts: fraction of nodes pair-swapped to jitter "
        "each start's spectral init",
    )
    p_fused.add_argument(
        "--solver", choices=["auto", "power", "lanczos", "lobpcg"], default="auto",
        help="in-process eigensolver; 'auto' picks lanczos at <=256 nodes "
        "and power above",
    )
    p_fused.add_argument(
        "--power-iters", type=int, default=None,
        help="cap the power-iteration budget (reference cap 1000, gKL2.cu:26)",
    )

    p_gen = sub.add_parser("generate", help="synthetic circuit generator")
    p_gen.add_argument("size", type=float, help="size multiplier (1.0 = 201,920 nodes)")
    p_gen.add_argument("--output", "-o", default="generated_circuit.hgr")
    p_gen.add_argument("--seed", type=int, default=None)

    sub.add_parser("info", help="print the CUDA devices (printGPUInfo analog)")
    return ap


def eig_dtype(args):
    """The ``eig`` subcommand's precision for its parsed ``args``: f32
    (with the host f64 refinement of lanczos and lobpcg) with ``--f32``,
    else f64 (``--f64`` or no flag), whatever ``--device``.  The JAX package's rule is "pure f64 off-TPU (native
    there), f32 device solve + f64 host refinement on TPU, where x64 is
    software-emulated" (``eig_kl_tpu/cli/main.py:204-212``); the H100 runs
    f64 natively, so it takes the off-TPU branch."""
    import torch

    return torch.float32 if args.f32 else torch.float64


def cmd_eig(args) -> int:
    from eig_kl_tpu_torch.io.eigfile import eig_out_path, write_eig_file
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.models.pipelines import spectral_partition
    from eig_kl_tpu_torch.utils.config import SpectralConfig
    from eig_kl_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    dtype = eig_dtype(args)
    t0 = time.perf_counter()
    hg = read_hgr(args.input)
    print(f"Problem size: {hg.num_nets} nets, {hg.num_nodes} nodes, {hg.num_pins} pins")
    run = spectral_partition(
        hg, SpectralConfig(solver=args.solver, tolerance=args.tol),
        dtype=dtype, device=args.device,
    )
    os.makedirs("pre_saved_EIG", exist_ok=True)
    os.makedirs("results", exist_ok=True)
    out = eig_out_path(args.input)
    write_eig_file(out, run.eig)
    left, right = run.eig.balance()
    print(f"lambda_2 = {run.eig.eigenvalue:.12g}")
    print(f"median   = {run.eig.median:.12g}")
    print(f"balance  = {left} / {right}")
    print(f"Execution time: {time.perf_counter() - t0:.3f} seconds")
    print(f"Results written to: {out}")
    return 0


def _kl_multi_start(args, hg, kl_config, dtype):
    """``kl --starts N``: random splits from ``--seed``, or with ``-EIG``
    the split of the EIG file (start 0) and balanced jitters of it, all
    starts in one batched launch per pass, then the kicks around the
    winner (the JAX CLI's multi-start branch, ``cli/main.py:354-436``).
    On the card in f32 under several ranks, with N divisible by their
    count, the starts are split over the ranks (``:380-393``)."""
    import torch

    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.eigfile import eig_out_path
    from eig_kl_tpu_torch.kl.init import split_from_eig
    from eig_kl_tpu_torch.models.pipelines import PartitionRun, _multi_start_dispatch
    from eig_kl_tpu_torch.parallel.mesh import make_mesh, rank_device, world_size

    ranks = world_size()
    mesh = None
    if args.device == "cuda" and dtype == torch.float32 and ranks > 1 and args.starts % ranks == 0:
        mesh = make_mesh(dp=ranks, device=args.device)
    g_host = clique_expand(hg, "kl")
    g = g_host.to_device(mesh.device if mesh else rank_device(args.device), dtype)
    base = split_from_eig(eig_out_path(args.input)) if args.eig_init else None
    best, cuts = _multi_start_dispatch(
        g, base, kl_config, starts=args.starts, perturb=args.perturb,
        seed=args.seed, perturb_base=args.eig_init, mesh=mesh,
    )
    return PartitionRun(
        circuit=hg.name, eig=None, kl=best, timings={}, nnz=g_host.nnz,
        start_cuts=cuts.tolist(),
    )


def _kl_sharded(args, hg, kl_config, dtype):
    """``kl --sharded``: the owner-computes engine over every rank, from
    the EIG file's split, the reference's shuffled order
    (``--shuffled-ties``, mapped back to the node ids) or a random split,
    with passes or kicks around it (the JAX CLI's ``cli/main.py:437-492``)."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.eigfile import eig_out_path
    from eig_kl_tpu_torch.kl.init import random_split, reference_shuffle_init, split_from_eig
    from eig_kl_tpu_torch.kl.multipass import refine_ils, refine_multipass
    from eig_kl_tpu_torch.models.pipelines import PartitionRun, unshuffle
    from eig_kl_tpu_torch.parallel.mesh import make_mesh
    from eig_kl_tpu_torch.parallel.sharded_kl2 import sharded_refine_oc

    g_host = clique_expand(hg, "kl")
    perm = None
    if args.eig_init:
        sides = split_from_eig(eig_out_path(args.input))
    elif args.shuffled_ties:
        g_host, sides, perm = reference_shuffle_init(g_host, args.seed)
    else:
        sides = random_split(hg.num_nodes, args.seed)
    mesh = make_mesh(device=args.device)

    def backend(s):
        return sharded_refine_oc(g_host, s, mesh, kl_config, dtype=dtype)

    if kl_config.kicks > 0:
        res = refine_ils(backend, sides, kl_config, kicks=kl_config.kicks,
                         kick_frac=kl_config.kick_frac, seed=args.seed)
    else:
        res = refine_multipass(backend, sides, kl_config)
    if perm is not None:
        res = unshuffle(res, perm)
    return PartitionRun(circuit=hg.name, eig=None, kl=res, timings={}, nnz=g_host.nnz)


def _run_kl(args, fused: bool) -> int:
    import numpy as np
    import torch

    from eig_kl_tpu_torch.io.eigfile import eig_out_path
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.models.pipelines import fused_partition, kl_partition
    from eig_kl_tpu_torch.parallel.mesh import rank
    from eig_kl_tpu_torch.utils import logging as rlog
    from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig
    from eig_kl_tpu_torch.utils.device import resolve_device
    from eig_kl_tpu_torch.utils.tracing import maybe_profile

    resolve_device(args.device)
    lead = rank() == 0

    def say(*parts):
        if lead:
            print(*parts)

    dtype = torch.float64 if args.f64 else torch.float32
    t0 = time.perf_counter()
    hg = read_hgr(args.input)
    say(f"Circuit: {hg.num_nets} nets, {hg.num_nodes} nodes, {hg.num_pins} pins")
    kl_config = KLConfig(
        gain_eps=getattr(args, "gain_eps", 1e-6),
        passes=args.passes,
        kicks=args.kicks,
        kick_frac=args.kick_frac,
    )
    with maybe_profile():
        if fused:
            spec_kwargs = {}
            if args.power_iters is not None:
                spec_kwargs["max_iterations"] = args.power_iters
            run = fused_partition(
                hg,
                use_eig=args.eig_init,
                spectral_config=SpectralConfig(solver=args.solver, **spec_kwargs),
                kl_config=kl_config,
                seed=args.seed,
                dtype=dtype,
                starts=args.starts,
                perturb=args.perturb,
                device=args.device,
            )
        elif args.starts > 1:
            run = _kl_multi_start(args, hg, kl_config, dtype)
        elif args.sharded:
            run = _kl_sharded(args, hg, kl_config, dtype)
        else:
            run = kl_partition(
                hg,
                init=eig_out_path(args.input) if args.eig_init else None,
                kl_config=kl_config,
                seed=args.seed,
                dtype=dtype,
                shuffled_ties=args.shuffled_ties,
                device=args.device,
            )
    runtime = time.perf_counter() - t0
    out = rlog.kl_results_path(args.input, args.eig_init)
    if lead:
        rlog.write_kl_trajectory(out, run.kl)
    if run.start_cuts is not None:
        say(
            "Multi-start best cuts: "
            f"{np.sort(np.asarray(run.start_cuts))[:8].round(2).tolist()} ..."
        )
    if run.nnz is not None:
        say(rlog.format_matrix_stats(hg.num_nodes, run.nnz))
    if getattr(args, "table", False):
        say(rlog.format_iteration_table(run.kl, kl_seconds=run.timings.get("kl.pass")))
    say(rlog.format_final_results(run.kl, runtime))
    for name, secs in sorted(run.timings.items()):
        say(f"  [{name}] {secs:.3f}s")
    if run.spectral_iterations is not None:
        say(f"Power iterations: {run.spectral_iterations}")
    elif run.spectral_solve is not None:
        what = {"lanczos": "Lanczos restarts", "lobpcg": "LOBPCG iterations"}
        say(f"{what[run.spectral_solve.solver]}: {run.spectral_solve.iterations}")
    say(f"Device: {_device_name(args.device)}")
    say(f"Trajectory written to: {out}")
    return 0


def _device_name(device: str) -> str:
    import torch

    if device == "cuda":
        return f"cuda ({torch.cuda.get_device_name(0)})"
    return "cpu"


def cmd_generate(args) -> int:
    from eig_kl_tpu_torch.models.generator import CircuitGenerator

    hg = CircuitGenerator(args.size, args.seed).write(args.output)
    print(f"Generated circuit written to: {args.output}")
    print(
        f"Circuit size: {args.size}x reference "
        f"({hg.num_nets} nets, {hg.num_nodes} nodes, {hg.num_pins} pins)"
    )
    return 0


def cmd_info() -> int:
    import torch

    from eig_kl_tpu_torch.parallel.mesh import world_size

    print("================= Device Info ===================")
    print(f"Ranks: {world_size()}")
    if not torch.cuda.is_available():
        print("No CUDA device (run with --device cpu)")
        return 0
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        print(f"Device {i}: {p.name} (cuda)")
        print(
            f"  sm_{p.major}{p.minor}, {p.multi_processor_count} SMs, "
            f"{p.total_memory / 2**30:.1f} GiB"
        )
    return 0


def main(argv: list[str] | None = None) -> int:
    from eig_kl_tpu_torch.parallel.mesh import release_default_group

    args = build_parser().parse_args(argv)
    try:
        if args.command == "eig":
            return cmd_eig(args)
        if args.command == "kl":
            return _run_kl(args, fused=False)
        if args.command == "fused":
            return _run_kl(args, fused=True)
        if args.command == "generate":
            return cmd_generate(args)
        if args.command == "info":
            return cmd_info()
    except FileNotFoundError as e:
        print(f"Error: file not found: {e.filename}", file=sys.stderr)
        return 1
    except (ValueError, OSError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    finally:
        release_default_group()
    return 1


if __name__ == "__main__":
    sys.exit(main())
