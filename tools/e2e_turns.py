"""The one-start run's or the momentum exit's end-to-end time, for
comparing two checkouts.

Run on a machine with one CUDA card::

    python3 tools/e2e_turns.py [--tree DIR] [--runs N] [--path one_start|momentum|lobpcg_f64|smega]

It imports ``eig_kl_tpu_torch`` from ``DIR`` (default: this repository)
and generates the circuit at 1.0x (seed 42).  ``--path one_start`` (the
default) runs ``fused_partition(hg, use_eig=True, device="cuda")``, the
path ``chip_smoke.py`` calls the one start; ``--path momentum`` runs
``power_partition_fiedler`` with the momentum exit, in f32, on the KL graph
of the circuit's largest component (184,406 nodes), as ``chip_smoke.py``'s
momentum phase does; ``--path lobpcg_f64`` runs ``spectral_partition``
with LOBPCG at its f64 default on that component (its blocked products
are K1's ``spmm_csr_f64``), as ``chip_smoke.py``'s f64 phase does;
``--path smega`` runs ``smega_refine`` (kernel K5) at S = 1 and at S = 8
on the circuit's KL graph from a random split (seed 42), each with a plan
built before the clock, and reports K5's own milliseconds per pass
(CUDA events around ``smega_pass_cuda`` on the same inputs).  Each
runs once to warm up and then ``N`` times
(default 5), each timed from a synchronised card to a synchronised card.
It also times the host's cost of a K6 norm, the wall time of 2,000
``tree_norm`` calls on 201,920 values up to one synchronisation at their
end (the card runs each faster than the host launches it).  It prints one
JSON object: the card, the tree, the path, its iterations, cut and
eigenvalue, the seconds of each run (with its spans for the one start),
and the norm's microseconds per call.  To compare two checkouts, run it in
turns from one command (A B B A A B), each process with its own
``--tree``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path


def _largest_component(hg):
    """``chip_smoke.py:largest_component``, loaded from this repository's
    script (it imports the package of ``--tree`` when it runs)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.largest_component(hg)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parent.parent),
                        help="the checkout whose eig_kl_tpu_torch is timed")
    parser.add_argument("--runs", type=int, default=5, help="timed runs after the warm-up")
    parser.add_argument("--path", choices=("one_start", "momentum", "lobpcg_f64", "smega"), default="one_start",
                        help="the path timed")
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tools/e2e_turns.py needs a CUDA card")
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.models.generator import CircuitGenerator
    from eig_kl_tpu_torch.models.pipelines import fused_partition
    from eig_kl_tpu_torch.ops.reduce import tree_norm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    hg = CircuitGenerator(1.0, 42).generate()
    if args.path == "one_start":
        def run():
            return fused_partition(hg, use_eig=True, device="cuda")

        def figures(r):
            return {"iterations": r.spectral_iterations, "best_cut": r.kl.best_cut,
                    "eigenvalue": float(r.eig.eigenvalue)}

        def spans(r):
            return {"spans_s": dict(sorted(r.timings.items()))}
    elif args.path == "lobpcg_f64":
        from eig_kl_tpu_torch.models.pipelines import spectral_partition
        from eig_kl_tpu_torch.utils.config import SpectralConfig

        lcc = _largest_component(hg)
        config = SpectralConfig(solver="lobpcg")

        def run():
            return spectral_partition(lcc, config, dtype=None, device="cuda")

        def figures(r):
            return {"iterations": r.spectral_solve.iterations, "eigenvalue": float(r.eig.eigenvalue),
                    "side_1": int(r.eig.sides.sum())}

        def spans(r):
            return {"spans_s": dict(sorted(r.timings.items()))}
    elif args.path == "smega":
        from eig_kl_tpu_torch.kl.init import random_split
        from eig_kl_tpu_torch.ops.partition import sides_to_signs
        from eig_kl_tpu_torch.ops.spmv import spmv
        from eig_kl_tpu_torch.parallel import smega
        from eig_kl_tpu_torch.utils.config import KLConfig

        g = clique_expand(hg, "kl")
        sides = random_split(g.num_nodes, 42)
        config = KLConfig(gain_eps=1e-6)
        plans = {S: smega.SmegaPlan(g, S) for S in (1, 8)}

        def k5_ms(S):
            """K5's milliseconds for the pass, by CUDA events (the inputs as
            smega_refine builds them: the one API both checkouts share)."""
            dg, n = plans[S].device_graph(dev), g.num_nodes
            s = sides_to_signs(torch.as_tensor(sides).to(dev), torch.float32)
            sf0 = torch.zeros(plans[S].n_pad, device=dev)
            as0 = torch.zeros_like(sf0)
            sf0[:n], as0[:n] = s, spmv(dg, s)
            n1 = int(sides.sum())
            cap = min(n1, n - n1)
            args = (dg, S, sf0, as0, 0.0, cap, n - n1, n1, cap + 1, config.terminate_limit(n), config.gain_eps)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            smega.smega_pass_cuda(*args)
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end)

        def run():
            return {S: (smega.smega_refine(g, sides, S, config, plan=plans[S]), k5_ms(S)) for S in plans}

        def figures(r):
            return {f"S{S}": [x.iterations, x.best_cut] for S, (x, _) in r.items()}

        def spans(r):
            return {"k5_ms": {f"S{S}": ms for S, (_, ms) in r.items()}}
    else:
        from eig_kl_tpu_torch.spectral.power import power_partition_fiedler
        from eig_kl_tpu_torch.utils.config import SpectralConfig

        lk = clique_expand(_largest_component(hg), "kl").to_device(dev, torch.float32)
        config = SpectralConfig(solver="power", convergence="momentum")

        def run():
            return power_partition_fiedler(lk, config, dtype=torch.float32)

        def figures(r):
            return {"iterations": r[4], "side_1": int(r[3].sum()), "eigenvalue": float(r[0]), "median": float(r[1])}

        def spans(r):
            return {}

    first = figures(run())
    runs = []
    for _ in range(args.runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        runs.append({"e2e_s": time.perf_counter() - t0, **spans(r)})
        if figures(r) != first:
            raise AssertionError(f"a repeated run gave {figures(r)}, not {first}")
    n = clique_expand(hg, "kl").num_nodes
    v = torch.rand(n, generator=torch.Generator().manual_seed(42)).to(dev)
    for _ in range(100):
        tree_norm(v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        tree_norm(v)
    torch.cuda.synchronize()
    norm_us = (time.perf_counter() - t0) / 2000 * 1e6
    print(json.dumps({
        "card": card,
        "tree": str(Path(args.tree).resolve()),
        "path": args.path,
        **first,
        "runs": runs,
        "tree_norm_wall_us_per_call": norm_us,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
