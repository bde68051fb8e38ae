"""The JAX package's sharded power iteration on the generated circuit at
1.0x, seed 42 (201,920 nodes), on the CPU at f32: what ``chip_smoke.py``'s
sharded phase holds the port's one- and two-rank runs to.

Run from the repository root (some minutes, a few GiB of memory)::

    JAX_PLATFORMS=cpu python3 tools/sharded_reference.py
    JAX_PLATFORMS=cpu python3 tools/sharded_reference.py --port

It prints, as JSON: ``sharded_power_fiedler`` with the "gkl2" exit on
``make_mesh(1)`` and ``make_mesh(2)`` of two virtual CPU devices (its
iterations, lambda and a digest of its vector), and the single-chip
``power_iteration_fiedler`` with the same exit, whose lambda differs from
the sharded ones' by the rounding of their norms (XLA's 1-D norm against a
sum of per-shard vector dots), and the JAX runs' own spread: lambda's
relative and the vector's largest difference from the one-shard run.  With ``--port`` it also runs the port's
``sharded_power_fiedler`` on the CPU at one rank (the kernels' plain
versions) beside them.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 2)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import MULTIPLIER, SEED, vector_digest as digest  # noqa: E402


def main() -> int:
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.models.generator import CircuitGenerator
    from eig_kl_tpu.parallel import sharded_power
    from eig_kl_tpu.parallel.mesh import make_mesh
    from eig_kl_tpu.spectral.power import power_iteration_fiedler
    from eig_kl_tpu.utils.config import SpectralConfig

    hg = CircuitGenerator(MULTIPLIER, SEED).generate()
    g = clique_expand(hg, "kl")
    cfg = SpectralConfig(solver="power", convergence="gkl2")
    out = {"circuit": {"nodes": g.num_nodes, "nnz": g.nnz}}
    runs = {}
    for S in (1, 2):
        t0 = time.perf_counter()
        lam, v = sharded_power.sharded_power_fiedler(g, make_mesh(S), cfg, dtype=jnp.float32)
        runs[S] = (float(lam), np.asarray(v))
        out[f"jax_sharded_S{S}"] = {"iterations": sharded_power.last_iterations, "lambda": float(lam),
                                    "vector": digest(v), "seconds": time.perf_counter() - t0}
    lam, v = power_iteration_fiedler(g.to_device(dtype=jnp.float32), cfg, dtype=jnp.float32)
    runs["single"] = (float(lam), np.asarray(v))
    out["jax_single_chip"] = {"lambda": float(lam), "vector": digest(v)}
    # The JAX package's own spread between shard counts and the single chip.
    for other in (2, "single"):
        out[f"jax_spread_S1_to_{other}"] = {
            "lambda_rel": abs(runs[other][0] - runs[1][0]) / abs(runs[1][0]),
            "vector_max_abs": float(np.abs(runs[other][1] - runs[1][1]).max()),
        }
    if "--port" in sys.argv:
        import torch

        from eig_kl_tpu_torch.graph.csr import Graph
        from eig_kl_tpu_torch.parallel import sharded_power as port_power
        from eig_kl_tpu_torch.parallel.mesh import make_mesh as port_mesh
        from eig_kl_tpu_torch.utils.config import SpectralConfig as PortSpectral

        torch.set_num_threads(1)
        t0 = time.perf_counter()
        lam, v = port_power.sharded_power_fiedler(
            Graph.from_arrays(g.indptr, g.indices, g.data), port_mesh(device="cpu"),
            PortSpectral(solver="power", convergence="gkl2"),
        )
        out["port_cpu_1_rank"] = {"iterations": port_power.last_iterations, "lambda": float(lam),
                                  "vector": digest(v.numpy()), "seconds": time.perf_counter() - t0}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
