"""The JAX package's smega across two devices, the reference of the port's
pass across ranks (``tests/test_torch_sharded.py``).

Run from the repository root (about 3 minutes on one CPU core)::

    JAX_PLATFORMS=cpu python3 tools/smega_ranks_reference.py

It runs ``eig_kl_tpu.parallel.smega.smega_refine(g, sides, make_mesh(2),
config, interpret=True, align=128)``, the TPU kernel's two-device form in
interpret mode on two virtual CPU devices (as ``tests/test_smega.py:67``
runs it), on the 61-node dyadic problem and the 64-node overflow graph of
``tests/test_torch_sharded.py:_jax_graphs``, whole and capped at 7 swaps,
and writes every field of each result to
``tools/smega_ranks_reference.npz`` (``<case>/<field>``), with a digest of
each case's graph and split (``<case>/inputs``).  One such run takes 10-100 s
(1.8 s a swap in interpret mode), too long for the tests, which read the
file and check the digests.
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import conftest  # noqa: E402,F401  -- the tests' JAX settings: 8 CPU devices, x64

import numpy as np  # noqa: E402

OUT = os.path.join(ROOT, "tools", "smega_ranks_reference.npz")
FIELDS = ("initial_cut", "final_cut", "best_cut", "verified_cut", "iterations",
          "sides", "best_sides", "cut_trajectory", "gain_trajectory")
#: (case, graph of _jax_graphs, max_iterations)
CASES = (("dyadic", "dyadic", None), ("dyadic cap 7", "dyadic", 7), ("overflow", "overflow", None))


def main() -> int:
    from eig_kl_tpu.parallel.mesh import make_mesh
    from eig_kl_tpu.parallel.smega import smega_refine
    from eig_kl_tpu.utils.config import KLConfig
    from tests.test_torch_sharded import _jax_graphs, inputs_digest

    graphs = _jax_graphs()
    out = {}
    for case, name, cap in CASES:
        g, sides = graphs[name]
        t0 = time.perf_counter()
        r = smega_refine(g, sides, make_mesh(2), KLConfig(max_iterations=cap), interpret=True, align=128)
        print(f"{case}: {r.iterations} swaps, best cut {r.best_cut}, {time.perf_counter() - t0:.1f} s", flush=True)
        out[f"{case}/inputs"] = np.array(inputs_digest(g, sides))
        for f in FIELDS:
            out[f"{case}/{f}"] = np.asarray(getattr(r, f))
    np.savez(OUT, **out)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
