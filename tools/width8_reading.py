"""How XLA's CPU backend orders the f32 power solve's quotients on graphs of
ELL width 8 (ROADMAP.md C), read from the code it generates, and the
scan that holds the port to the JAX package there.

``read N ...`` compiles the JAX package's ``_power_core`` (the momentum
exit) on a width-8 graph of N nodes under ``XLA_FLAGS=--xla_dump_to`` and
reads, from the optimised LLVM IR of the two fusions that hold a dot (the
check's quotient ``multiply_dot_fusion`` and the final one
``subtract_dot_fusion``), the vector loop's lanes and trip end, the
horizontal reductions and the scalar adds; it prints them beside
``ops/reduce.py:rows_dot_lanes(N)`` and fails where they disagree::

    JAX_PLATFORMS=cpu python3 tools/width8_reading.py read 4 16 19 55 84 157

About a second per length.  ``scan`` runs the JAX package's and the port's
sign and momentum exits on the connected graphs of 4, 7, ..., 160 nodes
(a path through the nodes and ``tests/conftest.py:random_hypergraph(
default_rng(n), n, n // 2, 3)``) and prints, per graph, its ELL width and
whether every iterate bit, the iteration count and the eigenvalue agree
(about two minutes)::

    JAX_PLATFORMS=cpu python3 tools/width8_reading.py scan
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]


def _structure(ir: str) -> dict:
    """The dot's loop in one fusion's optimised IR."""
    vf = re.findall(r"%vec.phi = phi <(\d+) x float>", ir)
    single = re.findall(r"reduce\.fadd\.v(\d+)f32", ir)
    trip = re.findall(r"icmp eq i64 %index.next, (\d+)", ir)
    lanes = int(vf[0]) if vf else int(single[0]) if single else 0
    return {"lanes": lanes, "trip_end": int(trip[0]) if trip else None, "reductions": single,
            "scalar_adds": len(re.findall(r"fadd reassoc float", ir))}


def read(n: int, dump: str) -> dict[str, dict]:
    """The dot loops of the momentum solve's program on a width-8 graph of
    n nodes (random ELL arrays of that shape: the loops depend on the
    shape alone), from ``dump``, the process's ``--xla_dump_to`` (XLA reads
    its flags once), emptied first."""
    for path in glob.glob(os.path.join(dump, "*")):
        shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)
    import jax.numpy as jnp
    import numpy as np

    from eig_kl_tpu.graph.csr import DeviceGraph
    from eig_kl_tpu.spectral.power import _power_core

    rng = np.random.default_rng(n)
    g = DeviceGraph(jnp.asarray(rng.integers(0, n, (n, 8)).astype(np.int32)),
                    jnp.asarray(rng.random((n, 8), dtype=np.float32)),
                    jnp.asarray(rng.random(n, dtype=np.float32) + 1), jnp.float32(1))
    _power_core.lower(g, shift=2.0, tolerance=1e-6, min_iters=100, max_iters=400, seed=42,
                      dtype="float32", convergence="momentum").compile()
    out = {}
    for path in glob.glob(os.path.join(dump, "*ir-with-opt.ll")):
        for m in re.finditer(r"define [^\n]*@(\w*dot_fusion\w*)\(.*?\n}\n", Path(path).read_text(), re.S):
            out[m.group(1)] = _structure(m.group(0))
    return out


def scan() -> list[tuple]:
    """The sign and momentum exits of the JAX package and the port on the
    connected graphs of 4, 7, ..., 160 nodes."""
    import numpy as np
    import torch

    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.spectral.power import _power_core
    from test_torch_faults import _bits, _connected_with_wide_net, _graphs

    torch.set_num_threads(1)
    rows = []
    for n in range(4, 161, 3):
        g_jax, g = _graphs(_connected_with_wide_net(n, 2, n))
        for conv in ("sign", "momentum"):
            kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=400, seed=42, convergence=conv)
            lam_j, v_j, it_j = jax_core(g_jax, dtype="float32", **kw)
            lam_t, v_t, it_t = _power_core(g, dtype=torch.float32, **kw)
            same = (it_t == int(it_j) and np.array_equal(_bits(v_t.numpy()), _bits(v_j))
                    and bool(_bits(lam_t) == _bits(lam_j)))
            rows.append((n, g.row_width, conv, it_t, same))
            print(n, g.row_width, conv, it_t, "equal" if same else "PARTS", flush=True)
    return rows


def main(argv: list[str]) -> int:
    if argv[:1] == ["read"]:
        dump = tempfile.mkdtemp(prefix="width8_")
        os.environ["XLA_FLAGS"] = f"--xla_dump_to={dump}"
        from eig_kl_tpu_torch.ops.reduce import rows_dot_lanes

        bad = 0
        try:
            for n in map(int, argv[1:]):
                loops = read(n, dump)
                want = rows_dot_lanes(n)
                ok = len(loops) == 2 and all(v["lanes"] == want for v in loops.values())
                bad += not ok
                print(n, want, loops, "" if ok else "DISAGREES", flush=True)
        finally:
            shutil.rmtree(dump, ignore_errors=True)
        return int(bad > 0)
    if argv[:1] == ["scan"]:
        rows = scan()
        parted = [r for r in rows if not r[-1]]
        print(f"{len(rows) - len(parted)} of {len(rows)} runs equal; width 8: "
              f"{sum(1 for r in rows if r[1] == 8 and r[-1])} of {sum(1 for r in rows if r[1] == 8)}")
        return int(bool(parted))
    print(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
