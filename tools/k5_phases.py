"""Where a swap of K5 (``eig_kl_tpu_torch/csrc/smega.cu``) spends its time.

Run from the repository root on a machine with one CUDA card::

    python3 tools/k5_phases.py

It copies the port into ``eig_kl_tpu_torch/_build/k5_phases/`` and
inserts into the copy's ``smega.cu`` ``clock64()`` stamps of thread 0 of
block 0 at seven places of the swap loop, summed per phase in shared
memory; the committed source stays as it is.  It runs the smega path's
pass (gen 1.0x seed 42, from the one-start run's spectral split) through
``smega_pass_cuda`` at S = 1, 2, 4, 8 in the wrapper's layout and at S = 8
in the other cached layout: the committed build in this process, the
stamped copy in a child process, in turns (committed, stamped, stamped,
committed).  It prints per phase the cycles per swap, the share of the
swap and that share of the stamped build's microseconds per swap, and
what the stamps cost.  The phases, from thread 0's clock (a barrier's
wait counts in the phase that ends with it):

1. loop: from the end of one swap to the top of the next;
2. select: the local first maximum (flat scan, or the cached rows and the
   lane search), up to the round-A cluster barrier;
3. round A: the cluster barrier, the S candidates read and combined, a
   block barrier;
4. rows (cached layouts): the two row walks, the locks and marks, the
   block barrier before the refresh;
5. refresh (cached layouts; flat: the row walks and locks): up to the
   round-B cluster barrier;
6. round B: the cluster barrier, w_ab, the bookkeeping, a block barrier.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
COPY = REPO / "eig_kl_tpu_torch" / "_build" / "k5_phases"
PHASES = ("loop", "select", "round A", "rows", "refresh", "round B")
HEADER = r"""#include <cuda_runtime.h>
__device__ unsigned long long k5_ticks[8];
__shared__ unsigned long long k5_acc[8];
__shared__ long long k5_last;
#define K5_STAMP(k)                                                   \
  do {                                                                \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                        \
      const long long now_ = clock64();                               \
      if ((k) == 0) {                                                 \
        for (int i_ = 0; i_ < 8; ++i_) k5_acc[i_] = 0;                \
      } else {                                                        \
        k5_acc[(k)] += now_ - k5_last;                                \
        k5_ticks[(k)] = k5_acc[(k)];                                  \
      }                                                               \
      k5_last = now_;                                                 \
    }                                                                 \
  } while (0)
extern "C" int k5_phase_ticks(unsigned long long* host) {
  return static_cast<int>(cudaMemcpyFromSymbol(host, k5_ticks, sizeof(k5_ticks)));
}
extern "C" int k5_phase_reset() {
  const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k5_ticks, zero, sizeof(zero)));
}
"""
# (a line of the swap loop, the same line with its stamp); each occurs once.
STAMPS = (
    ("  while (sh_go) {\n", "  K5_STAMP(0);\n  while (sh_go) {\n    K5_STAMP(1);\n"),
    ("    ex.publish_a(&cand, swap);\n", "    K5_STAMP(2);\n    ex.publish_a(&cand, swap);\n"),
    ("    const int a = sh_a;\n", "    K5_STAMP(3);\n    const int a = sh_a;\n"),
    ("      const int dirty = sh_count;\n", "      K5_STAMP(4);\n      const int dirty = sh_count;\n"),
    ("    ex.sync_b();\n", "    K5_STAMP(5);\n    ex.sync_b();\n"),
    ("    __syncthreads();\n  }\n  ex.finish(", "    __syncthreads();\n    K5_STAMP(6);\n  }\n  ex.finish("),
)


def stamped_source(src: str) -> str:
    """``smega.cu`` with the phase stamps; raises where a line moved."""
    for line, stamped in STAMPS:
        if src.count(line) != 1:
            raise RuntimeError(f"smega.cu no longer has exactly one {line!r}: update STAMPS")
        src = src.replace(line, stamped)
    return HEADER + src


def make_copy() -> None:
    shutil.rmtree(COPY, ignore_errors=True)
    pkg = COPY / "eig_kl_tpu_torch"
    shutil.copytree(REPO / "eig_kl_tpu_torch", pkg, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    cu = pkg / "csrc" / "smega.cu"
    cu.write_text(stamped_source(cu.read_text()))


def cuda_ms(fn, reps: int = 2) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(sides: np.ndarray, cut0: float, turns: int, lib=None) -> list[dict]:
    """Per case (S, layout): swaps, the best pass ms of ``turns`` turns and,
    with the stamped build's ``lib``, the phase cycles of its last pass."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.models.generator import CircuitGenerator
    from eig_kl_tpu_torch.ops.partition import sides_to_signs
    from eig_kl_tpu_torch.ops.spmv import spmv_csr
    from eig_kl_tpu_torch.parallel.smega import SmegaPlan, k5_layout, smega_pass_cuda
    from eig_kl_tpu_torch.utils.config import KLConfig

    dev = torch.device("cuda")
    g_host = clique_expand(CircuitGenerator(1.0, 42).generate(), "kl")
    n, n1 = g_host.num_nodes, int(sides.sum())
    cap = min(n1, n - n1)
    cases = []
    for shards in (1, 2, 4, 8):
        plan = SmegaPlan(g_host, shards)
        g = plan.device_graph(dev)
        s = sides_to_signs(torch.as_tensor(sides).to(dev), torch.float32)
        sf0 = torch.zeros(plan.n_pad, device=dev)
        as0 = torch.zeros_like(sf0)
        sf0[:n], as0[:n] = s, spmv_csr(g, s)
        args = (g, shards, sf0, as0, cut0, cap, n - n1, n1, cap + 1, KLConfig().terminate_limit(n), 1e-6)
        layout = k5_layout(plan.n_local, shards)
        for lay in [layout] + ([{"shared": "global", "global": "shared"}[layout]] if shards == 8 else []):
            cases.append((shards, lay, args))
    rows = [{"shards": s, "layout": lay, "ms": []} for s, lay, _ in cases]
    ticks = np.zeros(8, dtype=np.uint64)
    for _ in range(turns):
        for row, (_, lay, args) in zip(rows, cases):
            if lib is not None and lib.k5_phase_reset() != 0:
                raise RuntimeError("could not reset the phase counters")
            row["ms"].append(cuda_ms(lambda: smega_pass_cuda(*args, _layout=lay)))
            row["swaps"] = int(smega_pass_cuda(*args, _layout=lay).scalars[2])
            if lib is not None:
                if lib.k5_phase_ticks(ticks.ctypes.data) != 0:
                    raise RuntimeError("could not read the phase counters")
                row["ticks"] = [int(t) for t in ticks]
    return rows


def child(inputs: str) -> int:
    """The stamped copy's measurement: one JSON line."""
    sys.path.insert(0, str(COPY))
    from eig_kl_tpu_torch.ops import _build

    _build.build(("smega",))
    lib = ctypes.CDLL(str(_build.library_path("smega")))
    lib.k5_phase_ticks.argtypes = [ctypes.c_void_p]
    data = np.load(inputs)
    print(json.dumps(measure(data["sides"], float(data["cut0"]), 2, lib)))
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--stamped":
        return child(sys.argv[2])
    if not torch.cuda.is_available():
        raise SystemExit("k5_phases.py needs a CUDA card")
    sys.path.insert(0, str(REPO))
    from eig_kl_tpu_torch.models.generator import CircuitGenerator
    from eig_kl_tpu_torch.models.pipelines import fused_partition

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    make_copy()
    run = fused_partition(CircuitGenerator(1.0, 42).generate(), use_eig=True, device="cuda")
    sides = np.asarray(run.eig.sides, dtype=np.int8)
    inputs = COPY / "inputs.npz"
    np.savez(inputs, sides=sides, cut0=run.kl.initial_cut)

    committed = measure(sides, run.kl.initial_cut, 1)
    out = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--stamped", str(inputs)],
        capture_output=True, text=True, timeout=900,
    )
    if out.returncode != 0:
        raise RuntimeError(f"the stamped run failed:\n{out.stdout}\n{out.stderr}")
    stamped = json.loads(out.stdout.strip().splitlines()[-1])
    for row, again in zip(committed, measure(sides, run.kl.initial_cut, 1)):
        row["ms"] += again["ms"]

    results = []
    for c, s in zip(committed, stamped):
        if (c["shards"], c["layout"], c["swaps"]) != (s["shards"], s["layout"], s["swaps"]):
            raise RuntimeError(f"the stamped pass differs from the committed one: {s} against {c}")
        swaps = c["swaps"]
        us, us_stamped = 1e3 * min(c["ms"]) / swaps, 1e3 * min(s["ms"]) / swaps
        per_swap = np.asarray(s["ticks"][1:7], dtype=np.float64) / swaps
        total = per_swap.sum()
        phases = {
            name: {"cycles": float(v), "share": float(v / total), "us": float(v / total * us_stamped)}
            for name, v in zip(PHASES, per_swap)
        }
        results.append({
            "shards": c["shards"], "layout": c["layout"], "swaps": swaps, "us_per_swap": us,
            "us_per_swap_stamped": us_stamped, "cycles_per_swap": float(total), "phases": phases,
        })
        print(
            f"S = {c['shards']}, {c['layout']}: {swaps} swaps, {us:.3f} us/swap ({us_stamped:.3f} "
            f"stamped), {total:.0f} cycles per swap: "
            + ", ".join(f"{k} {v['cycles']:.0f} ({100 * v['share']:.1f} %, {v['us']:.3f} us)" for k, v in phases.items())
        )
    print(json.dumps({"card": card, "k5_phases": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
