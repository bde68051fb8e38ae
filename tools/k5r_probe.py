"""K5R, the sharded KL pass across ranks (``csrc/smega.cu``), timed per
swap: its ranks in processes of their own, against K5 at S = ranks in one
process, bit for bit.

Run from the repository root on a machine with a CUDA card::

    python3 tools/k5r_probe.py             # 2 ranks
    python3 tools/k5r_probe.py --ranks 4

Rank r runs on card ``r % cards``: on a machine with one card every rank
shares it, and the card time-slices between the ranks' contexts, so a
round waits for the peers' time slices (not a cross-card figure).  Each
rank builds gen 1.0x seed 42 (201,920 nodes) and gen 0.02x
(``benchmarks/data``), takes a random split (seed 42), and runs
``smega_pass_ranks_cuda`` capped at 50, 200 and 1,000 swaps on gen 1.0x
and whole on gen 0.02x, then K5 (``smega_pass_cuda``) at S = ranks on the
whole state from the same inputs.  It prints per rank and run the swaps,
the kernel's own device time (%globaltimer), the host time of the call,
microseconds per swap, whether the rank's logs, scalars and stripe of sf
equal K5's, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CAPS = (50, 200, 1000)


def rank_main(rank: int, ranks: int, tmp: str) -> None:
    import torch
    import torch.distributed as dist

    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.models.generator import CircuitGenerator
    from eig_kl_tpu_torch.parallel import smega
    from eig_kl_tpu_torch.parallel.mesh import make_mesh
    from eig_kl_tpu_torch.utils.config import KLConfig

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), ranks), rank=rank,
                            world_size=ranks, timeout=datetime.timedelta(seconds=120))
    mesh = make_mesh(ranks, device="cuda")
    dev = mesh.device
    out = {}
    try:
        graphs = {"gen 1.0x": (clique_expand(CircuitGenerator(1.0, 42).generate(), "kl"), CAPS),
                  "gen 0.02x": (clique_expand(read_hgr(os.path.join(ROOT, "benchmarks", "data", "gen_0.02_42.hgr")),
                                              "kl"), (None,))}
        for tag, (g, caps) in graphs.items():
            sides = random_split(g.num_nodes, 42)
            plan = smega.SmegaPlan(g, ranks)
            part = plan.rank_part(rank, dev)
            for cap in caps:
                cfg = KLConfig(gain_eps=1e-6, max_iterations=cap)
                args = smega.pass_inputs(plan, sides, cfg, dev, part)
                t0 = time.perf_counter()
                k5r = smega.smega_pass_ranks_cuda(mesh, part, *args)
                host_s = time.perf_counter() - t0
                ns = smega.peer_buffers(mesh).last_pass_ns
                k5 = smega.smega_pass_cuda(plan.device_graph(dev), ranks, *smega.pass_inputs(plan, sides, cfg, dev))
                stripe = slice(part.r0, part.r0 + part.n_local)
                same = all(torch.equal(getattr(k5r, f), getattr(k5, f)[stripe] if f == "sf" else getattr(k5, f))
                           for f in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"))
                swaps = int(k5r.scalars[2])
                out[f"{tag}, cap {cap}"] = {"swaps": swaps, "device_ms": ns / 1e6, "host_s": host_s,
                                            "us_per_swap": ns / 1e3 / max(swaps, 1), "equals_k5": same,
                                            "layout": smega.k5_layout(part.n_local, 1)}
    except Exception:  # noqa: BLE001 -- the parent reports it
        import traceback

        out["error"] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--tmp", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.ranks, args.tmp)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory(prefix="k5r_probe_") as tmp:
        procs = [subprocess.Popen([sys.executable, __file__, "--ranks", str(args.ranks), "--rank", str(r),
                                   "--tmp", tmp], env=dict(os.environ, OMP_NUM_THREADS="1"))
                 for r in range(args.ranks)]
        for p in procs:
            try:
                p.wait(timeout=600)
            except subprocess.TimeoutExpired:
                p.kill()
        ok = True
        for r in range(args.ranks):
            path = os.path.join(tmp, f"rank{r}.pkl")
            out = pickle.load(open(path, "rb")) if os.path.exists(path) else {"error": "no result"}
            ok &= "error" not in out and all(v["equals_k5"] for v in out.values())
            print(json.dumps({"rank": r, "card": card, "runs": out}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
