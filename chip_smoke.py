"""Smoke run of eig_kl_tpu_torch on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It builds the port's kernels from ``eig_kl_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card at the shapes of the main
path, drives the fused EIG+KL pipeline (``fused_partition``, the path of
``python -m eig_kl_tpu_torch fused <file> -EIG``) once on the generated
circuit at 1.0x the reference scale (seed 42, 201,920 nodes), checks that
the run went through the kernels and that its cuts are right, and prints
one JSON line per the kernels and, last, ``{"ok": true, "device": ...}``.
Any failed check raises, so the script exits nonzero and prints no
result; so does a machine without a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

MULTIPLIER = 1.0
SEED = 42
#: Best cut of the JAX package's fused pipeline on the CPU at f32 on this
#: circuit (KLConfig(gain_eps=1e-6)); the card must land within 3 % of it.
JAX_CPU_BEST_CUT = 39697.91
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, from CUDA
    events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def k2_bound(g, swaps: int, swapped: torch.Tensor) -> tuple[float, str, int, int]:
    """K2's least time for a pass of ``swaps`` swaps that swapped the nodes
    ``swapped``: ``(ms, bound_by, bytes, operations)``.

    Bytes: the graph, sf0 and a_s0 read once; the final sf, four logs and
    8 scalars written once.  Operations: what the pass needs with the TPU
    kernel's per-128-node row-max cache, not K2's flat scan: per swap a
    compare for each cached row maximum of each side, and a multiply and
    an add for each entry of the two swapped rows.
    """
    n, nnz = g.num_nodes, g.nnz
    n_bytes = 4 * (g.indptr.numel() + 2 * nnz + 3 * n + 4 * (swaps + 1) + 8)
    degrees = (g.indptr[1:] - g.indptr[:-1]).long()
    n_ops = swaps * 2 * -(-n // 128) + 2 * int(degrees[swapped.long()].sum())
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", n_bytes, n_ops


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    from eig_kl_tpu_torch.graph.csr import DeviceGraph
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.kl.megakernel import K2, kl_pass_cuda, kl_pass_plain
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.models.generator import CircuitGenerator
    from eig_kl_tpu_torch.models.pipelines import fused_partition
    from eig_kl_tpu_torch.ops import _build
    from eig_kl_tpu_torch.ops.spmv import K1, row_ids, spmv_csr, spmv_plain
    from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
    from eig_kl_tpu_torch.utils.config import KLConfig

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}")

    # Phase 1: build every kernel from the sources in the checkout.
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # Phase 2: the circuit, in memory.
    t0 = time.perf_counter()
    hg = CircuitGenerator(MULTIPLIER, SEED).generate()
    g_host = clique_expand(hg, "kl")
    g: DeviceGraph = g_host.to_device(dev, torch.float32)
    torch.cuda.synchronize()
    n, nnz = g.num_nodes, g.nnz
    print(
        f"circuit gen {MULTIPLIER}x seed {SEED}: {hg.num_nodes} nodes, {hg.num_nets} nets, "
        f"{hg.num_pins} pins, nnz {nnz}, max degree {g_host.max_degree}, "
        f"row width {g.row_width} ({time.perf_counter() - t0:.2f} s)"
    )

    # Phase 3: K1 against spmv_plain.
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    x = (torch.rand(n, generator=gen) - 0.5).to(dev)
    y_k = spmv_csr(g, x)
    y_k2 = spmv_csr(g, x)
    y_p = spmv_plain(g, x)
    torch.cuda.synchronize()
    a_abs = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, row_ids(g), (g.data.double() * x.double()[g.indices.long()]).abs()
    )
    err = (y_k.double() - y_p.double()).abs()
    check(bool((err <= 1e-5 * a_abs).all()), "K1 disagrees with spmv_plain beyond 1e-5*(|A||x|)")
    check(torch.equal(y_k, y_k2), "two K1 launches differ")
    k1_err = float(err.max())
    k1_ms = cuda_ms(lambda: spmv_csr(g, x), 200)
    k1_plain_ms = cuda_ms(lambda: spmv_plain(g, x), 5)
    a_sparse = torch.sparse_csr_tensor(
        g.indptr.long(), g.indices.long(), g.data, size=(n, n), check_invariants=True
    )
    k1_lib_ms = cuda_ms(lambda: a_sparse @ x, 200)
    k1_bytes = 4 * (g.indptr.numel() + 2 * nnz + 2 * n)
    k1_bound_ms = max(k1_bytes / HBM_BYTES_PER_S, 2 * nnz / F32_OPS_PER_S) * 1e3
    print(
        f"K1: max |kernel - plain| {k1_err:.3g} (bitwise equal: {torch.equal(y_k, y_p)}), "
        f"{k1_ms:.4f} ms, plain {k1_plain_ms:.3f} ms, torch.sparse {k1_lib_ms:.4f} ms, "
        f"bound {k1_bound_ms:.4f} ms ({k1_bytes} bytes)"
    )

    # Phase 4: K2 against kl_pass_plain from one seeded balanced split.
    sides = torch.as_tensor(random_split(n, SEED)).to(dev)
    s = sides_to_signs(sides, torch.float32)
    a_s = spmv_csr(g, s)
    cut0 = float(cut_size(g, s, a_s))
    n1 = int(sides.sum())
    cap = min(n1, n - n1)
    args = (g, s, a_s, cut0, cap, KLConfig().terminate_limit(n), 1e-6)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_k = kl_pass_cuda(*args)
    torch.cuda.synchronize()
    k2_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out_p = kl_pass_plain(*args)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    it = int(out_k.scalars[2])
    check(int(out_p.scalars[2]) == it, "K2 and kl_pass_plain ran different iteration counts")
    check(torch.equal(out_k.log_a, out_p.log_a), "K2 log_a differs from kl_pass_plain")
    check(torch.equal(out_k.log_b, out_p.log_b), "K2 log_b differs from kl_pass_plain")
    check(torch.equal(out_k.sf, out_p.sf), "K2 final sf differs from kl_pass_plain")
    check(torch.equal(out_k.log_cut, out_p.log_cut), "K2 log_cut differs from kl_pass_plain")
    check(torch.equal(out_k.scalars, out_p.scalars), "K2 scalars differ from kl_pass_plain")
    k2_err = float((out_k.log_cut[: it + 1] - out_p.log_cut[: it + 1]).abs().max())
    k2_ms = min(k2_ms, cuda_ms(lambda: kl_pass_cuda(*args), 2))
    swapped = torch.cat([out_k.log_a[1 : it + 1], out_k.log_b[1 : it + 1]])
    k2_bound_ms, k2_bound_by, k2_bytes, k2_ops = k2_bound(g, it, swapped)
    print(
        f"K2: {it} swaps from a random split, logs and sf bitwise equal to the plain "
        f"version; {k2_ms:.3f} ms ({1e3 * k2_ms / max(it, 1):.3f} us/swap), plain "
        f"{k2_plain_ms:.1f} ms, bound {k2_bound_ms:.4f} ms by {k2_bound_by} "
        f"({k2_bytes} bytes, {k2_ops} operations)"
    )

    # Phase 5: the fused pipeline end to end, through the user's entry point.
    K1.launches = 0
    K2.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = fused_partition(hg, use_eig=True, device="cuda")
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    k1_launches, k2_launches = K1.launches, K2.launches
    kl = run.kl
    iters = run.spectral_iterations
    check(k1_launches >= iters + 2, f"K1 launched {k1_launches} times for {iters} power steps")
    check(k2_launches == 1, f"K2 launched {k2_launches} times, not once")
    drift = abs(kl.final_cut - kl.verified_cut) / kl.final_cut
    check(drift <= 1e-5, f"cut drift {drift:.3g} above 1e-5")
    check(kl.best_cut <= kl.initial_cut, "best cut above the initial cut")
    check(
        kl.best_cut <= 1.03 * JAX_CPU_BEST_CUT,
        f"best cut {kl.best_cut} above 1.03 x {JAX_CPU_BEST_CUT}",
    )
    best = np.asarray(kl.best_sides)
    check(
        best.shape == (n,) and int(best.sum()) == int(np.asarray(run.eig.sides).sum()),
        "best partition does not keep the spectral split's balance",
    )
    sgn = 1.0 - 2.0 * best.astype(np.float64)
    rows = np.repeat(np.arange(n), np.diff(g_host.indptr))
    a_sgn = np.bincount(rows, weights=g_host.data * sgn[g_host.indices], minlength=n)
    host_cut = 0.25 * (g_host.data.sum() - sgn @ a_sgn)
    check(
        abs(host_cut - kl.best_cut) <= 1e-4 * kl.best_cut,
        f"best cut {kl.best_cut} disagrees with the host f64 recount {host_cut}",
    )
    print(
        f"fused gen {MULTIPLIER}x: {iters} power iterations, initial cut {kl.initial_cut}, "
        f"best cut {kl.best_cut} after {kl.iterations} swaps, final {kl.final_cut}, "
        f"verified {kl.verified_cut} (drift {drift:.3g}), host f64 recount of the best "
        f"partition {host_cut:.4f}; e2e {e2e_s:.3f} s on {card}; spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(run.timings.items()))
    )
    print(f"launches on the main path: K1 {k1_launches}, K2 {k2_launches}")
    # Each node is swapped at most once, so the swapped nodes are those
    # whose side the pass changed.
    moved = torch.as_tensor(np.flatnonzero(np.asarray(kl.sides) != np.asarray(run.eig.sides)))
    main_ms, main_by, main_bytes, main_ops = k2_bound(g, kl.iterations, moved.to(dev))
    print(
        f"K2 on the main path: {kl.iterations} swaps, bound {main_ms:.4f} ms by {main_by} "
        f"({main_bytes} bytes, {main_ops} operations)"
    )

    # Phase 6: where the time goes.  Two more end-to-end runs for the
    # spread, then one under the profiler for the device's busy time by
    # kernel.  These runs are not the main path's and are not counted.
    repeats = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = fused_partition(hg, use_eig=True, device="cuda")
        torch.cuda.synchronize()
        repeats.append(time.perf_counter() - t0)
        check(again.kl.best_cut == kl.best_cut, "a repeated run gave another best cut")
    print(
        f"e2e repeats: {', '.join(f'{t:.3f}' for t in repeats)} s; spans of the last: "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(again.timings.items()))
    )
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fused_partition(hg, use_eig=True, device="cuda")
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # Kernels only: an operator's device time is its kernels' time again.
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us > 0:
        print(
            f"profiled e2e {prof_wall:.3f} s, device busy {busy_us / 1e6:.3f} s "
            f"({100 * busy_us / 1e6 / prof_wall:.1f} %); top kernels by device time:"
        )
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            print(
                f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d} x  {e.key[:90]}"
            )
    else:
        print("profiler recorded no device time: device busy share not measured")

    kernels = [
        {
            "name": "K1 spmv_csr_f32",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/spmv_csr.cu",
            "replaces": "eig_kl_tpu/ops/spmv_pallas.py:339",
            "launches": k1_launches,
            "max_abs_err": k1_err,
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound_ms,
            "bound_by": "bytes",
            "library_ms": k1_lib_ms,
        },
        {
            "name": "K2 kl_pass_f32",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/kl_pass.cu",
            "replaces": "eig_kl_tpu/kl/megakernel.py:144",
            "launches": k2_launches,
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound_ms,
            "bound_by": k2_bound_by,
            "library_ms": None,
        },
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
