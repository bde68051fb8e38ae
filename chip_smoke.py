"""Smoke run of eig_kl_tpu_torch on one CUDA card.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

It builds the port's kernels and host library from
``eig_kl_tpu_torch/csrc``, holds each kernel against its plain PyTorch
version on the card at the shapes of the main path, drives the fused
EIG+KL pipeline (``fused_partition``, the path of ``python -m
eig_kl_tpu_torch fused <file> -EIG``) once on the generated circuit at 1.0x
the reference scale (seed 42, 201,920 nodes), then the multi-start path,
then the v3 path (``fused_refine_mega`` on the same graph with a v3 SpMV
plan attached), then the sharded KL pass (``smega_refine`` at 1, 2, 4 and
8 shards, one thread-block cluster each, from the one-start run's
spectral split), checks that each run went through its kernels and that
its cuts are right, and prints one JSON line per the kernels and, last,
``{"ok": true, "device": ...}``.  The kernels: K1 (the CSR SpMV, and its
power step entry point), K2, K3a/b/c, K4 (XLA's vector dot, one to four
dots per launch), K5 and K6 (the fixed-order sum of the norms and cuts,
and the power step's scale).  Library calls that compute a kernel's
function are timed by CUDA events and by their device time.  Then the Lanczos,
LOBPCG and momentum paths on the circuit's largest component, and the
f64 engine: every f64 kernel against its plain version, the f64 fused
run, Lanczos and LOBPCG at spectral_partition's f64 default, the f64
momentum exit and the f64 multi-start.  K7 (the exact rank select of every
median) is held against its plain version at the main path's sizes and
timed beside ``torch.kthvalue``; last, the JAX mega engine's own path on
gen 0.02x and on gen 1.0x: K1's ``spmv_v1_f32`` and ``spmv_v2_f32`` (the v1
and v2 TPU SpMVs' orders) against their plain versions, then
``fused_refine_mega`` called directly, held to the JAX package's
interpret-mode bits (gen 0.02x) and to the port's plain CPU run (gen 1.0x).
The CSR plan path (``fused_partition(with_plan=True)``) takes the v2 order
too, through ``spmv_v2_bf16i_f32`` and its lazy-walk forms; last, the v2
SpMV's other forms that the environment picks there, as in the JAX package
(``EIG_KL_TPU_BF16_W=1``: bf16 weights; ``EIG_KL_TPU_REDUCE_IMPL``: the
"mxu2" and "vpu" reduce orders): each entry point against its plain
version, then the paths that take them.  Last, the engines across ranks
(``eig_kl_tpu_torch/parallel``): ``sharded_refine_oc``, the dp-sharded
multi-start and the sharded power iteration at one rank over NCCL in this
process and at two ranks on the same card over gloo in two processes,
held to K2's swaps, to the one-card multi-start and to the JAX package's
runs (``tools/sharded_reference.py``); ``smega_refine`` across the two
ranks (kernel K5R, its rounds through CUDA IPC between the two processes)
on gen 1.0x (the first 1,000 swaps) and gen 0.02x (a whole pass), held to
K5 at S = 2 in one process, to K2's swaps and to its plain version across
the ranks; and the fused CLI with ``EIG_KL_TPU_PROFILE_DIR`` set, whose
Chrome trace must name K1's power step and K2.
Every lazy walk gathers z = dsinv * w: the momentum step's rescale writes
it (``lazy_rescale``), else the z pass (``lazy_z``); both are held to their
plain versions, each walk is held and timed given z and held with its z
pass, and each momentum run must launch one walk and one rescale per step
and no z pass but one per check and one at the start (the walks' earlier
design, two gathers per entry, is timed beside them by
``tools/lazy_walk_turns.py``).
Any failed check raises, so the script exits nonzero and prints no
result; so does a machine without a CUDA card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import datetime
import hashlib
import json
import os
import subprocess
import sys
import tempfile
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
STARTS, PERTURB, KICKS = 8, 0.05, 2  # the multi-start path
PASS_FIELDS = ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars")
SHARDS = (1, 2, 4, 8)  # the smega path's shard counts, one cluster of S blocks each
#: The bits every PR of the port has reproduced at gen 1.0x seed 42: the
#: one-start run's power iterations, swaps and best cut; the multi-start
#: best cut; the v3 path's power iterations and best cut (rounded to 0.01).
MAIN_ITERS, MAIN_SWAPS, MAIN_BEST = 326, 8348, 39693.86
MULTI_BEST = 39581.65
V3_ITERS, V3_BEST = 351, 39709.99
#: The CSR plan path (ROADMAP.md A10): the JAX package's v2 SpMV in its own
#: order with its default bf16 intermediates, as K1's spmv_v2_bf16i_f32; the
#: quality A/B of PARITY.md:84-88 over these spectral seeds, in three cells.
AB_SEEDS = (42, 43, 44, 45, 46)
AB_CELLS = ("csr f32", "padded f32", "padded bf16i", "padded bf16i bf16w")
#: The environment of each A/B cell: the fourth streams the plan's weights in
#: bf16 (EIG_KL_TPU_BF16_W=1, the JAX package's opt-in).
AB_KNOBS = {"padded bf16i bf16w": {"EIG_KL_TPU_BF16_W": "1"}}
#: gen 1.0x's v2 plan: its row block and bucket slot count, and its COO
#: tail's entries (eig_kl_tpu/ops/spmv_pallas.py:build_plan_v2's search).
V2_GEOMETRY, V2_COO_TAIL = (16384, 512), 125
#: The port's plain runs on the CPU at gen 1.0x (tools/plan_order_reference.py),
#: which the card's runs of the same paths must equal bit for bit: the plan
#: path's bf16i one-start run (power iterations, swaps, initial, best and
#: final cut), and fused_refine_mega called directly (as JAX_MEGA_GEN002).
PLAN_BF16I = (126, 9575, 66307.84375, 39262.55859375, 39262.55859375)
#: The same run under the v2 SpMV's other forms (tools/plan_order_reference.py
#: --forms): with bf16 weights (EIG_KL_TPU_BF16_W=1), in the "vpu" reduce's
#: order (EIG_KL_TPU_REDUCE_IMPL=vpu; with bf16 products it moves no bit
#: here), under both, and the padded f32 one start under "vpu".
PLAN_BF16I_BF16W = (151, 11689, 73263.25, 41917.87890625, 41917.87890625)
PLAN_BF16I_VPU = PLAN_BF16I
PLAN_BF16I_BF16W_VPU = PLAN_BF16I_BF16W
PLAN_F32_VPU = (351, 8081, 58764.71875, 39722.375, 39722.375)
BF16W = {"EIG_KL_TPU_BF16_W": "1"}
VPU = {"EIG_KL_TPU_REDUCE_IMPL": "vpu"}
MXU2 = {"EIG_KL_TPU_REDUCE_IMPL": "mxu2"}
MEGA_GEN1 = (326, 2.089679718017578, 58810.609375, 39726.91796875, 8063, 39726.91796875, 39726.9140625, 97975)
#: The one-start run on gen 0.02x (4,038 nodes, below XLA's 4,096-value
#: dot fusion): the JAX package's f32 CPU run's power iterations, swaps and
#: best cut, which its mega cuts reach through K4's fused dot.
GEN002_ITERS, GEN002_SWAPS, GEN002_BEST = 201, 357, 794.98
#: The JAX mega engine's fused_refine_mega on gen 0.02x in interpret mode on
#: the CPU (its v1 plan; tests/test_torch_faults.py): power iterations,
#: eigenvalue, initial, best cut, swaps, final and verified cut, nodes on
#: side 1 of the split.
JAX_MEGA_GEN002 = (201, 1.2118749618530273, 1041.8525390625, 788.5287475585938, 1362, 1003.1763305664062,
                   1003.1761474609375, 1947)
#: The largest connected component of that circuit: nodes, nets, pins.
LCC_COUNTS = (184406, 209370, 520304)
#: The JAX package's runs on that component on the CPU at f32
#: (tools/lcc_reference.py): Lanczos with the host f64 refinement (its
#: restarts and lambda_2), LOBPCG's iterations, one KL pass (KLConfig())
#: from the Lanczos split, and the momentum exit on the KL-weighted graph
#: (its iterations, median and a digest of its split; the port's plain run
#: on the CPU gives the same iterations and split).
JAX_LCC_RESTARTS, JAX_LCC_LAMBDA2 = 7, 0.04756223033233042
JAX_LCC_LOBPCG_ITERS = 169
JAX_LCC_KL_INITIAL, JAX_LCC_KL_BEST, JAX_LCC_KL_SWAPS = 55795.1953125, 40172.46875, 16579
JAX_LCC_MOMENTUM_ITERS, JAX_LCC_MOMENTUM_MEDIAN = 726, 1.5583746062475257e-05
JAX_LCC_MOMENTUM_SIDES = "1ea518686d1bcfa2"
#: The JAX package's f64 runs on the CPU (tools/lcc_reference.py --x64):
#: on the component, Lanczos and LOBPCG at f64 (no host refinement, the
#: JAX package's rule off the TPU): restarts, lambda_2, iterations; the
#: f64 momentum exit's iterations; fused_partition(use_eig=True,
#: dtype=float64) on the whole circuit: power iterations (the gkl2 exit's
#: cap), initial and best cut, swaps.
JAX_F64_RESTARTS, JAX_F64_LAMBDA2 = 6, 0.047562230223799844
JAX_F64_LOBPCG_ITERS, JAX_F64_LOBPCG_LAMBDA2 = 169, 0.047562230229031846
JAX_F64_MOMENTUM_ITERS = 726
JAX_F64_FUSED_ITERS, JAX_F64_FUSED_INITIAL, JAX_F64_FUSED_BEST, JAX_F64_FUSED_SWAPS = (
    1000, 52345.97619047332, 40725.30952380652, 9039)
F64_OPS_PER_S = 34e12  # H100 SXM f64 outside the tensor cores, NVIDIA data sheet
GEN_002 = os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks", "data", "gen_0.02_42.hgr")
#: The JAX package's f64 momentum split of that component, bit-packed
#: (tools/lcc_reference.py --x64 writes it).
MOMENTUM_F64_SIDES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", "lcc_momentum_f64_sides.bin")


def largest_component(hg):
    """The largest connected component of a hypergraph: its nodes renumbered
    in order, and the nets whose pins all lie in it.  The generator's
    circuits are disconnected (gen 1.0x seed 42: 201,920 nodes, the largest
    component 184,406), and on a disconnected graph lambda_2 = 0 and a
    "Fiedler vector" is an arbitrary null vector; the Lanczos, LOBPCG and
    momentum phases run on this component."""
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    from eig_kl_tpu_torch.io.hgr import Hypergraph

    sizes = np.diff(hg.net_offsets)
    first = np.repeat(hg.pins[hg.net_offsets[:-1]], sizes)
    n = hg.num_nodes
    adj = sp.coo_matrix((np.ones(len(first)), (first, hg.pins)), shape=(n, n))
    _, label = csgraph.connected_components(adj, directed=False)
    keep = label == np.argmax(np.bincount(label))
    new_id = np.cumsum(keep) - 1
    nets = np.add.reduceat(keep[hg.pins].astype(np.int64), hg.net_offsets[:-1]) == sizes
    pins = new_id[hg.pins[np.repeat(nets, sizes)]].astype(np.int32)
    offsets = np.zeros(int(nets.sum()) + 1, np.int64)
    np.cumsum(sizes[nets], out=offsets[1:])
    return Hypergraph(int(keep.sum()), int(nets.sum()), pins, offsets, name="lcc.hgr")


@contextlib.contextmanager
def knobs(env: dict):
    """The environment with ``env`` set (a value of None unset), as a user
    sets the JAX package's knobs; restored after."""
    saved = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def bits32(t: torch.Tensor) -> torch.Tensor:
    """The bits of an f32 tensor: equal bits mean equal values and zero signs."""
    return t.view(torch.int32)


def fmt_us(us) -> str:
    if us is None or us[0] is None:
        return "not measured (the profiler recorded no such kernel)"
    return f"{us[0]:.2f} us"


def swaps_of(out) -> list[tuple[int, torch.Tensor]]:
    """Per start of a PassOutput (with or without a start axis): the
    number of swaps and the nodes they swapped."""
    log_a = out.log_a.reshape(-1, out.log_a.shape[-1])
    log_b = out.log_b.reshape(-1, out.log_b.shape[-1])
    counts = out.scalars.reshape(-1, 8)[:, 2].long().tolist()
    return [
        (it, torch.cat([log_a[k, 1 : it + 1], log_b[k, 1 : it + 1]]))
        for k, it in enumerate(counts)
    ]


def k2_bound(g, starts) -> tuple[float, str, int, int]:
    """K2's least time for one launch over ``starts``, a list of
    ``(swaps, swapped nodes)`` per start: ``(ms, bound_by, bytes,
    operations)``, in the graph's dtype.

    Bytes: the graph read once; per start sf0, a_s0 and the four
    parameters read once, and the final sf, the entries the pass wrote
    into its four logs and 8 scalars written once.  Operations: what
    these passes need with the TPU kernel's per-128-node row-max cache,
    not K2's flat scan: per swap a compare for each cached row maximum of
    each side, and a multiply and an add for each entry of the two swapped
    rows.
    """
    n, nnz = g.num_nodes, g.nnz
    size = g.data.element_size()
    degrees = (g.indptr[1:] - g.indptr[:-1]).long()
    n_bytes, n_ops = 4 * g.indptr.numel() + (4 + size) * nnz, 0
    for swaps, swapped in starts:
        n_bytes += 3 * size * n + 2 * size + 8 + (2 * size + 8) * (swaps + 1) + 8 * size
        n_ops += swaps * 2 * -(-n // 128) + 2 * int(degrees[swapped.long()].sum())
    rate = F32_OPS_PER_S if size == 4 else F64_OPS_PER_S
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations", n_bytes, n_ops


def host_cut(g_host, sides) -> float:
    """The cut of ``sides`` on the host graph, recounted in float64."""
    n = g_host.num_nodes
    sgn = 1.0 - 2.0 * np.asarray(sides, dtype=np.float64)
    rows = np.repeat(np.arange(n), np.diff(g_host.indptr))
    a_sgn = np.bincount(rows, weights=g_host.data * sgn[g_host.indices], minlength=n)
    return float(0.25 * (g_host.data.sum() - sgn @ a_sgn))


def check_same_pass(a, b, what: str) -> None:
    for name in PASS_FIELDS:
        check(torch.equal(getattr(a, name), getattr(b, name)), f"{what}: {name} differs")


def report_device_busy(what: str, fn) -> list[str]:
    """Run ``fn`` once under the profiler and print the device's busy time,
    its share of the wall time, and the kernels that took most of it; return
    the names of the kernels it ran (none where the profiler saw no device
    time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernels only: an operator's device time is its kernels' time again.
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us == 0:
        print(f"{what}: the profiler recorded no device time: device busy share not measured")
        return []
    print(
        f"{what}, profiled: e2e {wall:.3f} s, device busy {busy_us / 1e6:.3f} s "
        f"({100 * busy_us / 1e6 / wall:.1f} %); top kernels by device time:"
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms {e.count:7d} x  {e.key[:90]}")
    return [e.key for e in events]


def device_us_per_call(fn, calls: int) -> tuple[float, float] | None:
    """Run ``fn`` (``calls`` calls of one function) under the profiler: the
    device time in microseconds of all its kernels per call, and the number
    of kernels per call; None if the profiler saw no kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    return sum(e.time_range.elapsed_us() for e in kernels) / calls, len(kernels) / calls


def one_kernel_per_call(fn, calls: int, kernel: str) -> int:
    """Run ``fn`` ``calls`` times under the profiler, a marker kernel (an
    add of one value) before each call and after the last; check that
    between every two markers it saw ran exactly one kernel, with
    ``kernel`` in its name, over at least half of the calls (the profiler
    may miss the first kernels of its window).  Returns the calls seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mark = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            mark.add_(1)
            fn()
        mark.add_(1)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
    check(bool(events) and kernel not in events[-1].name, f"the profiler missed the last marker after {kernel}")
    at = [i for i, e in enumerate(events) if e.name == events[-1].name]
    between = [[e.name for e in events[a + 1 : b]] for a, b in zip(at, at[1:])]
    check(len(between) >= calls // 2 and all(len(s) == 1 and kernel in s[0] for s in between),
          f"{calls} calls: the kernels between markers were {between}, not one {kernel} each")
    return len(between)


def library_device_us(fn, calls: int = 50) -> float | None:
    """Device microseconds of all the kernels of one call of ``fn`` (a
    library call), by the profiler over ``calls`` calls; None if it saw
    none."""
    us = device_us_per_call(lambda: [fn() for _ in range(calls)], calls)
    return None if us is None else us[0]


def k4_batches(xs, ys, plain_dots, what: str) -> dict:
    """K4's batch at 1 to 4 pairs, each launch's dots bit for bit the host
    chains ``plain_dots`` (computed once per pair); device us per launch of
    one dot and of two (the momentum exit's paired deflation), and the
    library's two ``torch.dot`` calls for the two."""
    from eig_kl_tpu_torch.ops.reduce import fma_dot_batch_cuda

    ref = torch.stack(plain_dots)
    for count in range(1, len(xs) + 1):
        got = fma_dot_batch_cuda(xs[:count], ys[:count])
        check(torch.equal(got.cpu(), ref[:count].cpu()), f"{what}'s batch of {count} differs from the host chains")
    one = device_us_per_launch(lambda: [fma_dot_batch_cuda(xs[:1], ys[:1]) for _ in range(10)], "fma_dot_batch")
    two = device_us_per_launch(lambda: [fma_dot_batch_cuda(xs[:2], ys[:2]) for _ in range(10)], "fma_dot_batch")

    def two_dots():  # the library's counterpart of one launch of two dots
        return torch.dot(xs[0], ys[0]), torch.dot(xs[1], ys[1])

    return {"device_us_one_dot": None if one is None else one[0],
            "device_us_two_dots": None if two is None else two[0],
            "library_ms_two_dots": cuda_ms(two_dots, 200), "library_device_us_two_dots": library_device_us(two_dots)}


def device_us_per_launch(fn, kernel: str, num_groups: int = 1) -> list[float] | None:
    """Run ``fn`` (calls that each launch the kernels whose names contain
    ``kernel`` ``num_groups`` times, one after another) under the
    profiler: the mean device time in microseconds of each of the
    ``num_groups`` launches per call, in launch order (K3b: its groups), or
    None if the profiler saw no whole call in three windows (a window now
    and then records none of its kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA and kernel in e.name),
            key=lambda e: e.time_range.start,
        )
        # The profiler may miss the first kernels of the window: count whole
        # calls from the last launch back.
        kernels = kernels[len(kernels) % num_groups :]
        if kernels:
            break
    else:
        return None
    per = [kernels[k::num_groups] for k in range(num_groups)]
    return [sum(e.time_range.elapsed_us() for e in group) / len(group) for group in per]


def turns(designs: dict, kernel: str, calls: int = 50) -> dict[str, list[float | None]]:
    """Device microseconds per launch of each design's kernel (names that
    contain ``kernel``), timed in turns: the designs in order, then in
    reverse (new, earlier, earlier, new), ``calls`` calls each time."""
    out = {name: [] for name in designs}
    for name in list(designs) + list(designs)[::-1]:
        us = device_us_per_launch(lambda fn=designs[name]: [fn() for _ in range(calls)], kernel)
        out[name].append(None if us is None else us[0])
    return out


#: The sharded phase (ROADMAP.md A8b): its two ranks share the one card over
#: gloo, which carries their collectives through the host (NCCL refuses two
#: ranks on one device); its one-rank runs take NCCL.  The ranks are killed
#: at the deadline.  The JAX package's sharded power ("gkl2") on this
#: circuit on the CPU (tools/sharded_reference.py): iterations, lambda and
#: the vector's digest on 1 and 2 devices, and its single-chip solve's
#: lambda and digest, which the port's one- and two-rank runs and its
#: one-card gkl2 exit equal bit for bit.  Their own spread (lambda 4.6e-5
#: relative and the vector 1.2e-6 apart between 1 and 2 devices, 5.8e-4 and
#: 1.1e-5 to the single chip) is the rounding of their norms.
SHARDED_DEADLINE_S = 300
#: smega_refine across the two ranks (K5R): the swaps of gen 1.0x's pass it
#: runs, and the swaps over which it is held to the plain version across
#: the ranks on the card (a loop of PyTorch calls and two gathers a swap).
SMEGA_RANKS_CAP, SMEGA_RANKS_PLAIN_CAP = 1000, 200
SMEGA_RANKS_LABEL = "two processes on one card, time-sliced: not a cross-card figure"
JAX_SHARDED_POWER = {1: (1000, 2.0929136276245117, "fae28b91cf9e09c0"),
                     2: (1000, 2.0928163528442383, "87aea64dc2f0bece")}
JAX_SINGLE_POWER = (2.091707706451416, "438b197f19182959")


def port_kernels() -> list:
    """Every kernel wrapper of the port, each once."""
    import importlib

    from eig_kl_tpu_torch.ops import _build, spmv_plan

    found = {}
    for name in ("kl.megakernel", "ops.reduce", "ops.select", "ops.spmv", "ops.spmv_plan", "ops.spmv_v3",
                 "parallel.smega"):
        mod = importlib.import_module(f"eig_kl_tpu_torch.{name}")
        for v in list(vars(mod).values()) + list(spmv_plan.K1_V2_FORMS.values()):
            if isinstance(v, _build.Kernel):
                found[id(v)] = v
    return list(found.values())


def vector_digest(v) -> str:
    """The first 16 hex digits of the SHA-256 of an f32 vector's bytes."""
    return hashlib.sha256(np.ascontiguousarray(np.asarray(v, dtype=np.float32)).tobytes()).hexdigest()[:16]


def _kl_fields(r) -> dict:
    return {f.name: getattr(r, f.name) for f in dataclasses.fields(r)}


def sharded_runs(g_host, sides, init_sides, dev) -> dict:
    """One rank's runs of the sharded path, each with the kernel counts set
    to 0 just before it and read just after: sharded_refine_oc over every
    rank of the group, multi_start_refine_mega_sharded with the starts
    split over them, sharded_power_fiedler ("gkl2") over them."""
    from eig_kl_tpu_torch.kl.megakernel import K2_STARTS
    from eig_kl_tpu_torch.parallel import sharded_kl, sharded_power
    from eig_kl_tpu_torch.parallel.mesh import make_mesh, world_size
    from eig_kl_tpu_torch.parallel.multi_start import multi_start_refine_mega_sharded
    from eig_kl_tpu_torch.parallel.sharded_kl2 import sharded_refine_oc
    from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig
    from eig_kl_tpu_torch.utils.tracing import Tracer

    kernels = port_kernels()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def counted(fn):
        for kern in kernels:
            kern.launches = 0
        K2_STARTS.clear()
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        secs = time.perf_counter() - t0
        return r, secs, {kern.symbol: kern.launches for kern in kernels if kern.launches}, dict(K2_STARTS)

    ranks = world_size()
    config = KLConfig(gain_eps=1e-6)
    mesh = make_mesh(device=dev)
    tracer = Tracer(dev)
    r, secs, launched, _ = counted(lambda: sharded_refine_oc(g_host, sides, mesh, config, tracer=tracer))
    out = {"ranks": ranks, "oc": {"result": _kl_fields(r), "swaps": sharded_kl.last_swaps, "seconds": secs,
                                  "pass_seconds": tracer.spans["kl.pass"], "launches": launched}}
    g_dev = g_host.to_device(mesh.device, torch.float32)
    g_dev.plan_layout  # the mega engine's layout, built once per graph, outside the clock
    dp_mesh = make_mesh(dp=ranks, device=dev)
    (best, cuts), secs, launched, k2_starts = counted(lambda: multi_start_refine_mega_sharded(
        g_dev, len(init_sides), mesh=dp_mesh, config=config, init_sides=init_sides))
    out["multi"] = {"best": _kl_fields(best), "cuts": cuts, "seconds": secs, "launches": launched,
                    "k2_starts": k2_starts}
    cfg = SpectralConfig(solver="power", convergence="gkl2")
    (lam, v), secs, launched, _ = counted(lambda: sharded_power.sharded_power_fiedler(g_host, mesh, cfg))
    out["power"] = {"lam": float(lam), "v": v.cpu().numpy(), "iterations": sharded_power.last_iterations,
                    "seconds": secs, "launches": launched}
    if ranks > 1:
        out["smega"] = smega_ranks_runs(g_host, sides, mesh, counted)
    return out


def smega_ranks_runs(g_host, sides, mesh, counted) -> dict:
    """One rank's runs of smega_refine across the mesh's ranks (K5R), each
    through ``counted``: (a) gen 1.0x from ``sides``, the first
    SMEGA_RANKS_CAP swaps; (b) gen 0.02x's whole pass from a random split.
    Then (c), pass by pass from the same inputs: K5R bit for bit the plain
    version across the ranks (on the card, the first SMEGA_RANKS_PLAIN_CAP
    swaps) and K5 at S = ranks in this process (its logs, scalars and this
    rank's stripe of sf), both timed.  The plans and the exchange buffers
    are made outside the clock, as a caller reuses them."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.parallel import smega
    from eig_kl_tpu_torch.utils.config import KLConfig

    dev, mp = mesh.device, mesh.axis_names[1]
    n_ranks, me = mesh.shape[mp], mesh.coords[mp]
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def device_ms():  # the last K5R launch's own device time
        return smega.peer_buffers(mesh).last_pass_ns / 1e6 if on_card else 0.0

    if on_card:
        smega.peer_buffers(mesh)
    g002 = clique_expand(read_hgr(GEN_002), "kl")
    runs = {"gen1": (g_host, sides, KLConfig(gain_eps=1e-6, max_iterations=SMEGA_RANKS_CAP)),
            "gen002": (g002, random_split(g002.num_nodes, SEED), KLConfig(gain_eps=1e-6))}
    out = {}
    for tag, (g, start, cfg) in runs.items():
        plan = smega.SmegaPlan(g, n_ranks)
        part = plan.rank_part(me, dev)
        r, secs, launched, _ = counted(lambda: smega.smega_refine(g, start, mesh, cfg, plan=plan))
        run = {"result": _kl_fields(r), "seconds": secs, "launches": launched,
               "device_ms": device_ms(), "n_local": part.n_local,
               "layout": smega.k5_layout(part.n_local, 1)}
        args = smega.pass_inputs(plan, start, cfg, dev, part)
        k5 = smega.smega_pass(plan.device_graph(dev), n_ranks, *smega.pass_inputs(plan, start, cfg, dev))
        k5r = smega.smega_pass_ranks(mesh, part, *args)
        run["pass_device_ms"] = device_ms()
        stripe = slice(part.r0, part.r0 + part.n_local)
        for name in PASS_FIELDS:
            want = getattr(k5, name)[stripe] if name == "sf" else getattr(k5, name)
            check(torch.equal(getattr(k5r, name), want), f"K5R ({tag}, rank {me}): {name} differs from K5's at S = "
                  f"{n_ranks} in one process")
        if tag == "gen1":
            plain_args = args[:3] + (SMEGA_RANKS_PLAIN_CAP,) + args[4:]
            k5r = smega.smega_pass_ranks(mesh, part, *plain_args)
            run["plain_cap_device_ms"] = device_ms()
            sync()
            t0 = time.perf_counter()
            plain = smega.smega_pass_ranks_plain(mesh, part, *plain_args)
            sync()
            run["plain_ms"] = (time.perf_counter() - t0) * 1e3
            check_same_pass(k5r, plain, f"K5R (rank {me}) against the plain version across the ranks")
            run["max_abs_err"] = float((k5r.log_cut - plain.log_cut).abs().max())
        out[tag] = run
    return out


def sharded_rank(rank: int, world: int, tmp: str) -> None:
    """A rank of the sharded phase's two: set up, wait for the parent's
    signal, join the gloo group, run :func:`sharded_runs`, write the result."""
    import pickle

    import torch.distributed as dist

    from eig_kl_tpu_torch.graph.csr import Graph

    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    dev = torch.device(inp["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    g_host = Graph.from_arrays(inp["indptr"], inp["indices"], inp["data"])
    t0 = time.monotonic()
    while not os.path.exists(os.path.join(tmp, "go")):
        if time.monotonic() - t0 > SHARDED_DEADLINE_S:
            raise SystemExit("no signal from the parent")
        time.sleep(0.05)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        out = sharded_runs(g_host, inp["sides"], inp["init_sides"], dev)
    except Exception:  # noqa: BLE001 -- the parent reports it
        import traceback

        out = {"error": traceback.format_exc()}
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def _same_kl(a: dict, b: dict, what: str, fields=None) -> None:
    for name, va in a.items():
        if fields is None or name in fields:
            same = np.array_equal(va, b[name]) if isinstance(va, np.ndarray) else va == b[name]
            check(same, f"{what}: {name} differs")


def sharded_phase(dev, hg, g_host, sides, k2_pass, card, expect_swaps=None, power_ref=None) -> dict:
    """The engines across ranks on gen 1.0x, from the one start's spectral
    split: one rank in this process over NCCL, two ranks in two processes
    on the same card over gloo.  ``k2_pass`` is K2's one-start pass from
    that split; ``expect_swaps`` its recorded swap count; ``power_ref`` the
    JAX sharded power's (iterations, lambda, vector digest) by rank count."""
    import pickle

    from eig_kl_tpu_torch.cli.main import main as cli_main
    from eig_kl_tpu_torch.io.hgr import write_hgr
    from eig_kl_tpu_torch.kl.init import perturb_split
    from eig_kl_tpu_torch.parallel.mesh import release_default_group
    from eig_kl_tpu_torch.parallel.multi_start import multi_start_refine_mega
    from eig_kl_tpu_torch.spectral.power import _power_core
    from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    n = g_host.num_nodes
    sides = np.asarray(sides, dtype=np.int8)
    init_sides = np.stack([sides] + [perturb_split(sides, 1 + i, PERTURB) for i in range(STARTS - 1)])
    tmp_dir = tempfile.TemporaryDirectory(prefix="eigkl_sharded_")  # removed at the end, or at exit
    tmp = tmp_dir.name
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump({"indptr": g_host.indptr, "indices": g_host.indices, "data": g_host.data, "sides": sides,
                     "init_sides": init_sides, "device": str(torch.device(dev.type, 0) if on_card else dev)}, f)
    root = os.path.dirname(os.path.abspath(__file__))
    code = "import sys; sys.path.insert(0, {!r}); import chip_smoke; chip_smoke.sharded_rank({}, 2, {!r})"
    env = dict(os.environ, LOCAL_RANK="0", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code.format(root, r, tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        one = sharded_runs(g_host, sides, init_sides, dev)
        release_default_group()
        with open(os.path.join(tmp, "go"), "w"):
            pass
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=max(SHARDED_DEADLINE_S - (time.perf_counter() - t_phase), 1))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                logs.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    two = []
    for r in range(2):
        path = os.path.join(tmp, f"rank{r}.pkl")
        check(os.path.exists(path), "a rank of the two-rank run wrote no result:\n"
              + b"\n".join(logs).decode(errors="replace")[-3000:])
        with open(path, "rb") as f:
            two.append(pickle.load(f))
        check("error" not in two[-1], f"rank {r} of the two-rank run failed:\n{two[-1].get('error')}")
    check(one["ranks"] == 1 and all(t["ranks"] == 2 for t in two), "the runs had other rank counts")

    # sharded_refine_oc: K2's swaps and gains at one rank and at two.
    it = int(k2_pass.scalars[2])
    k2_a, k2_b = (x[1 : it + 1].cpu().numpy() for x in (k2_pass.log_a, k2_pass.log_b))
    k2_gain = k2_pass.log_gain[1 : it + 1].cpu().numpy()
    oc = one["oc"]
    res = oc["result"]
    check(res["iterations"] == it and (expect_swaps is None or it == expect_swaps),
          f"sharded_refine_oc at one rank: {res['iterations']} swaps, K2 {it}")
    check(np.array_equal(oc["swaps"][0], k2_a) and np.array_equal(oc["swaps"][1], k2_b),
          "sharded_refine_oc at one rank swapped other nodes than K2")
    check(np.array_equal(res["gain_trajectory"][1:], k2_gain), "sharded_refine_oc's gains differ from K2's")
    # The JAX engines track the cut as cut - gain, uncompensated: at one
    # rank the best cut is the JAX CPU pipeline's (its XLA engine's), not
    # K2's compensated one, and the drift is the uncompensated sum's.
    recount = host_cut(g_host, res["best_sides"])
    oc_drift = abs(res["final_cut"] - res["verified_cut"]) / res["final_cut"]
    check(not on_card or (recount <= 1.03 * JAX_CPU_BEST_CUT and abs(res["best_cut"] - JAX_CPU_BEST_CUT) < 0.005),
          f"sharded_refine_oc: best cut {res['best_cut']} (JAX CPU {JAX_CPU_BEST_CUT}), its partition's host "
          f"recount {recount}, above 1.03 x {JAX_CPU_BEST_CUT}")
    for r, t in enumerate(two):
        check(np.array_equal(t["oc"]["swaps"][0], k2_a) and np.array_equal(t["oc"]["swaps"][1], k2_b)
              and np.array_equal(t["oc"]["result"]["gain_trajectory"][1:], k2_gain),
              f"sharded_refine_oc at two ranks (rank {r}) swapped other nodes or gained otherwise than at one")
        _same_kl(t["oc"]["result"], two[0]["oc"]["result"], f"sharded_refine_oc, rank {r} against rank 0")
    if on_card:
        want = {"spmv_csr_f32": 2, "tree_sum_f32": 2, "fma_dot_batch_f32": 2}
        for t in [one] + two:
            check(t["oc"]["launches"] == want, f"sharded_refine_oc launched {t['oc']['launches']}, not {want}")

    # multi_start_refine_mega_sharded at dp = 1 and 2 against the one-card run.
    g_dev = g_host.to_device(dev, torch.float32)
    ref_best, ref_cuts = multi_start_refine_mega(g_dev, STARTS, config=KLConfig(gain_eps=1e-6),
                                                 init_sides=init_sides, spmv_order="plan")
    for what, t in (("dp = 1", one), ("dp = 2, rank 0", two[0]), ("dp = 2, rank 1", two[1])):
        m = t["multi"]
        check(np.array_equal(m["cuts"], ref_cuts), f"the sharded multi-start at {what}: best cuts per start differ")
        _same_kl(m["best"], _kl_fields(ref_best), f"the sharded multi-start at {what}")
        per_rank = STARTS // t["ranks"]
        check(not on_card or (m["k2_starts"] == {per_rank: 1} and m["launches"].get("kl_pass_f32") == 1),
              f"the sharded multi-start at {what} launched K2 {m['k2_starts']}, {m['launches']}")

    # sharded_power_fiedler: each rank count equal to the JAX package's run
    # at that count, and the one-card gkl2 exit to the JAX single chip's
    # (tools/sharded_reference.py); their spread is theirs.
    lam1, v1 = _power_core(g_dev, shift=2.0, tolerance=1e-6, min_iters=100, max_iters=1000, seed=42,
                           dtype=torch.float32, convergence="gkl2")[:2]
    lam1, v1 = float(lam1), v1.cpu().numpy()
    for t in (one, two[0]):
        got = (t["power"]["iterations"], t["power"]["lam"], vector_digest(t["power"]["v"]))
        check(power_ref is None or got == power_ref[t["ranks"]],
              f"sharded_power_fiedler at {t['ranks']} ranks gave {got}, not the JAX run's "
              f"{power_ref and power_ref[t['ranks']]}")
    check(power_ref is None or (lam1, vector_digest(v1)) == JAX_SINGLE_POWER,
          f"the one-card gkl2 exit gave {lam1}, {vector_digest(v1)}, not the JAX run's {JAX_SINGLE_POWER}")
    check(two[0]["power"]["iterations"] == two[1]["power"]["iterations"] and
          np.array_equal(two[0]["power"]["v"], two[1]["power"]["v"]), "the two ranks' power runs differ")
    pw = one["power"]
    power_spread = {
        what: {"lambda_rel": abs(pw["lam"] - lam) / abs(lam), "vector_max_abs": float(np.abs(pw["v"] - v).max())}
        for what, lam, v in (("one rank to two", two[0]["power"]["lam"], two[0]["power"]["v"]),
                             ("one rank to the one-card gkl2 exit", lam1, v1))
    }

    # smega_refine across the two ranks (K5R, two processes on this card):
    # (a) gen 1.0x's first SMEGA_RANKS_CAP swaps and (b) gen 0.02x's whole
    # pass, each equal on both ranks and to K5 at S = 2 in this process,
    # bit for bit, and (a) to K2's swaps; one K5R launch per rank per run.
    # The ranks held themselves to K5 and to the plain version pass by pass.
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.parallel.smega import smega_refine

    g002 = clique_expand(read_hgr(GEN_002), "kl")
    k5_runs = {"gen1": smega_refine(g_host, sides, 2, KLConfig(gain_eps=1e-6, max_iterations=SMEGA_RANKS_CAP),
                                    device=dev),
               "gen002": smega_refine(g002, random_split(g002.num_nodes, SEED), 2, KLConfig(gain_eps=1e-6),
                                      device=dev)}
    cap = min(SMEGA_RANKS_CAP, it)
    check(k5_runs["gen1"].iterations == cap, f"K5 at S = 2 ran {k5_runs['gen1'].iterations} swaps, not {cap}")
    check(np.array_equal(k5_runs["gen1"].gain_trajectory[1:], k2_gain[:cap]), "K5 at S = 2 gained otherwise than K2")
    k2_sides = sides.copy()
    for v in np.concatenate([k2_a[:cap], k2_b[:cap]]):
        k2_sides[v] ^= 1
    check(np.array_equal(k5_runs["gen1"].sides, k2_sides), "K5 at S = 2 swapped other nodes than K2")
    for tag, ref in k5_runs.items():
        for r, t in enumerate(two):
            run = t["smega"][tag]
            _same_kl(run["result"], _kl_fields(ref), f"smega_refine across 2 ranks ({tag}, rank {r}) against K5 at S = 2")
            check(not on_card or run["launches"] == {"smega_ranks_pass_f32": 1, "spmv_csr_f32": 1},
                  f"smega_refine across 2 ranks ({tag}, rank {r}) launched {run['launches']}")
    capped_nodes = torch.as_tensor(np.concatenate([k2_a[:cap], k2_b[:cap]])).to(dev)
    k5r_bound = k2_bound(g_dev, [(cap, capped_nodes)])
    smega_ranks = {
        "label": SMEGA_RANKS_LABEL, "card": card, "cap": cap, "bound_ms": k5r_bound[0], "bound_by": k5r_bound[1],
        **{tag: {"swaps": two[0]["smega"][tag]["result"]["iterations"],
                 "best_cut": two[0]["smega"][tag]["result"]["best_cut"],
                 "n_local": two[0]["smega"][tag]["n_local"], "layout": two[0]["smega"][tag]["layout"],
                 "device_ms_by_rank": [t["smega"][tag]["device_ms"] for t in two],
                 "pass_device_ms_by_rank": [t["smega"][tag]["pass_device_ms"] for t in two],
                 "us_per_swap": 1e3 * max(t["smega"][tag]["device_ms"] for t in two)
                 / max(two[0]["smega"][tag]["result"]["iterations"], 1),
                 "e2e_s_by_rank": [t["smega"][tag]["seconds"] for t in two],
                 "launches_by_rank": [t["smega"][tag]["launches"] for t in two]} for tag in k5_runs},
        "plain_cap": SMEGA_RANKS_PLAIN_CAP,
        "plain_ms_by_rank": [t["smega"]["gen1"]["plain_ms"] for t in two],
        "plain_cap_device_ms_by_rank": [t["smega"]["gen1"]["plain_cap_device_ms"] for t in two],
        "max_abs_err": max(t["smega"]["gen1"]["max_abs_err"] for t in two),
    }

    # The fused CLI under EIG_KL_TPU_PROFILE_DIR: one Chrome trace naming
    # K1's power step and K2.
    cwd = os.getcwd()
    write_hgr(os.path.join(tmp, "gen.hgr"), hg)
    prof_dir = os.path.join(tmp, "profile")
    t0 = time.perf_counter()
    try:
        os.chdir(tmp)
        with knobs({"EIG_KL_TPU_PROFILE_DIR": prof_dir}), contextlib.redirect_stdout(open(os.devnull, "w")):
            rc = cli_main(["fused", "gen.hgr", "-EIG", "--device", dev.type])
    finally:
        os.chdir(cwd)
    cli_s = time.perf_counter() - t0
    traces = os.listdir(prof_dir) if os.path.isdir(prof_dir) else []
    check(rc == 0 and len(traces) == 1, f"the profiled fused CLI: rc {rc}, traces {traces}")
    with open(os.path.join(prof_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    named = {k: any(k in s for s in names) for k in ("power_step_kernel", "kl_pass_kernel")}
    check(not on_card or all(named.values()), f"the profiled fused CLI's trace names {named}")
    trace_mb = os.path.getsize(os.path.join(prof_dir, traces[0])) / 2**20

    summary = {
        "card": card,
        "oc": {f"{t['ranks']} rank{'s' * (t['ranks'] > 1)}": {
            "swaps": t["oc"]["result"]["iterations"], "e2e_s": t["oc"]["seconds"],
            "us_per_swap": 1e6 * t["oc"]["pass_seconds"] / max(t["oc"]["result"]["iterations"], 1),
            "best_cut": t["oc"]["result"]["best_cut"], "verified_cut": t["oc"]["result"]["verified_cut"],
            "launches": t["oc"]["launches"]} for t in (one, two[0])},
        "multi_start": {f"dp {t['ranks']}": {"starts": STARTS, "e2e_s": t["multi"]["seconds"],
                                             "best_cut": t["multi"]["best"]["best_cut"],
                                             "k2_launches_by_starts": t["multi"]["k2_starts"],
                                             "launches": t["multi"]["launches"]} for t in (one, two[0])},
        "power_gkl2": {f"{t['ranks']} rank{'s' * (t['ranks'] > 1)}": {
            "iterations": t["power"]["iterations"], "lambda": t["power"]["lam"], "seconds": t["power"]["seconds"],
            "launches": t["power"]["launches"]} for t in (one, two[0])},
        "power_gkl2_one_card": {"lambda": lam1},
        "smega_ranks": smega_ranks,
        "power_spread": power_spread,
        "oc_best_recount": recount, "oc_drift": oc_drift,
        "profiled_cli": {"seconds": cli_s, "trace_mib": trace_mb, "kernels_named": named},
        "phase_s": time.perf_counter() - t_phase,
    }
    for key, t in summary["oc"].items():
        print(f"sharded_refine_oc at {key} on gen {MULTIPLIER}x: {t['swaps']} swaps (= K2's, swap for swap and "
              f"gain for gain), best cut {t['best_cut']}, e2e {t['e2e_s']:.3f} s, {t['us_per_swap']:.1f} us per "
              f"swap; launches {t['launches']}")
    print(f"sharded_refine_oc's best partition: host f64 recount {recount:.4f} (JAX CPU {JAX_CPU_BEST_CUT}); "
          f"drift of the uncompensated cut {oc_drift:.3g}")
    for key, t in summary["multi_start"].items():
        print(f"multi_start_refine_mega_sharded at {key}, {STARTS} starts: per-start cuts and the best start equal "
              f"multi_start_refine_mega(spmv_order='plan'); best {t['best_cut']}, e2e {t['e2e_s']:.3f} s; K2 "
              f"launches by starts {t['k2_launches_by_starts']}")
    for key, t in summary["power_gkl2"].items():
        print(f"sharded_power_fiedler (gkl2) at {key}: {t['iterations']} iterations, lambda {t['lambda']}, "
              f"{t['seconds']:.3f} s")
    print(f"the one-card gkl2 exit: lambda {lam1}; spread {power_spread}; the profiled fused CLI: {cli_s:.2f} s, one trace of "
          f"{trace_mb:.1f} MiB naming {named}")
    for tag, what in (("gen1", f"gen {MULTIPLIER}x, the first {cap} swaps of the one start's pass (cap printed)"),
                      ("gen002", "gen 0.02x, the whole pass from a random split")):
        t = smega_ranks[tag]
        print(f"smega_refine across 2 ranks (K5R; {SMEGA_RANKS_LABEL}; {card}) on {what}: {t['swaps']} swaps, best "
              f"cut {t['best_cut']}, = K5 at S = 2 in one process bit for bit, on both ranks; {t['n_local']} nodes "
              f"per rank, layout {t['layout']!r}; device ms by rank {t['device_ms_by_rank']}, "
              f"{t['us_per_swap']:.1f} us per swap; e2e s by rank {t['e2e_s_by_rank']}; launches per rank "
              f"{t['launches_by_rank']}")
    print(f"K5R against the plain version across the 2 ranks on the card, {SMEGA_RANKS_PLAIN_CAP} swaps: bit for bit "
          f"on both ranks; plain ms by rank {smega_ranks['plain_ms_by_rank']}, K5R device ms by rank "
          f"{smega_ranks['plain_cap_device_ms_by_rank']}; bound {k5r_bound[0]:.4f} ms by {k5r_bound[1]} ({cap} swaps)")
    print(f"sharded phase: {summary['phase_s']:.1f} s")
    tmp_dir.cleanup()
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    from eig_kl_tpu_torch.graph.csr import CsrPlan, DeviceGraph
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import Hypergraph, read_hgr
    from eig_kl_tpu_torch.kl.megakernel import (
        K2,
        K2_F64,
        K2_STARTS,
        _batch_init,
        k2_selection,
        mega_spmv,
        fused_refine_mega,
        kl_pass_batch_cuda,
        kl_pass_batch_plain,
        kl_pass_cuda,
        kl_pass_plain,
    )
    from eig_kl_tpu_torch.kl.init import perturb_split, random_split
    from eig_kl_tpu_torch.models.generator import CircuitGenerator
    from eig_kl_tpu_torch.io.eigfile import read_eig_file, write_eig_file
    from eig_kl_tpu_torch.models.pipelines import PIPELINE_SPMV_ORDER, fused_partition, kl_partition, spectral_partition
    from eig_kl_tpu_torch.ops import _build
    from eig_kl_tpu_torch.ops.spmv import (
        K1,
        K1_F64,
        K1_LAPLACIAN,
        K1_LAPLACIAN_F64,
        K1_LAZY,
        K1_LAZY_F64,
        K1_RESCALE,
        K1_RESCALE_F64,
        K1_SPMM,
        K1_SPMM_F64,
        K1_STEP,
        K1_STEP_F64,
        K1_Z,
        K1_Z_F64,
        laplacian_cuda,
        laplacian_plain,
        lazy_rescale_cuda,
        lazy_rescale_plain,
        lazy_walk_cuda,
        lazy_walk_plain,
        lazy_z_cuda,
        lazy_z_plain,
        power_step_cuda,
        power_step_plain,
        row_ids,
        spmm_cuda,
        spmm_plain,
        spmv_csr,
        spmv_plain,
    )
    from eig_kl_tpu_torch.ops import spmv_v3 as V
    from eig_kl_tpu_torch.ops.select import K7, K7_F64, kth_smallest_cuda, kth_smallest_plain
    from eig_kl_tpu_torch.ops.spmv_plan import (
        K1_LAZY_V2,
        K1_LAZY_V2_BF16I,
        K1_V1,
        K1_V2,
        K1_V2_BF16I,
        K1_V2_FORMS,
        CooTail,
        V1Layout,
        V2Layout,
        lazy_walk_v2_plain,
        segment_ends,
        spmv_v1_cuda,
        spmv_v1_plain,
        spmv_v2_cuda,
        spmv_v2_plain,
        to_bf16,
        v2_kernel,
        v2_order,
    )
    from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
    from eig_kl_tpu_torch.ops import reduce as R
    from eig_kl_tpu_torch.ops.reduce import (
        K4,
        K4_F64,
        K6,
        K6_AXPY,
        K6_AXPY_F64,
        K6_F64,
        K6_SCALE,
        K6_SCALE_F64,
        K6_STEP,
        K4_FUSED,
        fma_dot_cuda,
        fma_dot_plain,
    )
    from eig_kl_tpu_torch.spectral.power import _power_core, power_operator, power_partition_fiedler
    from eig_kl_tpu_torch.parallel.smega import (
        K5,
        K5_CACHE_MIN_NODES,
        K5_LAYOUTS,
        K5_SHARED_BYTES,
        SmegaPlan,
        k5_layout,
        k5_shared_bytes,
        smega_pass_cuda,
        smega_pass_plain,
        smega_refine,
    )
    from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig
    from eig_kl_tpu_torch.utils.tracing import Tracer
    import tools.v1_mxu2_turns as turn_designs

    dev = torch.device("cuda")
    card = card_line()
    f32_kernels = (K1, K1_STEP, K1_LAPLACIAN, K1_SPMM, K1_LAZY, K2, V.K3A, V.K3B, V.K3C, K4, K5, K6,
                   K6_SCALE, K6_STEP, K6_AXPY, K1_V2, K1_V2_BF16I, K1_LAZY_V2, K1_LAZY_V2_BF16I, K4_FUSED,
                   K1_V1, K7, K1_RESCALE, K1_Z) + tuple(k for k in K1_V2_FORMS.values()
                                                        if k not in (K1_V2, K1_V2_BF16I, K1_LAZY_V2, K1_LAZY_V2_BF16I))
    f64_kernels = (K1_F64, K1_STEP_F64, K1_LAPLACIAN_F64, K1_SPMM_F64, K1_LAZY_F64, K2_F64, K4_F64,
                   K6_F64, K6_SCALE_F64, K6_AXPY_F64, K7_F64, K1_RESCALE_F64, K1_Z_F64)
    all_kernels = f32_kernels + f64_kernels

    def reset_counts():
        for kern in all_kernels:
            kern.launches = 0
        K2_STARTS.clear()

    def v3_launched():
        return [kern.symbol for kern in (V.K3A, V.K3B, V.K3C) if kern.launches]
    print(f"card: {card}")

    # Phase 1: build every kernel and the host library from the sources in
    # the checkout, one compiler per source, all at once.
    # The other designs of spmv_v1_f32 and the mxu2 forms, timed beside them
    # in phases 13 and 14, build alongside (tools/v1_mxu2_turns.py).
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        earlier = pool.submit(turn_designs.build)
        logs = _build.build(_build.KERNEL_SOURCES + _build.HOST_SOURCES)
        turn_libs = earlier.result()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s ({', '.join(logs) or 'cached'}; the earlier designs "
          f"{', '.join(turn_libs)})")

    def same_bits(a, b):
        view = torch.int32 if a.dtype == torch.float32 else torch.int64
        return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))

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
    check(torch.equal(bits32(y_k), bits32(y_p)), "K1 is not bitwise equal to spmv_plain")
    check(torch.equal(y_k, y_k2), "two K1 launches differ")
    k1_err = float(err.max())
    a_sparse = torch.sparse_csr_tensor(
        g.indptr.long(), g.indices.long(), g.data, size=(n, n), check_invariants=True
    )
    # K1 and torch.sparse by CUDA events, then each one's device time per launch.
    k1_ms = cuda_ms(lambda: spmv_csr(g, x), 200)
    k1_plain_ms = cuda_ms(lambda: spmv_plain(g, x), 5)
    k1_lib_ms = cuda_ms(lambda: a_sparse @ x, 200)
    k1_us = device_us_per_launch(lambda: [spmv_csr(g, x) for _ in range(50)], "spmv_csr_kernel")
    k1_lib_us = device_us_per_call(lambda: [a_sparse @ x for _ in range(50)], 50)
    k1_bytes = 4 * (g.indptr.numel() + 2 * nnz + 2 * n)
    k1_bound_ms = max(k1_bytes / HBM_BYTES_PER_S, 2 * nnz / F32_OPS_PER_S) * 1e3
    print(
        f"K1: bitwise equal to spmv_plain; {k1_ms:.4f} ms, plain {k1_plain_ms:.3f} ms, torch.sparse "
        f"{k1_lib_ms:.4f} ms, bound {k1_bound_ms:.4f} ms ({k1_bytes} bytes); device time per "
        f"launch: K1 {fmt_us(k1_us)}, torch.sparse "
        + ("not measured" if k1_lib_us is None else f"{k1_lib_us[0]:.2f} us in {k1_lib_us[1]:.1f} kernels per call")
    )
    # K1's power step entry point against power_step_plain at gen 1.0x.
    deg = torch.where(g.degrees > 0, g.degrees, 1.0)
    step_k = power_step_cuda(g, x, deg, 0.5)
    step_plain = power_step_plain(g, x, deg, 0.5)
    check(torch.equal(bits32(step_k), bits32(step_plain)), "K1's step differs from power_step_plain")
    check(torch.equal(bits32(step_k), bits32(power_step_cuda(g, x, deg, 0.5))), "two K1 step launches differ")
    step_third = power_step_cuda(g, x, deg, 1.0 / 3.0)
    step_third_plain = power_step_plain(g, x, deg, 1.0 / 3.0)
    check(torch.equal(bits32(step_third), bits32(step_third_plain)), "K1's step differs from power_step_plain at shift 3")
    k1s_err = max(float((step_k - step_plain).abs().max()), float((step_third - step_third_plain).abs().max()))
    k1s_ms = cuda_ms(lambda: power_step_cuda(g, x, deg, 0.5), 200)
    k1s_plain_ms = cuda_ms(lambda: power_step_plain(g, x, deg, 0.5), 5)
    k1s_us = device_us_per_launch(lambda: [power_step_cuda(g, x, deg, 0.5) for _ in range(50)], "power_step_kernel")

    def k1s_lib():  # torch.sparse's A @ x and the step's epilogue
        return x - 0.5 * (2.0 * x - 2.0 * (a_sparse @ x) / deg)

    k1s_lib_ms, k1s_lib_us = cuda_ms(k1s_lib, 200), library_device_us(k1s_lib)
    k1s_bytes = k1_bytes + 4 * n  # and deg; k1_bytes reads x once already
    k1s_bound_ms = max(k1s_bytes / HBM_BYTES_PER_S, (2 * nnz + 6 * n) / F32_OPS_PER_S) * 1e3
    print(
        f"K1 step: bitwise equal to power_step_plain (shift 2 and 3); {k1s_ms:.4f} ms, device "
        f"{fmt_us(k1s_us)} per launch, plain {k1s_plain_ms:.3f} ms, torch.sparse and the epilogue {k1s_lib_ms:.4f} "
        f"ms (device {fmt_us([k1s_lib_us])} per call), bound {k1s_bound_ms:.4f} ms ({k1s_bytes} bytes)"
    )

    # Phase 3b: K6 against its plain versions at the main path's shapes:
    # the 1-D norm, sum and dot over n, the 2-D norm over the v3 state.
    k6 = {}
    k6_err = 0.0
    for what, shape in (("1-D", (n,)), ("2-D", (-(-n // 1024) * 8, 128))):
        v = (torch.rand(shape, generator=gen) - 0.5).to(dev)
        v.view(-1)[::97] = -0.0
        w = (torch.rand(shape, generator=gen) - 0.5).to(dev)
        plain_sum = R.tree_sum_plain if what == "1-D" else R.tree_sum_2d_plain
        cases = {
            "norm": (lambda v=v: R.tree_sum_cuda(v, square=True, root=True),
                     lambda v=v, ps=plain_sum: R.sqrt_rn(R._products_plain(v, v, ps))),
            "sum": (lambda v=v: R.tree_sum_cuda(v), lambda v=v, ps=plain_sum: ps(v)),
            "dot": (lambda v=v, w=w: R.tree_sum_cuda(v, w), lambda v=v, w=w, ps=plain_sum: R._products_plain(v, w, ps)),
        }
        for case, (kern, plain) in cases.items():
            got = [kern() for _ in range(3)]
            ref = plain()
            for o in got:
                check(torch.equal(bits32(o), bits32(ref)), f"K6 {what} {case} differs from its plain version")
            k6_err = max(k6_err, float((got[0] - ref).abs()))
        numel = v.numel()
        norm_kern, norm_plain = cases["norm"]
        k6[what] = {
            "shape": list(shape),
            "ms": cuda_ms(norm_kern, 200),
            "sum_ms": cuda_ms(cases["sum"][0], 200),
            "dot_ms": cuda_ms(cases["dot"][0], 200),
            "plain_ms": cuda_ms(norm_plain, 3),
            "library_ms": cuda_ms(lambda v=v: torch.linalg.vector_norm(v), 200),
            "library_device_us": library_device_us(lambda v=v: torch.linalg.vector_norm(v)),
            "device_us": device_us_per_launch(lambda k=norm_kern: [k() for _ in range(50)], "tree_sum_kernel"),
            "bound_ms": 4 * numel / HBM_BYTES_PER_S * 1e3,
        }
        rounds = [list(r.windows) for r in R.reduce_rounds(tuple(shape))]
        print(
            f"K6 {what} over {tuple(shape)} (rounds {rounds}): norm, sum and dot bitwise equal "
            f"to the plain versions and over 3 launches; norm {k6[what]['ms']:.4f} ms (sum "
            f"{k6[what]['sum_ms']:.4f}, dot {k6[what]['dot_ms']:.4f}), device {fmt_us(k6[what]['device_us'])} "
            f"per launch, plain {k6[what]['plain_ms']:.3f} ms, torch.linalg.vector_norm (another order) "
            f"{k6[what]['library_ms']:.4f} ms, device {fmt_us([k6[what]['library_device_us']])} per call, bound "
            f"{k6[what]['bound_ms']:.5f} ms ({4 * numel} bytes)"
        )
    nrm = R.tree_norm(step_k)
    scaled = R.normalize_cuda(step_k, nrm)
    scaled_plain = R.normalize_plain(step_k, nrm)
    check(torch.equal(bits32(scaled), bits32(scaled_plain)), "K6's scale differs from normalize_plain")
    k6s_err = float((scaled - scaled_plain).abs().max())
    k6s_ms = cuda_ms(lambda: R.normalize_cuda(step_k, nrm), 200)
    k6s_plain_ms = cuda_ms(lambda: R.normalize_plain(step_k, nrm), 200)
    k6s_lib_ms = cuda_ms(lambda: step_k / nrm, 200)
    k6s_lib_us = library_device_us(lambda: step_k / nrm)
    k6s_us = device_us_per_launch(lambda: [R.normalize_cuda(step_k, nrm) for _ in range(50)], "scale_by_kernel")
    k6s_bound_ms = 8 * n / HBM_BYTES_PER_S * 1e3
    print(
        f"K6 scale: bitwise equal to normalize_plain; {k6s_ms:.4f} ms, device {fmt_us(k6s_us)} per launch, "
        f"plain {k6s_plain_ms:.4f} ms, y / nrm {k6s_lib_ms:.4f} ms (device {fmt_us([k6s_lib_us])} per call), "
        f"bound {k6s_bound_ms:.5f} ms ({8 * n} bytes)"
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
    it = it_random = int(out_k.scalars[2])
    check(int(out_p.scalars[2]) == it, "K2 and kl_pass_plain ran different iteration counts")
    check(torch.equal(out_k.log_a, out_p.log_a), "K2 log_a differs from kl_pass_plain")
    check(torch.equal(out_k.log_b, out_p.log_b), "K2 log_b differs from kl_pass_plain")
    check(torch.equal(out_k.sf, out_p.sf), "K2 final sf differs from kl_pass_plain")
    check(torch.equal(out_k.log_cut, out_p.log_cut), "K2 log_cut differs from kl_pass_plain")
    check(torch.equal(out_k.scalars, out_p.scalars), "K2 scalars differ from kl_pass_plain")
    k2_err = float((out_k.log_cut[: it + 1] - out_p.log_cut[: it + 1]).abs().max())
    k2_ms = min(k2_ms, cuda_ms(lambda: kl_pass_cuda(*args), 2))
    # The same pass with the row-max cache in its global-memory branch
    # (the wrapper takes it above about 3.5M nodes).
    one = torch.tensor([cut0], device=dev)
    cap_t = torch.tensor([cap], dtype=torch.int32, device=dev)
    g_args = (g, s[None], a_s[None], one, one, cap_t, torch.zeros_like(cap_t), cap + 1, args[5], 1e-6)
    out_g = kl_pass_batch_cuda(*g_args, _cache="global")
    check_same_pass(out_g.start(0), out_k, "K2 with its cache in global memory against K2")
    k2_global_ms = cuda_ms(lambda: kl_pass_batch_cuda(*g_args, _cache="global"), 2)
    k2_bound_ms, k2_bound_by, k2_bytes, k2_ops = k2_bound(g, swaps_of(out_k))
    print(
        f"K2: {it} swaps from a random split, logs and sf bitwise equal to the plain "
        f"version; {k2_ms:.3f} ms ({1e3 * k2_ms / max(it, 1):.3f} us/swap), plain "
        f"{k2_plain_ms:.1f} ms, bound {k2_bound_ms:.4f} ms by {k2_bound_by} "
        f"({k2_bytes} bytes, {k2_ops} operations); the cache in global memory: "
        f"bitwise equal, {k2_global_ms:.3f} ms ({1e3 * k2_global_ms / max(it, 1):.3f} us/swap)"
    )

    # K2's two selections on smaller circuits, in turns (flat, cache,
    # cache, flat): where the row-max cache starts to pay
    # (K2_CACHE_MIN_NODES).
    crossover, crossover_graphs = {}, {}
    for mult in (0.02, 0.05, 0.1, 0.25):
        c_hg = read_hgr(GEN_002) if mult == 0.02 else CircuitGenerator(mult, SEED).generate()
        crossover_graphs[mult] = clique_expand(c_hg, "kl")
        c_g = crossover_graphs[mult].to_device(dev)
        c_n = c_g.num_nodes
        c_sides = torch.as_tensor(random_split(c_n, SEED)).to(dev)
        c_s = sides_to_signs(c_sides, torch.float32)
        c_as, c_cut = _batch_init(c_g, c_s[None])
        c_n1 = int(c_sides.sum())
        c_cap = torch.tensor([min(c_n1, c_n - c_n1)], dtype=torch.int32, device=dev)
        c_args = (c_g, c_s[None], c_as, c_cut, c_cut, c_cap, torch.zeros_like(c_cap), int(c_cap) + 1,
                  KLConfig().terminate_limit(c_n), 1e-6)
        outs = {sel: kl_pass_batch_cuda(*c_args, _cache=sel) for sel in ("flat", "shared")}
        check_same_pass(outs["flat"], outs["shared"], f"K2's two selections at gen {mult}x")
        c_it = int(outs["flat"].scalars[0, 2])
        times = {"flat": [], "shared": []}
        for sel in ("flat", "shared", "shared", "flat"):
            times[sel].append(cuda_ms(lambda: kl_pass_batch_cuda(*c_args, _cache=sel), 5))
        crossover[c_n] = {sel: 1e3 * min(t) / c_it for sel, t in times.items()}
        print(
            f"K2 at gen {mult}x ({c_n} nodes, {c_it} swaps, the two selections bitwise equal): "
            f"flat scan {crossover[c_n]['flat']:.3f} us/swap, row-max cache "
            f"{crossover[c_n]['shared']:.3f} us/swap; the wrapper takes {k2_selection(c_n, c_g.row_width)}"
        )

    # Phase 4b: the batched K2 against kl_pass_batch_plain.  Four starts in
    # one launch, with caps that keep the plain version to some seconds: a
    # capped pass, a zero cap (no swap, scalars still written), a second
    # capped pass, and a re-entry with a best cut below the cut and a
    # termination count carried in.
    limit = KLConfig().terminate_limit(n)
    b_sides = torch.as_tensor(np.stack([random_split(n, SEED + i) for i in range(4)])).to(dev)
    b_s = sides_to_signs(b_sides, torch.float32)
    b_as, b_cut0 = _batch_init(g, b_s)
    b_best0 = b_cut0.clone()
    b_best0[3] = 1.0  # below any cut the pass reaches
    b_cap = torch.tensor([3000, 0, 2000, 1000], dtype=torch.int32, device=dev)
    b_term0 = torch.tensor([0, 0, 0, 7], dtype=torch.int32, device=dev)
    b_args = (g, b_s, b_as, b_cut0, b_best0, b_cap, b_term0, 3001, limit, 1e-6)
    out_b = kl_pass_batch_cuda(*b_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_bp = kl_pass_batch_plain(*b_args)
    torch.cuda.synchronize()
    kb_plain_ms = (time.perf_counter() - t0) * 1e3
    check_same_pass(out_b, out_bp, "batched K2 against kl_pass_batch_plain")
    b_its = out_b.scalars[:, 2].long().tolist()
    check(b_its == b_cap.tolist(), f"the capped starts ran {b_its} swaps")
    check(float(out_b.scalars[3, 1]) == float(b_best0[3]), "best0 below cut0 was not kept")
    kb_err = float((out_b.log_cut - out_bp.log_cut).abs().max())
    kb_ms = cuda_ms(lambda: kl_pass_batch_cuda(*b_args), 3)
    kb_bound_ms, kb_bound_by, kb_bytes, kb_ops = k2_bound(g, swaps_of(out_b))
    print(
        f"K2 batched: 4 starts, {b_its} swaps, sf, logs and scalars bitwise equal to the "
        f"plain version; {kb_ms:.3f} ms, plain {kb_plain_ms:.1f} ms, bound "
        f"{kb_bound_ms:.4f} ms by {kb_bound_by} ({kb_bytes} bytes, {kb_ops} operations)"
    )
    # The same four starts, full passes: one batched launch against four
    # single-start launches.
    full_cap = torch.tensor(
        [min(c, n - c) for c in b_sides.sum(dim=1, dtype=torch.int64).tolist()],
        dtype=torch.int32, device=dev,
    )
    zeros = torch.zeros_like(full_cap)
    log_len = int(full_cap.max()) + 1
    out_full = kl_pass_batch_cuda(g, b_s, b_as, b_cut0, b_cut0, full_cap, zeros, log_len, limit, 1e-6)
    for k in range(4):
        single = kl_pass_cuda(g, b_s[k], b_as[k], float(b_cut0[k]), int(full_cap[k]), limit, 1e-6)
        m = single.log_cut.shape[0]
        check(torch.equal(out_full.sf[k], single.sf), f"start {k}: sf differs from a single launch")
        check(torch.equal(out_full.scalars[k], single.scalars), f"start {k}: scalars differ from a single launch")
        for name in PASS_FIELDS[1:5]:
            log = getattr(out_full, name)[k]
            check(torch.equal(log[:m], getattr(single, name)), f"start {k}: {name} differs from a single launch")
            check(not bool(log[m:].any()), f"start {k}: {name} is not zero past its cap")
    torch.cuda.synchronize()
    print(
        "K2 batched: full passes of 4 starts "
        f"({out_full.scalars[:, 2].long().tolist()} swaps) bitwise equal to 4 single launches"
    )
    # Microseconds per swap of the slowest start against the number of
    # starts in the launch: the state is 8 B x n per start, and the card's
    # L2 holds 50 MB.
    sweep = {}
    for num in (1, 8, 32):
        w_sides = torch.as_tensor(np.stack([random_split(n, SEED + i) for i in range(num)])).to(dev)
        w_s = sides_to_signs(w_sides, torch.float32)
        w_as, w_cut0 = _batch_init(g, w_s)
        w_cap = torch.full((num,), 5000, dtype=torch.int32, device=dev)
        w_args = (g, w_s, w_as, w_cut0, w_cut0, w_cap, torch.zeros_like(w_cap), 5001, limit, 1e-6)
        w_out = kl_pass_batch_cuda(*w_args)
        w_ms = cuda_ms(lambda: kl_pass_batch_cuda(*w_args), 2)
        sweep[num] = 1e3 * w_ms / int(w_out.scalars[:, 2].max())
        print(
            f"K2 with {num} starts of 5,000 swaps each: {w_ms:.3f} ms, {sweep[num]:.3f} us per swap "
            f"of the slowest start, state {8 * n * num / 1e6:.1f} MB"
        )

    # Phase 5: the fused pipeline end to end, through the user's entry point.
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = fused_partition(hg, use_eig=True, device="cuda")
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    k1_launches, k2_launches = K1.launches, K2_STARTS[1]
    main_launches = {kern.symbol: kern.launches for kern in all_kernels}
    check(K2.launches == k2_launches, "the one-start run launched K2 with several starts")
    check(not v3_launched(), f"the main path launched {v3_launched()}")
    kl = run.kl
    iters = run.spectral_iterations
    # K1: the Rayleigh quotient's L x, the pass's A @ s and its recount;
    # K1's step, K6's norm and K6's scale once per power step; K6 also for
    # the two cuts' two sums; K4 for the Rayleigh quotient (XLA's vector
    # dot above 4,096 values, ROADMAP.md C9).
    check(k1_launches == 3, f"K1 launched {k1_launches} times, not 3")
    check(K1_STEP.launches == iters, f"K1's step launched {K1_STEP.launches} times for {iters} power steps")
    check(K6.launches == iters + 4, f"K6 launched {K6.launches} times for {iters} power steps")
    check(K4.launches == 1 and K4_FUSED.launches == 0, f"K4 launched {K4.launches} times, not once")
    check(K6_SCALE.launches == iters, f"K6's scale launched {K6_SCALE.launches} times for {iters} power steps")
    check(k2_launches == 1, f"K2 launched {k2_launches} times, not once")
    # K7 for every median (the sign checks' and the split's); the pipelines
    # take the ELL order of A @ s, not the v1 kernel's.
    check(K7.launches > 0 and K1_V1.launches == 0, f"K7 launched {K7.launches} times, K1's v1 {K1_V1.launches}")
    check(
        (iters, kl.iterations) == (MAIN_ITERS, MAIN_SWAPS) and abs(kl.best_cut - MAIN_BEST) < 0.005,
        f"the one-start run: {iters} power iterations, {kl.iterations} swaps, best cut "
        f"{kl.best_cut}, not {MAIN_ITERS}, {MAIN_SWAPS}, {MAIN_BEST}",
    )
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
    recount = host_cut(g_host, best)
    check(
        abs(recount - kl.best_cut) <= 1e-4 * kl.best_cut,
        f"best cut {kl.best_cut} disagrees with the host f64 recount {recount}",
    )
    print(
        f"fused gen {MULTIPLIER}x: {iters} power iterations, initial cut {kl.initial_cut}, "
        f"best cut {kl.best_cut} after {kl.iterations} swaps, final {kl.final_cut}, "
        f"verified {kl.verified_cut} (drift {drift:.3g}), host f64 recount of the best "
        f"partition {recount:.4f}; e2e {e2e_s:.3f} s on {card}; spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(run.timings.items()))
    )
    print(f"launches on the main path: {main_launches}")
    # Each node is swapped at most once, so the swapped nodes are those
    # whose side the pass changed.
    moved = torch.as_tensor(np.flatnonzero(np.asarray(kl.sides) != np.asarray(run.eig.sides)))
    main_ms, main_by, main_bytes, main_ops = k2_bound(g, [(kl.iterations, moved.to(dev))])
    print(
        f"K2 on the main path: {kl.iterations} swaps, bound {main_ms:.4f} ms by {main_by} "
        f"({main_bytes} bytes, {main_ops} operations)"
    )

    # Phase 5b: K7 (the exact rank select) against its plain version at the
    # main path's sizes: gen 1.0x's n (the run's own Fiedler vector in f32),
    # its largest component's and gen 0.02x's, in f32 and f64; device time
    # per call beside torch.kthvalue's in this call.
    k7 = {}
    rng = np.random.default_rng(SEED)
    for size in (n, LCC_COUNTS[0], 4038):
        for dt in (torch.float32, torch.float64):
            if size == n and dt == torch.float32:
                vec = torch.as_tensor(np.asarray(run.eig.values, np.float32)).to(dev)
            else:
                vec = torch.as_tensor(rng.standard_normal(size)).to(dt).to(dev)
            kb = torch.int32 if dt == torch.float32 else torch.int64
            for rank in (0, size // 2, size - 1):
                got = kth_smallest_cuda(vec, rank)
                check(torch.equal(got.cpu().view(kb), kth_smallest_plain(vec.cpu(), rank).view(kb)),
                      f"K7 differs from its plain version at n {size}, rank {rank}, {dt}")
                check(float(got) == float(torch.sort(vec).values[rank]), f"K7 is not the sorted element ({size}, {rank})")
            k = size // 2
            size_b = vec.element_size()
            tag = f"{size} {'f32' if dt == torch.float32 else 'f64'}"
            k7[tag] = {
                "ms": cuda_ms(lambda: kth_smallest_cuda(vec, k), 50),
                "plain_ms": cuda_ms(lambda: kth_smallest_plain(vec, k), 2),
                "library_ms": cuda_ms(lambda: torch.kthvalue(vec, k + 1), 20),
                "device_us": device_us_per_launch(lambda: [kth_smallest_cuda(vec, k) for _ in range(20)], "kth_small"),
                "library_device_us": library_device_us(lambda: torch.kthvalue(vec, k + 1), 10),
                "bound_ms": (size * size_b + size_b) / HBM_BYTES_PER_S * 1e3,
            }
            e = k7[tag]
            print(f"K7 at {tag}: bitwise equal to its plain version at ranks 0, n/2, n-1; {e['ms']:.4f} ms, device "
                  f"{fmt_us(e['device_us'])} per launch; torch.kthvalue {e['library_ms']:.4f} ms, device "
                  f"{fmt_us([e['library_device_us']])} per call; plain {e['plain_ms']:.3f} ms; bound "
                  f"{e['bound_ms'] * 1e3:.3f} us")
    print(f"K7 launches on the main path: {main_launches['kth_smallest_f32']}")

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
    profiled = report_device_busy("the fused run", lambda: fused_partition(hg, use_eig=True, device="cuda"))
    check(bool(profiled), "the profiler recorded no kernels on the main path")
    check(not any("kthvalue" in name for name in profiled), "torch.kthvalue ran on the main path")
    check(any("kth_small" in name for name in profiled), "the profile shows no K7 on the main path")
    print("main path's profile: K7 present, no kthvalue kernel")
    # The power solve's device launches: 25 bare steps, then the whole
    # solve with its sign checks, each under the profiler.
    op = power_operator(g, 2.0, torch.float32)
    px = op.step(op.to_state(x))[0]
    step_calls = device_us_per_call(lambda: [op.step(px) for _ in range(25)], 25)
    config = SpectralConfig(solver="power")
    solve_calls = device_us_per_call(
        lambda: _power_core(g, shift=config.shift, tolerance=config.tolerance, min_iters=config.min_power_iters,
                            max_iters=config.max_iterations, seed=config.seed, dtype=torch.float32,
                            convergence=config.convergence, check_interval=config.check_interval,
                            stable_checks=config.stable_checks), iters)
    check(step_calls is not None and step_calls[1] <= 4, f"a power step made {step_calls} (us, kernels) on the card")
    steps_launches = {
        "per_step": step_calls[1], "device_us_per_step": step_calls[0],
        "per_step_in_the_solve": None if solve_calls is None else solve_calls[1],
        "device_us_per_step_in_the_solve": None if solve_calls is None else solve_calls[0],
    }
    print(
        f"power solve: {step_calls[1]:.2f} kernels and {step_calls[0]:.2f} us of device time per bare step; "
        "the whole solve (sign checks included): "
        + ("not measured" if solve_calls is None else f"{solve_calls[1]:.2f} kernels and {solve_calls[0]:.2f} us per step")
    )

    # Phase 7: the multi-start path through the user's entry point: 8
    # spectral-seeded starts per batched launch, passes until converged,
    # kicks around the winner.
    multi_config = KLConfig(gain_eps=1e-6, passes=0, kicks=KICKS)

    def multi_run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fused_partition(
            hg, use_eig=True, starts=STARTS, perturb=PERTURB, kl_config=multi_config, device="cuda"
        )
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    reset_counts()
    multi, multi_s = multi_run()
    check(not v3_launched(), f"the multi-start path launched {v3_launched()}")
    m_k1, m_batched, m_single = K1.launches, K2_STARTS[STARTS], K2_STARTS[1]
    mkl = multi.kl
    check(K2.launches == m_batched + m_single, f"K2 launches by starts: {dict(K2_STARTS)}")
    check(2 <= m_batched <= 16, f"the batched K2 launched {m_batched} times, not once per pass of 2 to 16")
    check(KICKS <= m_single <= 16 * KICKS, f"the one-start K2 launched {m_single} times for {KICKS} kicks")
    # Each pass launches K1 for its initial A@s and for its recount, once
    # per start; the power solve launches K1's step once per step and K1
    # once, for the Rayleigh quotient.
    m_launches = {kern.symbol: kern.launches for kern in all_kernels}
    check(
        m_k1 == 1 + 2 * STARTS * m_batched + 2 * m_single,
        f"K1 launched {m_k1} times for {m_batched} batch passes and {m_single} kick passes",
    )
    check(K1_STEP.launches == multi.spectral_iterations, f"K1's step launched {K1_STEP.launches} times")
    check(K6.launches > multi.spectral_iterations and K6_SCALE.launches == multi.spectral_iterations,
          f"K6 launched {K6.launches} times, its scale {K6_SCALE.launches}")
    check(multi.spectral_iterations == iters, "the multi-start run took another number of power steps")
    check(np.array_equal(multi.eig.sides, run.eig.sides), "the multi-start run split otherwise")
    check(len(multi.start_cuts) == STARTS, "no best cut per start")
    # Start 0 is the unperturbed split: its first pass is the one-start run.
    check(
        mkl.best_cut <= min(multi.start_cuts) <= multi.start_cuts[0] <= kl.best_cut,
        f"best cut {mkl.best_cut}, per start {multi.start_cuts}, one start {kl.best_cut}",
    )
    check(abs(mkl.best_cut - MULTI_BEST) < 0.005, f"multi-start best cut {mkl.best_cut}, not {MULTI_BEST}")
    m_drift = abs(mkl.final_cut - mkl.verified_cut) / mkl.final_cut
    check(m_drift <= 1e-5, f"cut drift of the last pass {m_drift:.3g} above 1e-5")
    m_best = np.asarray(mkl.best_sides)
    check(
        m_best.shape == (n,) and int(m_best.sum()) == int(np.asarray(multi.eig.sides).sum()),
        "the multi-start best partition does not keep the spectral split's balance",
    )
    m_recount = host_cut(g_host, m_best)
    check(
        abs(m_recount - mkl.best_cut) <= 1e-4 * mkl.best_cut,
        f"best cut {mkl.best_cut} disagrees with the host f64 recount {m_recount}",
    )
    multi2, multi2_s = multi_run()
    check(multi2.kl.best_cut == mkl.best_cut, "a repeated multi-start run gave another best cut")
    check(multi2.start_cuts == multi.start_cuts, "a repeated multi-start run gave other per-start cuts")
    print(
        f"multi-start gen {MULTIPLIER}x ({STARTS} starts, perturb {PERTURB}, passes until "
        f"converged, {KICKS} kicks): per-start best cuts "
        f"{[round(c, 2) for c in multi.start_cuts]}, {m_batched} batch passes, {m_single} kick "
        f"passes, best cut {mkl.best_cut} (one start: {kl.best_cut}), winner's swaps "
        f"{mkl.iterations}, final {mkl.final_cut}, verified {mkl.verified_cut} (drift "
        f"{m_drift:.3g}), host f64 recount {m_recount:.4f}; e2e {multi_s:.3f} s and "
        f"{multi2_s:.3f} s on {card}; spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(multi.timings.items()))
    )
    print(f"launches on the multi-start path: {m_launches}, K2 batched {m_batched}, K2 one start {m_single}")
    report_device_busy("the multi-start run", multi_run)
    # The launch of that path's first pass, alone: its 8 starts from the
    # spectral split and its jitters.
    base = np.asarray(multi.eig.sides, dtype=np.int8)
    p_sides = torch.as_tensor(
        np.stack([base] + [perturb_split(base, 1 + i, PERTURB) for i in range(STARTS - 1)])
    ).to(dev)
    p_s = sides_to_signs(p_sides, torch.float32)
    p_as, p_cut0 = _batch_init(g, p_s, matvec=mega_spmv(g, PIPELINE_SPMV_ORDER))  # the pipelines' order
    p_cap = torch.tensor(
        [min(c, n - c) for c in p_sides.sum(dim=1, dtype=torch.int64).tolist()],
        dtype=torch.int32, device=dev,
    )
    p_args = (g, p_s, p_as, p_cut0, p_cut0, p_cap, torch.zeros_like(p_cap), int(p_cap.max()) + 1, limit, 1e-6)
    p_out = kl_pass_batch_cuda(*p_args)
    p_ms = cuda_ms(lambda: kl_pass_batch_cuda(*p_args), 2)
    p_its = p_out.scalars[:, 2].long().tolist()
    check(p_its[0] == kl.iterations, "start 0's first pass is not the one-start run's pass")
    p_bound_ms, p_bound_by, p_bytes, p_ops = k2_bound(g, swaps_of(p_out))
    print(
        f"K2 batched, the first pass of the multi-start path: {p_its} swaps, {p_ms:.3f} ms "
        f"({1e3 * p_ms / max(p_its):.3f} us per swap of the longest start), bound "
        f"{p_bound_ms:.4f} ms by {p_bound_by} ({p_bytes} bytes, {p_ops} operations)"
    )

    # Phase 8: the v3 path.  The same circuit's graph built by the native
    # host library against the NumPy build, the v3 plan attached to the
    # device graph, K3a/K3b/K3c against their plain versions at its
    # shapes, then the fused pipeline on the v3-planned graph.
    t0 = time.perf_counter()
    g_nat = clique_expand(hg, "kl", use_native=True)
    nat_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_np = clique_expand(hg, "kl", use_native=False)
    np_s = time.perf_counter() - t0
    for name in ("indptr", "indices", "data"):
        a, b = getattr(g_nat, name), getattr(g_np, name)
        check(a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)),
              f"native and NumPy expansions differ in {name}")
    print(f"graph build: native expansion {nat_s:.3f} s, NumPy {np_s:.3f} s, arrays equal")
    t0 = time.perf_counter()
    plan = V.build_plan_v3_for_graph(g_host, dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    N, P, C = plan.padded_nnz, plan.padded_nodes, plan.num_chunks
    stages = len(V.benes_distances(N))
    groups = V.benes_groups(N)
    print(
        f"v3 plan: N {N} slots, {stages} Benes stages in {len(groups)} K3b launches "
        f"({[(gr.first, gr.last, gr.run) for gr in groups]}: first, last stage, run), {C} chunks, "
        f"P {P}; host build {plan_s:.3f} s"
    )
    g3 = dataclasses.replace(g, plan=plan)

    xp = torch.zeros(P, device=dev)
    xp[:n] = x

    def bits(t):
        return t.view(torch.int32)

    def held(kernel, plain, first, arg, what):
        """The kernel's output, checked bitwise (zero signs included)
        against its plain version and a second launch; with its max |diff|."""
        out, ref = kernel(first, arg), plain(first, arg)
        check(torch.equal(bits(out), bits(ref)), f"{what} differs from its plain version")
        check(torch.equal(bits(out), bits(kernel(first, arg))), f"two {what} launches differ")
        return out, float((out - ref).abs().max())

    e_k, k3a_err = held(V.gather_v3_cuda, V.gather_v3_plain, plan, xp, "K3a")
    b_k, k3b_err = held(V.benes_v3_cuda, V.benes_v3_plain, plan.masks, e_k, "K3b")
    _, k3c_err = held(V.reduce_v3_cuda, V.reduce_v3_plain, plan, b_k, "K3c")

    def v3_plain(_, arg):
        return V.reduce_v3_plain(plan, V.benes_v3_plain(plan.masks, V.gather_v3_plain(plan, arg)))

    y3p, v3_self_err = held(lambda _, arg: V.spmv_v3_padded(plan, arg), v3_plain, None, xp, "the v3 SpMV")
    # K4, the power solve's Rayleigh quotient over the padded state.
    k4_x, k4_y = xp, y3p
    k4, k4_err = held(fma_dot_cuda, fma_dot_plain, k4_x, k4_y, "K4")
    # K3b with tiles of 2^13 slots (two blocks per SM) against the
    # default 2^14 (one).
    b_k13 = V.benes_v3_cuda(plan.masks, e_k, _tile=1 << 13)
    check(torch.equal(bits(b_k13), bits(b_k)), "K3b with tiles of 2^13 differs")
    # One v3 SpMV is K3a, K3b's groups and K3c: at most 5 launches.
    reset_counts()
    y3 = V.spmv_v3(plan, x)
    per_spmv = V.K3A.launches + V.K3B.launches + V.K3C.launches
    check(per_spmv == 2 + len(groups) <= 5, f"one v3 SpMV made {per_spmv} launches")
    v3_err = (y3.double() - y_k.double()).abs()
    check(bool((v3_err <= 1e-5 * a_abs).all()), "the v3 SpMV disagrees with K1 beyond 1e-5*(|A||x|)")
    torch.cuda.synchronize()
    k3a_ms = cuda_ms(lambda: V.gather_v3_cuda(plan, xp), 200)
    # The two tiles in turns: default, 2^13, 2^13, default.
    k3b_ms = cuda_ms(lambda: V.benes_v3_cuda(plan.masks, e_k), 200)
    k3b13_ms = cuda_ms(lambda: V.benes_v3_cuda(plan.masks, e_k, _tile=1 << 13), 200)
    k3b13_ms = min(k3b13_ms, cuda_ms(lambda: V.benes_v3_cuda(plan.masks, e_k, _tile=1 << 13), 200))
    k3b_ms = min(k3b_ms, cuda_ms(lambda: V.benes_v3_cuda(plan.masks, e_k), 200))
    k3c_ms = cuda_ms(lambda: V.reduce_v3_cuda(plan, b_k), 200)
    v3_ms = cuda_ms(lambda: V.spmv_v3(plan, x), 200)
    k3a_plain_ms = cuda_ms(lambda: V.gather_v3_plain(plan, xp), 5)
    k3b_plain_ms = cuda_ms(lambda: V.benes_v3_plain(plan.masks, e_k), 5)
    k3c_plain_ms = cuda_ms(lambda: V.reduce_v3_plain(plan, b_k), 5)
    v3_plain_ms = cuda_ms(lambda: v3_plain(None, xp), 3)
    v3_lib_ms = cuda_ms(lambda: a_sparse @ x, 200)
    k4_ms = cuda_ms(lambda: fma_dot_cuda(k4_x, k4_y), 20)
    k4_plain_ms = cuda_ms(lambda: fma_dot_plain(k4_x, k4_y), 3)
    k4_lib_ms = cuda_ms(lambda: torch.dot(k4_x, k4_y), 200)
    k4_lib_us = library_device_us(lambda: torch.dot(k4_x, k4_y))
    # K4's batch at 1 to 4 pairs of the padded state's length.
    k4_xs = [k4_x] + [(torch.rand(P, generator=gen) - 0.5).to(dev) for _ in range(3)]
    k4_ys = [k4_y] + [(torch.rand(P, generator=gen) - 0.5).to(dev) for _ in range(3)]
    k4_batch = k4_batches(k4_xs, k4_ys, [k4] + [fma_dot_plain(a, b) for a, b in zip(k4_xs[1:], k4_ys[1:])], "K4")
    # Least bytes each kernel must move, each input read once and each
    # output written once.  K3a: cw8 (4C), col_local (2N), weights (4N),
    # x (4P) in, e (4N) out.  K3b, the whole network: e (4N) and one row
    # of switch bits per stage (N/8 each) in, e (4N) out.  K3c: rw8 (4C),
    # row_local (2N), route_src (2 x 1024 per chunk = 4N), e (4N) in, y
    # (4P) out.  Their flops (N multiplies, 9N adds) take far less time.
    # The whole v3 SpMV: x and the plan in, y out; the products between
    # its kernels need not reach memory.  K4: x and y (4P each) in, one
    # float out; its P fused multiply-adds take far less time at the
    # card's rate (the chain's latency is what K4 pays).
    # No PyTorch call computes K3a, K3b or K3c alone, so their library_ms
    # is null; torch.sparse's y = A @ x computes the function of the whole
    # v3 SpMV and is that entry's library_ms.  torch.dot is K4's.
    k3a_bytes = 4 * C + 2 * N + 4 * N + 4 * P + 4 * N
    k3b_bytes = 4 * N + stages * N // 8 + 4 * N
    k3c_bytes = 4 * C + 2 * N + 2 * 1024 * C + 4 * N + 4 * P
    v3_bytes = 4 * C + 2 * N + 4 * N + 4 * P + stages * N // 8 + 4 * C + 2 * N + 2 * 1024 * C + 4 * P
    k4_bytes = 8 * P + 4
    k3a_bound, k3b_bound, k3c_bound, v3_bound, k4_bound = (
        b / HBM_BYTES_PER_S * 1e3 for b in (k3a_bytes, k3b_bytes, k3c_bytes, v3_bytes, k4_bytes)
    )
    print(
        f"K3a/K3b/K3c bitwise equal to their plain versions and to a second launch; v3 SpMV "
        f"against K1: max |diff| {float(v3_err.max()):.3g}; K3a {k3a_ms:.4f} ms (plain "
        f"{k3a_plain_ms:.3f}, bound {k3a_bound:.4f}, {k3a_bytes} bytes), K3b {k3b_ms:.4f} ms "
        f"for {stages} stages in {len(groups)} launches (tiles of {V.BENES_TILE}; of 2^13: {k3b13_ms:.4f} ms, "
        f"bitwise equal; plain {k3b_plain_ms:.3f}, bound {k3b_bound:.4f}, {k3b_bytes} "
        f"bytes), K3c {k3c_ms:.4f} ms (plain {k3c_plain_ms:.3f}, bound {k3c_bound:.4f}, "
        f"{k3c_bytes} bytes); whole v3 SpMV {v3_ms:.4f} ms (plain {v3_plain_ms:.3f}, bound "
        f"{v3_bound:.4f}, {v3_bytes} bytes), torch.sparse {v3_lib_ms:.4f} ms, K1 {k1_ms:.4f} ms"
    )
    print(
        f"K4 over P = {P}: {float(k4)!r} bitwise equal to the host chain and to a second launch; "
        f"{k4_ms:.4f} ms (plain {k4_plain_ms:.3f}, bound {k4_bound:.5f}, {k4_bytes} bytes), "
        f"torch.dot {k4_lib_ms:.4f} ms (device {fmt_us([k4_lib_us])} per call); batches of 1-4 pairs bitwise "
        f"the host chains, device {fmt_us([k4_batch['device_us_one_dot']])} per launch of one dot, "
        f"{fmt_us([k4_batch['device_us_two_dots']])} of two"
    )

    # The same SpMV under the profiler: each kernel's device time per
    # launch, apart from the host's time to issue the launches; then each
    # K3b group's device time per launch.
    report_device_busy("20 v3 SpMVs", lambda: [V.spmv_v3(plan, x) for _ in range(20)])
    k3b_group_us = {}
    for tile in (V.BENES_TILE, 1 << 13):
        tile_groups = V.benes_groups(N, tile)
        us = device_us_per_launch(
            lambda: [V.benes_v3_cuda(plan.masks, e_k, _tile=tile) for _ in range(20)], "benes_group",
            len(tile_groups),
        )
        k3b_group_us[tile] = us
        if us is None:
            print(f"K3b groups, tiles of {tile}: the profiler recorded no K3b kernel: not measured")
            continue
        print(
            f"K3b device time per launch, tiles of {tile}, by group (first, last stage, run): "
            + ", ".join(f"{(gr.first, gr.last, gr.run)} {t:.2f} us" for gr, t in zip(tile_groups, us))
            + f"; sum {sum(us):.2f} us"
        )

    # K3c's device time per launch, apart from the host's launch overhead:
    # inside whole v3 SpMVs (after K3b, as on the v3 path) and alone, back
    # to back on one input.
    k3c_us = {}
    for where, fn in (("in the v3 SpMV", lambda: [V.spmv_v3(plan, x) for _ in range(20)]),
                      ("alone", lambda: [V.reduce_v3_cuda(plan, b_k) for _ in range(20)])):
        us = device_us_per_launch(fn, "reduce_v3")
        k3c_us[where] = None if us is None else us[0]
    print(
        "K3c device time per launch: "
        + ", ".join(
            f"{where} " + ("not measured (the profiler recorded no K3c kernel)" if us is None else f"{us:.2f} us")
            for where, us in k3c_us.items()
        )
        + f" (bound {1e3 * k3c_bound:.2f} us)"
    )

    def v3_run():
        tracer = Tracer(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fused_refine_mega(g3, SpectralConfig(solver="power"), KLConfig(gain_eps=1e-6), tracer=tracer)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, tracer.spans

    reset_counts()
    (v3_eig, v3_kl, v3_iters), v3_s, v3_spans = v3_run()
    k4_launches = K4.launches
    v3_launches = {k: kern.launches for k, kern in (("K3a", V.K3A), ("K3b", V.K3B), ("K3c", V.K3C))}
    v3_spmvs = v3_launches["K3a"]
    v3_all = {kern.symbol: kern.launches for kern in all_kernels}
    check(K1.launches == 0 and K1_STEP.launches == 0, f"K1 launched on the v3 path: {v3_all}")
    # The 2-D norm is one K6 launch per power step; K6 also adds the two
    # cuts' two sums.
    check(K6.launches == v3_iters + 4 and K6_SCALE.launches == v3_iters, f"K6 on the v3 path: {v3_all}")
    check(K6_STEP.launches == v3_iters, f"K6's padded step on the v3 path: {v3_all}")
    check(K2.launches == 1, f"K2 launched {K2.launches} times on the v3 path, not once")
    check(v3_launches["K3c"] == v3_spmvs, f"v3 launches {v3_launches}: K3c not once per SpMV")
    check(
        v3_launches["K3b"] == len(groups) * v3_spmvs,
        f"v3 launches {v3_launches}: K3b not {len(groups)} per SpMV",
    )
    check(v3_spmvs >= v3_iters + 2, f"{v3_spmvs} v3 SpMVs for {v3_iters} power steps")
    check(k4_launches == 1, f"K4 launched {k4_launches} times on the v3 path, not once")
    check(
        v3_iters == V3_ITERS and abs(v3_kl.best_cut - V3_BEST) < 0.005,
        f"v3 path: {v3_iters} power iterations, best cut {v3_kl.best_cut}, not {V3_ITERS}, {V3_BEST}",
    )
    v3_drift = abs(v3_kl.final_cut - v3_kl.verified_cut) / v3_kl.final_cut
    check(v3_drift <= 1e-5, f"v3 path: cut drift {v3_drift:.3g} above 1e-5")
    check(v3_kl.best_cut <= v3_kl.initial_cut, "v3 path: best cut above the initial cut")
    check(v3_kl.best_cut <= 1.03 * JAX_CPU_BEST_CUT, f"v3 path: best cut {v3_kl.best_cut} above 1.03 x {JAX_CPU_BEST_CUT}")
    v3_best = np.asarray(v3_kl.best_sides)
    check(
        v3_best.shape == (n,) and int(v3_best.sum()) == int(np.asarray(v3_eig.sides).sum()),
        "v3 path: best partition does not keep the spectral split's balance",
    )
    v3_recount = host_cut(g_host, v3_best)
    check(
        abs(v3_recount - v3_kl.best_cut) <= 1e-4 * v3_kl.best_cut,
        f"v3 path: best cut {v3_kl.best_cut} disagrees with the host f64 recount {v3_recount}",
    )
    (_, v3_kl2, _), v3_s2, _ = v3_run()
    check(v3_kl2.best_cut == v3_kl.best_cut, "a repeated v3 run gave another best cut")
    print(
        f"v3 path (fused_refine_mega on the v3-planned graph): {v3_iters} power iterations, "
        f"lambda {v3_eig.eigenvalue!r}, initial cut {v3_kl.initial_cut}, best cut "
        f"{v3_kl.best_cut} after {v3_kl.iterations} swaps, final {v3_kl.final_cut}, verified "
        f"{v3_kl.verified_cut} (drift {v3_drift:.3g}), host f64 recount {v3_recount:.4f}; e2e "
        f"{v3_s:.3f} s and {v3_s2:.3f} s on {card}; spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(v3_spans.items()))
    )
    print(f"launches on the v3 path: {v3_spmvs} SpMVs, {v3_all}")

    # Phase 9: the sharded KL pass (smega_refine, K5) at S = 1, 2, 4, 8
    # shards, one thread-block cluster of S blocks, from the one-start
    # run's spectral split.  The plans are built and uploaded outside the
    # clock, as a caller reuses one per graph.
    t_phase = time.perf_counter()
    sm_sides = np.asarray(run.eig.sides, dtype=np.int8)
    sm_config = KLConfig(gain_eps=1e-6)
    plans, plan_s = {}, {}
    for shards in SHARDS:
        t0 = time.perf_counter()
        plans[shards] = SmegaPlan(g_host, shards)
        plan_s[shards] = time.perf_counter() - t0
        plans[shards].device_graph(dev)
    torch.cuda.synchronize()

    reset_counts()
    sm, sm_s = {}, {}
    for shards in SHARDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm[shards] = smega_refine(g_host, sm_sides, shards, sm_config, plan=plans[shards])
        torch.cuda.synchronize()
        sm_s[shards] = time.perf_counter() - t0
    k5_launches, sm_k1 = K5.launches, K1.launches
    check(k5_launches == len(SHARDS), f"K5 launched {k5_launches} times for {len(SHARDS)} smega runs")
    check(sm_k1 == len(SHARDS), f"K1 launched {sm_k1} times for {len(SHARDS)} smega runs")
    check(K2.launches == 0 and not v3_launched(), "the smega path launched K2 or a v3 kernel")
    # (a) One trajectory at every shard count; (d) drift and best <= initial.
    for shards in SHARDS:
        r = sm[shards]
        for name in ("iterations", "initial_cut", "final_cut", "best_cut", "verified_cut"):
            check(getattr(r, name) == getattr(sm[1], name), f"smega at S = {shards}: {name} differs from S = 1")
        for name in ("sides", "best_sides", "cut_trajectory", "gain_trajectory"):
            check(np.array_equal(getattr(r, name), getattr(sm[1], name)),
                  f"smega at S = {shards}: {name} differs from S = 1")
        sm_drift = abs(r.final_cut - r.verified_cut) / r.final_cut
        check(sm_drift <= 1e-5, f"smega at S = {shards}: cut drift {sm_drift:.3g} above 1e-5")
        check(r.best_cut <= r.initial_cut, f"smega at S = {shards}: best cut above the initial cut")

    # The pass alone: K5 at each S against K2 from the same split and A@s.
    n1 = int(sm_sides.sum())
    cap = min(n1, n - n1)
    s = sides_to_signs(torch.as_tensor(sm_sides).to(dev), torch.float32)
    a_s = spmv_csr(g, s)
    cut_tree = float(cut_size(g, s, a_s))
    k2_args = (g, s, a_s, cut_tree, cap, limit, 1e-6)
    k2_main = kl_pass_cuda(*k2_args)
    k2_main_ms = cuda_ms(lambda: kl_pass_cuda(*k2_args), 2)
    it = int(k2_main.scalars[2])
    check(it == sm[1].iterations == kl.iterations, "K2's and K5's passes ran different iteration counts")
    cut_host = sm[1].initial_cut

    def k5_args(shards, num_swaps, log_len):
        n_pad = plans[shards].n_pad
        sf0 = torch.zeros(n_pad, device=dev)
        as0 = torch.zeros(n_pad, device=dev)
        sf0[:n], as0[:n] = s, a_s
        return (plans[shards].device_graph(dev), shards, sf0, as0, cut_host, num_swaps, n - n1, n1, log_len, limit, 1e-6)

    # K5 in every layout that fits a shard (the wrapper's choice among
    # them) at every S: the whole pass bitwise equal across layouts and to
    # K2's swaps, timed in turns (forward, then backward).
    def fitting(n_local):
        return [lay for lay in K5_LAYOUTS if k5_shared_bytes(n_local, lay) <= K5_SHARED_BYTES]

    sm_layout = {shards: k5_layout(plans[shards].n_local, shards) for shards in SHARDS}
    sm_ms, sm_ms_layout = {}, {}
    # K5 computes K2's function: the same swaps have the same least time.
    sm_moved = torch.as_tensor(np.flatnonzero(sm[1].sides != sm_sides)).to(dev)
    sm_bound = k2_bound(g, [(it, sm_moved)])
    for shards in SHARDS:
        args = k5_args(shards, cap, cap + 1)
        layouts = fitting(plans[shards].n_local)
        first = None
        for lay in layouts:
            out = smega_pass_cuda(*args, _layout=lay)
            check(int(out.scalars[2]) == it, f"K5 at S = {shards} ({lay}) ran {int(out.scalars[2])} swaps, K2 {it}")
            # (b) K2's swaps and gains; the cut log starts from another cut0.
            for name in ("log_a", "log_b", "log_gain"):
                check(torch.equal(getattr(out, name)[: it + 1], getattr(k2_main, name)[: it + 1]),
                      f"K5 at S = {shards} ({lay}): {name} differs from K2's")
            check(torch.equal(out.sf[:n], k2_main.sf), f"K5 at S = {shards} ({lay}): final sf differs from K2's")
            if first is None:
                first = out
            check_same_pass(out, first, f"K5 at S = {shards}: {lay} against {layouts[0]}")
        times = {lay: [] for lay in layouts}
        for lay in layouts + layouts[::-1]:
            times[lay].append(cuda_ms(lambda: smega_pass_cuda(*args, _layout=lay), 2))
        sm_ms_layout[shards] = {lay: min(t) for lay, t in times.items()}
        sm_ms[shards] = sm_ms_layout[shards][sm_layout[shards]]
    cut_gap = abs(cut_host - cut_tree)
    gains = np.abs(sm[1].gain_trajectory[1:].astype(np.float64)).sum()
    cut_tol = cut_gap + 4 * 2.0**-24 * (abs(cut_host) + gains)  # Kahan's bound, both runs
    cut_diff = float(np.abs(sm[1].cut_trajectory - k2_main.log_cut[: it + 1].cpu().numpy().astype(np.float64)).max())
    check(cut_diff <= cut_tol, f"smega's and K2's cut logs differ by {cut_diff}, above {cut_tol}")
    print(
        f"smega gen {MULTIPLIER}x from the spectral split (S = {SHARDS}): {it} swaps, best cut "
        f"{sm[1].best_cut}, final {sm[1].final_cut}, verified {sm[1].verified_cut}; swaps, gains, "
        f"iterations and both partitions bitwise equal at every S and to K2's pass; cut0 host f64 "
        f"{cut_host!r} against K2's tree order {cut_tree!r}, cut logs {cut_diff:.6g} apart (bound "
        f"{cut_tol:.6g})"
    )
    for shards in SHARDS:
        print(
            f"K5 at S = {shards} ({plans[shards].n_local} nodes per shard, the wrapper takes "
            f"{sm_layout[shards]!r}): {sm_ms[shards]:.3f} ms per pass, {1e3 * sm_ms[shards] / it:.3f} us/swap; "
            "by layout, bitwise equal: "
            + ", ".join(f"{lay} {v:.3f} ms ({1e3 * v / it:.3f} us/swap)" for lay, v in sm_ms_layout[shards].items())
            + f" (K2 in this call: {k2_main_ms:.3f} ms, {1e3 * k2_main_ms / it:.3f} us/swap); bound "
            f"{sm_bound[0]:.4f} ms by {sm_bound[1]}; plan build {plan_s[shards]:.3f} s; "
            f"smega_refine e2e {sm_s[shards]:.3f} s"
        )
    print(f"launches on the smega path: K5 {k5_launches}, K1 {sm_k1}; smega e2e seconds at S = 8: {sm_s[8]:.3f}")

    # (c) K5 against smega_pass_plain on the card: the first 1,000 swaps at
    # every S in every layout that fits, and whole passes on gen 0.02x at
    # S = 2 and 4 in every layout.
    k5_err = 0.0
    for shards in SHARDS:
        capped_args = k5_args(shards, 1000, 1001)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_p = smega_pass_plain(*capped_args)
        torch.cuda.synchronize()
        k5_plain_ms = (time.perf_counter() - t0) * 1e3
        for lay in fitting(plans[shards].n_local):
            out_k = smega_pass_cuda(*capped_args, _layout=lay)
            check_same_pass(out_k, out_p, f"K5 at S = {shards} ({lay}) against smega_pass_plain")
            check(int(out_k.scalars[2]) == 1000,
                  f"the capped K5 pass at S = {shards} ({lay}) ran {int(out_k.scalars[2])} swaps")
            k5_err = max(k5_err, float((out_k.log_cut - out_p.log_cut).abs().max()))
    k5_ms = cuda_ms(lambda: smega_pass_cuda(*capped_args), 3)  # S = 8, as the plain time
    capped = torch.cat([out_p.log_a[1:], out_p.log_b[1:]])
    k5_bound_ms, k5_bound_by, k5_bytes, k5_ops = k2_bound(g, [(1000, capped)])
    small = crossover_graphs[0.02]
    small_sides = random_split(small.num_nodes, SEED)
    for shards in (2, 4):
        plan_small = SmegaPlan(small, shards, align=128)
        dg = plan_small.device_graph(dev)
        s_small = sides_to_signs(torch.as_tensor(small_sides).to(dev), torch.float32)
        sf0 = torch.zeros(plan_small.n_pad, device=dev)
        as0 = torch.zeros(plan_small.n_pad, device=dev)
        sf0[: small.num_nodes], as0[: small.num_nodes] = s_small, spmv_csr(dg, s_small)
        m1 = int(small_sides.sum())
        m_cap = min(m1, small.num_nodes - m1)
        args = (dg, shards, sf0, as0, float(cut_size(dg, s_small, as0[: small.num_nodes])), m_cap,
                small.num_nodes - m1, m1, m_cap + 1, KLConfig().terminate_limit(small.num_nodes), 1e-6)
        out_p = smega_pass_plain(*args)
        check(int(out_p.scalars[2]) > 100, f"gen 0.02x at S = {shards} ran {int(out_p.scalars[2])} swaps")
        for lay in fitting(plan_small.n_local):
            check_same_pass(smega_pass_cuda(*args, _layout=lay), out_p,
                            f"K5 on gen 0.02x at S = {shards} ({lay}) against smega_pass_plain")
    print(
        f"K5 bitwise equal to smega_pass_plain: 1,000 swaps at S = {SHARDS} in every layout that fits "
        f"(gen {MULTIPLIER}x), whole passes at S = 2 and 4 in all three (gen 0.02x); the 1,000 swaps at "
        f"S = 8 ({sm_layout[8]}): {k5_ms:.3f} ms, plain {k5_plain_ms:.1f} ms, bound {k5_bound_ms:.4f} ms by "
        f"{k5_bound_by} ({k5_bytes} bytes, {k5_ops} operations)"
    )

    # K5's flat scan against its cache on smaller circuits, at S = 1 and 8,
    # whole passes from a random split, in turns: where the cache starts to
    # pay (K5_CACHE_MIN_NODES, on the nodes per shard).
    k5_crossover = {}
    for mult, c_host in crossover_graphs.items():
        c_n = c_host.num_nodes
        c_sides = random_split(c_n, SEED)
        c_n1 = int(c_sides.sum())
        c_cap = min(c_n1, c_n - c_n1)
        for shards in (1, 8):
            c_plan = SmegaPlan(c_host, shards)
            dg = c_plan.device_graph(dev)
            c_s = sides_to_signs(torch.as_tensor(c_sides).to(dev), torch.float32)
            sf0 = torch.zeros(c_plan.n_pad, device=dev)
            as0 = torch.zeros(c_plan.n_pad, device=dev)
            sf0[:c_n], as0[:c_n] = c_s, spmv_csr(dg, c_s)
            args = (dg, shards, sf0, as0, float(cut_size(dg, c_s, as0[:c_n])), c_cap, c_n - c_n1, c_n1,
                    c_cap + 1, KLConfig().terminate_limit(c_n), 1e-6)
            layouts = fitting(c_plan.n_local)
            outs = {lay: smega_pass_cuda(*args, _layout=lay) for lay in layouts}
            for lay in layouts[1:]:
                check_same_pass(outs[lay], outs["flat"], f"K5's layouts at gen {mult}x, S = {shards}")
            c_it = int(outs["flat"].scalars[2])
            times = {lay: [] for lay in layouts}
            for lay in layouts + layouts[::-1]:
                times[lay].append(cuda_ms(lambda: smega_pass_cuda(*args, _layout=lay), 3))
            us = {lay: 1e3 * min(t) / c_it for lay, t in times.items()}
            k5_crossover[f"gen {mult}x, S = {shards}, {c_plan.n_local} nodes per shard"] = us
            print(
                f"K5 at gen {mult}x, S = {shards} ({c_plan.n_local} nodes per shard, {c_it} swaps, the "
                "layouts bitwise equal): "
                + ", ".join(f"{lay} {v:.3f} us/swap" for lay, v in us.items())
                + f"; the wrapper takes {k5_layout(c_plan.n_local, shards)} "
                f"(cache from {K5_CACHE_MIN_NODES} nodes per shard)"
            )
    print(f"smega phase: {time.perf_counter() - t_phase:.1f} s")

    # Phase 10: the Lanczos, LOBPCG and momentum paths, on the circuit's
    # largest connected component (on the whole, disconnected circuit
    # lambda_2 = 0 and a Fiedler vector is arbitrary).
    t_phase = time.perf_counter()
    lcc = largest_component(hg)
    counts = (lcc.num_nodes, lcc.num_nets, len(lcc.pins))
    check(counts == LCC_COUNTS, f"the largest component has {counts} nodes, nets, pins, not {LCC_COUNTS}")
    ln = lcc.num_nodes
    lcc_kl_host = clique_expand(lcc, "kl")
    lg = clique_expand(lcc, "eig").to_device(dev, torch.float32)
    lk = lcc_kl_host.to_device(dev, torch.float32)
    l_nnz = lg.nnz
    print(f"largest component: {ln} nodes, {lcc.num_nets} nets, {len(lcc.pins)} pins, nnz {l_nnz}, "
          f"row width {lg.row_width} ({time.perf_counter() - t_phase:.2f} s)")
    a_lcc = torch.sparse_csr_tensor(lg.indptr.long(), lg.indices.long(), lg.data, size=(ln, ln))
    csr_bytes = 4 * (lg.indptr.numel() + 2 * l_nnz)

    def bound(n_bytes, n_ops):
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    def held_bitwise(kern, plain, what):
        got, again, ref = kern(), kern(), plain()
        check(torch.equal(bits32(got), bits32(ref)), f"{what} is not bitwise equal to its plain version")
        check(torch.equal(got, again), f"two launches of {what} differ")
        return float((got - ref).abs().max())

    new = {}
    xl = (torch.rand(ln, generator=gen) - 0.5).to(dev)
    xl[::97] = -0.0
    dl = torch.sqrt(torch.where(lk.degrees > 0, lk.degrees, 1.0).double()).float().reciprocal()
    new["laplacian"] = dict(
        kern=lambda: laplacian_cuda(lg, xl), plain=lambda: laplacian_plain(lg, xl),
        lib=lambda: lg.degrees * xl - a_lcc @ xl, symbol="laplacian_kernel",
        bound=bound(csr_bytes + 12 * ln, 2 * l_nnz + 2 * ln),
    )
    a_lk = torch.sparse_csr_tensor(lk.indptr.long(), lk.indices.long(), lk.data, size=(ln, ln))
    # The walk gathers z = dsinv * w, given here as the momentum step's
    # rescale gives it: its bytes are w, dsinv and z read and y written (16
    # n; z's write is the rescale's or the z pass's), its operations two per
    # entry and the epilogue's three per row.
    zl = lazy_z_cuda(xl, dl)
    check(same_bits(lazy_walk_cuda(lk, xl, dl), lazy_walk_cuda(lk, xl, dl, z=zl)),
          "the lazy walk with its z pass differs from the walk given z")
    new["lazy walk"] = dict(
        kern=lambda: lazy_walk_cuda(lk, xl, dl, z=zl), plain=lambda: lazy_walk_plain(lk, xl, dl, z=zl),
        lib=lambda: 0.5 * (xl + dl * (a_lk @ (dl * xl))), symbol="lazy_walk_kernel",
        bound=bound(4 * (lk.indptr.numel() + 2 * l_nnz) + 16 * ln, 2 * l_nnz + 3 * ln),
    )
    # The blocked product walks the rows once for all k columns where k is a
    # multiple of 4: held at k = 4, 8, 12 and 16 in both forms to its plain
    # version and to K1 on each column, one kernel per call in the
    # profiler; timed at LOBPCG's k = 4 and 12 below.
    for k in (4, 8, 12, 16):
        X = (torch.rand(ln, k, generator=gen) - 0.5).to(dev)
        cols = [X[:, j].contiguous() for j in range(k)]
        for laplacian in (False, True):
            check(same_bits(spmm_cuda(lg, X, laplacian=laplacian), spmm_plain(lg, X, laplacian=laplacian)),
                  f"the blocked product at k = {k} (laplacian={laplacian}) differs from its plain version")
        check(same_bits(spmm_cuda(lg, X), torch.stack([spmv_csr(lg, c) for c in cols], dim=1)),
              f"a column of the blocked product at k = {k} differs from K1 on that column")
        one_kernel_per_call(lambda X=X: spmm_cuda(lg, X, laplacian=True), 20, "spmm_walk_kernel")
        if k in (4, 12):
            new[f"spmm k={k}"] = dict(
                kern=lambda X=X: spmm_cuda(lg, X, laplacian=True),
                plain=lambda X=X: spmm_plain(lg, X, laplacian=True),
                lib=lambda X=X: lg.degrees[:, None] * X - torch.sparse.mm(a_lcc, X), symbol="spmm",
                bound=bound(csr_bytes + 4 * ln + 8 * ln * k, (2 * l_nnz + 2 * ln) * k),
                k1_columns=lambda cols=cols: [spmv_csr(lg, c) for c in cols],
            )
    print("blocked product at k = 4, 8, 12, 16: both forms bitwise equal to the plain version and to K1 on each "
          "column, one spmm_walk_kernel per call in the profile")
    c_axpy = torch.tensor(-0.37, device=dev)
    yl = (torch.rand(ln, generator=gen) - 0.5).to(dev)
    new["axpy"] = dict(
        kern=lambda: R.axpy_cuda(c_axpy, xl, yl), plain=lambda: R.axpy_plain(c_axpy, xl, yl),
        lib=lambda: torch.addcmul(yl, c_axpy, xl), symbol="axpy_kernel", bound=bound(12 * ln, 2 * ln),
    )
    x2d, ax2d = xp.view(P // 128, 128), y3p.view(P // 128, 128)
    deg2d = torch.ones(P, device=dev)
    deg2d[:n] = torch.where(g.degrees > 0, g.degrees, 1.0)
    deg2d = deg2d.view(P // 128, 128)
    new["padded step"] = dict(
        kern=lambda: R.padded_step_cuda(x2d, ax2d, deg2d, 1.0 / 3.0),
        plain=lambda: R.padded_step_plain(x2d, ax2d, deg2d, 1.0 / 3.0),
        lib=lambda: x2d - (1.0 / 3.0) * (2.0 * x2d - 2.0 * ax2d / deg2d), symbol="padded_step_kernel",
        bound=bound(16 * P, 6 * P),
    )
    for what, e in new.items():
        e["err"] = held_bitwise(e["kern"], e["plain"], what)
        e["ms"] = cuda_ms(e["kern"], 200)
        e["plain_ms"] = cuda_ms(e["plain"], 3)
        e["library_ms"] = cuda_ms(e["lib"], 200)
        e["library_device_us"] = library_device_us(e["lib"])
        e["device_us"] = device_us_per_launch(lambda e=e: [e["kern"]() for _ in range(50)], e["symbol"])
        extra = ""
        if "k1_columns" in e:
            e["k1_columns_ms"] = cuda_ms(e["k1_columns"], 200)
            extra = f", {what[7:]} launches of K1 {e['k1_columns_ms']:.4f} ms"
        print(
            f"{what}: bitwise equal to its plain version; {e['ms']:.4f} ms, device {fmt_us(e['device_us'])} "
            f"per launch, plain {e['plain_ms']:.3f} ms, library {e['library_ms']:.4f} ms (device "
            f"{fmt_us([e['library_device_us']])} per call){extra}, bound "
            f"{e['bound'][0]:.5f} ms by {e['bound'][1]}"
        )
    # The momentum check's walk on a graph wider than 32 (the component's ELL
    # width is 48): the scaled epilogue of its deflated unit iterate w = u * c,
    # c one value (ops/spmv.py:lazy_walk).
    ql = R.normalize(dl.reciprocal(), R.tree_norm(dl.reciprocal()))
    ul = R.axpy(-R.fma_dot(ql, xl), ql, xl)
    cl = 1.0 / R.tree_norm(ul)
    wl = ul * cl
    zwl = lazy_z_cuda(wl, dl)
    scaled_err = held_bitwise(lambda: lazy_walk_cuda(lk, wl, dl, (ul, cl), z=zwl),
                              lambda: lazy_walk_plain(lk, wl, dl, (ul, cl)), "the scaled lazy walk")
    new["lazy walk"]["err"] = max(new["lazy walk"]["err"], scaled_err)
    check(same_bits(lazy_walk_cuda(lk, wl, dl, (ul, cl)), lazy_walk_cuda(lk, wl, dl, (ul, cl), z=zwl)),
          "the scaled lazy walk with its z pass differs from the walk given z")
    print(f"lazy walk, scaled (the momentum check's walk, ELL width {lk.row_width}): bitwise equal to its plain "
          "version, with z given and with its z pass")

    # The momentum step's rescale (w * inv, u * inv) with the next walk's z
    # in one launch, and the z pass, at the component's length: bit for bit
    # their plain versions.  Bytes: u, w and dsinv read, three vectors
    # written (the z pass: w and dsinv read, z written); a multiply per
    # value written.  The rescale has no one PyTorch call: beside it, the
    # two multiplies it replaces (the z pass: torch.mul).
    ur = (torch.rand(ln, generator=gen) - 0.5).to(dev)
    ur[::89] = -0.0
    inv_r = 1.0 / R.tree_norm(ur)
    zk = {
        "lazy rescale": dict(kern=lambda: lazy_rescale_cuda(ur, xl, inv_r, dl),
                             plain=lambda: lazy_rescale_plain(ur, xl, inv_r, dl), lib=None,
                             replaced=lambda: (xl * inv_r, ur * inv_r), bound=bound(24 * ln + 4, 3 * ln)),
        "z pass": dict(kern=lambda: lazy_z_cuda(xl, dl), plain=lambda: lazy_z_plain(xl, dl),
                       lib=lambda: dl * xl, bound=bound(12 * ln, ln), symbol="lazy_z_kernel"),
    }

    def hold_z_kernels(entries):
        """Hold each of the rescale's and the z pass's entries (one output
        or three) bit for bit against its plain version and time it."""
        for what, e in entries.items():
            outs = [e["kern"](), e["kern"](), e["plain"]()]
            got, again, ref = ([o] if torch.is_tensor(o) else list(o) for o in outs)
            check(all(same_bits(a, b) for a, b in zip(got, ref)), f"{what} is not bitwise its plain version")
            check(all(same_bits(a, b) for a, b in zip(got, again)), f"two launches of {what} differ")
            e["err"] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
            e["ms"] = cuda_ms(e["kern"], 200)
            e["plain_ms"] = cuda_ms(e["plain"], 200)
            e["device_us"] = device_us_per_launch(lambda e=e: [e["kern"]() for _ in range(50)],
                                                  e.get("symbol", "lazy_rescale_kernel"))
            e["library_ms"] = None if e["lib"] is None else cuda_ms(e["lib"], 200)
            e["library_device_us"] = None if e["lib"] is None else library_device_us(e["lib"])
            if "replaced" in e:
                e["replaced_ms"] = cuda_ms(e["replaced"], 200)
                e["replaced_device_us"] = library_device_us(e["replaced"])
            print(
                f"{what}: bitwise equal to its plain version; {e['ms']:.4f} ms, device {fmt_us(e['device_us'])} per "
                f"launch, plain {e['plain_ms']:.4f} ms, "
                + (f"library {e['library_ms']:.4f} ms (device {fmt_us([e['library_device_us']])})" if e["lib"] else
                   f"the two PyTorch multiplies it replaces {e['replaced_ms']:.4f} ms (device "
                   f"{fmt_us([e['replaced_device_us']])})")
                + f", bound {e['bound'][0]:.5f} ms by {e['bound'][1]}"
            )

    hold_z_kernels(zk)

    # The Lanczos path: spectral_partition, f32 on the card plus the host
    # f64 refinement (dtype=torch.float32, given: the default is f64), then
    # the EIG file and one KL pass from it.
    def spectral_run(solver, dtype=torch.float32):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = spectral_partition(lcc, SpectralConfig(solver=solver), dtype=dtype, device="cuda")
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    reset_counts()
    lz, lz_s = spectral_run("lanczos")
    lz_launches = {kern.symbol: kern.launches for kern in all_kernels}
    lz_solve = lz.spectral_solve
    check(K1_LAPLACIAN.launches > 0 and K1_SPMM.launches == 0 and K1.launches == 0,
          f"the Lanczos path launched {lz_launches}")
    check(lz_solve.refined is not None, "the f32 Lanczos run was not refined on the host")
    lam2, resid, steps = lz_solve.refined
    check(abs(lam2 - JAX_LCC_LAMBDA2) <= 1e-6 * JAX_LCC_LAMBDA2,
          f"Lanczos lambda_2 {lam2!r}, not {JAX_LCC_LAMBDA2!r} to 1e-6")
    check(resid <= 1e-5, f"the refined residual {resid} is above 1e-5")
    check(tuple(lz.eig.balance()) == (ln // 2, ln // 2), f"the Lanczos split's balance is {lz.eig.balance()}")
    print(
        f"lanczos path: {lz_solve.iterations} restarts (JAX on the CPU: {JAX_LCC_RESTARTS}), lambda {lz_solve.eigenvalue!r} "
        f"on the card, {lam2!r} after {steps} host f64 steps (residual {resid:.3g}; JAX {JAX_LCC_LAMBDA2!r}), "
        f"balance {lz.eig.balance()}; e2e {lz_s:.3f} s, spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(lz.timings.items()))
        + f"; K1's Laplacian {K1_LAPLACIAN.launches} launches; launches {lz_launches}"
    )
    report_device_busy("the lanczos run", lambda: spectral_run("lanczos"))
    with tempfile.TemporaryDirectory() as tmp:
        eig_path = os.path.join(tmp, "lcc.hgr_out.txt")
        write_eig_file(eig_path, lz.eig)
        eig_back = read_eig_file(eig_path)
    check(np.array_equal(eig_back.sides, lz.eig.sides), "the EIG file's sides differ from the run's")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck = kl_partition(lcc, init=eig_back, kl_config=KLConfig(), device="cuda")
    torch.cuda.synchronize()
    ck_s = time.perf_counter() - t0
    ckl = ck.kl
    ck_launches = {kern.symbol: kern.launches for kern in all_kernels}
    check(K2.launches == 1, f"the cEIG -> cKL pass launched {ck_launches}")
    ck_drift = abs(ckl.final_cut - ckl.verified_cut) / ckl.final_cut
    check(ck_drift <= 1e-5, f"cEIG -> cKL: cut drift {ck_drift:.3g} above 1e-5")
    check(ckl.best_cut <= ckl.initial_cut, "cEIG -> cKL: best cut above the initial cut")
    ck_recount = host_cut(lcc_kl_host, np.asarray(ckl.best_sides))
    check(abs(ck_recount - ckl.best_cut) <= 1e-4 * ckl.best_cut,
          f"cEIG -> cKL: best cut {ckl.best_cut} disagrees with the host f64 recount {ck_recount}")
    # The f32 Lanczos vectors differ from the JAX run's in their last bits,
    # so nodes next to the median may fall on the other side, and the pass
    # takes another path: its cuts are held to 1 % of the JAX run's.
    check(abs(ckl.initial_cut - JAX_LCC_KL_INITIAL) <= 1e-3 * JAX_LCC_KL_INITIAL,
          f"cEIG -> cKL: initial cut {ckl.initial_cut}, JAX {JAX_LCC_KL_INITIAL}")
    check(abs(ckl.best_cut - JAX_LCC_KL_BEST) <= 1e-2 * JAX_LCC_KL_BEST,
          f"cEIG -> cKL: best cut {ckl.best_cut}, JAX {JAX_LCC_KL_BEST}")
    print(
        f"cEIG -> cKL: initial cut {ckl.initial_cut}, best {ckl.best_cut} after {ckl.iterations} swaps, final "
        f"{ckl.final_cut}, verified {ckl.verified_cut} (drift {ck_drift:.3g}), host f64 recount "
        f"{ck_recount:.4f} (JAX on the CPU: initial {JAX_LCC_KL_INITIAL}, best {JAX_LCC_KL_BEST} after "
        f"{JAX_LCC_KL_SWAPS} swaps); e2e {ck_s:.3f} s; launches {ck_launches}"
    )

    # The LOBPCG path.
    reset_counts()
    lo, lo_s = spectral_run("lobpcg")
    lo_launches = {kern.symbol: kern.launches for kern in all_kernels}
    lo_solve = lo.spectral_solve
    check(K1_SPMM.launches > 0 and K1_LAPLACIAN.launches == 0 and K1.launches == 0,
          f"the LOBPCG path launched {lo_launches}")
    check(lo_solve.refined is not None, "the f32 LOBPCG run was not refined on the host")
    check(abs(lo.eig.eigenvalue - lam2) <= 1e-6 * lam2,
          f"LOBPCG lambda_2 {lo.eig.eigenvalue!r} against Lanczos {lam2!r}")
    print(
        f"lobpcg path: {lo_solve.iterations} iterations (JAX on the CPU: {JAX_LCC_LOBPCG_ITERS}), lambda "
        f"{lo_solve.eigenvalue!r} on the card, {lo.eig.eigenvalue!r} refined (residual {lo_solve.refined[1]:.3g}), "
        f"balance {lo.eig.balance()}; e2e {lo_s:.3f} s, spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(lo.timings.items()))
        + f"; launches {lo_launches}"
    )
    report_device_busy("the lobpcg run", lambda: spectral_run("lobpcg"))

    # The momentum exit of the power solve on the component's KL graph.
    mom_config = SpectralConfig(solver="power", convergence="momentum")

    def momentum_run():
        tracer = Tracer(dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with tracer.span("spectral"):
            out = power_partition_fiedler(lk, mom_config, dtype=torch.float32)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    reset_counts()
    (mo_lam, mo_med, mo_vals, mo_sides, mo_iters), mo_s = momentum_run()
    mo_launches = {kern.symbol: kern.launches for kern in all_kernels}
    # Each inner step: one lazy walk and one lazy_rescale (its two carries
    # and the next walk's z), no z pass; each check: the Rayleigh quotient's
    # walk after one z pass, whose z the next step's walk reuses; and the z
    # pass of the start.  K4: the start's deflation, then per check one
    # launch for the two deflation dots and one for the Rayleigh quotient;
    # the final eigenvalue's quotient.
    mo_checks = (mo_iters - 1) // mom_config.check_interval
    mo_steps = mo_iters - 1
    check(K1_LAZY.launches == mo_steps + mo_checks and K1_RESCALE.launches == mo_steps
          and K1_Z.launches == mo_checks + 1 and K6_AXPY.launches > 0 and K4.launches > 0,
          f"the momentum path launched {mo_launches} for {mo_steps} steps and {mo_checks} checks")
    check(K4.launches == 2 + 2 * mo_checks, f"K4 launched {K4.launches} times for {mo_checks} momentum checks")
    mo_digest = hashlib.sha256(np.ascontiguousarray(mo_sides.astype(np.int8)).tobytes()).hexdigest()[:16]
    check(mo_iters == JAX_LCC_MOMENTUM_ITERS, f"momentum: {mo_iters} iterations, JAX {JAX_LCC_MOMENTUM_ITERS}")
    check(mo_digest == JAX_LCC_MOMENTUM_SIDES, f"momentum: the split's digest {mo_digest}, JAX {JAX_LCC_MOMENTUM_SIDES}")
    check(mo_med == JAX_LCC_MOMENTUM_MEDIAN, f"momentum: median {mo_med!r}, JAX {JAX_LCC_MOMENTUM_MEDIAN!r}")
    (_, _, _, mo_sides2, _), mo_s2 = momentum_run()
    check(np.array_equal(mo_sides2, mo_sides), "a repeated momentum run split otherwise")
    print(
        f"momentum path: {mo_iters} iterations, lambda {mo_lam!r}, median {mo_med!r} (JAX {JAX_LCC_MOMENTUM_MEDIAN!r}), "
        f"{int(mo_sides.sum())} nodes on side 1, the JAX run's split; e2e {mo_s:.3f} s and {mo_s2:.3f} s; "
        f"launches {mo_launches}"
    )
    report_device_busy("the momentum run", momentum_run)
    print(f"lanczos/lobpcg/momentum phase: {time.perf_counter() - t_phase:.1f} s")

    # Phase 11: the f64 engine (ROADMAP.md A9): every f64 kernel against its
    # plain version bit for bit at the main path's shapes, then each f64
    # path through the user's entry points, its counts set to 0 just before
    # it and read just after: fused_partition at f64 on the whole circuit,
    # spectral_partition with Lanczos and LOBPCG at its default (f64, no
    # host refinement) and the f64 momentum exit on the component, and the
    # f64 multi-start.
    t_phase = time.perf_counter()

    def bits64(t):
        return t.view(torch.int64)

    def bound64(n_bytes, n_ops):
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F64_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"

    def held64(kern, plain, what):
        got, again, ref = kern(), kern(), plain()
        check(got.dtype == torch.float64 and ref.dtype == torch.float64, f"{what} is not f64")
        check(torch.equal(bits64(got), bits64(ref)), f"{what} is not bitwise equal to its plain version")
        check(torch.equal(bits64(got), bits64(again)), f"two launches of {what} differ")
        return float((got - ref).abs().max())

    g64 = g_host.to_device(dev, torch.float64)
    lg64 = clique_expand(lcc, "eig").to_device(dev, torch.float64)
    lk64 = lcc_kl_host.to_device(dev, torch.float64)
    x64 = (torch.rand(n, generator=gen, dtype=torch.float64) - 0.5).to(dev)
    x64[::97] = -0.0
    xl64 = (torch.rand(ln, generator=gen, dtype=torch.float64) - 0.5).to(dev)
    xl64[::97] = -0.0
    yl64 = (torch.rand(ln, generator=gen, dtype=torch.float64) - 0.5).to(dev)
    deg64 = torch.where(g64.degrees > 0, g64.degrees, 1.0)
    dl64 = 1.0 / torch.sqrt(torch.where(lk64.degrees > 0, lk64.degrees, 1.0))
    a64 = torch.sparse_csr_tensor(g64.indptr.long(), g64.indices.long(), g64.data, size=(n, n))
    al64 = torch.sparse_csr_tensor(lg64.indptr.long(), lg64.indices.long(), lg64.data, size=(ln, ln))
    alk64 = torch.sparse_csr_tensor(lk64.indptr.long(), lk64.indices.long(), lk64.data, size=(ln, ln))
    # Bytes: each input read once, each output written once (int32 CSR
    # offsets and columns, f64 values); operations: two per stored entry
    # and a few per row, at the card's f64 rate.
    csr64 = 4 * (g64.indptr.numel() + nnz) + 8 * nnz
    lcsr64 = 4 * (lg64.indptr.numel() + l_nnz) + 8 * l_nnz
    f64 = {}
    f64["K1 spmv_csr_f64"] = dict(
        kern=lambda: spmv_csr(g64, x64), plain=lambda: spmv_plain(g64, x64), lib=lambda: a64 @ x64,
        symbol="spmv_csr_kernel", bound=bound64(csr64 + 16 * n, 2 * nnz),
        replaces="eig_kl_tpu/ops/spmv_pallas.py:339", source="eig_kl_tpu_torch/csrc/spmv_csr.cu")
    f64["K1 power_step_f64"] = dict(
        kern=lambda: power_step_cuda(g64, x64, deg64, 0.5), plain=lambda: power_step_plain(g64, x64, deg64, 0.5),
        lib=lambda: x64 - 0.5 * (2.0 * x64 - 2.0 * (a64 @ x64) / deg64), symbol="power_step_kernel", bound=bound64(csr64 + 24 * n, 2 * nnz + 6 * n),
        replaces="eig_kl_tpu/ops/spmv_pallas.py:339 (with the power step of eig_kl_tpu/spectral/power.py:184)",
        source="eig_kl_tpu_torch/csrc/spmv_csr.cu")
    held64(lambda: power_step_cuda(g64, x64, deg64, 1.0 / 3.0),
           lambda: power_step_plain(g64, x64, deg64, 1.0 / 3.0), "K1's f64 step at shift 3")
    f64["K1 laplacian_f64"] = dict(
        kern=lambda: laplacian_cuda(lg64, xl64), plain=lambda: laplacian_plain(lg64, xl64),
        lib=lambda: lg64.degrees * xl64 - al64 @ xl64, symbol="laplacian_kernel",
        bound=bound64(lcsr64 + 24 * ln, 2 * l_nnz + 2 * ln),
        replaces="eig_kl_tpu/ops/spmv_pallas.py:339 (with eig_kl_tpu/spectral/lanczos.py:60's epilogue)",
        source="eig_kl_tpu_torch/csrc/spmv_csr.cu")
    for k in (4, 8, 12, 16):
        X64 = (torch.rand(ln, k, generator=gen, dtype=torch.float64) - 0.5).to(dev)
        for laplacian in (False, True):
            check(same_bits(spmm_cuda(lg64, X64, laplacian=laplacian), spmm_plain(lg64, X64, laplacian=laplacian)),
                  f"the f64 blocked product at k = {k} (laplacian={laplacian}) differs from its plain version")
        check(torch.equal(bits64(spmm_cuda(lg64, X64)),
                          bits64(torch.stack([spmv_csr(lg64, X64[:, j].contiguous()) for j in range(k)], dim=1))),
              f"a column of the f64 blocked product at k = {k} differs from K1 on that column")
        one_kernel_per_call(lambda X=X64: spmm_cuda(lg64, X, laplacian=True), 20, "spmm_walk_kernel")
        if k not in (4, 12):
            continue
        f64[f"K1 spmm_csr_f64 k={k}"] = dict(
            kern=lambda X=X64: spmm_cuda(lg64, X, laplacian=True),
            plain=lambda X=X64: spmm_plain(lg64, X, laplacian=True),
            lib=lambda X=X64: lg64.degrees[:, None] * X - torch.sparse.mm(al64, X), symbol="spmm",
            bound=bound64(lcsr64 + 8 * ln + 16 * ln * k, (2 * l_nnz + 2 * ln) * k),
            replaces="eig_kl_tpu/ops/spmv_pallas.py:339 (vmapped by eig_kl_tpu/spectral/lobpcg_solver.py:51-56)",
            source="eig_kl_tpu_torch/csrc/spmv_csr.cu")
    zl64 = lazy_z_cuda(xl64, dl64)
    check(same_bits(lazy_walk_cuda(lk64, xl64, dl64), lazy_walk_cuda(lk64, xl64, dl64, z=zl64)),
          "the f64 lazy walk with its z pass differs from the walk given z")
    f64["K1 lazy_walk_f64"] = dict(
        kern=lambda: lazy_walk_cuda(lk64, xl64, dl64, z=zl64), plain=lambda: lazy_walk_plain(lk64, xl64, dl64, z=zl64),
        lib=lambda: 0.5 * (xl64 + dl64 * (alk64 @ (dl64 * xl64))), symbol="lazy_walk_kernel",
        bound=bound64(4 * (lk64.indptr.numel() + l_nnz) + 8 * l_nnz + 32 * ln, 2 * l_nnz + 3 * ln),
        replaces="eig_kl_tpu/ops/spmv_pallas.py:339 (with eig_kl_tpu/spectral/power.py:305's epilogue)",
        source="eig_kl_tpu_torch/csrc/spmv_csr.cu")
    w64 = (torch.rand(n, generator=gen, dtype=torch.float64) - 0.5).to(dev)
    f64["K6 tree_sum_f64, the 1-D norm over n"] = dict(
        kern=lambda: R.tree_sum_cuda(x64, square=True, root=True),
        plain=lambda: R.sqrt_rn(R._products_plain(x64, x64, R.tree_sum_plain)),
        lib=lambda: torch.linalg.vector_norm(x64), symbol="tree_sum_kernel", bound=bound64(8 * n + 8, 2 * n),
        replaces="eig_kl_tpu/spectral/power.py:185 (jnp.linalg.norm) and eig_kl_tpu/ops/partition.py:88 (.sum()), XLA ops, no Pallas kernel",
        source="eig_kl_tpu_torch/csrc/tree_sum.cu")
    held64(lambda: R.tree_sum_cuda(x64), lambda: R.tree_sum_plain(x64), "K6's f64 sum")
    held64(lambda: R.tree_sum_cuda(x64, w64), lambda: R._products_plain(x64, w64, R.tree_sum_plain), "K6's f64 dot")
    short = x64[:20].contiguous()
    held64(lambda: R.tree_sum_cuda(short, square=True, root=True),
           lambda: R.sqrt_rn(R._products_plain(short, short, R.tree_sum_plain)), "K6's f64 norm of 20 values")
    nrm64 = R.tree_norm(x64)
    f64["K6 scale_by_f64"] = dict(
        kern=lambda: R.normalize_cuda(x64, nrm64), plain=lambda: R.normalize_plain(x64, nrm64),
        lib=lambda: x64 / nrm64, symbol="scale_by_kernel", bound=bound64(16 * n + 8, n),
        replaces="eig_kl_tpu/spectral/power.py:187 (jnp.where(safe, y / nrm, y), XLA ops, no Pallas kernel)",
        source="eig_kl_tpu_torch/csrc/tree_sum.cu")
    c64 = torch.tensor(-0.37, dtype=torch.float64, device=dev)
    f64["K6 axpy_f64"] = dict(
        kern=lambda: R.axpy_cuda(c64, xl64, yl64), plain=lambda: R.axpy_plain(c64, xl64, yl64),
        lib=lambda: torch.addcmul(yl64, c64, xl64), symbol="axpy_kernel", bound=bound64(24 * ln + 8, 2 * ln),
        replaces="eig_kl_tpu/spectral/power.py:310 (w - jnp.vdot(q0, w) * q0, XLA ops, no Pallas kernel)",
        source="eig_kl_tpu_torch/csrc/tree_sum.cu")
    f64["K4 fma_dot_batch_f64"] = dict(
        kern=lambda: fma_dot_cuda(xl64, yl64), plain=lambda: fma_dot_plain(xl64, yl64),
        lib=lambda: torch.dot(xl64, yl64), symbol="fma_dot_batch_kernel", bound=bound64(16 * ln + 8, 2 * ln),
        replaces="eig_kl_tpu/spectral/power.py:309, :336 (jnp.vdot, an XLA op, no Pallas kernel)",
        source="eig_kl_tpu_torch/csrc/fma_dot.cu", plain_reps=1, reps=20)
    ql64 = R.normalize(dl64.reciprocal(), R.tree_norm(dl64.reciprocal()))
    ul64 = R.axpy(-R.fma_dot(ql64, xl64), ql64, xl64)
    cl64 = 1.0 / R.tree_norm(ul64)
    wl64 = ul64 * cl64
    zwl64 = lazy_z_cuda(wl64, dl64)
    scaled64_err = held64(lambda: lazy_walk_cuda(lk64, wl64, dl64, (ul64, cl64), z=zwl64),
                          lambda: lazy_walk_plain(lk64, wl64, dl64, (ul64, cl64)), "the scaled f64 lazy walk")
    check(same_bits(lazy_walk_cuda(lk64, wl64, dl64, (ul64, cl64)), lazy_walk_cuda(lk64, wl64, dl64, (ul64, cl64),
                                                                                   z=zwl64)),
          "the scaled f64 lazy walk with its z pass differs from the walk given z")
    print("lazy walk f64, scaled (the momentum check's walk): bitwise equal to its plain version, with z given and "
          "with its z pass")
    ur64 = (torch.rand(ln, generator=gen, dtype=torch.float64) - 0.5).to(dev)
    ur64[::89] = -0.0
    inv_r64 = 1.0 / R.tree_norm(ur64)
    zk64 = {
        "lazy rescale f64": dict(kern=lambda: lazy_rescale_cuda(ur64, xl64, inv_r64, dl64),
                                 plain=lambda: lazy_rescale_plain(ur64, xl64, inv_r64, dl64), lib=None,
                                 replaced=lambda: (xl64 * inv_r64, ur64 * inv_r64),
                                 bound=bound64(48 * ln + 8, 3 * ln)),
        "z pass f64": dict(kern=lambda: lazy_z_cuda(xl64, dl64), plain=lambda: lazy_z_plain(xl64, dl64),
                           lib=lambda: dl64 * xl64, bound=bound64(24 * ln, ln), symbol="lazy_z_kernel"),
    }
    hold_z_kernels(zk64)
    for what, e in f64.items():
        e["err"] = held64(e["kern"], e["plain"], what)
        e["ms"] = cuda_ms(e["kern"], e.get("reps", 200))
        e["plain_ms"] = cuda_ms(e["plain"], e.get("plain_reps", 3))
        e["library_ms"] = None if e["lib"] is None else cuda_ms(e["lib"], 200)
        e["library_device_us"] = None if e["lib"] is None else library_device_us(e["lib"])
        e["device_us"] = device_us_per_launch(lambda e=e: [e["kern"]() for _ in range(20)], e["symbol"])
        print(
            f"{what}: bitwise equal to its plain version; {e['ms']:.4f} ms, device {fmt_us(e['device_us'])} "
            f"per launch, plain {e['plain_ms']:.3f} ms, library "
            + ("none" if e["library_ms"] is None
               else f"{e['library_ms']:.4f} ms (device {fmt_us([e['library_device_us']])} per call)")
            + f", bound {e['bound'][0]:.5f} ms by {e['bound'][1]}"
        )
    f64["K1 lazy_walk_f64"]["err"] = max(f64["K1 lazy_walk_f64"]["err"], scaled64_err)
    # K4's f64 batch at 1 to 4 pairs of the component's length.
    k4_xs64 = [xl64] + [(torch.rand(ln, generator=gen, dtype=torch.float64) - 0.5).to(dev) for _ in range(3)]
    k4_ys64 = [yl64] + [(torch.rand(ln, generator=gen, dtype=torch.float64) - 0.5).to(dev) for _ in range(3)]
    k4_batch64 = k4_batches(k4_xs64, k4_ys64, [fma_dot_plain(a, b) for a, b in zip(k4_xs64, k4_ys64)], "the f64 K4")
    print(f"K4 f64: batches of 1-4 pairs bitwise the host chains; device {fmt_us([k4_batch64['device_us_one_dot']])} "
          f"per launch of one dot, {fmt_us([k4_batch64['device_us_two_dots']])} of two")

    # K2 at f64: one start from a seeded random split, capped at 3,000
    # swaps (the plain pass's time), in each selection; four starts batched
    # against the batched plain version; the flat scan against the cache on
    # the smaller circuits (the f64 crossover).
    s64 = sides_to_signs(sides, torch.float64)
    as64 = spmv_csr(g64, s64)
    cut64 = float(cut_size(g64, s64, as64))
    cap64 = 3000
    args64 = (g64, s64, as64, cut64, cap64, limit, 1e-6)
    t0 = time.perf_counter()
    out64_p = kl_pass_plain(*args64)
    torch.cuda.synchronize()
    k2_64_plain_ms = (time.perf_counter() - t0) * 1e3
    out64_k = kl_pass_cuda(*args64)
    check(int(out64_k.scalars[2]) == cap64, f"the f64 K2 pass ran {int(out64_k.scalars[2])} swaps, not {cap64}")
    check_same_pass(out64_k, out64_p, "the f64 K2 against kl_pass_plain")
    check(out64_k.log_cut.dtype == torch.float64, "the f64 K2's logs are not f64")
    one64 = torch.tensor([cut64], dtype=torch.float64, device=dev)
    cap64_t = torch.tensor([cap64], dtype=torch.int32, device=dev)
    sel_args = (g64, s64[None], as64[None], one64, one64, cap64_t, torch.zeros_like(cap64_t), cap64 + 1, limit, 1e-6)
    k2_64_sel_ms = {}
    for sel in ("flat", "shared", "global"):
        check_same_pass(kl_pass_batch_cuda(*sel_args, _cache=sel).start(0), out64_p,
                        f"the f64 K2 with the {sel} selection against kl_pass_plain")
        k2_64_sel_ms[sel] = cuda_ms(lambda sel=sel: kl_pass_batch_cuda(*sel_args, _cache=sel), 2)
    k2_64_err = float((out64_k.log_cut - out64_p.log_cut).abs().max())
    k2_64_ms = cuda_ms(lambda: kl_pass_cuda(*args64), 2)
    k2_64_bound = k2_bound(g64, swaps_of(out64_k))
    print(
        f"K2 f64: {cap64} swaps from a random split, bitwise equal to kl_pass_plain in the flat, shared and "
        f"global selections; {k2_64_ms:.3f} ms (the wrapper's {k2_selection(n, g64.row_width, torch.float64)}), "
        + ", ".join(f"{sel} {t:.3f} ms ({1e3 * t / cap64:.3f} us/swap)" for sel, t in k2_64_sel_ms.items())
        + f"; plain {k2_64_plain_ms:.1f} ms; bound {k2_64_bound[0]:.4f} ms by {k2_64_bound[1]}"
    )
    b64_s = sides_to_signs(b_sides, torch.float64)
    b64_as, b64_cut0 = _batch_init(g64, b64_s)
    b64_best0 = b64_cut0.clone()
    b64_best0[3] = 1.0
    b64_cap = torch.tensor([1500, 0, 1000, 500], dtype=torch.int32, device=dev)
    b64_args = (g64, b64_s, b64_as, b64_cut0, b64_best0, b64_cap, b_term0, 1501, limit, 1e-6)
    out64_b = kl_pass_batch_cuda(*b64_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out64_bp = kl_pass_batch_plain(*b64_args)
    torch.cuda.synchronize()
    kb64_plain_ms = (time.perf_counter() - t0) * 1e3
    check_same_pass(out64_b, out64_bp, "the batched f64 K2 against kl_pass_batch_plain")
    check(out64_b.scalars[:, 2].long().tolist() == b64_cap.tolist(), "the batched f64 K2's swaps")
    kb64_err = float((out64_b.log_cut - out64_bp.log_cut).abs().max())
    kb64_ms = cuda_ms(lambda: kl_pass_batch_cuda(*b64_args), 3)
    kb64_bound = k2_bound(g64, swaps_of(out64_b))
    print(
        f"K2 f64 batched: 4 starts, {out64_b.scalars[:, 2].long().tolist()} swaps, bitwise equal to the plain "
        f"version; {kb64_ms:.3f} ms, plain {kb64_plain_ms:.1f} ms, bound {kb64_bound[0]:.4f} ms by {kb64_bound[1]}"
    )
    crossover64 = {}
    for mult in (0.02, 0.05, 0.1):
        c_g = crossover_graphs[mult].to_device(dev, torch.float64)
        c_n = c_g.num_nodes
        c_sides = torch.as_tensor(random_split(c_n, SEED)).to(dev)
        c_s = sides_to_signs(c_sides, torch.float64)
        c_as, c_cut = _batch_init(c_g, c_s[None])
        c_n1 = int(c_sides.sum())
        c_cap = torch.tensor([min(c_n1, c_n - c_n1)], dtype=torch.int32, device=dev)
        c_args = (c_g, c_s[None], c_as, c_cut, c_cut, c_cap, torch.zeros_like(c_cap), int(c_cap) + 1,
                  KLConfig().terminate_limit(c_n), 1e-6)
        outs = {sel: kl_pass_batch_cuda(*c_args, _cache=sel) for sel in ("flat", "shared")}
        check_same_pass(outs["flat"], outs["shared"], f"the f64 K2's two selections at gen {mult}x")
        c_it = int(outs["flat"].scalars[0, 2])
        times = {"flat": [], "shared": []}
        for sel in ("flat", "shared", "shared", "flat"):
            times[sel].append(cuda_ms(lambda sel=sel: kl_pass_batch_cuda(*c_args, _cache=sel), 5))
        crossover64[c_n] = {sel: 1e3 * min(t) / c_it for sel, t in times.items()}
        print(
            f"K2 f64 at gen {mult}x ({c_n} nodes, {c_it} swaps, the two selections bitwise equal): flat scan "
            f"{crossover64[c_n]['flat']:.3f} us/swap, row-max cache {crossover64[c_n]['shared']:.3f} us/swap; "
            f"the wrapper takes {k2_selection(c_n, c_g.row_width, torch.float64)}"
        )

    def f32_launched():
        return {kern.symbol: kern.launches for kern in f32_kernels if kern.launches}

    # fused_partition at f64 on the whole circuit, through the user's entry
    # point: the power solve's gkl2 exit (the f64 default), one KL pass.
    def fused64_run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fused_partition(hg, use_eig=True, dtype=torch.float64, device="cuda")
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    reset_counts()
    run64, run64_s = fused64_run()
    fu64_launches = {kern.symbol: kern.launches for kern in all_kernels}
    check(not f32_launched(), f"the f64 fused run launched f32 kernels: {f32_launched()}")
    kl64, iters64 = run64.kl, run64.spectral_iterations
    check(K1_F64.launches == 3 and K1_STEP_F64.launches == iters64 and K6_F64.launches == iters64 + 5
          and K6_SCALE_F64.launches == iters64 and K2_F64.launches == 1,
          f"the f64 fused run's launches: {fu64_launches} for {iters64} power steps")
    check(abs(iters64 - JAX_F64_FUSED_ITERS) <= 25,
          f"the f64 fused run: {iters64} power iterations, JAX {JAX_F64_FUSED_ITERS}")
    check(kl64.best_cut <= kl64.initial_cut, "the f64 fused run: best cut above the initial cut")
    check(kl64.best_cut <= 1.03 * JAX_F64_FUSED_BEST,
          f"the f64 fused run: best cut {kl64.best_cut} above 1.03 x {JAX_F64_FUSED_BEST}")
    drift64 = abs(kl64.final_cut - kl64.verified_cut) / kl64.final_cut
    check(drift64 <= 1e-10, f"the f64 fused run: cut drift {drift64:.3g} above 1e-10")
    recount64 = host_cut(g_host, np.asarray(kl64.best_sides))
    check(abs(recount64 - kl64.best_cut) <= 1e-12 * kl64.best_cut,
          f"the f64 fused run: best cut {kl64.best_cut!r} against the host recount {recount64!r}")
    check(run64.eig.values.dtype == np.float64, "the f64 fused run's vector is not f64")
    print(
        f"fused f64 gen {MULTIPLIER}x: {iters64} power iterations (JAX f64 on the CPU {JAX_F64_FUSED_ITERS}), "
        f"lambda {run64.eig.eigenvalue!r}, initial cut {kl64.initial_cut!r}, best cut {kl64.best_cut!r} after "
        f"{kl64.iterations} swaps (JAX: initial {JAX_F64_FUSED_INITIAL}, best {JAX_F64_FUSED_BEST} after "
        f"{JAX_F64_FUSED_SWAPS}), final {kl64.final_cut!r}, verified {kl64.verified_cut!r} (drift {drift64:.3g}), "
        f"host f64 recount {recount64!r}; e2e {run64_s:.3f} s on {card}; spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(run64.timings.items()))
    )
    print(f"launches on the f64 fused path: {fu64_launches}")
    report_device_busy("the f64 fused run", fused64_run)

    # Lanczos and LOBPCG at spectral_partition's default: f64 on the card,
    # no host refinement.
    reset_counts()
    lz64, lz64_s = spectral_run("lanczos", None)
    lz64_launches = {kern.symbol: kern.launches for kern in all_kernels}
    lz64_solve = lz64.spectral_solve
    check(not f32_launched() and K1_LAPLACIAN_F64.launches > 0,
          f"the f64 Lanczos path launched {lz64_launches}")
    check(lz64_solve.refined is None, "the f64 Lanczos run was refined on the host")
    check(abs(lz64.eig.eigenvalue - JAX_F64_LAMBDA2) <= 1e-10,
          f"f64 Lanczos lambda_2 {lz64.eig.eigenvalue!r}, JAX {JAX_F64_LAMBDA2!r}")
    check(tuple(lz64.eig.balance()) == (ln // 2, ln // 2), f"the f64 Lanczos split's balance {lz64.eig.balance()}")
    print(
        f"lanczos f64 path: {lz64_solve.iterations} restarts (JAX f64 on the CPU: {JAX_F64_RESTARTS}), lambda_2 "
        f"{lz64.eig.eigenvalue!r} (JAX {JAX_F64_LAMBDA2!r}, |diff| {abs(lz64.eig.eigenvalue - JAX_F64_LAMBDA2):.3g}), "
        f"residual {lz64_solve.residual:.3g}, balance {lz64.eig.balance()}; e2e {lz64_s:.3f} s, spans "
        + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(lz64.timings.items()))
        + f"; launches {lz64_launches}"
    )
    report_device_busy("the f64 lanczos run", lambda: spectral_run("lanczos", None))
    reset_counts()
    lo64, lo64_s = spectral_run("lobpcg", None)
    lo64_launches = {kern.symbol: kern.launches for kern in all_kernels}
    check(not f32_launched() and K1_SPMM_F64.launches > 0, f"the f64 LOBPCG path launched {lo64_launches}")
    check(lo64.spectral_solve.refined is None, "the f64 LOBPCG run was refined on the host")
    check(abs(lo64.eig.eigenvalue - lz64.eig.eigenvalue) <= 1e-8,
          f"f64 LOBPCG lambda_2 {lo64.eig.eigenvalue!r} against Lanczos {lz64.eig.eigenvalue!r}")
    print(
        f"lobpcg f64 path: {lo64.spectral_solve.iterations} iterations (JAX f64 on the CPU: {JAX_F64_LOBPCG_ITERS}, "
        f"lambda_2 {JAX_F64_LOBPCG_LAMBDA2!r}), lambda_2 {lo64.eig.eigenvalue!r}, balance {lo64.eig.balance()}; "
        f"e2e {lo64_s:.3f} s, spans " + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(lo64.timings.items()))
        + f"; launches {lo64_launches}"
    )
    report_device_busy("the f64 lobpcg run", lambda: spectral_run("lobpcg", None))

    # The momentum exit at f64 on the component's KL graph, against the
    # JAX package's f64 split.
    def momentum64_run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = power_partition_fiedler(lk64, mom_config, dtype=torch.float64)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    reset_counts()
    (m64_lam, m64_med, _, m64_sides, m64_iters), m64_s = momentum64_run()
    m64_launches = {kern.symbol: kern.launches for kern in all_kernels}
    m64_steps, m64_checks = m64_iters - 1, (m64_iters - 1) // mom_config.check_interval
    check(not f32_launched() and K1_LAZY_F64.launches == m64_steps + m64_checks
          and K1_RESCALE_F64.launches == m64_steps and K1_Z_F64.launches == m64_checks + 1
          and K6_AXPY_F64.launches > 0 and K4_F64.launches == 1 + 2 * m64_checks,
          f"the f64 momentum path launched {m64_launches}")
    with open(MOMENTUM_F64_SIDES, "rb") as f:
        jax_m64 = np.unpackbits(np.frombuffer(f.read(), np.uint8))[:ln].astype(np.int8)
    m64_hamming = int((m64_sides != jax_m64).sum())
    m64_hamming = min(m64_hamming, ln - m64_hamming)
    check(m64_iters == JAX_F64_MOMENTUM_ITERS, f"f64 momentum: {m64_iters} iterations, JAX {JAX_F64_MOMENTUM_ITERS}")
    check(m64_hamming <= 0.01 * ln, f"f64 momentum: the split is {m64_hamming} nodes from the JAX run's")
    print(
        f"momentum f64 path: {m64_iters} iterations (JAX {JAX_F64_MOMENTUM_ITERS}), lambda {m64_lam!r}, median "
        f"{m64_med!r}, split {m64_hamming} nodes from the JAX run's; e2e {m64_s:.3f} s; launches {m64_launches}"
    )
    report_device_busy("the f64 momentum run", momentum64_run)

    # The f64 multi-start through the user's entry point.
    def multi64_run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fused_partition(hg, use_eig=True, starts=STARTS, perturb=PERTURB, kl_config=multi_config,
                            dtype=torch.float64, device="cuda")
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    reset_counts()
    multi64, multi64_s = multi64_run()
    mu64_launches = {kern.symbol: kern.launches for kern in all_kernels}
    mu64_batched, mu64_single = K2_STARTS[STARTS], K2_STARTS[1]
    mkl64 = multi64.kl
    check(not f32_launched() and K2_F64.launches == mu64_batched + mu64_single and mu64_batched >= 2,
          f"the f64 multi-start path launched {mu64_launches}, K2 by starts {dict(K2_STARTS)}")
    check(mkl64.best_cut <= min(multi64.start_cuts) <= multi64.start_cuts[0] <= kl64.best_cut,
          f"f64 multi-start: best {mkl64.best_cut}, per start {multi64.start_cuts}, one start {kl64.best_cut}")
    mu64_drift = abs(mkl64.final_cut - mkl64.verified_cut) / mkl64.final_cut
    check(mu64_drift <= 1e-10, f"f64 multi-start: cut drift {mu64_drift:.3g} above 1e-10")
    mu64_recount = host_cut(g_host, np.asarray(mkl64.best_sides))
    check(abs(mu64_recount - mkl64.best_cut) <= 1e-12 * mkl64.best_cut,
          f"f64 multi-start: best cut {mkl64.best_cut!r} against the host recount {mu64_recount!r}")
    print(
        f"multi-start f64 gen {MULTIPLIER}x ({STARTS} starts, passes until converged, {KICKS} kicks): per-start "
        f"best cuts {[round(c, 2) for c in multi64.start_cuts]}, {mu64_batched} batch passes, {mu64_single} kick "
        f"passes, best cut {mkl64.best_cut!r} (one start: {kl64.best_cut!r}), drift {mu64_drift:.3g}, host "
        f"recount {mu64_recount!r}; e2e {multi64_s:.3f} s on {card}; launches {mu64_launches}"
    )
    print(f"f64 phase: {time.perf_counter() - t_phase:.1f} s")

    # Phase 12: the CSR plan path (ROADMAP.md A10), the JAX package's plan
    # path on its accelerator, where every f32 SpMV takes its v2 plan's order
    # (gen 1.0x: rblock 16,384, Q 512, a COO tail of 125 entries).  K1's
    # spmv_v2_f32 entry points (bf16 and f32 products, the SpMV and its
    # lazy-walk form) bit for bit against their plain versions at gen 1.0x's
    # padded state; K4's fused dot and K6's vectorized last block at the
    # sizes where XLA takes them (below 4,096 values, 33 to 1,024 rows);
    # then, each path with the counts set to 0 just before it and read just
    # after: the bf16-intermediate one-start run through
    # fused_partition(with_plan=True), held to the port's plain run on the
    # CPU (tools/plan_order_reference.py), the quality A/B of
    # PARITY.md:84-88 over 5 spectral seeds in three cells, the momentum
    # exit on the component's padded state (bf16i and f32), and the
    # one-start run on gen 0.02x, whose cuts take K4's fused dot.
    t_phase = time.perf_counter()
    gp = g_host.to_device(dev, torch.float32, with_plan=True)
    vlay = gp.plan.layout
    check(gp.plan.kernel == "v2" and gp.plan.padded_nodes == P and gp.plan.runs_bf16("bfloat16")
          and (vlay.rblock, vlay.quantum) == V2_GEOMETRY and isinstance(vlay.tail, CooTail)
          and vlay.tail.num_entries == V2_COO_TAIL, f"gen 1.0x's plan: {vlay.rblock}, {vlay.quantum}, {vlay.tail}")
    xs = torch.zeros(P, device=dev)
    xs[:n] = (torch.rand(n, generator=gen) - 0.5).to(dev)
    xs[: n : 89] = -0.0
    xs2d = xs.view(P // 128, 128)
    ds = torch.zeros(P, device=dev)
    ds[:n] = torch.sqrt(torch.where(g.degrees > 0, g.degrees, 1.0).double()).float().reciprocal()
    ds2d = ds.view(P // 128, 128)
    a_g = torch.sparse_csr_tensor(g.indptr.long(), g.indices.long(), g.data, size=(n, n))
    xs_n, ds_n = xs[:n], ds[:n]
    zs2d = lazy_z_cuda(xs2d, ds2d)
    # Bytes: the kept entries' CSR arrays, the COO tail's (row, col, w)
    # triplets (not the layout's 4 B per 32 rows that tell a warp where its
    # rows' triplets start), x's n values gathered (its sectors counted once each: every
    # value is read), y's P written; the lazy walk reads w and dsinv over
    # the whole padded state for its epilogue and gathers z = dsinv * w,
    # given (the momentum step's rescale writes it, and counts the write):
    # z read once, 4 P.  Operations: a product and an add per entry (bf16:
    # one rounding more) and the walk's epilogue.
    m_kept, m_tail = vlay.cols.numel(), vlay.tail.num_entries
    v2_entries = 4 * (n + 1) + 8 * m_kept + 12 * m_tail
    v2_bytes = v2_entries + 4 * n + 4 * P
    plan_k = {
        "spmv v2 bf16i": dict(
            kern=lambda: spmv_v2_cuda(vlay, xs2d, True), plain=lambda: spmv_v2_plain(vlay, xs2d, True),
            lib=None, symbol="spmv_v2_kernel", bound=bound(v2_bytes, 3 * (m_kept + m_tail))),
        "spmv v2 f32": dict(
            kern=lambda: spmv_v2_cuda(vlay, xs2d), plain=lambda: spmv_v2_plain(vlay, xs2d),
            lib=lambda: a_g @ xs_n, symbol="spmv_v2_kernel", bound=bound(v2_bytes, 2 * (m_kept + m_tail))),
        "lazy walk v2 bf16i": dict(
            kern=lambda: spmv_v2_cuda(vlay, xs2d, True, dsinv=ds2d, z=zs2d),
            plain=lambda: lazy_walk_v2_plain(vlay, xs2d, ds2d, True, z=zs2d),
            lib=None, symbol="spmv_v2_kernel", bound=bound(v2_entries + 16 * P, 3 * (m_kept + m_tail) + 3 * P)),
        "lazy walk v2 f32": dict(
            kern=lambda: spmv_v2_cuda(vlay, xs2d, False, dsinv=ds2d, z=zs2d),
            plain=lambda: lazy_walk_v2_plain(vlay, xs2d, ds2d, False, z=zs2d),
            lib=lambda: 0.5 * (xs_n + ds_n * (a_g @ (ds_n * xs_n))), symbol="spmv_v2_kernel",
            bound=bound(v2_entries + 16 * P, 2 * (m_kept + m_tail) + 3 * P)),
    }
    for bf in (True, False):
        check(same_bits(spmv_v2_cuda(vlay, xs2d, bf, dsinv=ds2d), spmv_v2_cuda(vlay, xs2d, bf, dsinv=ds2d, z=zs2d)),
              f"the v2 lazy walk (bf16 {bf}) with its z pass differs from the walk given z")
    for what, e in plan_k.items():
        e["err"] = held_bitwise(e["kern"], e["plain"], what)
        e["ms"] = cuda_ms(e["kern"], 200)
        e["plain_ms"] = cuda_ms(e["plain"], 3)
        e["library_ms"] = None if e["lib"] is None else cuda_ms(e["lib"], 200)
        e["library_device_us"] = None if e["lib"] is None else library_device_us(e["lib"])
        e["device_us"] = device_us_per_launch(lambda e=e: [e["kern"]() for _ in range(50)], e["symbol"])
        print(
            f"{what} on gen {MULTIPLIER}x's padded state (P = {P}): bitwise equal to its plain version; "
            f"{e['ms']:.4f} ms, device {fmt_us(e['device_us'])} per launch, plain {e['plain_ms']:.3f} ms, "
            + ("library none (no PyTorch call rounds each product to bf16)" if e["lib"] is None else
               f"library {e['library_ms']:.4f} ms (device {fmt_us([e['library_device_us']])} per call, "
               f"torch.sparse in its own order)")
            + f", bound {e['bound'][0]:.5f} ms by {e['bound'][1]}"
        )
    y_bf, y_f32 = plan_k["spmv v2 bf16i"]["kern"](), plan_k["spmv v2 f32"]["kern"]()
    check(torch.equal(y_f32.view(-1)[:n], spmv_v2_cuda(vlay, xs_n)), "the padded v2 SpMV differs from the flat one")
    check(bool((bits32(y_bf.view(-1)[n:]) == 0).all()), "the bf16i SpMV's padding rows are not +0")
    bf_rel = float(((y_bf - y_f32).abs().view(-1)[:n] / (a_g @ xs_n.abs()).clamp_min(1e-30)).max())
    check(0 < bf_rel <= 2.0**-8, f"the bf16 rounding moved a row by {bf_rel:.3g} of its absolute sum")
    print(f"bf16i against f32 on gen {MULTIPLIER}x: largest row change {bf_rel:.3g} of the row's absolute sum")

    # K4's fused dot at gen 0.02x's length and the sizes around XLA's
    # vector loop (remainders, the epilogue, the scalar and unrolled
    # lengths, the 4,096-value threshold), with -0, +0 and subnormal
    # inputs, in every order, against the plain versions.
    fd_err = 0.0
    for size in (0, 1, 7, 31, 32, 33, 45, 100, 160, 191, 192, 223, 224, 351, 380, 1000, 1031, 3694, 4038, 4095, 6000):
        fa = (torch.rand(size, generator=gen) - 0.5)
        fb = (torch.rand(size, generator=gen) - 0.5)
        fa[::11], fb[::13], fa[5::17] = -0.0, 0.0, 1e-41
        for order in R.FUSED_ORDERS:
            got = R.fused_dot_batch_cuda((fa.to(dev), fb.to(dev)), (fb.to(dev), fa.to(dev)), order)
            want = torch.stack([R.fused_dot_plain(fa, fb, order), R.fused_dot_plain(fb, fa, order)])
            check(torch.equal(bits32(got.cpu()), bits32(want)), f"K4's fused dot ({order}, {size} values) "
                  f"{got.tolist()} differs from its plain version {want.tolist()}")
            fd_err = max(fd_err, float((got.cpu() - want).abs().max()))
    n02 = 4038
    fx, fy = (torch.rand(n02, generator=gen) - 0.5).to(dev), (torch.rand(n02, generator=gen) - 0.5).to(dev)
    fd_ms = cuda_ms(lambda: R.fused_dot_batch_cuda((fx,), (fy,), "lanes"), 200)
    fd_plain_ms = cuda_ms(lambda: R.fused_dot_plain(fx, fy, "lanes"), 3)
    fd_lib_ms = cuda_ms(lambda: torch.dot(fx, fy), 200)
    fd_lib_us = library_device_us(lambda: torch.dot(fx, fy))
    fd_us = device_us_per_launch(lambda: [R.fused_dot_batch_cuda((fx,), (fy,), "lanes") for _ in range(50)],
                                 "fused_dot_batch_kernel")
    fd_chain_us = device_us_per_launch(lambda: [R.fused_dot_batch_cuda((fx,), (fy,), "chain") for _ in range(50)],
                                       "fused_dot_batch_kernel")
    fd_rows_us = device_us_per_launch(lambda: [R.fused_dot_batch_cuda((fx,), (fy,), "rows") for _ in range(50)],
                                      "fused_dot_batch_kernel")
    fd_bound = bound(8 * n02, 2 * n02)
    print(f"K4 fused dot: bitwise equal to its plain versions at 0-6,000 values in every order; at {n02} values "
          f"{fd_ms:.4f} ms, device {fmt_us(fd_us)} per launch (the chain order {fmt_us(fd_chain_us)}, the rows order "
          f"{fmt_us(fd_rows_us)}), plain "
          f"{fd_plain_ms:.3f} ms, torch.dot "
          f"{fd_lib_ms:.4f} ms (device {fmt_us([fd_lib_us])}), bound {fd_bound[0]:.6f} ms by {fd_bound[1]}")

    # K6's last block across XLA's lanes: every (k, 4) last block.
    for k in range(2, 33):
        rows = 32 * k - 5
        v2d = (torch.rand(rows, 128, generator=gen) - 0.5) * 3.0
        got = R.tree_norm_2d(v2d.to(dev)).cpu()
        want = R.tree_norm_2d(v2d)
        check(torch.equal(bits32(got), bits32(want)), f"K6's 2-D norm over {rows} rows differs from its plain version")
    print("K6's 2-D norm at every last block (k, 4), k = 2-32 (33-1,024 rows): bitwise equal to its plain version")

    def plan_run(seed, inter, with_plan, circuit=hg):
        torch.cuda.synchronize()
        t = time.perf_counter()
        r = fused_partition(circuit, use_eig=True, device="cuda", with_plan=with_plan,
                            spectral_config=SpectralConfig(solver="power", seed=seed, inter_dtype=inter))
        torch.cuda.synchronize()
        return r, time.perf_counter() - t

    # The bf16-intermediate one-start run (the JAX package's default on its
    # accelerator), through the user's entry point.
    reset_counts()
    bf_run, bf_s = plan_run(SEED, "bfloat16", True)
    bf_launches = {kern.symbol: kern.launches for kern in all_kernels}
    bkl, b_iters = bf_run.kl, bf_run.spectral_iterations
    # Per power step the v2 SpMV with bf16 products, K6's padded step, its
    # 2-D norm and its scale; the Rayleigh quotient's SpMV once more; the v2
    # SpMV in f32 for the pass's A @ s and its recount (the plan's order, as
    # the JAX package's spmv takes it on a planned graph); K4 for the
    # Rayleigh quotient.
    check(K1_V2_BF16I.launches == b_iters + 1 and K6_STEP.launches == b_iters and K6_SCALE.launches == b_iters
          and K1_STEP.launches == 0 and K1.launches == 0 and K1_V2.launches == 2 and K1_V1.launches == 0
          and K4.launches == 1 and K2.launches == 1,
          f"the bf16i run launched {bf_launches} for {b_iters} power steps")
    got_bf = (b_iters, bkl.iterations, bkl.initial_cut, bkl.best_cut, bkl.final_cut)
    check(got_bf == PLAN_BF16I, f"the bf16i one-start run gave {got_bf}, not the CPU run's {PLAN_BF16I}")
    b_drift = abs(bkl.final_cut - bkl.verified_cut) / bkl.final_cut
    b_recount = host_cut(g_host, np.asarray(bkl.best_sides))
    check(b_drift <= 1e-5, f"bf16i run: cut drift {b_drift:.3g} above 1e-5")
    check(bkl.best_cut <= bkl.initial_cut, "bf16i run: best cut above the initial cut")
    check(bkl.best_cut <= 1.03 * JAX_CPU_BEST_CUT, f"bf16i run: best cut {bkl.best_cut} above 1.03 x {JAX_CPU_BEST_CUT}")
    check(abs(b_recount - bkl.best_cut) <= 1e-4 * bkl.best_cut,
          f"bf16i run: best cut {bkl.best_cut} disagrees with the host f64 recount {b_recount}")
    print(
        f"bf16i one-start run (fused_partition(with_plan=True), P = {P}): {b_iters} power iterations, initial cut "
        f"{bkl.initial_cut}, best cut {bkl.best_cut} after {bkl.iterations} swaps, final {bkl.final_cut}, verified "
        f"{bkl.verified_cut} (drift {b_drift:.3g}), host f64 recount {b_recount:.4f}; e2e {bf_s:.3f} s on {card}; "
        f"spans " + ", ".join(f"{k} {v:.3f} s" for k, v in sorted(bf_run.timings.items())) + f"; launches {bf_launches}"
    )

    # The quality A/B (PARITY.md:84-88 on the TPU): the CSR f32 path (the
    # default), the padded f32 path and the padded bf16i path, spectral
    # seeds 42-46, the cells in turns within each seed.
    ab = {cell: [] for cell in AB_CELLS}
    ab_launches = {}
    for seed in AB_SEEDS:
        for cell in AB_CELLS:
            reset_counts()
            with knobs(AB_KNOBS.get(cell, {})):
                r, t = plan_run(seed, "float32" if "f32" in cell else "bfloat16", cell != "csr f32")
            if seed == AB_SEEDS[0]:  # the kernels line's launches are seed 42's
                ab_launches[cell] = {kern.symbol: kern.launches for kern in all_kernels if kern.launches}
            ab[cell].append({"initial": r.kl.initial_cut, "best": r.kl.best_cut, "iterations": r.spectral_iterations,
                             "swaps": r.kl.iterations, "e2e_s": t})
            check(r.kl.best_cut <= r.kl.initial_cut, f"A/B {cell} seed {seed}: best cut above the initial cut")
    ab_summary = {}
    for cell, rows in ab.items():
        col = {k: np.array([r[k] for r in rows], float) for k in rows[0]}
        ab_summary[cell] = {k: [float(v.mean()), float(v.std(ddof=1))] for k, v in col.items()}
        ab_summary[cell]["rows"] = rows
    check(ab["csr f32"][0]["best"] == kl.best_cut and ab["padded bf16i"][0]["best"] == bkl.best_cut,
          "the A/B's seed-42 cells differ from the one-start runs")
    check("spmv_v2_f32" in ab_launches["padded f32"] and "spmv_v2_bf16i_f32" in ab_launches["padded bf16i"]
          and "spmv_v2_bf16i_f32" not in ab_launches["padded f32"] and "power_step_f32" in ab_launches["csr f32"]
          and "spmv_v2_f32" not in ab_launches["csr f32"]
          and "spmv_v2_bf16w_f32" in ab_launches["padded bf16i bf16w"]
          and "spmv_v2_bf16i_f32" not in ab_launches["padded bf16i bf16w"], f"the A/B cells launched {ab_launches}")
    check(ab["padded bf16i bf16w"][0]["best"] == PLAN_BF16I_BF16W[3],
          f"the A/B's seed-42 bf16-weight cell gave {ab['padded bf16i bf16w'][0]['best']}, not {PLAN_BF16I_BF16W[3]}")
    for cell, summ in ab_summary.items():
        print(
            f"A/B {cell}, seeds {AB_SEEDS[0]}-{AB_SEEDS[-1]}: initial cut {summ['initial'][0]:.2f} +- "
            f"{summ['initial'][1]:.2f}, best cut {summ['best'][0]:.2f} +- {summ['best'][1]:.2f}, power iterations "
            f"{summ['iterations'][0]:.1f} +- {summ['iterations'][1]:.1f}, e2e {summ['e2e_s'][0]:.4f} +- "
            f"{summ['e2e_s'][1]:.4f} s; per seed {[(r['iterations'], round(r['best'], 2)) for r in summ['rows']]} on {card}"
        )

    # The momentum exit on the component's padded state: bf16i (the
    # default inter_dtype) and f32, against the CSR f32 run of phase 10.
    lkp = lcc_kl_host.to_device(dev, torch.float32, with_plan=True)
    check(isinstance(lkp.plan, CsrPlan) and lkp.plan.kernel == "v2", f"the component's plan: {lkp.plan}")
    mom_runs = {}
    for inter in ("bfloat16", "float32"):
        reset_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = power_partition_fiedler(lkp, dataclasses.replace(mom_config, inter_dtype=inter), dtype=torch.float32)
        torch.cuda.synchronize()
        mom_runs[inter] = (out, time.perf_counter() - t, {kern.symbol: kern.launches for kern in all_kernels if kern.launches})
        # One walk and one rescale per step, one z pass per check and at the
        # start, as on the CSR path (phase 10).
        lazy_k = K1_LAZY_V2_BF16I if inter == "bfloat16" else K1_LAZY_V2
        p_steps = out[4] - 1
        p_checks = p_steps // mom_config.check_interval
        check(lazy_k.launches == p_steps + p_checks and K1_RESCALE.launches == p_steps
              and K1_Z.launches == p_checks + 1 and K1_LAZY.launches == 0,
              f"momentum {inter} padded: {mom_runs[inter][2]} for {p_steps} steps and {p_checks} checks")
    for inter, ((m_lam, m_med, m_vals, m_sides, m_iters), m_s, m_launch) in mom_runs.items():
        ham = int((m_sides != mo_sides).sum())
        ham = min(ham, ln - ham)
        cos = float(abs(np.dot(m_vals, mo_vals)) / np.linalg.norm(m_vals) / np.linalg.norm(mo_vals))
        check(ham <= 0.01 * ln and cos >= 1 - 1e-4,
              f"momentum {inter} padded: split {ham} nodes, cos {cos} from the CSR f32 run")
        mom_runs[inter] = dict(iterations=m_iters, hamming_to_csr_f32=ham, cos_to_csr_f32=cos, e2e_s=m_s,
                               side_1=int(m_sides.sum()), launches=m_launch)
        print(f"momentum on the component's padded state, {inter}: {m_iters} steps (CSR f32: {mo_iters}), "
              f"split {ham} nodes from the CSR f32 run's, cos {cos:.9f}, e2e {m_s:.3f} s; launches {m_launch}")

    # The one-start run on gen 0.02x: its cuts' dots are K4's fused dot.
    hg02 = read_hgr(GEN_002)
    reset_counts()
    r02, r02_s = plan_run(SEED, "bfloat16", False, circuit=hg02)
    r02_launches = {kern.symbol: kern.launches for kern in all_kernels if kern.launches}
    check(K4_FUSED.launches == 3 and K4.launches == 0, f"gen 0.02x's one-start run launched {r02_launches}")
    check((r02.spectral_iterations, r02.kl.iterations) == (GEN002_ITERS, GEN002_SWAPS)
          and abs(r02.kl.best_cut - GEN002_BEST) < 0.005,
          f"gen 0.02x: {r02.spectral_iterations} power iterations, {r02.kl.iterations} swaps, best "
          f"{r02.kl.best_cut}, not {GEN002_ITERS}, {GEN002_SWAPS}, {GEN002_BEST}")
    print(f"gen 0.02x one-start run: {r02.spectral_iterations} power iterations, {r02.kl.iterations} swaps, best cut "
          f"{r02.kl.best_cut}, verified {r02.kl.verified_cut}; e2e {r02_s:.3f} s; launches {r02_launches}")
    print(json.dumps({"plan_path": {
        "card": card, "bf16i_one_start": {"iterations": b_iters, "initial": bkl.initial_cut, "best": bkl.best_cut,
                                          "swaps": bkl.iterations, "e2e_s": bf_s},
        "a_b": ab_summary, "momentum_padded": mom_runs}}))
    print(f"plan phase: {time.perf_counter() - t_phase:.1f} s")

    # Phase 13: the JAX mega engine's own path, called directly as a user
    # would (fused_refine_mega), on gen 0.02x (22,416 stored entries, a v1
    # plan) and on gen 1.0x (a v2 plan): K1's spmv_v1_f32 and spmv_v2_f32
    # (the TPU SpMVs' orders) held against their plain versions on the CPU,
    # then fused_refine_mega, which takes its starting A @ s and its recount
    # from them and its median from K7, held on gen 0.02x to the JAX
    # package's interpret-mode run of the same program
    # (tests/test_torch_faults.py:test_fused_refine_mega_equals_jax_on_gen002)
    # and on gen 1.0x to the port's plain run on the CPU
    # (tools/plan_order_reference.py).
    t_phase = time.perf_counter()
    host02 = clique_expand(hg02, "kl")
    g02, g02c = host02.to_device(dev), host02.to_device("cpu")
    lay, lay_c = g02.plan_layout, g02c.plan_layout
    n02 = host02.num_nodes
    rng = np.random.default_rng(SEED)
    xv = rng.standard_normal(n02).astype(np.float32)
    xv[::13] = -0.0
    sv = np.where(rng.random(n02) < 0.5, -1.0, 1.0).astype(np.float32)
    v1_err = 0.0
    for vec in (xv, sv):
        v2d = np.zeros(lay.padded_nodes, np.float32)
        v2d[:n02] = vec
        for t in (torch.as_tensor(vec), torch.as_tensor(v2d.reshape(-1, 128))):  # flat, and the padded state
            got = spmv_v1_cuda(lay, t.to(dev))
            ref = spmv_v1_plain(lay_c, t)
            check(torch.equal(bits32(got.cpu()), bits32(ref)), "spmv_v1_f32 is not bitwise equal to spmv_v1_plain")
            check(torch.equal(got, spmv_v1_cuda(lay, t.to(dev))), "two spmv_v1_f32 launches differ")
            v1_err = max(v1_err, float((got.cpu().double() - ref.double()).abs().max()))
    x02 = torch.as_tensor(xv).to(dev)
    a02 = torch.sparse_csr_tensor(g02.indptr.long(), g02.indices.long(), g02.data, size=(n02, n02))
    chunks = lay.num_chunks
    # Bytes: per chunk its int16 col_local and row_local, f32 weights, x
    # base and place in win_chunks; win_ptr; x in and y out.  Operations:
    # per slot its product and the scan's 9 adds, per segment end its add
    # into the window.
    v1_bytes = chunks * (512 * (2 + 2 + 4) + 4 + 4) + 4 * lay.win_ptr.numel() + 8 * n02
    v1_ops = chunks * 512 * (1 + 9) + int(segment_ends(lay).sum())
    v1 = {
        "ms": cuda_ms(lambda: spmv_v1_cuda(lay, x02), 200),
        "plain_ms": cuda_ms(lambda: spmv_v1_plain(lay, x02), 5),
        "library_ms": cuda_ms(lambda: a02 @ x02, 200),
        "device_us": device_us_per_launch(lambda: [spmv_v1_cuda(lay, x02) for _ in range(50)], "spmv_v1"),
        "library_device_us": library_device_us(lambda: a02 @ x02),
        "bound": (max(v1_bytes / HBM_BYTES_PER_S, v1_ops / F32_OPS_PER_S) * 1e3,
                  "bytes" if v1_bytes / HBM_BYTES_PER_S >= v1_ops / F32_OPS_PER_S else "operations"),
    }
    print(f"K1 spmv_v1_f32 at gen 0.02x ({chunks} chunks in {lay.num_windows} windows): bitwise equal to "
          f"spmv_v1_plain; {v1['ms']:.4f} ms, device {fmt_us(v1['device_us'])} per launch; plain "
          f"{v1['plain_ms']:.3f} ms; torch.sparse {v1['library_ms']:.4f} ms (device "
          f"{fmt_us([v1['library_device_us']])}); bound {v1['bound'][0] * 1e3:.3f} us by {v1['bound'][1]} "
          f"({v1_bytes} bytes, {v1_ops} operations)")
    # The earlier design (a block per y window walking its chunks) beside it, in
    # turns, on the same layout and x; its bits are the same.
    def v1_earlier(lay_, x_):
        y_ = torch.empty_like(x_)
        turn_designs.v1_earlier(turn_libs["v1"], lay_, x_, y_)
        return y_

    check(torch.equal(bits32(v1_earlier(lay, x02)), bits32(spmv_v1_cuda(lay, x02))),
          "the earlier spmv_v1_f32 design gives other bits than the kernel's")
    v1["turns_device_us"] = turns({"new": lambda: spmv_v1_cuda(lay, x02), "earlier": lambda: v1_earlier(lay, x02)},
                                  "spmv_v1")
    print(f"K1 spmv_v1_f32 at gen 0.02x in turns (new, earlier, earlier, new): new "
          f"{fmt_us(v1['turns_device_us']['new'])}, the earlier design {fmt_us(v1['turns_device_us']['earlier'])} per "
          f"launch")
    # The CSR plan path on gen 0.02x (its v1 plan): spmv_v1_f32 on the
    # padded state, per power step, held to the same run of the plain
    # versions on the CPU.
    x02p = torch.zeros(lay.padded_nodes, device=dev)
    x02p[:n02] = x02
    x02p = x02p.view(-1, 128)
    v1["padded_device_us"] = device_us_per_launch(lambda: [spmv_v1_cuda(lay, x02p) for _ in range(50)], "spmv_v1")
    reset_counts()
    r02p, r02p_s = plan_run(SEED, "bfloat16", True, circuit=hg02)
    r02p_launches = {kern.symbol: kern.launches for kern in all_kernels if kern.launches}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r02c = fused_partition(hg02, use_eig=True, device="cpu", with_plan=True,
                               spectral_config=SpectralConfig(solver="power", seed=SEED))
    finally:
        torch.set_num_threads(threads)
    got02, want02 = ((r.spectral_iterations, r.kl.iterations, r.kl.best_cut, r.kl.verified_cut) for r in (r02p, r02c))
    check(got02 == want02 and K1_V1.launches == r02p.spectral_iterations + 3 and K1_V2.launches == 0
          and K1_STEP.launches == 0, f"gen 0.02x's plan path gave {got02} (CPU {want02}), launches {r02p_launches}")
    print(f"plan path on gen 0.02x (fused_partition(with_plan=True), a v1 plan): {r02p.spectral_iterations} power "
          f"iterations, {r02p.kl.iterations} swaps, best cut {r02p.kl.best_cut}, verified {r02p.kl.verified_cut}: "
          f"the plain CPU run's bits; spmv_v1_f32 on the padded state device {fmt_us(v1['padded_device_us'])} per "
          f"launch; e2e {r02p_s:.3f} s; launches {r02p_launches}")

    # The 6,000-node random graph (78,752 entries: a v2 plan with a v1 tail;
    # tests/conftest.py:random_hypergraph(default_rng(21), 6000, 7800, 5)):
    # spmv_v2_f32 after spmv_v1_f32 for the tail, against the plain version.
    rng6 = np.random.default_rng(21)
    sizes6 = rng6.integers(2, 6, size=7800)
    pins6 = np.concatenate([rng6.choice(6000, size=k, replace=False) for k in sizes6]).astype(np.int32)
    offs6 = np.zeros(7801, np.int64)
    np.cumsum(sizes6, out=offs6[1:])
    host6 = clique_expand(Hypergraph(6000, 7800, pins6, offs6), "kl")
    lay6, lay6_c = host6.to_device(dev).plan_layout, host6.to_device("cpu").plan_layout
    x6 = torch.as_tensor(rng6.standard_normal(6000).astype(np.float32))
    got6 = spmv_v2_cuda(lay6, x6.to(dev))
    check(isinstance(lay6.tail, V1Layout) and host6.nnz == 78_752
          and torch.equal(bits32(got6.cpu()), bits32(spmv_v2_plain(lay6_c, x6))),
          "spmv_v2_f32 on the 6,000-node graph differs from its plain version")
    x6d = x6.to(dev)
    v2_6000 = {
        "ms": cuda_ms(lambda: spmv_v2_cuda(lay6, x6d), 200),
        "device_us": device_us_per_launch(lambda: [spmv_v2_cuda(lay6, x6d) for _ in range(50)], "spmv_v2"),
        "tail_device_us": device_us_per_launch(lambda: [spmv_v2_cuda(lay6, x6d) for _ in range(50)], "spmv_v1"),
    }
    print(f"K1 spmv_v2_f32 on the 6,000-node graph (78,752 entries, a v1 tail of {lay6.tail.num_chunks} chunks): "
          f"bitwise equal to its plain version; {v2_6000['ms']:.4f} ms per SpMV by events, device "
          f"{fmt_us(v2_6000['device_us'])} per launch and the tail's spmv_v1_f32 {fmt_us(v2_6000['tail_device_us'])}")
    tail6 = lay6.tail
    check(torch.equal(bits32(v1_earlier(tail6, x6d)), bits32(spmv_v1_cuda(tail6, x6d))),
          "the earlier spmv_v1_f32 design gives other bits on the 6,000-node graph's tail")
    v1_tail_bytes = tail6.num_chunks * (512 * 8 + 8) + 4 * tail6.win_ptr.numel() + 8 * 6000
    v1_tail_ops = tail6.num_chunks * 512 * 10 + int(segment_ends(tail6).sum())
    v1["tail"] = {
        "chunks": tail6.num_chunks, "windows": tail6.num_windows,
        "turns_device_us": turns({"new": lambda: spmv_v1_cuda(tail6, x6d),
                                  "earlier": lambda: v1_earlier(tail6, x6d)}, "spmv_v1"),
        "bound_ms": max(v1_tail_bytes / HBM_BYTES_PER_S, v1_tail_ops / F32_OPS_PER_S) * 1e3,
    }
    print(f"K1 spmv_v1_f32 as the 6,000-node graph's v1 tail ({tail6.num_chunks} chunks in {tail6.num_windows} "
          f"windows) in turns: new {fmt_us(v1['tail']['turns_device_us']['new'])}, the earlier design "
          f"{fmt_us(v1['tail']['turns_device_us']['earlier'])} per launch; bound {v1['tail']['bound_ms'] * 1e3:.4f} us")
    reset_counts()
    t0 = time.perf_counter()
    e_mega, k_mega, it_mega = fused_refine_mega(g02, SpectralConfig(solver="power"), KLConfig(gain_eps=1e-6))
    mega_s = time.perf_counter() - t0
    mega_launches = {kern.symbol: kern.launches for kern in all_kernels if kern.launches}
    check(K1_V1.launches == 2 and K7.launches > 0 and K2.launches == 1,
          f"the mega engine's path on gen 0.02x launched {mega_launches}")
    got_mega = (it_mega, e_mega.eigenvalue, k_mega.initial_cut, k_mega.best_cut, k_mega.iterations,
                k_mega.final_cut, k_mega.verified_cut, int(e_mega.sides.sum()))
    check(got_mega == JAX_MEGA_GEN002, f"the mega engine on gen 0.02x gave {got_mega}, not the JAX run's {JAX_MEGA_GEN002}")
    print(f"mega engine on gen 0.02x (fused_refine_mega, spmv_order plan): {it_mega} power iterations, "
          f"eigenvalue {e_mega.eigenvalue}, initial cut {k_mega.initial_cut}, best {k_mega.best_cut} after "
          f"{k_mega.iterations} swaps, verified {k_mega.verified_cut}: the JAX package's interpret-mode run bit for "
          f"bit; e2e {mega_s:.3f} s; launches {mega_launches}")

    # gen 1.0x: spmv_v2_f32 on the flat vector the mega engine gives it, on
    # signs and on normal values, against its plain version on the CPU.
    check(g.plan is None and isinstance(g.plan_layout, V2Layout), "gen 1.0x's mega layout is not a v2 one")
    mlay, mlay_c = g.plan_layout, CsrPlan.for_graph(g_host.to_device("cpu")).layout
    v2_err = 0.0
    for vec in (xs_n.cpu(), sides_to_signs(torch.as_tensor(np.asarray(kl.sides)), torch.float32)):
        got = spmv_v2_cuda(mlay, vec.to(dev))
        with torch.no_grad():
            ref = spmv_v2_plain(mlay_c, vec)
        check(torch.equal(bits32(got.cpu()), bits32(ref)), "spmv_v2_f32 is not bitwise equal to spmv_v2_plain at gen 1.0x")
        v2_err = max(v2_err, float((got.cpu().double() - ref.double()).abs().max()))
    print(f"K1 spmv_v2_f32 on gen {MULTIPLIER}x's flat vectors (the mega engine's A @ s): bitwise equal to "
          f"spmv_v2_plain on the CPU")
    reset_counts()
    t0 = time.perf_counter()
    e_m1, k_m1, it_m1 = fused_refine_mega(g, SpectralConfig(solver="power"), KLConfig(gain_eps=1e-6))
    torch.cuda.synchronize()
    mega1_s = time.perf_counter() - t0
    mega1_launches = {kern.symbol: kern.launches for kern in all_kernels if kern.launches}
    check(K1_V2.launches == 2 and K1_V1.launches == 0 and K7.launches > 0 and K2.launches == 1,
          f"the mega engine's path on gen 1.0x launched {mega1_launches}")
    got_m1 = (it_m1, e_m1.eigenvalue, k_m1.initial_cut, k_m1.best_cut, k_m1.iterations, k_m1.final_cut,
              k_m1.verified_cut, int(e_m1.sides.sum()))
    check(got_m1 == MEGA_GEN1, f"the mega engine on gen 1.0x gave {got_m1}, not the CPU run's {MEGA_GEN1}")
    m1_drift = abs(k_m1.final_cut - k_m1.verified_cut) / k_m1.final_cut
    check(m1_drift <= 1e-5, f"the mega engine on gen 1.0x: cut drift {m1_drift:.3g} above 1e-5")
    print(f"mega engine on gen {MULTIPLIER}x (fused_refine_mega, spmv_order plan, the v2 order): {it_m1} power "
          f"iterations, eigenvalue {e_m1.eigenvalue}, initial cut {k_m1.initial_cut}, best {k_m1.best_cut} after "
          f"{k_m1.iterations} swaps, final {k_m1.final_cut}, verified {k_m1.verified_cut} (drift {m1_drift:.3g}): "
          f"the port's plain CPU run bit for bit; e2e {mega1_s:.3f} s on {card}; launches {mega1_launches}")
    print(f"mega phase: {time.perf_counter() - t_phase:.1f} s")

    # Phase 14: the v2 SpMV's other forms, which the power solve's plan branch
    # takes where the environment asks for them, as the JAX package's does:
    # bf16 weights (EIG_KL_TPU_BF16_W=1, with bf16 products) and the orders
    # of the opt-in reduce kernels (EIG_KL_TPU_REDUCE_IMPL: "vpu", and "mxu2"
    # at row blocks up to 2,048; "mxuv", and "mxu2" at gen 1.0x's 16,384,
    # take the default's order and entry point).  Every entry point bit for
    # bit against its plain version and timed: the vpu and bf16-weight forms
    # at gen 1.0x's padded state, the mxu2 forms on the 6,000-node graph at
    # row block 512 (4 partials; and checked at 2,048, 2 partials).  Then
    # each path with the counts set to 0 just before it and read just after:
    # the bf16i one start at gen 1.0x under bf16 weights, under "vpu" and
    # under both, and the padded f32 one start under "vpu", each held to the
    # port's plain CPU run (tools/plan_order_reference.py --forms); the
    # momentum exit on the component's padded state under each; and on the
    # 6,000-node graph (its plan's row block is 512) the one start in f32,
    # with bf16 products and with bf16 weights under "mxu2", each held to the
    # same run of the plain versions on the CPU, and its momentum exits.
    t_phase = time.perf_counter()
    forms = {}

    def form_bound(lay, products, order, lazy):
        # Bytes: as the default forms' (phase 12), with 2 B per weight for
        # bf16 weights and each kept entry's 2 B slot for the mxu2 and vpu
        # orders; a v1 tail's chunks (col, row, weight, their base and
        # window) read by spmv_v1_f32.  Operations: a product and an add per
        # entry, one rounding more with bf16 products, and the lazy walk's
        # epilogue.
        nn, pp, m = lay.num_nodes, lay.padded_nodes, lay.cols.numel()
        tail = lay.tail
        if isinstance(tail, CooTail):
            t_bytes, t_m = 12 * tail.num_entries, tail.num_entries
        elif isinstance(tail, V1Layout):
            t_bytes = tail.num_chunks * (512 * 8 + 8) + 4 * tail.win_ptr.numel()
            t_m = int((tail.weights != 0).sum())
        else:
            t_bytes = t_m = 0
        entries = 4 * (nn + 1) + m * (6 if products == "bf16w" else 8) + (0 if order == "mxu" else 2 * m) + t_bytes
        per = 2 + (products != "f32")
        if lazy:  # w, dsinv and z read, y written (phase 12)
            return bound(entries + 16 * pp, per * (m + t_m) + 3 * pp)
        return bound(entries + 4 * nn + 4 * pp, per * (m + t_m))

    def form_check(lay, x2d, d2d, reduce, products, lazy, lib=None, timed=True):
        bf16, bf16w = products != "f32", products == "bf16w"
        kern = v2_kernel(lay, bf16, reduce, bf16w, lazy)
        kw = dict(reduce=reduce, bf16_weights=bf16w)
        z2d = lazy_z_cuda(x2d, d2d) if lazy else None
        if lazy:
            def run():
                return spmv_v2_cuda(lay, x2d, bf16, dsinv=d2d, z=z2d, **kw)

            def plain():
                return lazy_walk_v2_plain(lay, x2d, d2d, bf16, z=z2d, **kw)
        else:
            def run():
                return spmv_v2_cuda(lay, x2d, bf16, **kw)

            def plain():
                return spmv_v2_plain(lay, x2d, bf16, **kw)
        err = held_bitwise(run, plain, f"{kern.symbol} (row block {lay.rblock})")
        if not timed:
            return
        order = v2_order(lay, reduce)[0]
        # Beside it, on the same layout and state, the default order's form
        # (f32 weights where the form is the default order with bf16
        # weights).
        base_w = bf16w and order != "mxu"
        base_d = d2d if lazy else None
        base_us = device_us_per_launch(
            lambda: [spmv_v2_cuda(lay, x2d, bf16, dsinv=base_d, bf16_weights=base_w, z=z2d) for _ in range(50)],
            "spmv_v2_kernel")
        e = forms[kern.symbol] = dict(
            err=err, ms=cuda_ms(run, 200), plain_ms=cuda_ms(plain, 3),
            library_ms=None if lib is None else cuda_ms(lib, 200),
            library_device_us=None if lib is None else library_device_us(lib),
            device_us=device_us_per_launch(lambda: [run() for _ in range(50)], "spmv_v2"),
            bound=form_bound(lay, products, order, lazy), rblock=lay.rblock, nodes=lay.num_nodes,
            base_device_us=None if base_us is None else base_us[0],
        )
        if order == "mxu2" and not lazy:
            # The earlier design (a lane per row, a switch on the slot class) and
            # the group design (a thread per partial) beside the kernel, in
            # turns, on the same layout and state; each gives its bits.
            designs, ref = {"new": run}, bits32(run())
            for variant in turn_designs.MXU2_VARIANTS:
                with turn_designs.swapped(kern, turn_libs[variant], variant):
                    check(torch.equal(bits32(run()), ref), f"the {variant} design of {kern.symbol} gives other bits")

                def other(variant=variant):
                    with turn_designs.swapped(kern, turn_libs[variant], variant):
                        return run()
                designs[variant] = other
            e["turns_device_us"] = turns(designs, "spmv_v2")
        print(f"K1 {kern.symbol} at row block {lay.rblock} ({lay.num_nodes} nodes, padded state): bitwise equal to "
              f"its plain version; {e['ms']:.4f} ms, device {fmt_us(e['device_us'])} per launch, plain "
              f"{e['plain_ms']:.3f} ms, " + ("library none (no PyTorch call rounds each product or weight to bf16)"
                                             if lib is None else f"library {e['library_ms']:.4f} ms (device "
                                             f"{fmt_us([e['library_device_us']])})")
              + f", bound {e['bound'][0]:.5f} ms by {e['bound'][1]}; the default's order on the same layout "
              f"{fmt_us(base_us)}" + ("; in turns " + ", ".join(f"{k} {fmt_us(v)}" for k, v in e["turns_device_us"].items())
                                      if "turns_device_us" in e else ""))

    vlay_w = dataclasses.replace(vlay, weights_bf16=to_bf16(vlay.weights))
    lib_spmv = lambda: a_g @ xs_n  # noqa: E731
    lib_lazy = lambda: 0.5 * (xs_n + ds_n * (a_g @ (ds_n * xs_n)))  # noqa: E731
    for lazy in (False, True):
        form_check(vlay_w, xs2d, ds2d, "mxu", "bf16w", lazy)
        for products in ("f32", "bf16i", "bf16w"):
            form_check(vlay_w, xs2d, ds2d, "vpu", products, lazy,
                       lib=(lib_lazy if lazy else lib_spmv) if products == "f32" else None)
    check(v2_kernel(vlay, False, "mxu2") is K1_V2 and v2_kernel(vlay, True, "mxuv", lazy=True) is K1_LAZY_V2_BF16I,
          "at row block 16,384 mxu2 and mxuv do not take the default's entry point")
    hg6 = Hypergraph(6000, 7800, pins6, offs6)
    g6d = host6.to_device(dev)
    a6 = torch.sparse_csr_tensor(g6d.indptr.long(), g6d.indices.long(), g6d.data, size=(6000, 6000))
    for rb6 in (512, 2048):
        lay6r = CsrPlan.for_graph(g6d, kernel="v2", rblock=rb6, bf16_weights=True).layout
        p6 = lay6r.padded_nodes
        x6p = torch.zeros(p6, device=dev)
        x6p[:6000] = x6d
        x6p[:6000:89] = -0.0
        d6p = torch.zeros(p6, device=dev)
        deg6 = torch.as_tensor(host6.weighted_degrees.astype(np.float32)).to(dev)
        d6p[:6000] = torch.sqrt(torch.where(deg6 > 0, deg6, 1.0).double()).float().reciprocal()
        x6n, d6n = x6p[:6000], d6p[:6000]
        for lazy in (False, True):
            for products in ("f32", "bf16i", "bf16w"):
                lib = None
                if products == "f32":
                    lib = (lambda: 0.5 * (x6n + d6n * (a6 @ (d6n * x6n)))) if lazy else (lambda: a6 @ x6n)
                form_check(lay6r, x6p.view(-1, 128), d6p.view(-1, 128), "mxu2", products, lazy, lib=lib,
                           timed=rb6 == 512)
        check(v2_order(lay6r, "mxu2") == ("mxu2", 4 if rb6 == 512 else 2), f"mxu2 at row block {rb6}")

    def path(env, fn):
        with knobs(env):
            reset_counts()
            out = fn()
            launched = {kern.symbol: kern.launches for kern in all_kernels if kern.launches}
        return out, launched

    form_paths = {}
    form_launches = {}
    v1_tail_launches = {}
    power_kernels = {"spmv_v2_f32", "spmv_v2_bf16i_f32"} | {k.symbol for k in K1_V2_FORMS.values() if not
                                                             k.symbol.startswith("lazy")}
    for tag, env, inter, sym, want in (
        ("bf16 weights", BF16W, "bfloat16", "spmv_v2_bf16w_f32", PLAN_BF16I_BF16W),
        ("vpu", VPU, "bfloat16", "spmv_v2_vpu_bf16i_f32", PLAN_BF16I_VPU),
        ("vpu, bf16 weights", {**VPU, **BF16W}, "bfloat16", "spmv_v2_vpu_bf16w_f32", PLAN_BF16I_BF16W_VPU),
        ("vpu, f32 products", VPU, "float32", "spmv_v2_vpu_f32", PLAN_F32_VPU),
    ):
        (r, r_s), launched = path(env, lambda inter=inter: plan_run(SEED, inter, True))
        rk = r.kl
        got = (r.spectral_iterations, rk.iterations, rk.initial_cut, rk.best_cut, rk.final_cut)
        # The power steps and the final quotient through the form, the KL
        # pass's A @ s and recount through the default's f32 form (the JAX
        # package's spmv ignores the knobs).
        others = {k: v for k, v in launched.items() if k in power_kernels and k not in (sym, "spmv_v2_f32")}
        check(launched.get(sym, 0) == r.spectral_iterations + 1 and launched.get("spmv_v2_f32", 0) == 2 and not others,
              f"the one start ({tag}) launched {launched}")
        check(got == want, f"the one start ({tag}) gave {got}, not the CPU run's {want}")
        drift = abs(rk.final_cut - rk.verified_cut) / rk.final_cut
        recount = host_cut(g_host, np.asarray(rk.best_sides))
        check(drift <= 1e-5 and rk.best_cut <= rk.initial_cut and abs(recount - rk.best_cut) <= 1e-4 * rk.best_cut,
              f"the one start ({tag}): drift {drift:.3g}, best {rk.best_cut}, initial {rk.initial_cut}, recount {recount}")
        form_paths[f"one start, {tag}"] = {"iterations": r.spectral_iterations, "swaps": rk.iterations,
                                           "initial": rk.initial_cut, "best": rk.best_cut, "e2e_s": r_s}
        form_launches[sym] = launched[sym]
        print(f"plan path one start at gen {MULTIPLIER}x, {tag} ({inter}): {r.spectral_iterations} power iterations, "
              f"initial cut {rk.initial_cut}, best {rk.best_cut} after {rk.iterations} swaps, final {rk.final_cut}, "
              f"verified {rk.verified_cut}: the port's plain CPU run bit for bit; e2e {r_s:.3f} s; launches {launched}")
    with knobs(BF16W):
        lkp_w = lcc_kl_host.to_device(dev, torch.float32, with_plan=True)
    check(lkp_w.plan.layout.weights_bf16 is not None and lkp.plan.layout.weights_bf16 is None,
          "the component's plans: bf16 weights kept where the knob is not set, or not kept where it is")

    def momentum_form(graph, inter):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = power_partition_fiedler(graph, dataclasses.replace(mom_config, inter_dtype=inter), dtype=torch.float32)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    for tag, graph, env, inter, sym in (
        ("bf16 weights", lkp_w, {}, "bfloat16", "lazy_walk_v2_bf16w_f32"),
        ("vpu", lkp, VPU, "bfloat16", "lazy_walk_v2_vpu_bf16i_f32"),
        ("vpu, bf16 weights", lkp_w, VPU, "bfloat16", "lazy_walk_v2_vpu_bf16w_f32"),
        ("vpu, f32 products", lkp, VPU, "float32", "lazy_walk_v2_vpu_f32"),
    ):
        ((m_lam, m_med, m_vals, m_sides, m_iters), m_s), launched = path(env, lambda g_=graph, i_=inter: momentum_form(g_, i_))
        check(launched.get(sym, 0) > m_iters and np.isfinite(m_vals).all() and np.isfinite(m_lam),
              f"the momentum exit ({tag}) launched {launched}")
        ham = int((m_sides != mo_sides).sum())
        ham = min(ham, ln - ham)
        cos = float(abs(np.dot(m_vals, mo_vals)) / np.linalg.norm(m_vals) / np.linalg.norm(mo_vals))
        form_paths[f"momentum, {tag}"] = {"iterations": m_iters, "hamming_to_csr_f32": ham, "cos_to_csr_f32": cos,
                                          "e2e_s": m_s}
        form_launches[sym] = launched[sym]
        print(f"momentum on the component's padded state, {tag} ({inter}): {m_iters} steps, split {ham} nodes from "
              f"the CSR f32 run's, cos {cos:.9f}, e2e {m_s:.3f} s; launches {launched}")
    del lkp_w

    threads = torch.get_num_threads()
    for tag, env, inter, sym in (
        ("mxu2, f32 products", {**MXU2, "EIG_KL_TPU_BF16_W": None}, "float32", "spmv_v2_mxu2_f32"),
        ("mxu2", {**MXU2, "EIG_KL_TPU_BF16_W": None}, "bfloat16", "spmv_v2_mxu2_bf16i_f32"),
        ("mxu2, bf16 weights", {**MXU2, **BF16W}, "bfloat16", "spmv_v2_mxu2_bf16w_f32"),
    ):
        (r, r_s), launched = path(env, lambda inter=inter: plan_run(SEED, inter, True, circuit=hg6))
        torch.set_num_threads(1)
        try:
            with knobs(env):
                rc = fused_partition(hg6, use_eig=True, device="cpu", with_plan=True,
                                     spectral_config=SpectralConfig(solver="power", seed=SEED, inter_dtype=inter))
        finally:
            torch.set_num_threads(threads)
        got6, want6 = ((x.spectral_iterations, x.kl.iterations, x.kl.best_cut, x.kl.verified_cut) for x in (r, rc))
        check(got6 == want6 and launched.get(sym, 0) == r.spectral_iterations + 1,
              f"the 6,000-node one start ({tag}) gave {got6} (CPU {want6}), launches {launched}")
        form_paths[f"6,000 nodes one start, {tag}"] = {"iterations": r.spectral_iterations, "swaps": r.kl.iterations,
                                                       "best": r.kl.best_cut, "e2e_s": r_s}
        v1_tail_launches[f"6000_one_start_{tag}"] = launched.get("spmv_v1_f32", 0)
        form_launches[sym] = launched[sym]
        print(f"plan path one start on the 6,000-node graph, {tag} ({inter}): {r.spectral_iterations} power "
              f"iterations, {r.kl.iterations} swaps, best cut {r.kl.best_cut}, verified {r.kl.verified_cut}: the "
              f"plain CPU run's bits; e2e {r_s:.3f} s; launches {launched}")
        lsym = sym.replace("spmv", "lazy_walk")
        with knobs(env):
            g6p = host6.to_device(dev, torch.float32, with_plan=True)
        check(g6p.plan.layout.rblock == 512, f"the 6,000-node plan's row block {g6p.plan.layout.rblock}")
        ((m_lam, _, m_vals, _, m_iters), m_s), launched = path(env, lambda: momentum_form(g6p, inter))
        check(launched.get(lsym, 0) > m_iters and np.isfinite(m_vals).all(),
              f"the 6,000-node momentum exit ({tag}) launched {launched}")
        form_paths[f"6,000 nodes momentum, {tag}"] = {"iterations": m_iters, "e2e_s": m_s}
        v1_tail_launches[f"6000_momentum_{tag}"] = launched.get("spmv_v1_f32", 0)
        form_launches[lsym] = launched[lsym]
        print(f"momentum on the 6,000-node graph's padded state, {tag}: {m_iters} steps, e2e {m_s:.3f} s; "
              f"launches {launched}")
    check(set(form_launches) == set(forms), f"paths launched {sorted(form_launches)}, timed {sorted(forms)}")
    print(json.dumps({"v2_forms": {"card": card, "paths": form_paths}}))
    print(f"forms phase: {time.perf_counter() - t_phase:.1f} s")

    # Phase 15: the engines across ranks (ROADMAP.md A8b, A8c) from the one
    # start's spectral split: sharded_refine_oc against K2's pass (phase 9),
    # the dp-sharded multi-start against the one-card one, the sharded power
    # iteration, at one rank over NCCL and two ranks on this card over gloo;
    # smega_refine across the two ranks (K5R); then the fused CLI under
    # EIG_KL_TPU_PROFILE_DIR.
    sharded = sharded_phase(dev, hg, g_host, sm_sides, k2_main, card, expect_swaps=MAIN_SWAPS,
                            power_ref=JAX_SHARDED_POWER)
    print(json.dumps({"sharded": sharded}))

    kernels = [
        {
            "name": "K1 spmv_csr_f32",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/spmv_csr.cu",
            "replaces": "eig_kl_tpu/ops/spmv_pallas.py:339",
            "launches": k1_launches,
            "launches_multi_start": m_k1,
            "launches_sharded_one_rank": sharded["oc"]["1 rank"]["launches"].get("spmv_csr_f32", 0),
            "max_abs_err": k1_err,
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound_ms,
            "bound_by": "bytes",
            "library_ms": k1_lib_ms,
            "device_us_per_launch": None if k1_us is None else k1_us[0],
            "library_device_us_per_call": None if k1_lib_us is None else k1_lib_us[0],
            "library_kernels_per_call": None if k1_lib_us is None else k1_lib_us[1],
        },
        {
            "name": "K1 power_step_f32",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/spmv_csr.cu",
            "replaces": "eig_kl_tpu/ops/spmv_pallas.py:339 (the SpMV, with the power step of eig_kl_tpu/spectral/power.py:184)",
            "launches": main_launches["power_step_f32"],
            "launches_multi_start": m_launches["power_step_f32"],
            "max_abs_err": k1s_err,
            "ms": k1s_ms,
            "plain_ms": k1s_plain_ms,
            "bound_ms": k1s_bound_ms,
            "bound_by": "bytes",
            "library_ms": k1s_lib_ms,
            "library_device_us": k1s_lib_us,
            "device_us_per_launch": None if k1s_us is None else k1s_us[0],
        },
        {
            "name": "K2 kl_pass_f32",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/kl_pass.cu",
            "replaces": "eig_kl_tpu/kl/megakernel.py:144",
            "launches": k2_launches,
            "launches_multi_start": m_single,
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
            "bound_ms": k2_bound_ms,
            "bound_by": k2_bound_by,
            "library_ms": None,
            "swaps": it_random,
            "global_cache_ms": k2_global_ms,
            "main_pass_swaps": it,
            "main_pass_ms": k2_main_ms,
            "us_per_swap": 1e3 * k2_main_ms / it,
            "us_per_swap_flat_and_cache_by_nodes": crossover,
        },
        {
            "name": "K2 kl_pass_f32, batched over starts",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/kl_pass.cu",
            "replaces": "eig_kl_tpu/kl/megakernel.py:638",
            "launches": m_batched,
            "launches_sharded_multi_start": {k: v["k2_launches_by_starts"] for k, v in sharded["multi_start"].items()},
            "max_abs_err": kb_err,
            "ms": kb_ms,
            "plain_ms": kb_plain_ms,
            "bound_ms": kb_bound_ms,
            "bound_by": kb_bound_by,
            "library_ms": None,
            "first_pass_ms": p_ms,
            "first_pass_bound_ms": p_bound_ms,
            "us_per_swap_by_starts": sweep,
        },
        {
            "name": "K3a gather_v3_f32",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/spmv_v3.cu",
            "replaces": "eig_kl_tpu/ops/spmv_pallas.py:1698",
            "launches": v3_launches["K3a"],
            "max_abs_err": k3a_err,
            "ms": k3a_ms,
            "plain_ms": k3a_plain_ms,
            "bound_ms": k3a_bound,
            "bound_by": "bytes",
            "library_ms": None,
        },
        {
            "name": "K3b benes_v3_f32, all stages of one network in its groups' launches",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/spmv_v3.cu",
            "replaces": "eig_kl_tpu/ops/spmv_pallas.py:1718",
            "launches": v3_launches["K3b"],
            "max_abs_err": k3b_err,
            "ms": k3b_ms,
            "plain_ms": k3b_plain_ms,
            "bound_ms": k3b_bound,
            "bound_by": "bytes",
            "library_ms": None,
            "launches_per_network": len(groups),
            "group_device_us": k3b_group_us[V.BENES_TILE],
            "tile_2_13_ms": k3b13_ms,
            "tile_2_13_group_device_us": k3b_group_us[1 << 13],
        },
        {
            "name": "K3c reduce_v3_f32",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/spmv_v3.cu",
            "replaces": "eig_kl_tpu/ops/spmv_pallas.py:1802",
            "launches": v3_launches["K3c"],
            "max_abs_err": k3c_err,
            "ms": k3c_ms,
            "plain_ms": k3c_plain_ms,
            "bound_ms": k3c_bound,
            "bound_by": "bytes",
            "library_ms": None,
            "device_us_per_launch_in_the_v3_spmv": k3c_us["in the v3 SpMV"],
            "device_us_per_launch_alone": k3c_us["alone"],
        },
        {
            "name": "v3 SpMV spmv_v3: K3a + K3b + K3c",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/spmv_v3.cu",
            "replaces": "eig_kl_tpu/ops/spmv_pallas.py:1841",
            "launches": v3_spmvs,
            "max_abs_err": v3_self_err,
            "ms": v3_ms,
            "plain_ms": v3_plain_ms,
            "bound_ms": v3_bound,
            "bound_by": "bytes",
            "library_ms": v3_lib_ms,
        },
        {
            "name": "K4 fma_dot_batch_f32",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/fma_dot.cu",
            "replaces": "eig_kl_tpu/spectral/power.py:413 (jnp.vdot, an XLA op, no Pallas kernel)",
            "launches": k4_launches,
            "launches_momentum": mo_launches["fma_dot_batch_f32"],
            "max_abs_err": k4_err,
            "ms": k4_ms,
            "plain_ms": k4_plain_ms,
            "bound_ms": k4_bound,
            "bound_by": "bytes",
            "library_ms": k4_lib_ms,
            "library_device_us": k4_lib_us,
            "device_us_per_launch": k4_batch["device_us_one_dot"],
            "device_us_two_dots_per_launch": k4_batch["device_us_two_dots"],
            "library_ms_two_dots": k4_batch["library_ms_two_dots"],
            "library_device_us_two_dots": k4_batch["library_device_us_two_dots"],
        },
        {
            "name": "K5 smega_pass_f32, S = 8 in the wrapper's layout, the first 1,000 swaps of the main path's pass",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/smega.cu",
            "replaces": "eig_kl_tpu/parallel/smega.py:166",
            "launches": k5_launches,
            "max_abs_err": k5_err,
            "ms": k5_ms,
            "plain_ms": k5_plain_ms,
            "bound_ms": k5_bound_ms,
            "bound_by": k5_bound_by,
            "library_ms": None,
            "pass_swaps": it,
            "pass_ms_by_shards": sm_ms,
            "pass_bound_ms": sm_bound[0],
            "us_per_swap_by_shards": {k: 1e3 * v / it for k, v in sm_ms.items()},
            "layout_by_shards": sm_layout,
            "us_per_swap_by_shards_and_layout": {
                k: {lay: 1e3 * v / it for lay, v in by.items()} for k, by in sm_ms_layout.items()
            },
            "us_per_swap_by_layout_on_smaller_circuits": k5_crossover,
            "k2_pass_ms": k2_main_ms,
            "e2e_s_by_shards": sm_s,
        },
        {
            "name": f"K5R smega_ranks_pass_f32, 2 ranks ({SMEGA_RANKS_LABEL}), the first "
                    f"{sharded['smega_ranks']['cap']} swaps of the main path's pass",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/smega.cu",
            "replaces": "eig_kl_tpu/parallel/smega.py:166 (n_dev > 1: the launch barrier :210-216, round A "
                        ":310-362, round B :480-559)",
            "launches": sharded["smega_ranks"]["gen1"]["launches_by_rank"][0].get("smega_ranks_pass_f32", 0),
            "launches_by_rank": sharded["smega_ranks"]["gen1"]["launches_by_rank"],
            "max_abs_err": sharded["smega_ranks"]["max_abs_err"],
            "ms": max(sharded["smega_ranks"]["gen1"]["device_ms_by_rank"]),
            "ms_from": "the kernel's own %globaltimer, the slower rank",
            "plain_ms": max(sharded["smega_ranks"]["plain_ms_by_rank"]),
            "plain_swaps": sharded["smega_ranks"]["plain_cap"],
            "bound_ms": sharded["smega_ranks"]["bound_ms"],
            "bound_by": sharded["smega_ranks"]["bound_by"],
            "library_ms": None,
            "us_per_swap": sharded["smega_ranks"]["gen1"]["us_per_swap"],
            "gen002_whole_pass": {k: sharded["smega_ranks"]["gen002"][k]
                                  for k in ("swaps", "device_ms_by_rank", "us_per_swap", "launches_by_rank")},
            "card": card,
        },
        {
            "name": "K6 tree_sum_f32, the 1-D norm over n",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/tree_sum.cu",
            "replaces": "eig_kl_tpu/spectral/power.py:185 (jnp.linalg.norm) and eig_kl_tpu/ops/partition.py:88 (.sum()), XLA ops, no Pallas kernel",
            "launches": main_launches["tree_sum_f32"],
            "launches_multi_start": m_launches["tree_sum_f32"],
            "launches_v3": v3_all["tree_sum_f32"],
            "max_abs_err": k6_err,
            "ms": k6["1-D"]["ms"],
            "plain_ms": k6["1-D"]["plain_ms"],
            "bound_ms": k6["1-D"]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": k6["1-D"]["library_ms"],
            "library_device_us": k6["1-D"]["library_device_us"],
            "device_us_per_launch": None if k6["1-D"]["device_us"] is None else k6["1-D"]["device_us"][0],
            "by_shape": k6,
            "power_solve_launches": steps_launches,
        },
        {
            "name": "K6 scale_by_f32, the power step's y / nrm",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/tree_sum.cu",
            "replaces": "eig_kl_tpu/spectral/power.py:187 (jnp.where(safe, y / nrm, y), XLA ops, no Pallas kernel)",
            "launches": main_launches["scale_by_f32"],
            "launches_multi_start": m_launches["scale_by_f32"],
            "launches_v3": v3_all["scale_by_f32"],
            "max_abs_err": k6s_err,
            "ms": k6s_ms,
            "plain_ms": k6s_plain_ms,
            "bound_ms": k6s_bound_ms,
            "bound_by": "bytes",
            "library_ms": k6s_lib_ms,
            "library_device_us": k6s_lib_us,
            "device_us_per_launch": None if k6s_us is None else k6s_us[0],
        },
    ]
    def new_entry(name, what, source, replaces, launches, **more):
        e = new[what]
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": e["err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound"][0], "bound_by": e["bound"][1], "library_ms": e["library_ms"],
            "library_device_us": e["library_device_us"],
            "device_us_per_launch": None if e["device_us"] is None else e["device_us"][0], **more,
        }

    kernels += [
        new_entry("K1 laplacian_f32, deg * x - A @ x", "laplacian", "eig_kl_tpu_torch/csrc/spmv_csr.cu",
                  "eig_kl_tpu/ops/spmv_pallas.py:339 (with eig_kl_tpu/spectral/lanczos.py:60's epilogue)",
                  lz_launches["laplacian_f32"], launches_lanczos_path=lz_launches),
        new_entry("K1 spmm_csr_f32, deg * X - A @ X, k = 4", "spmm k=4", "eig_kl_tpu_torch/csrc/spmv_csr.cu",
                  "eig_kl_tpu/ops/spmv_pallas.py:339 (vmapped by eig_kl_tpu/spectral/lobpcg_solver.py:51-56)",
                  lo_launches["spmm_csr_f32"], k1_columns_ms=new["spmm k=4"]["k1_columns_ms"],
                  launches_lobpcg_path=lo_launches),
        new_entry("K1 spmm_csr_f32, deg * X - A @ X, k = 12", "spmm k=12", "eig_kl_tpu_torch/csrc/spmv_csr.cu",
                  "eig_kl_tpu/ops/spmv_pallas.py:339 (vmapped by eig_kl_tpu/spectral/lobpcg_solver.py:51-56)",
                  lo_launches["spmm_csr_f32"], k1_columns_ms=new["spmm k=12"]["k1_columns_ms"]),
        new_entry("K1 lazy_walk_f32, 0.5 (w + dsinv * A @ z), z = dsinv * w given", "lazy walk",
                  "eig_kl_tpu_torch/csrc/spmv_csr.cu",
                  "eig_kl_tpu/ops/spmv_pallas.py:339 (with eig_kl_tpu/spectral/power.py:305's epilogue)",
                  mo_launches["lazy_walk_f32"], launches_momentum_path=mo_launches),
        new_entry("K6 axpy_f32, a * x + y fused (the momentum exit's deflation)", "axpy",
                  "eig_kl_tpu_torch/csrc/tree_sum.cu",
                  "eig_kl_tpu/spectral/power.py:310 (w - jnp.vdot(q0, w) * q0, XLA ops, no Pallas kernel)",
                  mo_launches["axpy_f32"]),
        new_entry("K6 padded_step_f32, the v3 padded power step", "padded step", "eig_kl_tpu_torch/csrc/tree_sum.cu",
                  "eig_kl_tpu/spectral/power.py:184 (x - inv_shift * norm_lap(x), XLA ops, no Pallas kernel)",
                  v3_all["padded_step_f32"]),
    ]
    plan_launches = {
        "spmv v2 bf16i": bf_launches["spmv_v2_bf16i_f32"],
        "spmv v2 f32": mega1_launches["spmv_v2_f32"],
        "lazy walk v2 bf16i": mom_runs["bfloat16"]["launches"]["lazy_walk_v2_bf16i_f32"],
        "lazy walk v2 f32": mom_runs["float32"]["launches"]["lazy_walk_v2_f32"],
    }
    v2_pair = ("eig_kl_tpu/ops/spmv_pallas.py:1049 (_gather_kernel) and :1118 (_reduce_kernel_mxu), "
               "in their own order")
    plan_names = {
        "spmv v2 bf16i": ("K1 spmv_v2_bf16i_f32, A @ x in the v2 TPU SpMV's order, bf16 products, on the padded "
                          "state (the plan path's power step)", f"{v2_pair}, inter_dtype bfloat16 (:1077)"),
        "spmv v2 f32": ("K1 spmv_v2_f32, A @ x in the v2 TPU SpMV's order, f32 products (the mega engine's A @ s "
                        "and recount above 32,768 entries; launches from fused_refine_mega on gen 1.0x)", v2_pair),
        "lazy walk v2 bf16i": ("K1 lazy_walk_v2_bf16i_f32, the lazy walk through the v2 order, bf16 products",
                               f"{v2_pair}, with eig_kl_tpu/spectral/power.py:305's epilogue"),
        "lazy walk v2 f32": ("K1 lazy_walk_v2_f32, the lazy walk through the v2 order, f32 products",
                             f"{v2_pair}, with eig_kl_tpu/spectral/power.py:305's epilogue"),
    }
    for what, e in plan_k.items():
        name, replaces = plan_names[what]
        kernels.append({
            "name": name, "route": "cuda", "source": "eig_kl_tpu_torch/csrc/spmv_csr.cu", "replaces": replaces,
            "launches": plan_launches[what], "max_abs_err": e["err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound"][0], "bound_by": e["bound"][1], "library_ms": e["library_ms"],
            "library_device_us": e["library_device_us"],
            "device_us_per_launch": None if e["device_us"] is None else e["device_us"][0],
            **({"turns_device_us": e["turns_device_us"]} if "turns_device_us" in e else {}),
            **({"library_none_because": "no PyTorch call rounds each product to bf16 before the sum"}
               if e["lib"] is None else {}),
            **({"device_us_per_launch_6000_nodes": None if v2_6000["device_us"] is None else v2_6000["device_us"][0],
                "tail_device_us_per_launch_6000_nodes":
                    None if v2_6000["tail_device_us"] is None else v2_6000["tail_device_us"][0]}
               if what == "spmv v2 f32" else {}),
        })
    kernels.append({
        "name": "K4 fused_dot_batch_f32, a dot with its operands' producers fused (XLA's loop order), 4,038 values",
        "route": "cuda", "source": "eig_kl_tpu_torch/csrc/fma_dot.cu",
        "replaces": "eig_kl_tpu/kl/megakernel.py:754, :773 and eig_kl_tpu/spectral/power.py:309, :336 "
                    "(jnp.vdot fused by XLA below 4,096 values, no Pallas kernel)",
        "launches": r02_launches["fused_dot_batch_f32"], "max_abs_err": fd_err, "ms": fd_ms,
        "plain_ms": fd_plain_ms, "bound_ms": fd_bound[0], "bound_by": fd_bound[1], "library_ms": fd_lib_ms,
        "library_device_us": fd_lib_us, "device_us_per_launch": None if fd_us is None else fd_us[0],
        "device_us_per_launch_chain_order": None if fd_chain_us is None else fd_chain_us[0],
        "device_us_per_launch_rows_order": None if fd_rows_us is None else fd_rows_us[0],
    })
    launches64 = {
        "K1 spmv_csr_f64": fu64_launches["spmv_csr_f64"], "K1 power_step_f64": fu64_launches["power_step_f64"],
        "K1 laplacian_f64": lz64_launches["laplacian_f64"], "K1 spmm_csr_f64 k=4": lo64_launches["spmm_csr_f64"],
        "K1 spmm_csr_f64 k=12": lo64_launches["spmm_csr_f64"], "K1 lazy_walk_f64": m64_launches["lazy_walk_f64"],
        "K6 tree_sum_f64, the 1-D norm over n": fu64_launches["tree_sum_f64"],
        "K6 scale_by_f64": fu64_launches["scale_by_f64"], "K6 axpy_f64": m64_launches["axpy_f64"],
        "K4 fma_dot_batch_f64": m64_launches["fma_dot_batch_f64"],
    }
    for what, e in f64.items():
        kernels.append({
            "name": what, "route": "cuda", "source": e["source"], "replaces": e["replaces"],
            "launches": launches64[what], "max_abs_err": e["err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound"][0], "bound_by": e["bound"][1], "library_ms": e["library_ms"],
            "library_device_us": e["library_device_us"],
            "device_us_per_launch": None if e["device_us"] is None else e["device_us"][0],
            **({"device_us_two_dots_per_launch": k4_batch64["device_us_two_dots"],
                "library_ms_two_dots": k4_batch64["library_ms_two_dots"],
                "library_device_us_two_dots": k4_batch64["library_device_us_two_dots"]}
               if what.startswith("K4") else {}),
            **({"turns_device_us": e["turns_device_us"]} if "turns_device_us" in e else {}),
        })
    # lazy_rescale and the z pass: launches from the momentum runs (f32 on the
    # component's CSR graph, and f64).
    z_launches = {"lazy rescale": mo_launches["lazy_rescale_f32"], "z pass": mo_launches["lazy_z_f32"],
                  "lazy rescale f64": m64_launches["lazy_rescale_f64"], "z pass f64": m64_launches["lazy_z_f64"]}
    for what, e in {**zk, **zk64}.items():
        rescale = what.startswith("lazy rescale")
        kernels.append({
            "name": f"K1 {'lazy_rescale' if rescale else 'lazy_z'}_{'f64' if what.endswith('f64') else 'f32'}, "
                    + ("the momentum step's (w * inv, u * inv) and the next walk's z = dsinv * (u * inv) in one pass"
                       if rescale else "the z pass z = dsinv * w for a walk whose vector no rescale made"),
            "route": "cuda", "source": "eig_kl_tpu_torch/csrc/spmv_csr.cu",
            "replaces": "none: eig_kl_tpu/spectral/power.py:322 (w * inv, u * inv) and the product dsinv_st * w "
                        "of :305 that XLA fuses into the walk's gather, XLA element-wise ops, no Pallas kernel",
            "launches": z_launches[what], "max_abs_err": e["err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound"][0], "bound_by": e["bound"][1], "library_ms": e["library_ms"],
            "library_device_us": e["library_device_us"],
            "device_us_per_launch": None if e["device_us"] is None else e["device_us"][0],
            **({"library_none_because": "no one PyTorch call writes the three vectors",
                "replaced_torch_ms": e["replaced_ms"], "replaced_torch_device_us": e["replaced_device_us"]}
               if rescale else {}),
        })
    kernels += [
        {
            "name": "K2 kl_pass_f64, 3,000 swaps of one start",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/kl_pass.cu",
            "replaces": "eig_kl_tpu/kl/megakernel.py:144 (at f64 the JAX package's XLA engine, eig_kl_tpu/kl/engine.py:206)",
            "launches": fu64_launches["kl_pass_f64"],
            "launches_multi_start": mu64_single,
            "max_abs_err": k2_64_err,
            "ms": k2_64_ms,
            "plain_ms": k2_64_plain_ms,
            "bound_ms": k2_64_bound[0],
            "bound_by": k2_64_bound[1],
            "library_ms": None,
            "ms_by_selection": k2_64_sel_ms,
            "us_per_swap_flat_and_cache_by_nodes": crossover64,
        },
        {
            "name": "K2 kl_pass_f64, batched over starts",
            "route": "cuda",
            "source": "eig_kl_tpu_torch/csrc/kl_pass.cu",
            "replaces": "eig_kl_tpu/kl/megakernel.py:638 (at f64 eig_kl_tpu/parallel/multi_start.py:44)",
            "launches": mu64_batched,
            "max_abs_err": kb64_err,
            "ms": kb64_ms,
            "plain_ms": kb64_plain_ms,
            "bound_ms": kb64_bound[0],
            "bound_by": kb64_bound[1],
            "library_ms": None,
        },
    ]
    kernels.append({
        "name": "K1 spmv_v1_f32, A @ s in the v1 TPU SpMV's order (the mega engine's start and recount), gen 0.02x",
        "route": "cuda", "source": "eig_kl_tpu_torch/csrc/spmv_csr.cu",
        "replaces": "eig_kl_tpu/ops/spmv_pallas.py:339 (_spmv_kernel, pallas_call :428, through "
                    "eig_kl_tpu/kl/megakernel.py:753, :770)",
        "launches": mega_launches.get("spmv_v1_f32", 0), "launches_main_path": main_launches["spmv_v1_f32"],
        "max_abs_err": v1_err, "ms": v1["ms"], "plain_ms": v1["plain_ms"], "bound_ms": v1["bound"][0],
        "bound_by": v1["bound"][1], "library_ms": v1["library_ms"], "library_device_us": v1["library_device_us"],
        "device_us_per_launch": None if v1["device_us"] is None else v1["device_us"][0],
        "device_us_per_launch_padded_state": None if v1["padded_device_us"] is None else v1["padded_device_us"][0],
        "launches_plan_path_gen002": r02p_launches["spmv_v1_f32"],
        "launches_by_path": {"mega_gen002": mega_launches.get("spmv_v1_f32", 0),
                             "plan_path_gen002": r02p_launches["spmv_v1_f32"], **v1_tail_launches},
        "turns_device_us": v1["turns_device_us"], "tail_6000": v1["tail"],
    })
    form_replaces = {
        "mxu": "eig_kl_tpu/ops/spmv_pallas.py:1049 (_gather_kernel with bf16 weights, EIG_KL_TPU_BF16_W: :109, "
               ":477-482) and :1118 (_reduce_kernel_mxu), in their own order",
        "mxu2": "eig_kl_tpu/ops/spmv_pallas.py:1049 (_gather_kernel) and :1276 (_reduce_kernel_mxu2, "
                "EIG_KL_TPU_REDUCE_IMPL=mxu2), in their own order",
        "vpu": "eig_kl_tpu/ops/spmv_pallas.py:1049 (_gather_kernel) and :1080 (_reduce_kernel, "
               "EIG_KL_TPU_REDUCE_IMPL=vpu), in their own order",
    }
    for sym, e in forms.items():
        order = "mxu2" if "_mxu2" in sym else "vpu" if "_vpu" in sym else "mxu"
        kernels.append({
            "name": f"K1 {sym}, {'the lazy walk' if sym.startswith('lazy') else 'A @ x'} in the v2 order of its "
                    f"form, at row block {e['rblock']} ({e['nodes']} nodes, padded state); launches from the "
                    f"plan path under its knobs",
            "route": "cuda", "source": "eig_kl_tpu_torch/csrc/spmv_csr.cu",
            "replaces": form_replaces[order]
            + (", with eig_kl_tpu/spectral/power.py:305's epilogue" if sym.startswith("lazy") else ""),
            "launches": form_launches[sym], "max_abs_err": e["err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound"][0], "bound_by": e["bound"][1], "library_ms": e["library_ms"],
            "library_device_us": e["library_device_us"],
            "device_us_per_launch": None if e["device_us"] is None else e["device_us"][0],
            "default_order_device_us_same_layout": e["base_device_us"],
            **({"turns_device_us": e["turns_device_us"]} if "turns_device_us" in e else {}),
            **({"library_none_because": "no PyTorch call rounds each product (or weight) to bf16 before the sum"}
               if e["library_ms"] is None else {}),
        })
    for dt, symbol in (("f32", "kth_smallest_f32"), ("f64", "kth_smallest_f64")):
        e = k7[f"{n} {dt}"]
        kernels.append({
            "name": f"K7 {symbol}, the exact rank select (the upper median), n = {n}",
            "route": "cuda", "source": "eig_kl_tpu_torch/csrc/select.cu",
            "replaces": "eig_kl_tpu/ops/select.py:118 (kth_smallest: _kth_key_bits :53, _kth_key_radix :68; "
                        "XLA ops, no Pallas kernel)",
            "launches": main_launches[symbol] if dt == "f32" else fu64_launches[symbol],
            "launches_by_path": {"main": main_launches[symbol], "multi_start": m_launches[symbol],
                                 "momentum": mo_launches[symbol], "f64_fused": fu64_launches[symbol],
                                 "f64_momentum": m64_launches[symbol], "mega_gen002": mega_launches.get(symbol, 0)},
            "max_abs_err": 0.0, "ms": e["ms"], "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
            "bound_by": "bytes", "library_ms": e["library_ms"], "library_device_us": e["library_device_us"],
            "device_us_per_launch": None if e["device_us"] is None else e["device_us"][0],
            "by_size": {tag: {**v, "device_us": None if v["device_us"] is None else v["device_us"][0]}
                        for tag, v in k7.items() if tag.endswith(dt)},
        })
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
