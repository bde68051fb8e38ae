"""The node-sharded KL pass (smega) on one card: kernel K5
(``csrc/smega.cu``), its plain version, and :func:`smega_refine` around it
(the port of ``eig_kl_tpu/parallel/smega.py``).

The JAX package runs one shard per TPU core of the mesh axis ``"mp"``:
each runs the whole swap loop over its 1/S of the nodes inside one Pallas
kernel, and per swap two rounds of remote DMA exchange each shard's
first-max candidate per side and the owner's ``w_ab``; each shard updates
only its own rows of ``A @ s`` (owner-computes).  On one card a shard is a
thread block, the S shards are one thread-block cluster, and the rounds go
through the cluster's distributed shared memory.  ``n_shards`` stands in
for ``mesh.shape["mp"]``; the same engine across cards is ROADMAP.md A8c.

Per swap, per shard ``r`` (nodes ``[r * n_local, (r + 1) * n_local)``):

1. the local first maximum of ``D = -(sf * a_s)`` per side (K5: through
   a row-max cache of the shard's own 128-node rows from
   :data:`K5_CACHE_MIN_NODES` nodes per shard up, refreshed by the owner
   of the rows a swap touched, as the TPU kernel's ``hierarchical`` mode;
   with the shard's state in shared memory where it fits; a flat scan
   below; :func:`k5_layout`);
2. round A: the global winner of each side by "larger value, then lower
   shard, then lower local index" (smega.py:351-362), which is the first
   maximum over all nodes, so the trajectory equals the single-chip
   engine's (K2) at every S;
3. the owner-computes updates of the shard's rows: its entries of row
   ``a`` get ``-2w``, then its entries of row ``b`` get ``+2w``
   (smega.py:446-514); b's owner finds ``w_ab`` in row ``a``; the owners
   lock a, b;
4. round B: every shard takes ``w_ab`` from b's owner and folds the gain
   ``m_l + m_r - 2 w_ab`` into the replicated Kahan cut, best cut, logs and
   termination count (smega.py:561-582).

The adjacency a shard reads: A is symmetric, so shard r's rows that
neighbour v are the entries of CSR row v whose columns lie in shard r's
range.  K5's block r walks the whole row and keeps those; that replaces
the TPU's column-transpose layout (``_build_colT``, a shape for its DMA
engine), whose entries are the same.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph, Graph
from eig_kl_tpu_torch.kl.megakernel import PassOutput
from eig_kl_tpu_torch.kl.result import KLResult, best_iteration, replay_swaps
from eig_kl_tpu_torch.ops._build import Kernel
from eig_kl_tpu_torch.ops.partition import sides_to_signs
from eig_kl_tpu_torch.ops.spmv import spmv
from eig_kl_tpu_torch.parallel.mesh import Mesh, NotPorted
from eig_kl_tpu_torch.utils.config import KLConfig
from eig_kl_tpu_torch.utils.device import resolve_device

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
K5 = Kernel(
    "smega",
    "smega_pass_f32",
    [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P],
)
#: The cluster sizes K5 launches: the portable ones, at most 8 blocks.
CLUSTER_SHARDS = (1, 2, 4, 8)
#: K5's three layouts, in the kernel's numbering: the flat scan over the
#: state in global memory; the per-shard row-max cache in shared memory
#: with the state in global memory; cache and state in shared memory.
K5_LAYOUTS = ("flat", "global", "shared")
ROW = 128  #: nodes per row of K5's row-max cache
#: K5 selects through its row-max cache from this many nodes per shard up,
#: and by a flat scan below.  The crossover on the H100 (chip_smoke.py,
#: PERF.md), flat against the cache with the state in shared memory, µs
#: per swap: 4,096 nodes per shard 3.94 against 4.19, 7,168 nodes 4.49
#: against 4.28, 10,240 nodes 4.57 against 4.20; the next multiple of
#: 1,024 above the interpolated 5,700.
K5_CACHE_MIN_NODES = 6_144
#: Dynamic shared memory one block of K5 may take: the H100's 227 KB
#: opt-in per block less 1 KB for the kernel's own shared variables
#: (under 600 B).
K5_SHARED_BYTES = 232_448 - 1024


def k5_shared_bytes(n_local: int, layout: str) -> int:
    """Dynamic shared memory of one block of K5 (``csrc/smega.cu:
    shared_bytes``): none for "flat"; for the cache both sides'
    maxima per 128-node row, a dirty bit per row and a list with room for
    every row; "shared" adds the stripe's sf and a_s, 8 bytes per node."""
    if layout == "flat":
        return 0
    rows = n_local // ROW
    cache = 4 * (3 * rows + -(-rows // 32))
    return cache + (8 * n_local if layout == "shared" else 0)


def k5_layout(n_local: int, n_shards: int) -> str:
    """K5's layout for ``n_shards`` shards of ``n_local`` nodes: "flat"
    below :data:`K5_CACHE_MIN_NODES` (or where ``n_local`` is no multiple
    of 128, or where the cache alone outgrows shared memory, past
    2,443,008 nodes per shard); else "shared", cache and state in shared
    memory, where they fit :data:`K5_SHARED_BYTES` (up to 28,544 nodes per
    shard); else "global", the cache in shared memory and the state in
    global memory.  The shard count does not enter: a block's footprint
    is its own."""
    if n_shards not in CLUSTER_SHARDS:
        raise ValueError(f"K5 runs 1, 2, 4 or 8 shards, not {n_shards}")
    if n_local < K5_CACHE_MIN_NODES or n_local % ROW:
        return "flat"
    for layout in ("shared", "global"):
        if k5_shared_bytes(n_local, layout) <= K5_SHARED_BYTES:
            return layout
    return "flat"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class SmegaPlan:
    """What the sharded pass reads, built once per (graph, shard count,
    align) and reused by every :func:`smega_refine` call on that graph
    (multi-start, passes, benchmarks), as the JAX package's ``SmegaPlan``.

    Attributes:
      graph: the host graph.
      n_shards, align: the shard count and the per-shard node granularity
        (a multiple of 128).
      n_pad: ``n`` rounded up to ``n_shards * align``; ``n_local = n_pad /
        n_shards`` nodes per shard (smega.py:776-784).
      rows: int64[nnz], the row of every CSR entry (for the host recounts).
    """

    def __init__(self, g: Graph, n_shards: int, align: int = 1024):
        if align < 128 or align % 128 != 0:
            raise ValueError(f"align must be a positive multiple of 128, got {align}")
        if n_shards < 1:
            raise ValueError(f"n_shards must be at least 1, got {n_shards}")
        self.graph = g
        self.n_shards = n_shards
        self.align = align
        self.n_pad = _round_up(max(g.num_nodes, 1), n_shards * align)
        self.n_local = self.n_pad // n_shards
        self.rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), g.degrees)
        self._dev: dict[torch.device, DeviceGraph] = {}

    def device_graph(self, device: torch.device) -> DeviceGraph:
        """The f32 CSR graph on ``device``, uploaded on first use and
        cached per device."""
        if device not in self._dev:
            self._dev[device] = self.graph.to_device(device, torch.float32)
        return self._dev[device]


def smega_pass_plain(
    g: DeviceGraph,
    n_shards: int,
    sf0: torch.Tensor,
    as0: torch.Tensor,
    cut0: float,
    cap: int,
    nf0: int,
    nf1: int,
    log_len: int,
    terminate_limit: int,
    gain_eps: float,
) -> PassOutput:
    """One sharded pass as a Python loop of PyTorch ops, in f32: K5's
    arithmetic, operation for operation.

    ``sf0`` and ``as0`` are float32[n_pad], ``n_pad = n_shards *
    n_local``; ``nf0`` and ``nf1`` are the free nodes per side (the TPU
    kernel's ``ip_ref``).  Selection and the row updates run on ``sf0``'s
    device, the scalar bookkeeping on the host in float32 NumPy scalars.
    ``torch.argmax`` returns the first maximum and counts -0.0 and +0.0 as
    equal, as K5 does, within a shard and across the S candidates.  The S
    owners' entries of a row touch disjoint nodes, one add each, so one
    ``index_add_`` over the row does what they do.  This is the flat
    reference of all three of K5's layouts: the cached selection finds the
    same node (``tests/test_torch_smega.py`` emulates it).
    """
    t = np.float32
    n_pad = sf0.shape[0]
    n_local = n_pad // n_shards
    sf, a_s = sf0.clone(), as0.clone()
    indptr_h = g.indptr.cpu().numpy()
    cols = g.indices.long()
    cols_h = g.indices.cpu().numpy()
    data = g.data.to(torch.float32)
    data_h = data.cpu().numpy()
    minus, plus = -2.0 * data, 2.0 * data
    log_cut = np.zeros(log_len, dtype=t)
    log_gain = np.zeros(log_len, dtype=t)
    log_a = np.zeros(log_len, dtype=np.int32)
    log_b = np.zeros(log_len, dtype=np.int32)
    cut = log_cut[0] = t(cut0)
    best = cut
    comp, two, eps = t(0.0), t(2.0), t(gain_eps)
    it, term, stop = 0, 0, 0
    while stop == 0 and it < cap and nf0 > 0 and nf1 > 0:
        # Round A: each shard's first maximum per side, then the winner:
        # the larger value at the lower shard.
        d = -(sf * a_s)
        dl = torch.where(sf > 0, d, -torch.inf).view(n_shards, n_local)
        dr = torch.where(sf < 0, d, -torch.inf).view(n_shards, n_local)
        la, lb = dl.argmax(dim=1), dr.argmax(dim=1)
        ml, mr = dl.gather(1, la[:, None])[:, 0], dr.gather(1, lb[:, None])[:, 0]
        wa, wb = ml.argmax(), mr.argmax()
        picked = torch.stack(
            [(wa * n_local + la[wa]).double(), (wb * n_local + lb[wb]).double(),
             ml[wa].double(), mr[wb].double()]
        )
        a, b, m_l, m_r = picked.tolist()  # one device read per swap
        if m_l == -np.inf or m_r == -np.inf:
            break  # no free node on a side (free counts that disagree with sf0)
        a, b, m_l, m_r = int(a), int(b), t(m_l), t(m_r)

        # Owner-computes: the owners' entries of row a, then of row b; b's
        # owner finds w_ab in row a.
        lo, hi = indptr_h[a], indptr_h[a + 1]
        a_s.index_add_(0, cols[lo:hi], minus[lo:hi])
        w_ab = data_h[lo:hi][cols_h[lo:hi] == b].sum(dtype=t)
        lo, hi = indptr_h[b], indptr_h[b + 1]
        a_s.index_add_(0, cols[lo:hi], plus[lo:hi])
        sf[a] = 0.0
        sf[b] = 0.0

        # Round B: w_ab from b's owner, then the replicated bookkeeping.
        gain = (m_l + m_r) - two * w_ab
        y = -gain - comp  # Kahan-compensated cut (smega.py:561-565)
        tot = cut + y
        comp = (tot - cut) - y
        cut = tot
        best = min(cut, best)
        it += 1
        log_cut[it], log_gain[it], log_a[it], log_b[it] = cut, gain, a, b
        term = term + 1 if gain <= eps else 0
        stop = int(term > terminate_limit)
        nf0 -= 1
        nf1 -= 1
    scalars = np.array([cut, best, it, term, nf0, nf1, t(cut0), stop], dtype=t)
    dev = sf0.device
    return PassOutput(
        sf=sf,
        log_cut=torch.as_tensor(log_cut).to(dev),
        log_gain=torch.as_tensor(log_gain).to(dev),
        log_a=torch.as_tensor(log_a).to(dev),
        log_b=torch.as_tensor(log_b).to(dev),
        scalars=torch.as_tensor(scalars).to(dev),
    )


def smega_pass_cuda(
    g: DeviceGraph,
    n_shards: int,
    sf0: torch.Tensor,
    as0: torch.Tensor,
    cut0: float,
    cap: int,
    nf0: int,
    nf1: int,
    log_len: int,
    terminate_limit: int,
    gain_eps: float,
    *,
    _layout: str | None = None,
) -> PassOutput:
    """Launch K5 on the current stream: one cluster of ``n_shards`` blocks
    of 1,024 threads, block r running shard r.  The state is f32, the
    graph's index arrays int32, on one card; inputs are not modified.
    The layout is :func:`k5_layout`'s for the shard size; ``_layout``
    ("flat", "global" or "shared") forces one, for tests and
    measurements.  Raises if the card cannot hold the cluster in that
    layout."""
    if n_shards not in CLUSTER_SHARDS:
        raise ValueError(
            f"K5 runs {n_shards} shards as one thread-block cluster, which takes 1, 2, 4 "
            "or 8 blocks; more shards, or shards on several cards, are ROADMAP.md A8c"
        )
    n_pad = sf0.shape[0] if sf0.dim() == 1 else 0
    dev = sf0.device
    tensors = (sf0, as0, g.indptr, g.indices, g.data)
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("the sharded KL pass needs its inputs and the graph on one CUDA device")
    _check_f32(sf0, as0, g.data)
    if g.indptr.dtype != torch.int32 or g.indices.dtype != torch.int32:
        raise TypeError("the graph's indptr and indices must be int32")
    if n_pad % (4 * n_shards) != 0 or n_pad < g.num_nodes or as0.shape != sf0.shape:
        raise ValueError(
            f"sf0 and as0 must be equal vectors over the graph's {g.num_nodes} nodes, padded "
            f"to a multiple of {4 * n_shards}"
        )
    if not 0 <= cap < log_len:
        raise ValueError(f"log_len {log_len} must exceed the cap {cap}")
    n_local = n_pad // n_shards
    if _layout is None:
        _layout = k5_layout(n_local, n_shards)
    if _layout not in K5_LAYOUTS:
        raise ValueError(f"_layout must be 'flat', 'global' or 'shared', not {_layout!r}")
    if _layout != "flat" and n_local % ROW:
        raise ValueError(f"K5's row-max cache needs shards of a multiple of {ROW} nodes, not {n_local}")
    if k5_shared_bytes(n_local, _layout) > K5_SHARED_BYTES:
        raise ValueError(f"K5's {_layout!r} layout does not fit one block's shared memory at {n_local} nodes")
    sf, a_s = sf0.contiguous().clone(), as0.contiguous().clone()
    log_cut = torch.zeros(log_len, dtype=torch.float32, device=dev)
    log_gain = torch.zeros_like(log_cut)
    log_a = torch.zeros(log_len, dtype=torch.int32, device=dev)
    log_b = torch.zeros_like(log_a)
    scalars = torch.empty(8, dtype=torch.float32, device=dev)
    cut0 = float(np.float32(cut0))
    K5(
        g.indptr.data_ptr(),
        g.indices.data_ptr(),
        g.data.data_ptr(),
        sf.data_ptr(),
        a_s.data_ptr(),
        n_local,
        n_shards,
        K5_LAYOUTS.index(_layout),
        cut0,
        cap,
        nf0,
        nf1,
        terminate_limit,
        gain_eps,
        log_len,
        log_cut.data_ptr(),
        log_gain.data_ptr(),
        log_a.data_ptr(),
        log_b.data_ptr(),
        scalars.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return PassOutput(sf, log_cut, log_gain, log_a, log_b, scalars)


def _check_f32(*tensors: torch.Tensor) -> None:
    """K5 and its plain version take f32 only: the JAX package's smega
    kernel is f32 only (its weights, ``eig_kl_tpu/parallel/smega.py:107``,
    and its state), so an f64 sharded pass has no reference."""
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(
            "the sharded KL pass is float32 only, as the JAX package's smega kernel is "
            f"(eig_kl_tpu/parallel/smega.py:107); got {[t.dtype for t in tensors]}"
        )


def smega_pass(g, n_shards, sf0, as0, cut0, cap, nf0, nf1, log_len, terminate_limit, gain_eps) -> PassOutput:
    """One sharded pass: K5 for tensors on the card (or an error), the
    plain version for tensors on the CPU; f32 only on both."""
    _check_f32(sf0, as0, g.data)
    fn = smega_pass_plain if sf0.device.type == "cpu" else smega_pass_cuda
    return fn(g, n_shards, sf0, as0, cut0, cap, nf0, nf1, log_len, terminate_limit, gain_eps)


def _host_cut(g: Graph, rows: np.ndarray, sides: np.ndarray) -> float:
    """The cut of ``sides`` recounted on the host in float64
    (smega.py:885-891 and :910-916)."""
    s = 1.0 - 2.0 * np.asarray(sides).astype(np.float64)
    s_as = float((g.data.astype(np.float64) * s[rows] * s[g.indices]).sum())
    return 0.25 * (float(g.weighted_degrees.sum()) - s_as)


def smega_refine(
    g: Graph,
    sides: np.ndarray,
    n_shards: int | Mesh,
    config: KLConfig = KLConfig(),
    *,
    device: str | torch.device | None = None,
    align: int = 1024,
    plan: SmegaPlan | None = None,
) -> KLResult:
    """One KL pass of the host graph ``g`` from the int8[n] ``sides``, its
    nodes split over ``n_shards`` shards (K5 on the card, one block per
    shard; the plain version with ``device="cpu"``).

    The trajectory equals the single-chip pass's at every shard count;
    ``initial_cut`` is the JAX engine's host float64 recount rounded to
    f32, so the cut log may differ from :func:`refine_mega`'s (with
    ``spmv_order="ell"``: smega starts from the ELL row sums) by that
    start only.  ``plan`` (a :class:`SmegaPlan` for ``n_shards``) skips the
    host build and the upload on repeated calls on one graph; a plan for
    another shard count is refused.  ``align`` sets the per-shard node
    granularity (a multiple of 128).  A :class:`Mesh` in place of
    ``n_shards`` (the JAX call ``smega_refine(g, sides, mesh)``) runs one
    shard on the rank's device where its ``"mp"`` axis holds one rank;
    across ranks it raises :class:`NotPorted`.
    """
    if isinstance(n_shards, Mesh):
        if n_shards.shape[n_shards.axis_names[1]] > 1:
            raise NotPorted(
                "smega_refine over more than one rank: K5 across cards (ROADMAP.md A8c), which needs a "
                "machine with at least two cards"
            )
        n_shards, device = 1, n_shards.device
    dev = resolve_device(device)
    n = g.num_nodes
    if plan is None:
        plan = SmegaPlan(g, n_shards, align)
    elif plan.n_shards != n_shards:
        raise ValueError(f"plan built for {plan.n_shards} shards, not {n_shards}")
    elif plan.graph is not g and plan.graph.num_nodes != n:
        raise ValueError(f"plan built for a graph of {plan.graph.num_nodes} nodes, not {n}")
    n_pad = plan.n_pad
    sides = np.asarray(sides, dtype=np.int8)
    if sides.shape != (n,):
        raise ValueError(f"sides must be ({n},), got {sides.shape}")
    sides_pad = np.zeros(n_pad, dtype=np.int8)
    sides_pad[:n] = sides
    n1 = int(sides.astype(np.int64).sum())
    natural = min(n - n1, n1)
    true_cap = natural if config.max_iterations is None else min(config.max_iterations, natural)
    # The log length (smega.py:873-875).
    max_iters = min(_round_up(max(true_cap, 1), 4096), max(natural, 1))

    dg = plan.device_graph(dev)
    s = sides_to_signs(torch.as_tensor(sides).to(dev), torch.float32)
    sf0 = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    as0 = torch.zeros_like(sf0)
    sf0[:n] = s
    as0[:n] = spmv(dg, s)  # the ELL row sum of smega.py:721, in XLA's order
    cut0 = np.float32(_host_cut(g, plan.rows, sides))
    out = smega_pass(
        dg, n_shards, sf0, as0, float(cut0), true_cap, n - n1, n1, max_iters + 1,
        config.terminate_limit(n), config.gain_eps,
    )
    lc, lg, la, lb, sc = (
        x.cpu().numpy() for x in (out.log_cut, out.log_gain, out.log_a, out.log_b, out.scalars)
    )
    iterations = int(sc[2])
    fin_sides = replay_swaps(sides_pad, la, lb, iterations)[:n]
    best_sides = replay_swaps(sides_pad, la, lb, best_iteration(lc, iterations))[:n]
    return KLResult(
        sides=fin_sides,
        best_sides=best_sides,
        initial_cut=float(sc[6]),
        final_cut=float(sc[0]),
        best_cut=float(sc[1]),
        verified_cut=_host_cut(g, plan.rows, fin_sides),
        iterations=iterations,
        cut_trajectory=lc[: iterations + 1],
        gain_trajectory=lg[: iterations + 1],
    )
