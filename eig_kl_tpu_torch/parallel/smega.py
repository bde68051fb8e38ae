"""The node-sharded KL pass (smega): on one card kernel K5, across the
ranks of a process group kernel K5R (both ``csrc/smega.cu``), their plain
versions, and :func:`smega_refine` around them (the port of
``eig_kl_tpu/parallel/smega.py``).

The JAX package runs one shard per TPU core of the mesh axis ``"mp"``:
each runs the whole swap loop over its 1/S of the nodes inside one Pallas
kernel, and per swap two rounds of remote DMA exchange each shard's
first-max candidate per side and the owner's ``w_ab``; each shard updates
only its own rows of ``A @ s`` (owner-computes).  On one card (an integer
``n_shards``) a shard is a thread block, the S shards are one thread-block
cluster, and the rounds go through the cluster's distributed shared
memory.  Across the S ranks of a mesh's ``"mp"`` axis (a :class:`Mesh`)
a shard is one persistent block per rank (K5R), the rounds are stores
into the peers' exchange buffers, mapped through CUDA IPC (so the ranks
share one host: one card each, or several on one card), and a rank holds
only what a TPU shard holds: its stripe of the state and its column
slice (:class:`RankPart`).  On the CPU the ranks run the plain version,
its rounds two gathers over the group per swap.

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
engine), whose entries are the same.  Across ranks each rank keeps only
those entries, as the TPU shard does: its column slice.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph, Graph
from eig_kl_tpu_torch.kl.megakernel import PassOutput
from eig_kl_tpu_torch.kl.result import KLResult, best_iteration, replay_swaps
from eig_kl_tpu_torch.ops._build import Kernel, library
from eig_kl_tpu_torch.ops.partition import sides_to_signs
from eig_kl_tpu_torch.ops.spmv import spmv
from eig_kl_tpu_torch.parallel.mesh import Mesh
from eig_kl_tpu_torch.parallel.sharded_kl import rows_graph
from eig_kl_tpu_torch.utils.config import KLConfig
from eig_kl_tpu_torch.utils.device import resolve_device

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
K5 = Kernel(
    "smega",
    "smega_pass_f32",
    [_P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P],
)
K5R = Kernel(
    "smega",
    "smega_ranks_pass_f32",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P,
     ctypes.c_uint, ctypes.c_longlong, _P, _P],
)
#: The cluster sizes K5 launches: the portable ones, at most 8 blocks.
CLUSTER_SHARDS = (1, 2, 4, 8)
#: The most ranks K5R runs: one warp reads the candidates, and CUDA IPC
#: maps memory between the processes of one host (8 cards at most).
MAX_RANKS = 8
#: How long a K5R spin waits for a peer before its rank gives up and
#: raises: a peer that dies fails the run instead of hanging it.  Ranks on
#: one card wait out each other's time slices, milliseconds each.
K5R_SPIN_TIMEOUT_S = 60.0
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

    Across ranks (:meth:`rank_part`) each rank builds and uploads only its
    own part, once per device.
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
        self._parts: dict[tuple[int, torch.device], RankPart] = {}

    def device_graph(self, device: torch.device) -> DeviceGraph:
        """The f32 CSR graph on ``device``, uploaded on first use and
        cached per device."""
        if device not in self._dev:
            self._dev[device] = self.graph.to_device(device, torch.float32)
        return self._dev[device]

    def rank_part(self, rank: int, device: torch.device) -> "RankPart":
        """Shard ``rank``'s part on ``device``, built on first use and
        cached per (rank, device)."""
        key = (rank, device)
        if key not in self._parts:
            if not 0 <= rank < self.n_shards:
                raise ValueError(f"rank {rank} of a plan for {self.n_shards} shards")
            g, r0 = self.graph, rank * self.n_local
            keep = (g.indices >= r0) & (g.indices < r0 + self.n_local)
            col_indptr = np.zeros(g.num_nodes + 1, dtype=np.int64)
            np.cumsum(np.bincount(self.rows[keep], minlength=g.num_nodes), out=col_indptr[1:])
            self._parts[key] = RankPart(
                r0=r0,
                n_local=self.n_local,
                rows=rows_graph(g, self.n_pad, range(r0, r0 + self.n_local), torch.float32, device),
                col_indptr=torch.as_tensor(col_indptr.astype(np.int32)).to(device),
                col_indices=torch.as_tensor(g.indices[keep].astype(np.int32)).to(device),
                col_data=torch.as_tensor(g.data[keep].astype(np.float32)).to(device),
            )
        return self._parts[key]


@dataclasses.dataclass(frozen=True)
class RankPart:
    """What one rank of the sharded pass holds: what the TPU shard holds.

    Attributes:
      r0, n_local: its nodes ``[r0, r0 + n_local)`` of the padded graph.
      rows: its rows of the graph as a CSR graph over all ``n_pad`` rows
        (the others empty), at the whole graph's ELL width, for its rows of
        the starting ``A @ s`` in XLA's order (``smega.py:721``).
      col_indptr, col_indices, col_data: its column slice, for every node
        ``v`` the entries of row ``v`` whose column lies in its nodes, in
        CSR order (int32[n + 1], int32 global columns, f32): the entries
        of ``_build_colT`` (``smega.py:93``), about ``nnz / S``.
    """

    r0: int
    n_local: int
    rows: DeviceGraph
    col_indptr: torch.Tensor
    col_indices: torch.Tensor
    col_data: torch.Tensor


def _pass_plain(indptr, cols, data, r0, n_local, sf0, as0, round_a, round_b, cut0, cap, nf0, nf1,
                log_len, terminate_limit, gain_eps) -> PassOutput:
    """The plain pass over the shards whose stripes ``sf0`` and ``as0``
    hold (nodes from ``r0``, ``n_local`` per shard), adding from the rows
    ``(indptr, cols, data)`` (global columns) the entries in those stripes.
    ``round_a`` takes their candidates, a float64 ``(shards here, 4)``
    tensor of rows ``(m_l, a, m_r, b)``, and returns every shard's, in
    shard order; ``round_b(w, owner)`` takes this process's ``w_ab`` (0
    where it holds not b) and returns the owner's."""
    t = np.float32
    sf, a_s = sf0.clone(), as0.clone()
    here = sf.shape[0] // n_local
    base = r0 + n_local * torch.arange(here, device=sf.device)
    indptr_h = indptr.cpu().numpy()
    cols_h = cols.cpu().numpy()
    local = cols.long() - r0
    data = data.to(torch.float32)
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
        dl = torch.where(sf > 0, d, -torch.inf).view(here, n_local)
        dr = torch.where(sf < 0, d, -torch.inf).view(here, n_local)
        la, lb = dl.argmax(dim=1), dr.argmax(dim=1)
        ml, mr = dl.gather(1, la[:, None])[:, 0], dr.gather(1, lb[:, None])[:, 0]
        cand = round_a(torch.stack([ml.double(), (base + la).double(), mr.double(), (base + lb).double()], 1))
        wa, wb = cand[:, 0].argmax(), cand[:, 2].argmax()
        picked = torch.stack([cand[wa, 1], cand[wb, 3], cand[wa, 0], cand[wb, 2]])
        a, b, m_l, m_r = picked.tolist()  # one device read per swap
        if m_l == -np.inf or m_r == -np.inf:
            break  # no free node on a side (free counts that disagree with sf0)
        a, b, m_l, m_r = int(a), int(b), t(m_l), t(m_r)

        # Owner-computes: the stripes' entries of row a, then of row b; b's
        # owner finds w_ab in row a.
        lo, hi = indptr_h[a], indptr_h[a + 1]
        a_s.index_add_(0, local[lo:hi], minus[lo:hi])
        w_ab = data_h[lo:hi][cols_h[lo:hi] == b].sum(dtype=t)
        lo, hi = indptr_h[b], indptr_h[b + 1]
        a_s.index_add_(0, local[lo:hi], plus[lo:hi])
        for v in (a, b):
            if 0 <= v - r0 < sf.shape[0]:
                sf[v - r0] = 0.0

        # Round B: w_ab from b's owner, then the replicated bookkeeping.
        w_ab = round_b(w_ab, b // n_local)
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
    n_local = sf0.shape[0] // n_shards
    return _pass_plain(g.indptr, g.indices, g.data, 0, n_local, sf0, as0, lambda c: c, lambda w, _: w,
                       cut0, cap, nf0, nf1, log_len, terminate_limit, gain_eps)


def smega_pass_ranks_plain(
    mesh: Mesh,
    part: RankPart,
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
    """:func:`smega_pass_plain` across the ranks of ``mesh``'s ``"mp"``
    axis, this rank's shard alone: ``sf0`` and ``as0`` are its stripe
    (float32[n_local]), ``part`` its column slice.  Round A is one gather
    of every rank's candidates (the winner: the larger value, then the
    lower rank, then the lower local index, the global first maximum);
    round B one gather of a value per rank, of which b's owner's is
    ``w_ab``.  Every loop scalar is the same on every rank; the result
    holds this rank's stripe of ``sf`` and the (replicated) logs."""
    mp = mesh.axis_names[1]
    mesh._check_member()
    return _pass_plain(
        part.col_indptr, part.col_indices, part.col_data, part.r0, part.n_local, sf0, as0,
        lambda c: mesh.all_gather(c[0], mp),
        lambda w, owner: np.float32(mesh.all_gather(torch.tensor([w], dtype=torch.float32), mp)[owner, 0].item()),
        cut0, cap, nf0, nf1, log_len, terminate_limit, gain_eps)


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


def _lib_call(fn, *args, what: str) -> None:
    code = fn(*args)
    if code != 0:
        msg = library("smega").smega_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


class PeerBuffers:
    """K5R's exchange buffers for one mesh's ``"mp"`` group, in this
    process: its own, allocated here by ``cudaMalloc`` (not through
    PyTorch's caching allocator, so that its IPC handle maps the base of
    the allocation), and its peers', mapped from their handles
    (``cudaIpcOpenMemHandle``, lazy peer access), which travel over the
    group.  Made collectively, once per mesh (:func:`peer_buffers`); they
    live as long as the process.

    Attributes:
      pointers: ctypes array of the ranks' buffers in this process, in rank
        order (this rank's own among them).
      calls: K5R launches so far on these buffers, the same on every rank.
      last_pass_ns: the device time of the last of them in this process,
        in ns, from the kernel's own %globaltimer (start to end).
    """

    def __init__(self, mesh: Mesh):
        mp = mesh.axis_names[1]
        mesh._check_member()
        lib = library("smega")
        lib.smega_exchange_alloc.argtypes = [_I, _P, _P]
        lib.smega_exchange_open.argtypes = [_I, _P, _P]
        lib.smega_exchange_handle_bytes.argtypes = []
        lib.smega_error_string.argtypes = [_I]
        lib.smega_error_string.restype = ctypes.c_char_p
        dev = mesh.device.index if mesh.device.index is not None else torch.cuda.current_device()
        own = ctypes.c_void_p()
        handle = ctypes.create_string_buffer(lib.smega_exchange_handle_bytes())
        _lib_call(lib.smega_exchange_alloc, dev, ctypes.byref(own), handle, what="K5R's exchange buffer")
        me = mesh.coords[mp]
        ptrs = []
        for k, h in enumerate(mesh.all_gather_object(handle.raw, mp)):
            if k == me:
                ptrs.append(own.value)
                continue
            peer = ctypes.c_void_p()
            _lib_call(lib.smega_exchange_open, dev, h, ctypes.byref(peer),
                      what=f"rank {me} mapping rank {k}'s exchange buffer")
            ptrs.append(peer.value)
        self.pointers = (ctypes.c_void_p * len(ptrs))(*ptrs)
        self.calls = 0
        self.last_pass_ns = 0

    def launch_barrier(self, mesh: Mesh) -> int:
        """The group barrier before a launch (the TPU kernel's barrier
        semaphore, ``smega.py:210-216``): every rank of ``mesh`` has mapped
        every buffer and finished its previous launch.  Returns this
        launch's number, checked equal on every rank."""
        self.calls += 1
        seen = mesh.all_gather_object(self.calls, mesh.axis_names[1])
        if any(c != self.calls for c in seen):
            raise RuntimeError(f"K5R's ranks disagree on the launch number: {seen}")
        return self.calls


_peer_buffers: "weakref.WeakKeyDictionary[Mesh, PeerBuffers]" = weakref.WeakKeyDictionary()


def peer_buffers(mesh: Mesh) -> PeerBuffers:
    """The mesh's :class:`PeerBuffers`, made on first use (collectively:
    every rank of the mesh calls it)."""
    if mesh not in _peer_buffers:
        _peer_buffers[mesh] = PeerBuffers(mesh)
    return _peer_buffers[mesh]


def smega_pass_ranks_cuda(
    mesh: Mesh,
    part: RankPart,
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
    spin_timeout_s: float = K5R_SPIN_TIMEOUT_S,
    _layout: str | None = None,
) -> PassOutput:
    """Launch K5R on this rank's card: one block of 1,024 threads running
    this rank's shard of the pass across the ranks of ``mesh``'s ``"mp"``
    axis, in K5's layout for the shard (:func:`k5_layout`; ``_layout``
    forces one).  ``sf0`` and ``as0`` are the rank's stripe
    (float32[n_local]) and ``part`` its column slice, on the card.  Every
    rank calls it together; after a group barrier each launches, and
    waits for its kernel.  Raises if a rank waited more than
    ``spin_timeout_s`` for a peer in a round (naming the rank, the round
    and the peer), and if the launch or the buffers' mapping fails."""
    mp = mesh.axis_names[1]
    mesh._check_member()
    n_ranks, me = mesh.shape[mp], mesh.coords[mp]
    if not 1 <= n_ranks <= MAX_RANKS:
        raise ValueError(f"K5R runs 1 to {MAX_RANKS} ranks (one host), not {n_ranks}")
    dev = sf0.device
    tensors = (sf0, as0, part.col_indptr, part.col_indices, part.col_data)
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("K5R needs its stripe and its column slice on this rank's CUDA device")
    _check_f32(sf0, as0, part.col_data)
    if sf0.shape != (part.n_local,) or as0.shape != sf0.shape:
        raise ValueError(f"sf0 and as0 must be this rank's stripe of {part.n_local} nodes")
    if not 0 <= cap < log_len:
        raise ValueError(f"log_len {log_len} must exceed the cap {cap}")
    if spin_timeout_s <= 0:
        raise ValueError(f"spin_timeout_s must be positive, got {spin_timeout_s}")
    n_local = part.n_local
    if _layout is None:
        _layout = k5_layout(n_local, 1)
    if _layout not in K5_LAYOUTS or (_layout != "flat" and n_local % ROW) or n_local % 4:
        raise ValueError(f"K5R's {_layout!r} layout does not take shards of {n_local} nodes")
    if k5_shared_bytes(n_local, _layout) > K5_SHARED_BYTES:
        raise ValueError(f"K5R's {_layout!r} layout does not fit one block's shared memory at {n_local} nodes")
    buffers = peer_buffers(mesh)
    sf, a_s = sf0.contiguous().clone(), as0.contiguous().clone()
    log_cut = torch.zeros(log_len, dtype=torch.float32, device=dev)
    log_gain = torch.zeros_like(log_cut)
    log_a = torch.zeros(log_len, dtype=torch.int32, device=dev)
    log_b = torch.zeros_like(log_a)
    scalars = torch.empty(8, dtype=torch.float32, device=dev)
    status = torch.zeros(5, dtype=torch.int64, device=dev)
    call = buffers.launch_barrier(mesh)  # the library is loaded: no rank builds after it
    K5R(
        part.col_indptr.data_ptr(),
        part.col_indices.data_ptr(),
        part.col_data.data_ptr(),
        sf.data_ptr(),
        a_s.data_ptr(),
        n_local,
        me,
        n_ranks,
        K5_LAYOUTS.index(_layout),
        float(np.float32(cut0)),
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
        buffers.pointers,
        call,
        int(spin_timeout_s * 1e9),
        status.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    code, rnd, swap, peer, ns = status.tolist()  # waits for the kernel
    if code != 0:
        what = ("its candidate (round A)", "w_ab (round B)")[rnd]
        raise RuntimeError(
            f"K5R: rank {me} of {n_ranks} waited more than {spin_timeout_s} s for {what} from rank {peer} "
            f"at swap {swap}; a peer died, did not launch, or its launch number differs"
        )
    buffers.last_pass_ns = ns
    return PassOutput(sf, log_cut, log_gain, log_a, log_b, scalars)


def smega_pass_ranks(mesh, part, sf0, as0, cut0, cap, nf0, nf1, log_len, terminate_limit,
                     gain_eps) -> PassOutput:
    """This rank's shard of the pass across ranks: K5R for tensors on the
    card (or an error), the plain version for tensors on the CPU."""
    _check_f32(sf0, as0, part.col_data)
    fn = smega_pass_ranks_plain if sf0.device.type == "cpu" else smega_pass_ranks_cuda
    return fn(mesh, part, sf0, as0, cut0, cap, nf0, nf1, log_len, terminate_limit, gain_eps)


def _host_cut(g: Graph, rows: np.ndarray, sides: np.ndarray) -> float:
    """The cut of ``sides`` recounted on the host in float64
    (smega.py:885-891 and :910-916)."""
    s = 1.0 - 2.0 * np.asarray(sides).astype(np.float64)
    s_as = float((g.data.astype(np.float64) * s[rows] * s[g.indices]).sum())
    return 0.25 * (float(g.weighted_degrees.sum()) - s_as)


def pass_inputs(plan: SmegaPlan, sides: np.ndarray, config: KLConfig, device: torch.device,
                part: RankPart | None = None) -> tuple:
    """The pass's arguments after the graph (and the shard count) for a
    start from the int8[n] ``sides`` (smega.py:862-893): ``(sf0, as0, cut0,
    cap, nf0, nf1, log_len, terminate_limit, gain_eps)``.  ``sf0`` and
    ``as0`` hold the padded state, or with ``part`` that rank's stripe;
    ``A @ s`` is the ELL row sum of smega.py:721 in XLA's order (a rank's
    rows at the whole graph's ELL width), ``cut0`` the host float64
    recount rounded to f32, the same on every rank."""
    g, n, n_pad = plan.graph, plan.graph.num_nodes, plan.n_pad
    sides = np.asarray(sides, dtype=np.int8)
    if sides.shape != (n,):
        raise ValueError(f"sides must be ({n},), got {sides.shape}")
    n1 = int(sides.astype(np.int64).sum())
    natural = min(n - n1, n1)
    cap = natural if config.max_iterations is None else min(config.max_iterations, natural)
    # The log length (smega.py:873-875).
    log_len = min(_round_up(max(cap, 1), 4096), max(natural, 1)) + 1
    s = torch.zeros(n_pad, dtype=torch.float32, device=device)
    s[:n] = sides_to_signs(torch.as_tensor(sides).to(device), torch.float32)
    if part is None:
        sf0 = s
        as0 = torch.zeros_like(s)
        as0[:n] = spmv(plan.device_graph(device), s[:n])
    else:
        stripe = slice(part.r0, part.r0 + part.n_local)
        sf0 = s[stripe].clone()
        as0 = spmv(part.rows, s)[stripe].clone()
    cut0 = float(np.float32(_host_cut(g, plan.rows, sides)))
    return sf0, as0, cut0, cap, n - n1, n1, log_len, config.terminate_limit(n), config.gain_eps


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
    granularity (a multiple of 128).

    A :class:`Mesh` in place of ``n_shards`` is the JAX call
    ``smega_refine(g, sides, mesh)``: one shard per rank of its ``"mp"``
    axis, on the rank's device (K5R on the card, the plain version across
    the group on the CPU; with one rank, K5 at one shard), every rank
    calling it alike and returning the same result.  Each rank uploads only
    its part of the plan (:meth:`SmegaPlan.rank_part`).
    """
    mesh = None
    if isinstance(n_shards, Mesh):
        mesh, device = n_shards, n_shards.device
        n_shards = mesh.shape[mesh.axis_names[1]]
        if n_shards == 1:
            mesh = None
        else:
            mesh._check_member()
    dev = resolve_device(device)
    n = g.num_nodes
    if plan is None:
        plan = SmegaPlan(g, n_shards, align)
    elif plan.n_shards != n_shards:
        raise ValueError(f"plan built for {plan.n_shards} shards, not {n_shards}")
    elif plan.graph is not g and plan.graph.num_nodes != n:
        raise ValueError(f"plan built for a graph of {plan.graph.num_nodes} nodes, not {n}")
    if mesh is None:
        out = smega_pass(plan.device_graph(dev), n_shards, *pass_inputs(plan, sides, config, dev))
    else:
        part = plan.rank_part(mesh.coords[mesh.axis_names[1]], dev)
        out = smega_pass_ranks(mesh, part, *pass_inputs(plan, sides, config, dev, part))
    lc, lg, la, lb, sc = (
        x.cpu().numpy() for x in (out.log_cut, out.log_gain, out.log_a, out.log_b, out.scalars)
    )
    iterations = int(sc[2])
    sides_pad = np.zeros(plan.n_pad, dtype=np.int8)
    sides_pad[:n] = sides
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
