"""Node-sharded KL refinement over the ranks of a mesh: the broadcast
engine (the port of ``eig_kl_tpu/parallel/sharded_kl.py``).

The nodes are padded to a multiple of the ``"mp"`` size with
zero-degree, permanently locked dummies and split into contiguous row
ranges, one per rank (:func:`~eig_kl_tpu_torch.parallel.mesh.node_sharding`).
A rank holds its rows of the padded ELL adjacency, of ``A @ s`` and of
the lock mask; the signs and every scalar are replicated.  Per swap:

* selection: each rank's masked first maximum per side, then one
  ``all_gather`` of the candidates and the first maximum over them
  (larger value, then lower rank, then lower local index: the first
  maximum over all nodes, as on one card);
* the two chosen ELL rows reach every rank by one sum over ranks to
  which only their owners contribute (``fetch_rows``), and every rank
  scatter-adds the entries that land in its range.

The JAX package runs the loop inside one ``shard_map``-ped
``lax.while_loop``; here it is a host loop of PyTorch operations and
collectives (:class:`~eig_kl_tpu_torch.parallel.mesh.Mesh`), with one
read of the candidates per swap.  The arithmetic is the JAX program's:
the starting ``A @ s`` and the recount in XLA's ELL order on the rank's
rows (:func:`~eig_kl_tpu_torch.ops.spmv.spmv`), the degree sum in XLA's
tree order (:func:`~eig_kl_tpu_torch.ops.reduce.tree_sum`), the dot as
XLA's vector dot (:func:`~eig_kl_tpu_torch.ops.reduce.fma_dot`), the
sums over ranks in rank order; the cut is tracked without compensation,
``cut - gain``, as the JAX engines do.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph, Graph, ell_width
from eig_kl_tpu_torch.kl.result import KLResult, best_iteration, replay_swaps
from eig_kl_tpu_torch.ops.reduce import fma_dot, tree_sum
from eig_kl_tpu_torch.ops.spmv import spmv
from eig_kl_tpu_torch.parallel.mesh import Mesh, node_sharding
from eig_kl_tpu_torch.utils.config import KLConfig
from eig_kl_tpu_torch.utils.tracing import Tracer

#: The dtypes the sharded engines run, as the JAX functions do.
SHARDED_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
#: The swap log ``(a[1..iterations], b[1..iterations])`` of this process's
#: most recent pass of either engine (as the JAX ``sharded_power`` keeps
#: its ``last_iterations``).
last_swaps: tuple[np.ndarray, np.ndarray] = (np.zeros(0, np.int32), np.zeros(0, np.int32))


def _np_dtype(dtype: torch.dtype):
    """The NumPy dtype that holds ``dtype``'s values: itself, or f32 for
    bf16 (which widens exactly)."""
    return np.float64 if dtype == torch.float64 else np.float32


def _ell_rows(g: Graph, rows: range, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The padded ELL rows ``rows`` of the host graph (``sharded_kl.py:57``):
    ``(int64[len(rows), dmax] column ids, [len(rows), dmax] weights of
    dtype)``; a pad holds its own row's id and weight 0, and rows past the
    graph's are all pads.  The weights are rounded once from f64."""
    n, dmax = g.num_nodes, ell_width(g.max_degree)
    ell_idx = np.tile(np.arange(rows.start, rows.stop, dtype=np.int64)[:, None], (1, dmax))
    ell_w = np.zeros((len(rows), dmax), dtype=np.float64)
    lo, hi = min(rows.start, n), min(rows.stop, n)
    deg = g.degrees[lo:hi]
    row = np.repeat(np.arange(hi - lo, dtype=np.int64), deg)
    pos = np.arange(int(deg.sum()), dtype=np.int64) - np.repeat(g.indptr[lo:hi] - g.indptr[lo], deg)
    sl = slice(int(g.indptr[lo]), int(g.indptr[hi]))
    ell_idx[row, pos] = g.indices[sl]
    ell_w[row, pos] = g.data[sl]
    return torch.as_tensor(ell_idx), torch.as_tensor(ell_w).to(dtype)


@dataclasses.dataclass
class _Shard:
    """A rank's share of the padded graph: its rows ``[r0, r0 + n_l)`` as a
    CSR graph over all ``n_pad`` rows whose other rows are empty, degrees
    included (its ``A @ s`` rows come from :func:`spmv` at the whole
    graph's ELL width, which sets XLA's order), and its degrees alone."""

    n: int
    n_pad: int
    r0: int
    n_l: int
    graph: DeviceGraph
    deg_l: torch.Tensor

    def a_s(self, s: torch.Tensor) -> torch.Tensor:
        """The rank's rows of ``A @ s`` (``s`` over all ``n_pad`` nodes)."""
        x = s.to(self.graph.dtype)
        return spmv(self.graph, x)[self.r0 : self.r0 + self.n_l].to(s.dtype)


def rows_graph(g: Graph, n_pad: int, rows: range, dtype: torch.dtype, device: torch.device) -> DeviceGraph:
    """The rows ``rows`` of the host graph as a CSR graph over all ``n_pad``
    rows whose other rows are empty, degrees included, at the whole graph's
    ELL width (which sets the SpMV's order: a rank's rows of ``A @ s`` then
    equal the whole graph's bit for bit)."""
    n = g.num_nodes
    lo, hi = min(rows.start, n), min(rows.stop, n)
    indptr = np.zeros(n_pad + 1, dtype=np.int64)
    counts = np.zeros(n_pad, dtype=np.int64)
    counts[lo:hi] = g.degrees[lo:hi]
    np.cumsum(counts, out=indptr[1:])
    sl = slice(int(g.indptr[lo]), int(g.indptr[hi]))
    deg = np.zeros(n_pad, dtype=np.float64)
    deg[lo:hi] = g.weighted_degrees[lo:hi]
    return DeviceGraph(
        indptr=torch.as_tensor(indptr.astype(np.int32)).to(device),
        indices=torch.as_tensor(g.indices[sl].astype(np.int32)).to(device),
        data=torch.as_tensor(g.data[sl]).to(dtype).to(device),
        degrees=torch.as_tensor(deg).to(dtype).to(device),
        total_weight=torch.zeros((), dtype=dtype, device=device),
        row_width=ell_width(g.max_degree),
    )


def _shard(g: Graph, mesh: Mesh, dtype: torch.dtype, device: torch.device) -> _Shard:
    n = g.num_nodes
    mp = mesh.shape[mesh.axis_names[1]]
    n_pad = -(-n // mp) * mp
    rows = node_sharding(mesh, n_pad, mesh.axis_names[1])
    # bf16 has no SpMV of its own: its row sums add in f32, rounded once.
    local = rows_graph(g, n_pad, rows, torch.float32 if dtype == torch.bfloat16 else dtype, device)
    deg = np.zeros(n_pad, dtype=np.float64)
    deg[: g.num_nodes] = g.weighted_degrees
    deg_l = torch.as_tensor(deg[rows.start : rows.stop]).to(dtype).to(device)
    return _Shard(n=n, n_pad=n_pad, r0=rows.start, n_l=len(rows), graph=local, deg_l=deg_l)


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype the fixed-order sums take: f32 for bf16 (then rounded)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _cut(mesh: Mesh, sh: _Shard, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(a_s_l, cut)`` for the signs ``s``: the rank's rows of ``A @ s``
    and ``0.25 * (psum(sum(deg_l)) - psum(s_l . a_s_l))`` (``sharded_kl.py:93-97``,
    ``:193-198``), the same value on every rank."""
    mp = mesh.axis_names[1]
    a_s_l = sh.a_s(s)
    s_l = s[sh.r0 : sh.r0 + sh.n_l]
    wide = _wide(s.dtype)
    deg_sum = tree_sum(sh.deg_l.to(wide)).to(s.dtype)
    dot = fma_dot(s_l.to(wide).contiguous(), a_s_l.to(wide).contiguous()).to(s.dtype)
    parts = mesh.sum(torch.stack([deg_sum, dot]), mp)
    return a_s_l, 0.25 * (parts[0] - parts[1])


def _carrier(dtype: torch.dtype) -> torch.dtype:
    """The float that carries a candidate's value and node id through one
    gather (``sharded_kl2.py:196-212``): f64 for f64, where the id is cast
    (exact to 2^53); f32 otherwise, where the int32 id is bitcast into the
    lane (a value cast would round ids above 2^24, or 2^8 in bf16)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _host_scalar(dtype: torch.dtype):
    """The host's scalar of ``dtype`` for the replicated bookkeeping: a
    NumPy scalar (f32, f64), or a 0-d tensor (bf16, which NumPy lacks);
    either rounds each operation to ``dtype``."""
    if dtype == torch.bfloat16:
        return lambda x: torch.tensor(x, dtype=torch.bfloat16)
    return np.float64 if dtype == torch.float64 else np.float32


def select2(mesh: Mesh, r0: int, sf_l: torch.Tensor, a_s_l: torch.Tensor, scalar):
    """Both sides' first maximum of ``D = -s * (A s)`` over the free nodes
    of all ranks, from each rank's ``sf = s * free`` and ``A @ s`` rows, in
    one gather of 4 values per rank (``sharded_kl2.py:214-238``): the
    larger value, then the lower rank, then the lower index.  Returns
    ``(a, d_a, b, d_b)`` on the host, the gains as ``scalar``s."""
    neg = torch.tensor(-torch.inf, dtype=sf_l.dtype, device=sf_l.device)
    d = -(sf_l * a_s_l)
    dm = torch.stack([torch.where(sf_l > 0, d, neg), torch.where(sf_l < 0, d, neg)])
    li = dm.argmax(dim=1)
    mine = torch.cat([dm.gather(1, li[:, None])[:, 0].double(), li.double()]).cpu()  # one read per swap
    if mesh.shape[mesh.axis_names[1]] == 1:
        v0, v1, i0, i1 = mine.tolist()
        return int(i0) + r0, scalar(v0), int(i1) + r0, scalar(v1)
    car = _carrier(sf_l.dtype)
    ids = (mine[2:].to(torch.int64) + r0).to(torch.int32)
    ids = ids.to(car) if car == torch.float64 else ids.view(torch.float32)
    cand = torch.stack([mine[0].to(car), ids[0], mine[1].to(car), ids[1]])
    allc = mesh.all_gather(cand, mesh.axis_names[1])  # (mp, 4) on the host
    p0, p1 = int(torch.argmax(allc[:, 0])), int(torch.argmax(allc[:, 2]))
    win = allc[[p0, p1]][:, [1, 3]].diagonal()
    win = win.to(torch.int64) if car == torch.float64 else win.contiguous().view(torch.int32)
    return int(win[0]), scalar(allc[p0, 0].item()), int(win[1]), scalar(allc[p1, 2].item())


def max_swaps(n: int, n1: int, config: KLConfig) -> int:
    """The swap cap: the smaller side, or ``max_iterations`` if smaller."""
    natural = min(n - n1, n1)
    return natural if config.max_iterations is None else min(config.max_iterations, natural)


def sharded_pass(g: Graph, sides: np.ndarray, mesh: Mesh, config: KLConfig, dtype: torch.dtype,
                 tracer: Tracer | None, prepare) -> KLResult:
    """The swap loop of both engines over the mesh's ``"mp"`` ranks: the
    start (``A @ s`` rows and the cut summed over ranks), per swap the
    selection (:func:`select2`), the engine's exchange and ``A @ s``
    update, then ``cut - gain`` uncompensated, the best cut, the logs and
    the termination count (``sharded_kl.py:150-190``), and the recount.

    ``prepare(shard)`` builds the engine's per-rank data once and returns
    ``swap(a, b, c_a, c_b, a_s_l) -> w_ab``: it adds ``c_a`` times column
    a and ``c_b`` times column b into the rank's rows ``a_s_l`` (``c =
    -2 s``) and returns ``w_ab`` summed over ranks, as a float."""
    global last_swaps
    if dtype not in SHARDED_DTYPES:
        raise TypeError(f"the sharded engines run f32, f64 or bf16, not {dtype}")
    mesh._check_member()
    dev, n = mesh.device, g.num_nodes
    sides = np.asarray(sides, dtype=np.int8)
    if sides.shape != (n,):
        raise ValueError(f"sides must be ({n},), got {sides.shape}")
    sh = _shard(g, mesh, dtype, dev)
    r0, n_l = sh.r0, sh.n_l
    swap = prepare(sh)
    sides_pad = np.zeros(sh.n_pad, dtype=np.int8)
    sides_pad[:n] = sides
    n1 = int(sides.astype(np.int64).sum())
    cap, limit = max_swaps(n, n1, config), config.terminate_limit(n)
    scalar = _host_scalar(dtype)
    eps, two = scalar(config.gain_eps), scalar(2.0)
    s_h = 1.0 - 2.0 * sides_pad.astype(np.float64)  # the signs, replicated on the host
    tracer = tracer or Tracer(dev)
    with tracer.span("kl.pass"):
        s = torch.as_tensor(s_h).to(dtype).to(dev)
        a_s_l, cut0 = _cut(mesh, sh, s)
        sf_l = s[r0 : r0 + n_l] * (torch.arange(r0, r0 + n_l, device=dev) < n)  # the padding is locked
        cut = best = scalar(cut0.item())
        log_cut, log_gain, log_a, log_b = [cut], [scalar(0.0)], [0], [0]
        term, nf0, nf1 = 0, n - n1, n1
        while len(log_a) <= cap and nf0 > 0 and nf1 > 0 and term <= limit:
            a, d_a, b, d_b = select2(mesh, r0, sf_l, a_s_l, scalar)
            s_a, s_b = s_h[a], s_h[b]
            w_ab = swap(a, b, float(-2.0 * s_a), float(-2.0 * s_b), a_s_l)
            gain = d_a + d_b - two * scalar(w_ab)
            s_h[a], s_h[b] = -s_a, -s_b
            for v in (a, b):
                if r0 <= v < r0 + n_l:
                    sf_l[v - r0] = 0.0
            cut = cut - gain
            best = min(cut, best)
            log_cut.append(cut)
            log_gain.append(gain)
            log_a.append(a)
            log_b.append(b)
            term = term + 1 if gain <= eps else 0
            nf0, nf1 = nf0 - 1, nf1 - 1
    with tracer.span("kl.finalize"):
        verified = _cut(mesh, sh, torch.as_tensor(s_h).to(dtype).to(dev))[1].item()
        its = len(log_a) - 1
        np_dt = _np_dtype(dtype)
        log_cut = np.array([float(x) for x in log_cut], dtype=np_dt)
        log_a, log_b = np.asarray(log_a, np.int32), np.asarray(log_b, np.int32)
        last_swaps = (log_a[1:], log_b[1:])
        return KLResult(
            sides=(s_h[:n] < 0).astype(np.int8),
            best_sides=replay_swaps(sides_pad, log_a, log_b, best_iteration(log_cut, its))[:n],
            initial_cut=float(cut0),
            final_cut=float(cut),
            best_cut=float(best),
            verified_cut=verified,
            iterations=its,
            cut_trajectory=log_cut,
            gain_trajectory=np.array([float(x) for x in log_gain], dtype=np_dt),
        )


def sharded_refine(
    g: Graph,
    sides: np.ndarray,
    mesh: Mesh,
    config: KLConfig = KLConfig(),
    *,
    dtype: torch.dtype = torch.float32,
    tracer: Tracer | None = None,
) -> KLResult:
    """One KL pass of the host graph ``g`` from the int8[n] ``sides``, its
    nodes split over the mesh's ``"mp"`` ranks (every rank of the mesh
    calls it with the same arguments and gets the same result; the
    ``"dp"`` rows each run it whole).  The trajectory is the single-card
    engine's (the JAX package's ``kl/engine.refine``) at every rank
    count.  ``tracer`` receives the spans "kl.pass" and "kl.finalize"."""
    mp = mesh.axis_names[1]

    def prepare(sh: _Shard):
        r0, n_l, dev = sh.r0, sh.n_l, sh.graph.device
        ell_idx, ell_w = (x.to(dev) for x in _ell_rows(g, range(r0, r0 + n_l), dtype))
        zero = torch.zeros((), dtype=dtype, device=dev)

        def fetch_rows(a: int, b: int):
            """The ELL rows of a and b on every rank: one sum over ranks to
            which each row's owner alone contributes (``sharded_kl.py:126-135``,
            whose four sums are one here), carried in f64, which holds the
            ids and weights exactly."""
            rows = torch.zeros(4, ell_w.shape[1], dtype=torch.float64, device=dev)
            for k, node in enumerate((a, b)):
                if r0 <= node < r0 + n_l:
                    rows[2 * k], rows[2 * k + 1] = ell_idx[node - r0], ell_w[node - r0]
            rows = mesh.sum(rows, mp)
            return rows[0].long(), rows[1].to(dtype), rows[2].long(), rows[3].to(dtype)

        def scatter_row(a_s_l, row_i, row_w, coeff):
            tgt = row_i - r0
            ok = (tgt >= 0) & (tgt < n_l)
            a_s_l.index_add_(0, tgt.clamp(0, n_l - 1), torch.where(ok, coeff * row_w, zero))

        def swap(a, b, c_a, c_b, a_s_l):
            row_ia, row_wa, row_ib, row_wb = fetch_rows(a, b)
            w_ab = torch.where(row_ia == b, row_wa, zero).sum().item()
            scatter_row(a_s_l, row_ia, row_wa, c_a)
            scatter_row(a_s_l, row_ib, row_wb, c_b)
            return w_ab

        return swap

    return sharded_pass(g, sides, mesh, config, dtype, tracer, prepare)
