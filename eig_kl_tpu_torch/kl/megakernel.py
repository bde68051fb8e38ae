"""The KL pass: kernel K2 (``csrc/kl_pass.cu``), its plain version, and
the refinement and fused pipelines around it (the port of
``eig_kl_tpu/kl/megakernel.py``).

One launch runs one pass of each of S starts, one thread block per start,
as the TPU mega-kernel does in its batched form (``megakernel.py:_kernel``
with ``batched=True``, launched by ``_run_batched``, ``:602``); a single
start is S = 1 of the same kernel.  Per swap: the first maximum of
``D = -(sf * a_s)`` over each side (``sf`` = side sign * free; K2 finds
it through a per-128-node row-max cache, as the TPU kernel does above
``HIER_THRESHOLD``, or by a flat scan on small graphs, the plain version
by a flat argmax: the same node), the two
row updates of the cached ``a_s = A @ s``, the lock, the gain
``D_a + D_b - 2 w_ab`` added into a Kahan-compensated cut, the four swap
logs, and the termination rule (``floor(log2 n) + 5`` consecutive swaps
with ``gain <= gain_eps``, cKL.cpp:303,382-386).  Each start has its own
``cut0``, ``best0``, ``cap`` and ``term0``, so a pass can leave the kernel
and re-enter it (``refresh_interval``).  K2 has an f32 and an f64
instantiation (``K2``, ``K2_F64``); the f64 pass stands for the JAX
package's f64 engine off the TPU (``eig_kl_tpu/kl/engine.py:206``), to
which its plain version is held (``tests/test_torch_kl.py``).  Around the pass: the initial
``A @ s`` and cut of every start, and afterwards the replay of the final
and best partitions from the swap logs and the from-scratch recount
(``megakernel.py:_finalize_batch``, ``:710``).
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph
from eig_kl_tpu_torch.io.eigfile import EigResult
from eig_kl_tpu_torch.kl.result import KLResult, best_iteration, replay_swaps
from eig_kl_tpu_torch.ops._build import Kernel
from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
from eig_kl_tpu_torch.ops.reduce import FUSED_DOT_BYTES, K4_MAX_PAIRS, fused_dot_batch, tree_sum
from eig_kl_tpu_torch.ops.select import upper_median
from eig_kl_tpu_torch.ops.spmv import spmv
from eig_kl_tpu_torch.ops.spmv_plan import plan_spmv
from eig_kl_tpu_torch.ops.spmv_v3 import SpmvPlanV3
from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig
from eig_kl_tpu_torch.utils.tracing import Tracer

_P, _I = ctypes.c_void_p, ctypes.c_int
K2, K2_F64 = (
    Kernel(
        "kl_pass",
        f"kl_pass_{suffix}",
        [_P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _I, scalar, _I, _P, _P, _P, _P, _P, _P],
    )
    for suffix, scalar in (("f32", ctypes.c_float), ("f64", ctypes.c_double))
)
#: K2's launches (f32 and f64) by their number of starts (``K2.launches``
#: plus ``K2_F64.launches`` is the total): ``K2_STARTS[1]`` counts the
#: single-start form, ``K2_STARTS[8]`` batches of 8.  Only
#: :func:`kl_pass_batch_cuda` adds to it, one per launch.
K2_STARTS: collections.Counter = collections.Counter()

ROW = 128  #: nodes per row of K2's row-max cache
#: K2 selects through its row-max cache from this many nodes up, and by a
#: flat scan below.  The crossover on the H100 (chip_smoke.py, PERF.md),
#: in f32: gen 0.02x (4,038 nodes) 2.19 us per swap flat against 2.58
#: cached, gen 0.05x (10,096) 2.70 against 2.67, gen 0.1x (20,192) 3.67
#: against 2.76.  chip_smoke.py measures the f64 crossover beside it.
K2_CACHE_MIN_NODES = 10_000
#: Dynamic shared memory K2's cache may take: the H100's 227 KB opt-in
#: per block less 2 KB for the kernel's own shared variables (under 1.1
#: KB in f64).
K2_SHARED_CACHE_BYTES = 232_448 - 2048


def k2_cache_words(n_padded: int, row_width: int, dtype: torch.dtype = torch.float32) -> tuple[int, int]:
    """``(words, list_cap)`` of one start's row-max cache in K2 for
    ``n_padded`` nodes (a multiple of :data:`ROW`), in 4-byte words: both
    sides' maxima per row (one word each in f32, two in f64), a dirty bit
    per row, and a list of dirty rows with room for the most one swap can
    touch (two rows of at most ``row_width`` entries, plus the rows of a
    and b); in f64 rounded up to an even count, so that every start's
    maxima stay 8-byte aligned (``csrc/kl_pass.cu:cache_words``)."""
    rows = n_padded // ROW
    list_cap = min(rows, 2 * row_width + 2)
    size = torch.empty((), dtype=dtype).element_size()
    words = 2 * rows * (size // 4) + -(-rows // 32) + list_cap
    return words + (words & 1 if size == 8 else 0), list_cap


def k2_selection(num_nodes: int, row_width: int, dtype: torch.dtype = torch.float32) -> str:
    """How K2 selects for a graph of ``num_nodes`` in ``dtype``: "flat"
    below :data:`K2_CACHE_MIN_NODES`, else "shared" while the cache fits
    :data:`K2_SHARED_CACHE_BYTES`, else "global"."""
    if num_nodes < K2_CACHE_MIN_NODES:
        return "flat"
    words = k2_cache_words(-(-num_nodes // ROW) * ROW, row_width, dtype)[0]
    return "shared" if 4 * words <= K2_SHARED_CACHE_BYTES else "global"


@dataclasses.dataclass(frozen=True)
class PassOutput:
    """What one KL pass returns, on the pass's device.  A batch of S
    starts returns the same fields with a leading start axis.

    Attributes:
      sf: float[n] final side sign * free (0 = locked).
      log_cut, log_gain: float[log_len]; entry 0 is the initial cut and
        0, entries 1..iterations the cut and gain after each swap; the
        rest is 0.
      log_a, log_b: int32[log_len]; entries 1..iterations the swapped
        pair (a left side 0, b left side 1).
      scalars: float[8], the TPU kernel's ``out_ref`` (megakernel.py:486-494):
        cut, best cut, iterations, termination count, free nodes on
        side 0 and on side 1, initial cut, stop flag.
    """

    sf: torch.Tensor
    log_cut: torch.Tensor
    log_gain: torch.Tensor
    log_a: torch.Tensor
    log_b: torch.Tensor
    scalars: torch.Tensor

    def start(self, k: int) -> "PassOutput":
        """Start ``k`` of a batch."""
        return PassOutput(*(getattr(self, f.name)[k] for f in dataclasses.fields(self)))


def kl_pass_plain(
    g: DeviceGraph,
    sf0: torch.Tensor,
    as0: torch.Tensor,
    cut0: float,
    cap: int,
    terminate_limit: int,
    gain_eps: float,
    *,
    best0: float | None = None,
    term0: int = 0,
    log_len: int | None = None,
) -> PassOutput:
    """One KL pass as a Python loop of PyTorch ops, in ``sf0``'s dtype.

    The same arithmetic as K2, operation for operation: selection and row
    updates run on ``sf0``'s device, the scalar bookkeeping runs on the
    host in NumPy scalars of the same dtype.  ``torch.argmax`` returns the
    first maximum, and counts -0.0 and +0.0 as equal, as K2 does.

    ``best0`` (default ``cut0``) and ``term0`` carry the best cut and the
    termination count of the pass's earlier chunks into a re-entry
    (megakernel.py:459-468); ``log_len`` (default ``cap + 1``) is the
    length of the logs.
    """
    dtype = sf0.dtype
    t = torch.empty(0, dtype=dtype).numpy().dtype.type
    if log_len is None:
        log_len = cap + 1
    sf, a_s = sf0.clone(), as0.clone()
    indptr = g.indptr.cpu().numpy()
    indices = g.indices.cpu().numpy()
    data = g.data.to(dtype)
    data_h = data.cpu().numpy()
    log_cut = np.zeros(log_len, dtype=t)
    log_gain = np.zeros(log_len, dtype=t)
    log_a = np.zeros(log_len, dtype=np.int32)
    log_b = np.zeros(log_len, dtype=np.int32)
    cut = log_cut[0] = t(cut0)
    best = cut if best0 is None else min(cut, t(best0))
    comp, two, eps = t(0.0), t(2.0), t(gain_eps)
    nf0, nf1 = int((sf > 0).sum()), int((sf < 0).sum())
    it, term, stop = 0, int(term0), 0
    while stop == 0 and it < cap and nf0 > 0 and nf1 > 0:
        d = -(sf * a_s)
        dl = torch.where(sf > 0, d, -torch.inf)
        dr = torch.where(sf < 0, d, -torch.inf)
        am = torch.stack([torch.argmax(dl), torch.argmax(dr)])
        picked = torch.cat([am.double(), torch.stack([dl[am[0]], dr[am[1]]]).double()])
        a, b, m_l, m_r = picked.tolist()  # one device read per swap
        a, b, m_l, m_r = int(a), int(b), t(m_l), t(m_r)

        # Row a, then row b.  a is on side 0 and b on side 1, so their
        # signs are +1 and -1 and the coefficients -2*s are -2 and +2.
        lo, hi = indptr[a], indptr[a + 1]
        a_s.index_add_(0, g.indices[lo:hi].long(), -2.0 * data[lo:hi])
        row = indices[lo:hi]
        w_ab = data_h[lo:hi][row == b].sum(dtype=t)
        lo, hi = indptr[b], indptr[b + 1]
        a_s.index_add_(0, g.indices[lo:hi].long(), 2.0 * data[lo:hi])
        sf[a] = 0.0
        sf[b] = 0.0

        gain = (m_l + m_r) - two * w_ab
        y = -gain - comp  # Kahan-compensated cut (megakernel.py:424-431)
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


def kl_pass_batch_plain(
    g: DeviceGraph,
    sf0: torch.Tensor,
    as0: torch.Tensor,
    cut0: torch.Tensor,
    best0: torch.Tensor,
    cap: torch.Tensor,
    term0: torch.Tensor,
    log_len: int,
    terminate_limit: int,
    gain_eps: float,
) -> PassOutput:
    """S independent passes, one :func:`kl_pass_plain` per start: the plain
    version of the batched K2.  ``sf0`` and ``as0`` are float[S, n];
    ``cut0`` and ``best0`` float[S]; ``cap`` and ``term0`` int32[S]."""
    outs = [
        kl_pass_plain(
            g, sf0[k], as0[k], c, int(m), terminate_limit, gain_eps,
            best0=b, term0=int(t0), log_len=log_len,
        )
        for k, (c, b, m, t0) in enumerate(
            zip(cut0.tolist(), best0.tolist(), cap.tolist(), term0.tolist())
        )
    ]
    return PassOutput(
        *(torch.stack([getattr(o, f.name) for o in outs]) for f in dataclasses.fields(PassOutput))
    )


def kl_pass_batch_cuda(
    g: DeviceGraph,
    sf0: torch.Tensor,
    as0: torch.Tensor,
    cut0: torch.Tensor,
    best0: torch.Tensor,
    cap: torch.Tensor,
    term0: torch.Tensor,
    log_len: int,
    terminate_limit: int,
    gain_eps: float,
    *,
    _cache: str | None = None,
) -> PassOutput:
    """Launch K2 on the current stream: ``grid = (S,)``, one block of 1,024
    threads runs the whole pass of one start.  Everything is f32, or
    everything f64 (``cap`` and ``term0`` int32), on one card; the
    per-start parameters are device arrays, so nothing is read back before
    the launch.  Inputs are not modified.

    From :data:`K2_CACHE_MIN_NODES` nodes up the selection goes through a
    per-start row-max cache, kept in the block's shared memory while it
    fits :data:`K2_SHARED_CACHE_BYTES` (about 3.5M nodes in f32, 1.8M in
    f64), else in a global-memory stripe per start; below, a flat scan.  ``_cache``
    ("flat", "shared" or "global") forces one of the three, for tests and
    measurements."""
    n = g.num_nodes
    dev = sf0.device
    per_start = {"cut0": cut0, "best0": best0, "cap": cap, "term0": term0}
    tensors = {"sf0": sf0, "as0": as0, **per_start}
    if dev.type != "cuda" or g.device != dev or any(t.device != dev for t in tensors.values()):
        raise ValueError("the KL pass kernel needs its inputs and the graph on one CUDA device")
    dtype = sf0.dtype
    floats = (sf0, as0, cut0, best0, g.data)
    if dtype not in (torch.float32, torch.float64) or any(t.dtype != dtype for t in floats):
        raise TypeError(
            "the card's KL pass takes sf0, as0, cut0, best0 and the graph all f32 or "
            f"all f64; got {[t.dtype for t in floats]}"
        )
    if cap.dtype != torch.int32 or term0.dtype != torch.int32:
        raise TypeError("cap and term0 must be int32")
    if sf0.dim() != 2 or sf0.shape[1] != n or as0.shape != sf0.shape or sf0.shape[0] < 1:
        raise ValueError(f"sf0 and as0 must be (S, {n}) matrices")
    num_starts = sf0.shape[0]
    for name, t in per_start.items():
        if t.shape != (num_starts,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({num_starts},) vector")
    if log_len < 1:
        raise ValueError("log_len must be at least 1 (and above every cap)")
    padded = -(-n // ROW) * ROW  # whole cache rows; padding has sf = 0
    words, list_cap = k2_cache_words(padded, g.row_width, dtype)
    if _cache is None:
        _cache = k2_selection(n, g.row_width, dtype)
    if _cache not in ("flat", "shared", "global"):
        raise ValueError(f"_cache must be 'flat', 'shared' or 'global', not {_cache!r}")
    cache = None
    if _cache == "global":
        cache = torch.empty(num_starts, words, dtype=torch.int32, device=dev)
    sf = torch.zeros(num_starts, padded, dtype=dtype, device=dev)
    a_s = torch.zeros(num_starts, padded, dtype=dtype, device=dev)
    sf[:, :n] = sf0
    a_s[:, :n] = as0
    log_cut = torch.zeros(num_starts, log_len, dtype=dtype, device=dev)
    log_gain = torch.zeros_like(log_cut)
    log_a = torch.zeros(num_starts, log_len, dtype=torch.int32, device=dev)
    log_b = torch.zeros_like(log_a)
    scalars = torch.empty(num_starts, 8, dtype=dtype, device=dev)
    (K2 if dtype == torch.float32 else K2_F64)(
        g.indptr.data_ptr(),
        g.indices.data_ptr(),
        g.data.data_ptr(),
        sf.data_ptr(),
        a_s.data_ptr(),
        padded,
        int(_cache != "flat"),
        list_cap,
        None if cache is None else cache.data_ptr(),
        num_starts,
        cut0.data_ptr(),
        best0.data_ptr(),
        cap.data_ptr(),
        term0.data_ptr(),
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
    K2_STARTS[num_starts] += 1
    return PassOutput(sf[:, :n], log_cut, log_gain, log_a, log_b, scalars)


def kl_pass_batch(
    g, sf0, as0, cut0, best0, cap, term0, log_len, terminate_limit, gain_eps
) -> PassOutput:
    """S KL passes: one K2 launch for tensors on the card (or an error),
    the plain version for tensors on the CPU."""
    fn = kl_pass_batch_plain if sf0.device.type == "cpu" else kl_pass_batch_cuda
    return fn(g, sf0, as0, cut0, best0, cap, term0, log_len, terminate_limit, gain_eps)


def kl_pass_cuda(
    g: DeviceGraph,
    sf0: torch.Tensor,
    as0: torch.Tensor,
    cut0: float,
    cap: int,
    terminate_limit: int,
    gain_eps: float,
) -> PassOutput:
    """One start through K2: the S = 1 case of :func:`kl_pass_batch_cuda`,
    with ``best0 = cut0`` and ``term0 = 0``; that wrapper checks the
    arguments."""
    cut = torch.tensor([cut0], dtype=sf0.dtype, device=sf0.device)
    caps = torch.tensor([cap], dtype=torch.int32, device=sf0.device)
    out = kl_pass_batch_cuda(
        g, sf0[None], as0[None], cut, cut, caps, torch.zeros_like(caps),
        cap + 1, terminate_limit, gain_eps,
    )
    return out.start(0)


def kl_pass(g, sf0, as0, cut0, cap, terminate_limit, gain_eps) -> PassOutput:
    """One KL pass of one start: K2 for tensors on the card, the plain
    version for tensors on the CPU."""
    fn = kl_pass_plain if sf0.device.type == "cpu" else kl_pass_cuda
    return fn(g, sf0, as0, cut0, cap, terminate_limit, gain_eps)


def natural_cap(num_nodes: int, n1: int, config: KLConfig) -> int:
    """Swap cap: the smaller side (KL's exhaustion point), or
    ``max_iterations`` if that is smaller (megakernel.py:1403-1413)."""
    natural = min(num_nodes - n1, n1)
    if config.max_iterations is None:
        return natural
    return min(config.max_iterations, natural)


#: The orders of the mega paths' ``A @ s`` (:func:`mega_spmv`).
SPMV_ORDERS = ("plan", "ell")


def mega_spmv(g: DeviceGraph, spmv_order: str = "plan"):
    """The ``A @ s`` of the mega paths, as a function of ``s``.

    ``spmv_order`` "plan" is the JAX mega engine's: the TPU SpMV of its
    plan (``megakernel.py:MegaGraph``, ``:133-137``), which for an f32
    graph with no v3 plan is the v1 kernel at most ``V1_MAX_NNZ`` stored
    entries and the v2 pair above (:attr:`DeviceGraph.plan_layout`;
    :func:`~eig_kl_tpu_torch.ops.spmv_plan.plan_spmv`, K1's ``spmv_v1_f32``
    or ``spmv_v2_f32`` on the card).  In f64 (which the mega engine does
    not run), with a v3 plan, and for "ell" it is :func:`spmv`: K1 in the
    ELL order of the JAX package's XLA engine, which the pipelines take
    because the JAX package runs that engine off the TPU
    (``models/pipelines.py:_use_mega``), or the route of a plan the graph
    carries, as that engine's ``spmv`` takes it."""
    if spmv_order not in SPMV_ORDERS:
        raise ValueError(f"spmv_order is one of {SPMV_ORDERS}, got {spmv_order!r}")
    if spmv_order == "plan" and not isinstance(g.plan, SpmvPlanV3) and g.plan_layout is not None:
        layout = g.plan_layout
        return lambda x: plan_spmv(layout, x)
    return lambda x: spmv(g, x)


def _batch_init(
    g: DeviceGraph, s: torch.Tensor, form: str = "slice", matvec=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """``A @ s`` and the from-scratch cut of every start of the sign stack
    ``s`` (float[S, n]), on the device: ``(a_s[S, n], cut[S])``.  Used for
    the initial state and for the final recount (megakernel.py:_batch_init,
    ``:763``); each start is computed as a single start is, ``A @ s`` by
    ``matvec`` (a :func:`mega_spmv`; by default the JAX mega engine's).

    The cut is ``0.25 * (sum(deg) - s . A s)``, the JAX mega engine's form
    (``megakernel.py:754``, ``:773``).  Below 4,096 nodes in f32 it adds as
    that engine's program on the CPU does: ``wsum`` as ``jnp.sum`` adds it
    (:func:`tree_sum`, ``:1034``), the dot as XLA's loop with its signs
    fused in (:func:`fused_dot_batch`; K4, up to 4 starts per launch;
    ROADMAP.md C5): ``form`` "slice" where they are a slice of the padded
    state (``_batch_init``, ``:773``), "recount" where they are ``1 - 2
    fs`` of the replayed split (the verified cut, ``:754``, read in the
    engine's own program: ``ops/reduce.py:LANES_FORMS``).
    From 4,096 nodes XLA's CPU dot would be one sequential chain, which at
    gen 1.0x moves the verified cut 6.2e-5 from the tracked one, past the
    drift gate of 1e-5; there, and in f64 (which the JAX mega engine does
    not run), the cut is :func:`cut_size`'s fixed tree order, the order
    that keeps the drift within the gate (ROADMAP.md C5, settled)."""
    matvec = matvec or mega_spmv(g)
    a_s = torch.stack([matvec(row) for row in s])
    if g.dtype != torch.float32 or s.shape[1] * 4 >= FUSED_DOT_BYTES:
        cut = torch.stack([cut_size(g, row, a_row) for row, a_row in zip(s, a_s)])
        return a_s, cut.to(g.dtype)
    rows, a_rows = s.unbind(), a_s.unbind()
    dots = torch.cat([
        fused_dot_batch(rows[k : k + K4_MAX_PAIRS], a_rows[k : k + K4_MAX_PAIRS], form)
        for k in range(0, len(rows), K4_MAX_PAIRS)
    ])
    return a_s, 0.25 * (tree_sum(g.degrees) - dots)


def _caps(sides: torch.Tensor, config: KLConfig) -> list[int]:
    """Each start's swap cap, from its own split (megakernel.py:1137-1149)."""
    n = sides.shape[1]
    return [natural_cap(n, n1, config) for n1 in sides.sum(dim=1, dtype=torch.int64).tolist()]


def _replay(sides0: torch.Tensor, out: PassOutput, upto: torch.Tensor) -> torch.Tensor:
    """Each start's partition after its first ``upto[k]`` swaps: side(a)
    -> 1, side(b) -> 0, by masked scatter from the swap logs.  A node
    swaps at most once, so the order of the writes does not matter; masked
    entries land in a spare column."""
    num_starts, n = sides0.shape
    iota = torch.arange(out.log_a.shape[1], device=sides0.device)
    valid = (iota >= 1) & (iota <= upto[:, None])
    spare = torch.full_like(out.log_a, n, dtype=torch.int64)
    r = torch.cat([sides0, sides0.new_zeros(num_starts, 1)], dim=1)
    r.scatter_(1, torch.where(valid, out.log_a.long(), spare), 1)
    r.scatter_(1, torch.where(valid, out.log_b.long(), spare), 0)
    return r[:, :n]


def _refine_batch(
    g: DeviceGraph, sides: torch.Tensor, config: KLConfig, tracer: Tracer, matvec
) -> list[KLResult]:
    """One pass of each start of ``sides`` (int8[S, n] on the graph's
    device) in one launch: the initial ``A @ s`` and cut of every start,
    the pass, then the finalization on the device -- the final and best
    partitions replayed from the swap logs (the best is the first minimum
    of the cut log up to ``iterations``) and the from-scratch recount (the
    gKL.cu:524-530 oracle) -- and one transfer of the results to the host
    (megakernel.py:_mega_full, ``:791``)."""
    n = g.num_nodes
    dev = g.device
    with tracer.span("kl.pass"):
        caps = _caps(sides, config)
        s = sides_to_signs(sides, g.dtype)
        a_s, cut0 = _batch_init(g, s, matvec=matvec)
        cap_t = torch.tensor(caps, dtype=torch.int32, device=dev)
        out = kl_pass_batch(
            g, s, a_s, cut0, cut0, cap_t, torch.zeros_like(cap_t),
            max(caps) + 1, config.terminate_limit(n), config.gain_eps,
        )

    with tracer.span("kl.finalize"):
        it = out.scalars[:, 2].long()
        iota = torch.arange(out.log_cut.shape[1], device=dev)
        in_run = iota <= it[:, None]
        best_it = torch.argmin(torch.where(in_run, out.log_cut, torch.inf), dim=1)  # first minimum
        final = _replay(sides, out, it)
        best = _replay(sides, out, best_it)
        verified = _batch_init(g, sides_to_signs(final, g.dtype), "recount", matvec)[1]
        sc, lc, lg, ver, fin_h, best_h = (
            x.cpu().numpy() for x in (out.scalars, out.log_cut, out.log_gain, verified, final, best)
        )
        results = []
        for k in range(sides.shape[0]):
            its = int(sc[k, 2])
            results.append(
                KLResult(
                    sides=fin_h[k],
                    best_sides=best_h[k],
                    initial_cut=float(sc[k, 6]),
                    final_cut=float(sc[k, 0]),
                    best_cut=float(sc[k, 1]),
                    verified_cut=float(ver[k]),
                    iterations=its,
                    cut_trajectory=lc[k, : its + 1],
                    gain_trajectory=lg[k, : its + 1],
                )
            )
    return results


def _refine_batch_refresh(
    g: DeviceGraph, sides_batch: np.ndarray, config: KLConfig, tracer: Tracer, matvec
) -> list[KLResult]:
    """Chunked refinement of S starts: every ``refresh_interval`` swaps
    the kernel exits, the host replays each start's chunk of the log into
    its partition and lock state, and the next chunk re-enters with a
    from-scratch ``A @ s`` and cut for all starts, the best cut and the
    termination count carried over (megakernel.py:_refine_mega_batch_refresh,
    ``:1207``; the stronger form of the reference's disabled
    verifyAndCorrectCutSize, gKL.cu:368-382).  Starts that have stopped
    ride along with a zero cap: their block runs no swap."""
    num_starts, n = sides_batch.shape
    dev, dtype = g.device, g.dtype
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    n1 = sides_batch.astype(np.int64).sum(axis=1)
    naturals = np.minimum(n - n1, n1)
    true_caps = (
        naturals if config.max_iterations is None
        else np.minimum(config.max_iterations, naturals)
    )
    chunk = min(config.refresh_interval, int(max(true_caps.max(), 1)))
    terminate_limit = config.terminate_limit(n)

    sides_cur = sides_batch.astype(np.int8).copy()
    free_mask = np.ones((num_starts, n), dtype=bool)
    term = np.zeros(num_starts, np.int64)
    best = np.full(num_starts, np.inf)
    stopped = np.zeros(num_starts, bool)
    it_total = np.zeros(num_starts, np.int64)
    initial_cut = np.zeros(num_starts)
    final_cut = np.zeros(num_starts)
    cuts = [[] for _ in range(num_starts)]
    gains = [[] for _ in range(num_starts)]
    a_log = [[] for _ in range(num_starts)]
    b_log = [[] for _ in range(num_starts)]
    first = True
    with tracer.span("kl.pass"):
        while not stopped.all():
            cap_chunk = np.where(stopped, 0, np.minimum(chunk, true_caps - it_total))
            signs = (1.0 - 2.0 * sides_cur.astype(np_dtype)).astype(np_dtype)
            s_dev = torch.as_tensor(signs).to(dev)
            a_s, cut_dev = _batch_init(g, s_dev, matvec=matvec)
            sf_dev = torch.as_tensor(signs * free_mask).to(dev)
            best_arr = cut_dev if first else torch.as_tensor(best.astype(np_dtype)).to(dev)
            out = kl_pass_batch(
                g, sf_dev, a_s, cut_dev, best_arr,
                torch.as_tensor(cap_chunk.astype(np.int32)).to(dev),
                torch.as_tensor(term.astype(np.int32)).to(dev),
                chunk + 1, terminate_limit, config.gain_eps,
            )
            # The final sf is not fetched: the replay below rebuilds the
            # state from the swap log.
            lc, lg, la, lb, sc = (
                x.cpu().numpy()
                for x in (out.log_cut, out.log_gain, out.log_a, out.log_b, out.scalars)
            )
            for k in range(num_starts):
                if stopped[k]:
                    continue
                it_chunk = int(sc[k, 2])
                if first:
                    initial_cut[k] = float(sc[k, 6])
                best[k] = float(sc[k, 1])
                term[k] = int(sc[k, 3])
                lo = 0 if it_total[k] == 0 else 1  # later chunks repeat entry 0
                cuts[k].append(lc[k, lo : it_chunk + 1])
                gains[k].append(lg[k, lo : it_chunk + 1])
                la_c = la[k, 1 : it_chunk + 1]
                lb_c = lb[k, 1 : it_chunk + 1]
                a_log[k].append(la_c)
                b_log[k].append(lb_c)
                sides_cur[k, la_c] = 1
                sides_cur[k, lb_c] = 0
                free_mask[k, la_c] = False
                free_mask[k, lb_c] = False
                it_total[k] += it_chunk
                if (
                    bool(sc[k, 7])
                    or int(sc[k, 4]) == 0
                    or int(sc[k, 5]) == 0
                    or it_total[k] >= true_caps[k]
                ):
                    stopped[k] = True
                    final_cut[k] = float(sc[k, 0])
            first = False

    with tracer.span("kl.finalize"):
        # From-scratch recount of every final partition (gKL.cu:524-530).
        s_fin = torch.as_tensor(1.0 - 2.0 * sides_cur.astype(np_dtype)).to(dev)
        verified = _batch_init(g, s_fin, matvec=matvec)[1].cpu().numpy()
        results = []
        for k in range(num_starts):
            iterations = int(it_total[k])
            log_cut = np.concatenate(cuts[k]) if cuts[k] else np.zeros(1, np_dtype)
            log_gain = np.concatenate(gains[k]) if gains[k] else np.zeros(1, np_dtype)
            log_a = np.concatenate([np.zeros(1, np.int32)] + a_log[k])
            log_b = np.concatenate([np.zeros(1, np.int32)] + b_log[k])
            results.append(
                KLResult(
                    sides=sides_cur[k].copy(),
                    best_sides=replay_swaps(
                        sides_batch[k], log_a, log_b, best_iteration(log_cut, iterations)
                    ),
                    initial_cut=float(initial_cut[k]),
                    final_cut=float(final_cut[k]),
                    best_cut=float(best[k]),
                    verified_cut=float(verified[k]),
                    iterations=iterations,
                    cut_trajectory=log_cut[: iterations + 1],
                    gain_trajectory=log_gain[: iterations + 1],
                )
            )
    return results


def refine_mega_batch(
    g: DeviceGraph,
    sides_batch: np.ndarray,
    config: KLConfig = KLConfig(),
    *,
    tracer: Tracer | None = None,
    spmv_order: str = "plan",
) -> list[KLResult]:
    """One KL pass of each of S starts in one kernel launch, on the
    graph's device; one host-side result per start, each equal to
    :func:`refine_mega` from the same split.

    Args:
      sides_batch: int8[S, n] initial side labels per start.
      config: ``refresh_interval > 0`` runs the chunked kernel re-entry of
        :func:`refine_mega`, batched.
      tracer: receives the spans "kl.pass" and "kl.finalize".
      spmv_order: the order of the initial ``A @ s`` and of the recount
        (:func:`mega_spmv`): "plan", the JAX mega engine's (its
        ``refine_mega_batch``), or "ell", the JAX XLA engine's, which the
        pipelines take.
    """
    matvec = mega_spmv(g, spmv_order)
    sides_batch = np.asarray(sides_batch, dtype=np.int8)
    if sides_batch.ndim != 2 or sides_batch.shape[1] != g.num_nodes:
        raise ValueError(f"sides_batch must be (S, {g.num_nodes}), got {sides_batch.shape}")
    tracer = tracer or Tracer(g.device)
    if config.refresh_interval > 0:
        return _refine_batch_refresh(g, sides_batch, config, tracer, matvec)
    return _refine_batch(g, torch.as_tensor(sides_batch).to(g.device), config, tracer, matvec)


def refine_mega(
    g: DeviceGraph,
    sides: np.ndarray,
    config: KLConfig = KLConfig(),
    *,
    tracer: Tracer | None = None,
    spmv_order: str = "plan",
) -> KLResult:
    """One KL pass from the int8[n] side labels ``sides``, on the graph's
    device; host-side result.  It is the S = 1 case of
    :func:`refine_mega_batch`, with and without ``refresh_interval``.
    ``tracer`` receives the spans "kl.pass" and "kl.finalize";
    ``spmv_order`` is :func:`refine_mega_batch`'s."""
    return refine_mega_batch(
        g, np.asarray(sides, dtype=np.int8)[None], config, tracer=tracer, spmv_order=spmv_order
    )[0]


def fused_refine_mega(
    g: DeviceGraph,
    spectral_config: SpectralConfig,
    config: KLConfig = KLConfig(),
    *,
    tracer: Tracer | None = None,
    spmv_order: str = "plan",
):
    """The whole gKL2 pipeline on the graph's device: power solve,
    "upper"-median split (gKL2.cu:403-414), one KL pass, finalization.
    The split stays on the device between the phases.  ``tracer``
    receives the spans "spectral", "kl.pass" and "kl.finalize";
    ``spmv_order`` is :func:`refine_mega_batch`'s (the power solve runs
    on the graph as it is, as the JAX ``_fused_full``'s does on its
    device graph).

    Returns ``(EigResult, KLResult, power iterations)``.
    """
    from eig_kl_tpu_torch.spectral.power import _power_core

    matvec = mega_spmv(g, spmv_order)
    tracer = tracer or Tracer(g.device)
    with tracer.span("spectral"):
        lam, v, iters = _power_core(
            g,
            shift=spectral_config.shift,
            tolerance=spectral_config.tolerance,
            min_iters=spectral_config.min_power_iters,
            max_iters=spectral_config.max_iterations,
            seed=spectral_config.seed,
            dtype=g.dtype,
            convergence=spectral_config.convergence,
            check_interval=spectral_config.check_interval,
            stable_checks=spectral_config.stable_checks,
            inter_dtype=spectral_config.inter_dtype,
        )
        med = upper_median(v)
        sides = (med > v).to(torch.int8)
    kl = _refine_batch(g, sides[None], config, tracer, matvec)[0]
    eig = EigResult(
        eigenvalue=float(lam),
        median=float(med),
        sides=sides.cpu().numpy(),
        values=v.double().cpu().numpy(),
    )
    return eig, kl, iters
