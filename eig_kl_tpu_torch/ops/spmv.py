"""The SpMV ``y = A @ x``: kernel K1 (``csrc/spmv_csr.cu``), its plain
version, and the dispatch between them and the plan routes for an f32
graph with a plan (a :class:`~eig_kl_tpu_torch.graph.csr.CsrPlan`'s TPU
kernel order, :mod:`eig_kl_tpu_torch.ops.spmv_plan`; the v3 route,
:mod:`eig_kl_tpu_torch.ops.spmv_v3`); and K1's other entry points, each an
epilogue on K1's SpMV: the power step (:func:`power_step`), the "eig"
Laplacian of Lanczos and LOBPCG (:func:`laplacian`), LOBPCG's blocked
product (:func:`spmm`) and the momentum exit's lazy walk
(:func:`lazy_walk`), which gathers ``z = dsinv * w``: the momentum step's
rescale makes it in the same pass (:func:`lazy_rescale`), else the z pass
(:func:`lazy_z`), both of :mod:`eig_kl_tpu_torch.ops.rescale`.

Replaces the XLA ELL SpMV of ``eig_kl_tpu/ops/partition.py:spmv``, which
the JAX package runs for a graph without a plan.  The power solver runs
one SpMV per step; the KL pass runs one for its initial ``A @ s`` and one
for the final recount; Lanczos one Laplacian per step, LOBPCG two blocked
products per iteration.

Summation order.  K1 and the plain version add each row in one fixed
order: the order in which XLA's CPU backend adds the rows of the JAX
package's f32 ELL SpMV (``eig_kl_tpu/ops/partition.py:spmv``), so that
the f32 result equals the JAX package's CPU result bit for bit.  That
order depends on the ELL width ``W = DeviceGraph.row_width`` (the
largest degree rounded up to a multiple of 8):

* ``W = 8`` or ``16``: one chain of fused multiply-adds over the row's
  entries in order (LLVM unrolls the row's loop fully and keeps it a
  chain; :data:`CHAIN_WIDTH`).
* ``W = 24`` or ``32``: the entries of a row go to 8 lanes by their
  position in the row (position mod 8); each lane accumulates its entries
  in order with fused multiply-adds (one rounding per entry); the 8 lane
  sums combine as ``((l0+l4) + (l2+l6)) + ((l1+l5) + (l3+l7))``.
* ``W > 32``: the row is cut into windows of 32 positions after
  ``(32 * ceil(W / 32) - W) // 2`` leading pad positions; each window
  adds its rounded products in order, and the window sums add in order.

The ELL's padding entries add exact zeros and are skipped.  The
epilogues round as XLA's CPU fusion does: a product that feeds an add or
a subtraction is one fused multiply-add with it (``deg * x - A x``,
``w + dsinv * A(dsinv * w)``, ``x - c * lap``).  The f64
plain version uses the same order with unfused multiply-adds (PyTorch
has no exact f64 fused multiply-add); it is not bit-identical to XLA's.

Every entry point has an f32 and an f64 kernel (``K1`` and ``K1_F64``,
``K1_STEP`` and ``K1_STEP_F64``, ...), each with its own launch count;
an f64 tensor on the card goes to the f64 kernel, which equals the f64
plain version bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import CsrPlan, DeviceGraph
from eig_kl_tpu_torch.ops._build import Kernel, stream_handle
from eig_kl_tpu_torch.ops.rescale import (  # noqa: F401  (exported)
    K1_RESCALE,
    K1_RESCALE_F64,
    K1_Z,
    K1_Z_F64,
    checked_z,
    lazy_rescale,
    lazy_rescale_cuda,
    lazy_rescale_plain,
    lazy_z,
    lazy_z_cuda,
    lazy_z_plain,
)
from eig_kl_tpu_torch.ops.spmv_plan import plan_spmv
from eig_kl_tpu_torch.ops.spmv_v3 import SpmvPlanV3, spmv_v3

_P, _I = ctypes.c_void_p, ctypes.c_int


def _pair(symbol: str, argtypes) -> tuple[Kernel, Kernel]:
    """The f32 and f64 kernels of one entry point; ``argtypes`` maps a
    scalar ctypes type to the argument list."""
    return tuple(
        Kernel("spmv_csr", f"{symbol}_{suffix}", argtypes(scalar))
        for suffix, scalar in (("f32", ctypes.c_float), ("f64", ctypes.c_double))
    )


K1, K1_F64 = _pair("spmv_csr", lambda _: [_P] * 5 + [_I, _I, _P])
K1_STEP, K1_STEP_F64 = _pair("power_step", lambda t: [_P] * 5 + [t, _P, _I, _I, _I, _P])
K1_LAPLACIAN, K1_LAPLACIAN_F64 = _pair("laplacian", lambda _: [_P] * 6 + [_I, _I, _P])
K1_SPMM, K1_SPMM_F64 = _pair("spmm_csr", lambda _: [_P] * 6 + [_I, _I, _I, _P])
K1_LAZY, K1_LAZY_F64 = _pair("lazy_walk", lambda _: [_P] * 9 + [_I, _I, _P])
_F64 = {K1: K1_F64, K1_STEP: K1_STEP_F64, K1_LAPLACIAN: K1_LAPLACIAN_F64, K1_SPMM: K1_SPMM_F64,
        K1_LAZY: K1_LAZY_F64}
#: The dtypes K1 takes on the card.
CARD_DTYPES = (torch.float32, torch.float64)


def _typed(kernel: Kernel, dtype: torch.dtype) -> Kernel:
    """``kernel``'s instantiation for ``dtype`` (f32 or f64)."""
    return kernel if dtype == torch.float32 else _F64[kernel]


#: The most columns :func:`spmm` takes on the card (``csrc/spmv_csr.cu``).
SPMM_MAX_COLUMNS = 16

LANES = 8
WINDOW = 32
#: The widest ELL rows that XLA adds in one chain (read from its x86-64
#: code at widths 8, 16, 24 and 32: LLVM unrolls the row's loop of 8 or 16
#: fully and keeps it a chain, and vectorizes 24 or 32 in 8 lanes;
#: ROADMAP.md C).  One fusion keeps lanes at 16: the power solve's first
#: step, whose loop body also draws the start vector (:func:`power_step`'s
#: ``lanes``); at 8 that step is a chain too (read at 4 to 55 nodes).
CHAIN_WIDTH = 16


def row_ids(g: DeviceGraph) -> torch.Tensor:
    """int64[nnz]: the row of every stored entry."""
    counts = (g.indptr[1:] - g.indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(g.num_nodes, device=g.device), counts)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 tensors with one rounding, like ``fmaf``.

    The product is exact in f64.  The f64 sum is formed round-to-odd (its
    exact error from TwoSum decides the last bit), which makes the final
    rounding to f32 the correctly rounded fused result (Boldo and
    Melquiond, "When double rounding is odd", 2005).
    """
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def _accumulate(acc, rows, slot, step, values, fused_with=None):
    """``acc[rows, slot] += values`` in increasing ``step`` order; with
    ``fused_with`` the add is ``fma(values, fused_with, acc)``."""
    if not step.numel():
        return acc
    order = torch.argsort(step, stable=True)
    for sel in torch.split(order, torch.bincount(step).tolist()):
        r, s = rows[sel], slot[sel]
        if fused_with is None:
            acc[r, s] = acc[r, s] + values[sel]
        else:
            acc[r, s] = fma_f32(values[sel], fused_with[sel], acc[r, s])
    return acc


def spmv_plain(g: DeviceGraph, x: torch.Tensor, *, lanes: bool = False) -> torch.Tensor:
    """``A @ x`` in plain PyTorch, in the graph's dtype, in K1's order; ``x``
    a vector, or an ``(n, k)`` matrix whose columns are taken at once.
    ``lanes``: the 8 lanes at widths 16 and below too (the order of
    :data:`CHAIN_WIDTH`'s one exception)."""
    n, dt, dev = g.num_nodes, g.dtype, g.device
    rows = row_ids(g)
    pos = torch.arange(g.nnz, device=dev) - g.indptr[:-1].long()[rows]
    xv = x[g.indices.long()].to(dt)
    extra = tuple(x.shape[1:])
    data = g.data.view(-1, *(1,) * len(extra)).expand_as(xv)
    fused = dt == torch.float32
    products = None if fused and g.row_width <= WINDOW else data * xv
    if g.row_width <= WINDOW:
        k = 1 if g.row_width <= CHAIN_WIDTH and not lanes else LANES
        lanes = torch.zeros(n, k, *extra, dtype=dt, device=dev)
        if fused:
            _accumulate(lanes, rows, pos % k, pos // k, data, fused_with=xv)
        else:
            _accumulate(lanes, rows, pos % k, pos // k, products)
        while lanes.shape[1] > 1:
            half = lanes.shape[1] // 2
            lanes = lanes[:, :half] + lanes[:, half:]
        return lanes[:, 0].contiguous()
    m = -(-g.row_width // WINDOW)
    shifted = pos + (m * WINDOW - g.row_width) // 2
    windows = torch.zeros(n, m, *extra, dtype=dt, device=dev)
    _accumulate(windows, rows, shifted // WINDOW, shifted % WINDOW, products)
    y = torch.zeros(n, *extra, dtype=dt, device=dev)
    for j in range(m):
        y = y + windows[:, j]
    return y


def _check_dtype(g: DeviceGraph, x: torch.Tensor, what: str) -> None:
    if x.dtype not in CARD_DTYPES or g.dtype != x.dtype:
        raise TypeError(
            f"{what}: the card's K1 takes an f32 or an f64 graph and x of the "
            f"graph's dtype; got x {x.dtype}, graph {g.dtype}"
        )


def _check_card(g: DeviceGraph, x: torch.Tensor, what: str) -> None:
    n = g.num_nodes
    if x.device.type != "cuda" or g.device != x.device:
        raise ValueError(f"{what} needs x and the graph on one CUDA device")
    _check_dtype(g, x, what)
    if x.shape != (n,) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous ({n},) vector, got {tuple(x.shape)}")


def spmv_csr(g: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """Launch K1 on the current stream; ``x`` and the graph are f32, or
    both f64, on the card."""
    _check_card(g, x, "spmv_csr")
    y = torch.empty(g.num_nodes, dtype=x.dtype, device=x.device)
    _typed(K1, x.dtype)(
        g.indptr.data_ptr(),
        g.indices.data_ptr(),
        g.data.data_ptr(),
        x.data_ptr(),
        y.data_ptr(),
        g.num_nodes,
        g.row_width,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return y


def spmv(g: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """``A @ x``, as the JAX package's ``ops/partition.py:spmv`` dispatches
    it: for an f32 graph with a plan the plan's route (a :class:`CsrPlan`'s
    TPU kernel order in f32, :func:`~eig_kl_tpu_torch.ops.spmv_plan.plan_spmv`;
    a v3 plan's route), else K1; the kernels for a tensor on the card, the
    plain versions for a tensor on the CPU."""
    if isinstance(g.plan, CsrPlan) and g.dtype == torch.float32:
        return plan_spmv(g.plan.layout, x.to(torch.float32))
    if isinstance(g.plan, SpmvPlanV3) and g.dtype == torch.float32:
        return spmv_v3(g.plan, x.to(torch.float32))
    if x.device.type == "cpu":
        return spmv_plain(g, x)
    return spmv_csr(g, x)


def power_step(g: DeviceGraph, x: torch.Tensor, deg: torch.Tensor, inv_shift: float, *,
               lanes: bool = False) -> torch.Tensor:
    """One shift-inverted power step before its norm (``power.py:119-124``
    of the JAX package): ``y = x - inv_shift * L x`` with ``L x = 2 x - 2
    (A @ x) / deg``.  K1's step entry point for a tensor on the card,
    :func:`power_step_plain` on the CPU; the graph carries no v3 plan.
    ``lanes``: the row sums in 8 lanes at width 16 too, as in the solve's
    first step (``power.py:190-191``: XLA fuses the start vector's draw into
    it and does not unroll its rows; ROADMAP.md C)."""
    if x.device.type == "cpu":
        return power_step_plain(g, x, deg, inv_shift, lanes=lanes)
    return power_step_cuda(g, x, deg, inv_shift, lanes=lanes)


def power_step_plain(g: DeviceGraph, x: torch.Tensor, deg: torch.Tensor, inv_shift: float, *,
                     lanes: bool = False) -> torch.Tensor:
    """:func:`power_step` in plain PyTorch, each operation rounded on its
    own, except the last in f32: XLA's CPU fusion contracts ``x - c * lap``
    into one fused multiply-add, which changes no bit where ``c`` is a power
    of two (shift 2.0) and rounds once less elsewhere."""
    lap = 2.0 * x - 2.0 * spmv_plain(g, x.to(g.dtype), lanes=lanes).to(x.dtype) / deg
    if x.dtype != torch.float32:
        return x - inv_shift * lap
    c = torch.tensor(-np.float32(inv_shift), device=x.device)
    return fma_f32(c, lap, x)


def power_step_cuda(g: DeviceGraph, x: torch.Tensor, deg: torch.Tensor, inv_shift: float, *,
                    lanes: bool = False) -> torch.Tensor:
    """Launch K1's step entry point on the current stream: the graph, ``x``
    and ``deg`` (contiguous, ``(n,)``), all f32 or all f64, on one card.
    ``lanes`` is passed to the kernel as its own argument."""
    _check_card(g, x, "power_step_cuda")
    _check_vector(g, deg, x, "deg")
    y = torch.empty_like(x)
    shift = float(np.float32(inv_shift)) if x.dtype == torch.float32 else float(inv_shift)
    _typed(K1_STEP, x.dtype)(
        g.indptr.data_ptr(), g.indices.data_ptr(), g.data.data_ptr(), x.data_ptr(), deg.data_ptr(),
        shift, y.data_ptr(), g.num_nodes, g.row_width, int(lanes),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return y


def _check_vector(g: DeviceGraph, v: torch.Tensor, like: torch.Tensor, name: str) -> None:
    if v.device != like.device or v.dtype != like.dtype or v.shape != (g.num_nodes,) or not v.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {like.dtype} ({g.num_nodes},) vector on x's card")


def _fused_sub(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b - c`` as XLA's CPU fusion rounds it: one fused multiply-add in
    f32, the rounded product in f64."""
    if a.dtype != torch.float32:
        return a * b - c
    return fma_f32(a.expand_as(b), b, -c)


def laplacian(g: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """``L x = deg * x - A x`` (``L = D - A``, the clique-expansion Laplacian
    built at cEIG.cpp:86-133; ``eig_kl_tpu/spectral/lanczos.py:57``): K1's
    Laplacian entry point for a tensor on the card, :func:`laplacian_plain`
    on the CPU.  The graph carries no v3 plan."""
    if x.device.type == "cpu":
        return laplacian_plain(g, x)
    return laplacian_cuda(g, x)


def laplacian_plain(g: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """:func:`laplacian` in plain PyTorch, in the graph's dtype."""
    return _fused_sub(g.degrees, x, spmv_plain(g, x))


def laplacian_cuda(g: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """Launch K1's Laplacian entry point on the current stream: the graph
    and ``x`` (contiguous, ``(n,)``), both f32 or both f64, on one card."""
    _check_card(g, x, "laplacian_cuda")
    _check_vector(g, g.degrees, x, "the graph's degrees")
    y = torch.empty_like(x)
    _typed(K1_LAPLACIAN, x.dtype)(
        g.indptr.data_ptr(), g.indices.data_ptr(), g.data.data_ptr(), x.data_ptr(),
        g.degrees.data_ptr(), y.data_ptr(), g.num_nodes, g.row_width,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return y


def spmm(g: DeviceGraph, X: torch.Tensor, *, laplacian: bool = False) -> torch.Tensor:
    """``A @ X`` for ``X`` of shape ``(n, k)``, each column the SpMV of that
    column (the JAX package's ``vmap`` of ``spmv``,
    ``eig_kl_tpu/spectral/lobpcg_solver.py:51-56``); with ``laplacian``,
    ``deg * X - A @ X``.  K1's blocked entry point for a tensor on the card
    (``1 <= k <= 16``; four columns per walk of the rows where k is a
    multiple of 4 and X 16-byte aligned, from one 32-byte sector of each
    gathered row of X, else one), :func:`spmm_plain` on the CPU."""
    if X.device.type == "cpu":
        return spmm_plain(g, X, laplacian=laplacian)
    return spmm_cuda(g, X, laplacian=laplacian)


def spmm_plain(g: DeviceGraph, X: torch.Tensor, *, laplacian: bool = False) -> torch.Tensor:
    """:func:`spmm` in plain PyTorch, every column in K1's order."""
    AX = spmv_plain(g, X)
    if not laplacian:
        return AX
    return _fused_sub(g.degrees[:, None], X, AX)


def spmm_cuda(g: DeviceGraph, X: torch.Tensor, *, laplacian: bool = False) -> torch.Tensor:
    """Launch K1's blocked entry point on the current stream: the graph and
    a contiguous row-major ``(n, k)`` ``X``, ``1 <= k <= 16``, both f32 or
    both f64, on one card."""
    n = g.num_nodes
    if X.device.type != "cuda" or g.device != X.device:
        raise ValueError("spmm_cuda needs X and the graph on one CUDA device")
    _check_dtype(g, X, "spmm_cuda")
    if X.dim() != 2 or X.shape[0] != n or not 1 <= X.shape[1] <= SPMM_MAX_COLUMNS or not X.is_contiguous():
        raise ValueError(
            f"X must be a contiguous (n, k) matrix with n = {n} and 1 <= k <= "
            f"{SPMM_MAX_COLUMNS}, got {tuple(X.shape)}"
        )
    if laplacian:
        _check_vector(g, g.degrees, X, "the graph's degrees")
    Y = torch.empty_like(X)
    _typed(K1_SPMM, X.dtype)(
        g.indptr.data_ptr(), g.indices.data_ptr(), g.data.data_ptr(), X.data_ptr(),
        g.degrees.data_ptr() if laplacian else None, Y.data_ptr(), n, X.shape[1], g.row_width,
        torch.cuda.current_stream(X.device).cuda_stream,
    )
    return Y


def lazy_walk(g: DeviceGraph, w: torch.Tensor, dsinv: torch.Tensor, scaled=None, z=None) -> torch.Tensor:
    """The lazy walk ``(I + D^-1/2 A D^-1/2) / 2`` applied to ``w``:
    ``0.5 * (w + dsinv * (A @ (dsinv * w)))``, the momentum exit's operator
    (``eig_kl_tpu/spectral/power.py:297-305``).  K1's lazy-walk entry point
    for a tensor on the card, :func:`lazy_walk_plain` on the CPU; the graph
    carries no v3 plan.

    ``scaled``: ``(u, c)``, ``c`` a 0-d tensor, with ``w = u * c`` rounded
    once.  The epilogue is then ``0.5 * fma(u, c, dsinv * Ax)``, the
    product ``dsinv * Ax`` rounded: the momentum check's walk of the
    deflated iterate on a graph wider than 32 from 4,096 values, where XLA
    recomputes ``w`` inside the epilogue's fusion and contracts its product
    instead (ROADMAP.md C9).

    ``z``: ``dsinv * w`` (:func:`lazy_z`, or :func:`lazy_rescale`'s third
    output), the vector the walk gathers; without it the walk makes it
    first.  The result is the same bits either way."""
    if w.device.type == "cpu":
        return lazy_walk_plain(g, w, dsinv, scaled, z)
    return lazy_walk_cuda(g, w, dsinv, scaled, z)


def lazy_walk_plain(g: DeviceGraph, w: torch.Tensor, dsinv: torch.Tensor, scaled=None, z=None) -> torch.Tensor:
    """:func:`lazy_walk` in plain PyTorch: ``z = dsinv * w`` rounded once
    (or given), ``w + dsinv * Az`` one fused multiply-add in f32 (with
    ``scaled``, ``u * c + round(dsinv * Az)``), the halving exact."""
    z = lazy_z_plain(w, dsinv) if z is None else checked_z(z, w)
    ax = spmv_plain(g, z.to(g.dtype)).to(w.dtype)
    if scaled is not None:
        u, c = scaled
        if w.dtype != torch.float32:
            return 0.5 * (u * c + dsinv * ax)
        return 0.5 * fma_f32(u, c.expand_as(u), dsinv * ax)
    if w.dtype != torch.float32:
        return 0.5 * (w + dsinv * ax)
    return 0.5 * fma_f32(dsinv, ax, w)


def lazy_walk_cuda(g: DeviceGraph, w: torch.Tensor, dsinv: torch.Tensor, scaled=None, z=None) -> torch.Tensor:
    """Launch K1's lazy-walk entry point on the current stream: the graph,
    ``w``, ``dsinv`` and ``z`` (contiguous, ``(n,)``), all f32 or all f64,
    on one card; without ``z``, the z pass (:func:`lazy_z_cuda`) first;
    ``scaled`` as :func:`lazy_walk` takes it, ``u`` like ``w`` and ``c``
    0-d, both on that card."""
    _check_card(g, w, "lazy_walk_cuda")
    _check_vector(g, dsinv, w, "dsinv")
    z = lazy_z_cuda(w, dsinv) if z is None else checked_z(z, w)
    u = c = None
    if scaled is not None:
        u, c = scaled
        _check_vector(g, u, w, "u")
        if c.device != w.device or c.dtype != w.dtype or c.dim() != 0:
            raise ValueError(f"c must be a 0-d {w.dtype} tensor on w's card")
    y = torch.empty_like(w)
    _typed(K1_LAZY, w.dtype)(
        g.indptr.data_ptr(), g.indices.data_ptr(), g.data.data_ptr(), w.data_ptr(), z.data_ptr(),
        dsinv.data_ptr(), None if u is None else u.data_ptr(), None if c is None else c.data_ptr(),
        y.data_ptr(), g.num_nodes, g.row_width, stream_handle(w.device),
    )
    return y
