"""Sums in one fixed order, the same on every device: kernel K6
(``csrc/tree_sum.cu``), its plain versions, and K4 (``csrc/fma_dot.cu``).

The power solver's sign exit compares median splits of iterates in
which hundreds of nodes tie with the median to the last bit (symmetric
positions in the graph converge to equal values).  A one-ulp change in
the step's norm moves nodes across the median, and the split and the KL
pass that follow differ.  A fixed summation order removes that:
:func:`tree_sum` adds in the order XLA's CPU backend uses for a 1-D sum
(its tree-reduction rewrite), so that, with the SpMV's fixed row order
(:mod:`eig_kl_tpu_torch.ops.spmv`), the port's iterate on the CPU and on
the card equals the JAX package's CPU iterate bit for bit.

The order: zero-pad the vector to a multiple of 32, the padding split
between the two ends (the smaller half in front); add each window of 32
in sequence; repeat until at most 32 values remain; add those in
sequence.  :func:`reduce_rounds` lists those rounds for a shape (1-D, or
the 2-D order of :func:`tree_sum_2d`).  A sum of products (a norm's
squares, a dot) rounds each product before a window adds it; where no
round is taken (at most 32 values per axis), XLA fuses each product
into its add, a chain of fused multiply-adds in order, and so does this.

K6 runs a whole sum in one launch for an f32 or f64 tensor on the card
(``K6``, ``K6_F64``), the plain versions run it for a tensor on the CPU;
a failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from eig_kl_tpu_torch.ops._build import Kernel
from eig_kl_tpu_torch.ops.spmv import fma_f32

_WINDOW = 32
_P, _I = ctypes.c_void_p, ctypes.c_int
K4, K4_F64 = (Kernel("fma_dot", f"fma_dot_batch_{t}", [_P] * 3 + [_I, _I, _P]) for t in ("f32", "f64"))
#: K4's entry point for a dot that XLA emits as a loop with its operands'
#: producers fused in (:func:`fused_dot_batch`): f32 only.
K4_FUSED = Kernel("fma_dot", "fused_dot_batch_f32", [_P] * 3 + [_I] * 5 + [_P])
K6, K6_F64 = (
    Kernel("tree_sum", f"tree_sum_{t}", [_P, _P, _I, _P, _P, _I, _P, _P, _I, _P])
    for t in ("f32", "f64")
)
K6_SCALE, K6_SCALE_F64 = (
    Kernel("tree_sum", f"scale_by_{t}", [_P, _P, _P, _I, _P]) for t in ("f32", "f64")
)
K6_AXPY, K6_AXPY_F64 = (
    Kernel("tree_sum", f"axpy_{t}", [_P, _I, _P, _P, _P, _I, _P]) for t in ("f32", "f64")
)
#: A v3 plan's padded step: f32 only, as the JAX package's v3 plan is.
K6_STEP = Kernel("tree_sum", "padded_step_f32", [_P, _P, _P, ctypes.c_float, _P, _I, _P])
_F64 = {K4: K4_F64, K6: K6_F64, K6_SCALE: K6_SCALE_F64, K6_AXPY: K6_AXPY_F64}
#: XLA's CPU vector dot rounds its first 8 products before adding them,
#: then fuses each product into its add (:func:`fma_dot`).
_DOT_UNFUSED = 8
#: The dots one K4 launch runs (csrc/fma_dot.cu:kMaxPairs).
K4_MAX_PAIRS = 4
#: XLA's CPU backend fuses an element-wise producer (a slice of the padded
#: state, a sign from a split, the lazy walk) into a vector dot only where
#: the other operand holds fewer bytes than this (``kFusionThresholdBytes``
#: of its instruction fusion); a larger dot calls its vector dot
#: (:func:`fma_dot`).
FUSED_DOT_BYTES = 16 * 1024


def _typed(kernel: Kernel, tensors, what: str) -> Kernel:
    """``kernel``'s instantiation for the dtype of ``tensors`` (all f32 or
    all f64)."""
    dtypes = {t.dtype for t in tensors}
    if dtypes == {torch.float32}:
        return kernel
    if dtypes == {torch.float64}:
        return _F64[kernel]
    raise TypeError(f"{what} takes f32 or f64 tensors of one dtype; got {[t.dtype for t in tensors]}")
#: K6's mode: the values summed are v, v * v or v * w.
_SUM, _SQUARE, _PRODUCT = 0, 1, 2
_MAX_ROUNDS = 8  # csrc/tree_sum.cu:kMaxRounds


class ReduceRound(NamedTuple):
    """One round of the fixed order: the round's input shape, its windows
    per axis (the next round's shape), a window's extent per axis, and the
    zeros padded in front of each axis."""

    shape: tuple[int, ...]
    windows: tuple[int, ...]
    window: tuple[int, ...]
    pads: tuple[int, ...]


@functools.lru_cache(maxsize=None)
def reduce_rounds(shape: tuple[int, ...]) -> tuple[ReduceRound, ...]:
    """The rounds of :func:`tree_sum` (a 1-D shape) or :func:`tree_sum_2d`
    (a 2-D shape): each axis longer than 32 is cut into windows of 32 after
    a centred zero pad, an axis of at most 32 is one window; repeat until no
    axis is longer than 32.  What remains, ``rounds[-1].windows`` (or the
    shape itself if there is no round), is added in row-major order."""
    shape = tuple(int(s) for s in shape)
    rounds = []
    while max(shape, default=0) > _WINDOW:
        windows, window, pads = [], [], []
        for size in shape:
            m = -(-size // _WINDOW) if size > _WINDOW else 1
            windows.append(m)
            window.append(_WINDOW if size > _WINDOW else size)
            pads.append((m * _WINDOW - size) // 2 if size > _WINDOW else 0)
        rounds.append(ReduceRound(shape, tuple(windows), tuple(window), tuple(pads)))
        shape = tuple(windows)
    return tuple(rounds)


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of the 1-D tensor ``v`` in the fixed order above (0-d tensor):
    K6 for a tensor on the card, :func:`tree_sum_plain` on the CPU."""
    if v.device.type == "cpu":
        return tree_sum_plain(v)
    return tree_sum_cuda(v)


def tree_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x . y`` with the products summed by :func:`tree_sum`."""
    if x.device.type == "cpu":
        return _products_plain(x, y, tree_sum_plain)
    return tree_sum_cuda(x, y)


def tree_norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm with the squares summed by :func:`tree_sum`.

    The root is :func:`sqrt_rn`'s, correctly rounded on every device as
    XLA's and K6's are.
    """
    if x.device.type == "cpu":
        return sqrt_rn(_products_plain(x, x, tree_sum_plain))
    return tree_sum_cuda(x, square=True, root=True)


def tree_sum_plain(v: torch.Tensor) -> torch.Tensor:
    """:func:`tree_sum` in plain PyTorch."""
    while v.numel() > _WINDOW:
        m = -(-v.numel() // _WINDOW)
        lo = (m * _WINDOW - v.numel()) // 2
        w = torch.zeros(m * _WINDOW, dtype=v.dtype, device=v.device)
        w[lo : lo + v.numel()] = v
        w = w.view(m, _WINDOW)
        acc = torch.zeros(m, dtype=v.dtype, device=v.device)
        for k in range(_WINDOW):
            acc = acc + w[:, k]
        v = acc
    acc = torch.zeros((), dtype=v.dtype, device=v.device)
    for x in v.unbind():
        acc = acc + x
    return acc


def _products_plain(x: torch.Tensor, y: torch.Tensor, sum_plain) -> torch.Tensor:
    """The sum of ``x * y`` in ``sum_plain``'s order.  In f32 where no
    round is taken, XLA's loop fuses each product into its add: a chain of
    fused multiply-adds in row-major order (f64 has no exact fused
    multiply-add in PyTorch and keeps the rounded products)."""
    if x.dtype != torch.float32 or reduce_rounds(tuple(x.shape)):
        return sum_plain(x * y)
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for a, b in zip(x.reshape(-1).unbind(), y.reshape(-1).unbind()):
        acc = fma_f32(a, b, acc)
    return acc


def sqrt_rn(t: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of an f32 or f64 tensor (a 0-d
    one included), in its dtype on its device, as XLA's and K6's roots are.

    PyTorch's ``sqrt`` on the CPU is not: its f32 root is an ulp off for
    about 1 % of inputs, its f64 root for some (ROADMAP.md C2, C11).  On the
    CPU the root is NumPy's, which is; on the card PyTorch's, which is.  An
    f32 root is taken in f64 and rounded once, the correctly rounded f32
    root."""
    if t.device.type != "cpu":
        return torch.sqrt(t.double()).to(t.dtype) if t.dtype == torch.float32 else torch.sqrt(t)
    return torch.from_numpy(np.asarray(np.sqrt(t.double().numpy()))).to(t.dtype)


def tree_sum_2d(v: torch.Tensor) -> torch.Tensor:
    """Sum of the 2-D tensor ``v`` in the order XLA's CPU backend adds a
    reduction over both axes (``jnp.linalg.norm`` of the power solver's
    padded ``(P/128, 128)`` state): each axis longer than 32 is cut into
    windows of 32 after a centred zero pad (the smaller half in front), an
    axis of at most 32 is one window; each window adds its elements in
    row-major order; repeat until no axis is longer than 32, then add what
    remains in row-major order (or, for the last block, as below).  K6
    for a tensor on the card, :func:`tree_sum_2d_plain` on the CPU.

    Between 33 and 1,024 rows the last block is ``(k, 4)`` with 2 <= k <=
    32, and XLA's final reduce is a loop over its k rows that LLVM
    vectorizes across rows for some k (:func:`last_block_lanes`); the last
    block is added in that order (ROADMAP.md C6).  Above 1,024 rows a
    second round of ``(32, 4)`` windows comes first, each added in
    :func:`window_lanes`' order, and the last block ``(k, 1)`` in order.
    Held bit for bit against ``jnp.linalg.norm`` at every k of both rounds
    (1 to 32,768 rows) and at gen 0.02x and 1.0x.
    """
    if v.device.type == "cpu":
        return tree_sum_2d_plain(v)
    return tree_sum_cuda(v)


#: The 2-D order's last block of ``(k, 4)`` sums (33 to 1,024 rows of 128):
#: XLA's CPU loop over its k rows, vectorized by LLVM for these k (read
#: from the x86-64 code of ``jax.jit(jnp.linalg.norm)``, jax 0.9.0) into
#: this many lanes, lane j adding the 4 sums of rows j, j + lanes, ... in
#: order; for the other k the loop adds the block in row-major order.
_LAST_BLOCK_LANES = {2: 2, 4: 4, 8: 8, 16: 8, 17: 8, 18: 8, 19: 8, 20: 4, 21: 4, 22: 4, 23: 4,
                     24: 8, 25: 8, 26: 8, 27: 8, 28: 4, 29: 4, 30: 4, 31: 4, 32: 8}


def last_block_lanes(shape: tuple[int, ...], dtype: torch.dtype = torch.float32) -> int:
    """The lanes across which XLA adds the last block of an f32 2-D sum of
    ``shape`` (1: in row-major order), by :data:`_LAST_BLOCK_LANES`.  A 1-D
    sum, an f64 sum and a last block of other than 4 columns add in order
    (f64's vector loop would take 4 lanes; not derived, as no f64 path sums
    a 2-D state)."""
    rounds = reduce_rounds(tuple(shape))
    if len(shape) != 2 or dtype != torch.float32 or not rounds:
        return 1
    k, c = rounds[-1].windows
    return _LAST_BLOCK_LANES.get(k, 1) if c == 4 else 1


def _last_block_plain(v: torch.Tensor, lanes: int) -> torch.Tensor:
    """The sum of the last block ``v`` (k rows) as XLA's vector loop adds
    it: lane j from +0 (the other lanes from -0, which changes no sum)
    adds the row's values of rows j, j + lanes, ... in order; the lanes
    fold in halves, ``l[i] + l[i + h]``; the rows past the last whole
    group of ``lanes`` add in row-major order."""
    k = v.shape[0]
    whole = k // lanes * lanes
    acc = torch.full((lanes,), -0.0, dtype=v.dtype, device=v.device)
    acc[0] = 0.0
    for i in range(0, whole, lanes):
        for col in v[i : i + lanes].unbind(1):
            acc = acc + col
    while acc.numel() > 1:
        h = acc.numel() // 2
        acc = acc[:h] + acc[h:]
    acc = acc[0]
    for x in v[whole:].reshape(-1).unbind():
        acc = acc + x
    return acc


def window_lanes(shape: tuple[int, ...], dtype: torch.dtype = torch.float32):
    """How XLA's CPU loop adds each ``(32, 4)`` window of an f32 2-D round
    over ``shape = (rows, 4)`` (the second round of a padded state's norm,
    above 1,024 rows of 128): ``(lanes, rows_in_lanes)``, or None for
    row-major order.  Where the round's lead pad is 0 (``rows`` = 0 or 31
    mod 32, a total pad of 0 or 1) LLVM vectorizes the loop over a window's
    rows, its trip count known: 8 lanes over all 32 rows for a pad of 0, 4
    lanes over the first 28 rows for a pad of 1 (31 rows in common), lane
    j adding the 4 values of rows j, j + lanes, ... in order; the rest of
    the window's rows add in row-major order after the lanes' fold (read
    from the optimized IR of XLA's reduce-window, jax 0.9.0; ROADMAP.md
    C6).  With a lead pad the loop keeps its bounds checks and is scalar.
    Other widths and f64 are not derived (no path of the port sums them)."""
    if len(shape) != 2 or dtype != torch.float32 or shape[1] != 4 or shape[0] <= _WINDOW:
        return None
    pad = -(-shape[0] // _WINDOW) * _WINDOW - shape[0]
    return {0: (8, 32), 1: (4, 28)}.get(pad)


def _windows_by_lanes(win: torch.Tensor, rows: int, lanes: int, in_lanes: int) -> torch.Tensor:
    """The sums of the windows ``win`` ``(m, 32, c)`` of an input of
    ``rows`` rows (lead pad 0) in :func:`window_lanes`' order: lane j from
    +0 (the others from -0) adds rows j, j + lanes, ... below ``in_lanes``
    column by column, the lanes fold in halves, then the window's other
    real rows add in row-major order."""
    m = win.shape[0]
    acc = torch.full((m, lanes), -0.0, dtype=win.dtype, device=win.device)
    acc[:, 0] = 0.0
    for i in range(0, in_lanes, lanes):
        for c in range(win.shape[2]):
            acc = acc + win[:, i : i + lanes, c]
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    acc = acc[:, 0]
    first = torch.arange(m, device=win.device) * _WINDOW
    for r in range(in_lanes, _WINDOW):
        real = first + r < rows
        for c in range(win.shape[2]):
            acc = torch.where(real, acc + win[:, r, c], acc)
    return acc


def tree_sum_2d_plain(v: torch.Tensor) -> torch.Tensor:
    """:func:`tree_sum_2d` in plain PyTorch."""
    lanes = last_block_lanes(tuple(v.shape), v.dtype)
    while max(v.shape) > _WINDOW:
        spec = []
        for size in v.shape:
            if size > _WINDOW:
                m = -(-size // _WINDOW)
                spec.append((m, _WINDOW, (m * _WINDOW - size) // 2))
            else:
                spec.append((1, size, 0))
        (ma, wa, la), (mb, wb, lb) = spec
        by_lanes = window_lanes(tuple(v.shape), v.dtype)
        w = torch.zeros(ma * wa, mb * wb, dtype=v.dtype, device=v.device)
        w[la : la + v.shape[0], lb : lb + v.shape[1]] = v
        if by_lanes:
            v = _windows_by_lanes(w.view(ma, wa, wb), v.shape[0], *by_lanes)[:, None]
            continue
        w = w.view(ma, wa, mb, wb).permute(1, 3, 0, 2).reshape(wa * wb, ma, mb)
        acc = torch.zeros(ma, mb, dtype=v.dtype, device=v.device)
        for k in range(wa * wb):
            acc = acc + w[k]
        v = acc
    if lanes > 1:
        return _last_block_plain(v, lanes)
    acc = torch.zeros((), dtype=v.dtype, device=v.device)
    for x in v.reshape(-1).unbind():
        acc = acc + x
    return acc


def tree_norm_2d(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of the 2-D tensor ``x``, the squares summed by
    :func:`tree_sum_2d`; an f32 root is taken as in :func:`tree_norm`."""
    if x.device.type == "cpu":
        return sqrt_rn(_products_plain(x, x, tree_sum_2d_plain))
    return tree_sum_cuda(x, square=True, root=True)


@functools.lru_cache(maxsize=None)
def k6_plan(shape: tuple[int, ...], dtype: torch.dtype = torch.float32):
    """K6's launch plan for a 1-D or 2-D shape, built once per shape and
    dtype: the host int array the C entry point reads (the number of
    rounds, the values left after them, then per round its input rows and
    columns, windows per axis, window extents and lead pads, a 1-D shape
    taken as one row; last the lanes of the last block and its columns,
    :func:`last_block_lanes`), the scratch it needs and where its second
    half starts.  The halves hold round 1's and round 2's windows: the
    grid's sums take the first, the next stage's the second, and the
    stages after alternate, each writing fewer sums than the one before."""
    rounds = reduce_rounds(shape)
    if len(rounds) > _MAX_ROUNDS:
        raise ValueError(f"K6 takes at most {_MAX_ROUNDS} rounds; {shape} needs {len(rounds)}")
    last = rounds[-1].windows if rounds else shape
    words = [len(rounds), math.prod(last)]
    for r in rounds:
        for part, lead in ((r.shape, 1), (r.windows, 1), (r.window, 1), (r.pads, 0)):
            words.extend((lead, *part) if len(shape) == 1 else part)
    words.extend((last_block_lanes(shape, dtype), last[-1] if last else 0))
    outs = [math.prod(r.windows) for r in rounds[:2]] + [0, 0]
    return (ctypes.c_int * len(words))(*words), outs[0] + outs[1], outs[0]


_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _ticket(device: torch.device, stream) -> torch.Tensor:
    """K6's ticket counter for one stream: zero between launches (the last
    block of each launch resets it), so launches on one stream share it and
    launches on two streams never do."""
    key = (device.index, stream.cuda_stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _TICKETS[key]


_SCRATCH: dict[tuple[int, int, torch.dtype], torch.Tensor] = {}


def _scratch(device: torch.device, stream, dtype: torch.dtype, length: int) -> torch.Tensor:
    """K6's scratch for one stream and dtype, grown to ``length`` values:
    launches on one stream run in order, so they share it, as they share
    the ticket."""
    key = (device.index, stream.cuda_stream, dtype)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < length:
        buf = _SCRATCH[key] = torch.empty(max(length, 1), dtype=dtype, device=device)
    return buf


def tree_sum_cuda(
    v: torch.Tensor, w: torch.Tensor | None = None, *, square: bool = False, root: bool = False
) -> torch.Tensor:
    """Launch K6 on the current stream: the sum of ``v`` (``v * v`` with
    ``square``, ``v * w`` with ``w``) in the order of :func:`tree_sum` for
    a 1-D tensor or of :func:`tree_sum_2d` for a 2-D one, its root taken as
    in :func:`tree_norm` with ``root``.  Contiguous f32 or f64 tensors of
    one dtype on one card; returns a 0-d tensor of that dtype there."""
    both = (v,) if w is None else (v, w)
    if v.device.type != "cuda" or any(t.device != v.device for t in both):
        raise ValueError("tree_sum_cuda needs its tensors on one CUDA device")
    kernel = _typed(K6, both, "tree_sum_cuda")
    if v.dim() not in (1, 2) or any(t.shape != v.shape or not t.is_contiguous() for t in both):
        raise ValueError(f"tree_sum_cuda: contiguous 1-D or 2-D tensors of one shape, got {[tuple(t.shape) for t in both]}")
    if v.numel() >= 2**31 - 2**16:
        raise ValueError(f"tree_sum_cuda: {v.numel()} values do not fit its int32 indices")
    plan, scratch_len, second = k6_plan(tuple(v.shape), v.dtype)
    mode = _PRODUCT if w is not None else _SQUARE if square else _SUM
    stream = torch.cuda.current_stream(v.device)
    scratch = _scratch(v.device, stream, v.dtype, scratch_len)
    out = torch.empty((), dtype=v.dtype, device=v.device)
    # The kernel's loads are unconditional, at clamped indices: an empty
    # input hands it the output's value to read and drop.
    src = both[0] if v.numel() else out
    kernel(
        src.data_ptr(), (both[-1] if v.numel() else out).data_ptr(), mode, ctypes.addressof(plan),
        scratch.data_ptr(), second, _ticket(v.device, stream).data_ptr(), out.data_ptr(), int(root),
        stream.cuda_stream,
    )
    return out


def normalize(y: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    """``y / nrm`` where ``nrm > 0``, else ``y`` (the power step's last
    operation, with ``nrm`` a 0-d tensor): K6's scale entry point for a
    tensor on the card, :func:`normalize_plain` on the CPU."""
    if y.device.type == "cpu":
        return normalize_plain(y, nrm)
    return normalize_cuda(y, nrm)


def normalize_plain(y: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    """:func:`normalize` in plain PyTorch."""
    safe = nrm > 0
    return torch.where(safe, y / torch.where(safe, nrm, 1.0), y)


def normalize_cuda(y: torch.Tensor, nrm: torch.Tensor) -> torch.Tensor:
    """Launch K6's scale entry point on the current stream: a contiguous
    tensor and a 0-d norm, both f32 or both f64, on one card."""
    if y.device.type != "cuda" or nrm.device != y.device:
        raise ValueError("normalize_cuda needs y and nrm on one CUDA device")
    kernel = _typed(K6_SCALE, (y, nrm), "normalize_cuda")
    if not y.is_contiguous() or nrm.dim() != 0 or y.numel() >= 2**31:
        raise ValueError(f"normalize_cuda: a contiguous tensor and a 0-d norm, got {tuple(y.shape)}, {tuple(nrm.shape)}")
    out = torch.empty_like(y)
    kernel(y.data_ptr(), nrm.data_ptr(), out.data_ptr(), y.numel(), torch.cuda.current_stream(y.device).cuda_stream)
    return out


def fma_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x . y`` for f32 or f64 vectors as XLA's CPU backend computes a
    vector dot (``jnp.vdot``): from +0, the first 8 products rounded and
    added in index order, then one chain of fused multiply-adds in index
    order.  (Measured against ``jax.jit(jnp.vdot)`` in both types,
    ``tests/test_torch_spmv_v3.py`` and ``tests/test_torch_f64.py``.)

    The one-pair case of :func:`fma_dot_batch`.  Returns a 0-d tensor of
    the inputs' dtype on ``x``'s device.
    """
    return fma_dot_batch((x,), (y,))[0]


def fma_dot_batch(xs, ys) -> torch.Tensor:
    """The dots ``xs[k] . ys[k]`` of :func:`fma_dot`, 1 to 4 pairs of
    contiguous vectors of one length, dtype and device, as a tensor of
    ``len(xs)`` values: one K4 launch (``csrc/fma_dot.cu``) for tensors on
    the card, a chain each, :func:`fma_dot_plain` per pair for tensors on
    the CPU.  Both devices take the same inputs."""
    kernel = _k4_checked(xs, ys)
    if xs[0].device.type == "cpu":
        return torch.stack([fma_dot_plain(x, y) for x, y in zip(xs, ys)])
    return _k4_launch(kernel, xs, ys)


def _fma_exact(a: float, b: float, c: float) -> float:
    """``a * b + c`` for finite doubles, rounded once: the exact rational
    (each double's ratio has a power-of-two denominator), then Python's
    correctly rounded integer division."""
    na, da = a.as_integer_ratio()
    nb, db = b.as_integer_ratio()
    nc, dc = c.as_integer_ratio()
    return (na * nb * dc + nc * da * db) / (da * db * dc)


def fma_dot_plain(x: torch.Tensor, y: torch.Tensor, unfused: int = _DOT_UNFUSED) -> torch.Tensor:
    """The chain of :func:`fma_dot` on the host, in the inputs' dtype: the
    first ``unfused`` products rounded and added, then the fused chain
    (``unfused=0``: :func:`fused_dot`'s "chain" order).

    f32: each product is exact in f64; the first 8 are rounded to f32 and
    added in f32; each later step forms the f64 sum rounded to odd (its
    TwoSum error decides the last bit) before the rounding to f32, which
    makes it the correctly rounded ``fmaf`` (see ``ops/spmv.py:fma_f32``).
    f64: each later step is the exact rational ``a * b + acc`` rounded
    once (Python 3.12 has no ``math.fma``); a non-finite input takes the
    unfused chain, which gives the same infinities and NaNs.
    """
    if x.dtype == torch.float64 and y.dtype == torch.float64:
        xs, ys = x.cpu().tolist(), y.cpu().tolist()
        fused = _fma_exact if all(map(math.isfinite, xs + ys)) else lambda a, b, c: a * b + c
        acc = 0.0
        for i, (a, b) in enumerate(zip(xs, ys)):
            acc = acc + a * b if i < unfused else fused(a, b, acc)
        return torch.tensor(acc, dtype=torch.float64, device=x.device)
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"fma_dot takes two f32 or two f64 vectors; got {x.dtype} and {y.dtype}")
    prods = (x.double() * y.double()).cpu().tolist()
    acc = np.float32(0.0)
    for p in prods[:unfused]:
        acc = acc + np.float32(p)
    acc = float(acc)
    for p in prods[unfused:]:
        s = p + acc
        bp = s - acc
        err = (p - bp) + (acc - (s - bp))
        if err != 0.0 and not int(np.float64(s).view(np.int64)) & 1:
            s = math.nextafter(s, math.copysign(math.inf, err))
        acc = float(np.float32(s))
    return torch.tensor(acc, dtype=torch.float32, device=x.device)


def fused_dot(x: torch.Tensor, y: torch.Tensor, order: str) -> torch.Tensor:
    """``x . y`` as XLA's CPU backend computes a vector dot into which it
    fuses an operand's element-wise producer: the one-pair case of
    :func:`fused_dot_batch`."""
    return fused_dot_batch((x,), (y,), order)[0]


def fused_dot_batch(xs, ys, order: str) -> torch.Tensor:
    """The dots ``xs[k] . ys[k]`` (1 to 4 pairs, as :func:`fma_dot_batch`
    takes them) of a ``jnp.vdot`` whose operand XLA computes inside the
    dot's loop: a slice of the padded state, the signs of a split, or the
    lazy walk with its row sums (ROADMAP.md C5, C9).

    XLA fuses such a producer only into an f32 dot of fewer than
    :data:`FUSED_DOT_BYTES` per operand (4,096 values); a larger dot, and
    every f64 dot, is :func:`fma_dot_batch`.  The fused dot is a loop that
    LLVM compiles in one of two orders (read from the x86-64 code of the
    JAX package's programs, jax 0.9.0):

    * ``"lanes"``, ``"slice"`` and ``"signs"`` (a loop of element-wise
      operands, vectorized): 32 lanes, lane ``k`` from +0 (``k = 0``) or
      -0 a chain of fused multiply-adds over the elements ``i = k (mod
      32)`` below ``32 * (n // 32)``; the four 8-lane accumulators add as
      ``((a1 + a0) + a2) + a3``, their 8 lanes fold in halves (``l[i] +
      l[i + h]``); the rest of ``r = n % 32`` elements go through one
      vector epilogue of 8 or 4 lanes (:func:`dot_epilogue_width`),
      started from the sum in its lane 0, folded the same way, and the
      last ``r`` mod its width elements by scalar fused multiply-adds.
      Shorter dots take the scalar chain or LLVM's fully unrolled,
      reassociated vector loop (:func:`unrolled_lanes_plan`).  Where
      these begin, and which epilogue wins a tie in steps, depends on the
      producer fused in, read for four (:data:`LANES_FORMS`): "lanes" a
      scaled vector with a slice (the padded state's Rayleigh quotient),
      "slice" a bare slice (the mega engine's initial cut and the padded
      deflation dots), "signs" the signs ``1 - 2 fs`` of a split (its
      verified cut), "laplacian" the Laplacian ``2 v - 2 (A v) / deg``
      with its row sums out of the loop and the degrees an operand (the
      CSR solve's final Rayleigh quotient on a graph wider than 32).  A dot
      of one value is its product.
    * ``"chain"`` (the lazy walk's row sums fused in keep the loop scalar):
      one chain of fused multiply-adds from +0 in index order, no product
      rounded on its own (:func:`fma_dot_plain` with ``unfused=0``).
    * ``"rows"`` (a graph of ELL width 8: the row sums of the Laplacian or
      of the lazy walk fused in, the loop vectorized across rows): a chain
      in :func:`rows_dot_lanes` lanes, folded, then a scalar chain over
      the rest (:func:`rows_dot_plain`).

    K4's fused entry point (``csrc/fma_dot.cu:fused_dot_batch_f32``) for
    tensors on the card, the plain versions for tensors on the CPU.
    """
    _check_order(order)
    kernel = _k4_checked(xs, ys)
    if kernel is not K4 or xs[0].numel() * xs[0].element_size() >= FUSED_DOT_BYTES:
        return fma_dot_batch(xs, ys)
    if xs[0].device.type == "cpu":
        return torch.stack([fused_dot_plain(x, y, order) for x, y in zip(xs, ys)])
    return _k4_fused_launch(xs, ys, order)


def fused_dot_plain(x: torch.Tensor, y: torch.Tensor, order: str) -> torch.Tensor:
    """The f32 dot in :func:`fused_dot_batch`'s ``order`` at any length, in
    plain PyTorch (K4's fused entry point's plain version)."""
    if order == "chain":
        return fma_dot_plain(x, y, unfused=0)
    if order == "rows":
        return rows_dot_plain(x, y)
    form, n = LANES_FORMS[order], x.numel()
    if n == 1:
        return (x * y)[0]
    if n <= form.chain_max:
        return fma_dot_plain(x, y, unfused=0)
    if n <= form.unrolled_max:
        return _unrolled_lanes_plain(x, y, form)
    return _lanes_dot_plain(x, y, form)


class LanesForm(NamedTuple):
    """Where a vectorized fused dot's order changes with its length, for
    one fused producer (read from the x86-64 code of ``jax.jit`` of the
    dot at 1 to 420 values, jax 0.9.0; ROADMAP.md C5, C9): the loop stays a
    scalar chain up to ``chain_max`` values, is unrolled fully and
    reassociated up to ``unrolled_max``, a vector loop beyond.
    ``pairs_at_6``: the unrolled epilogue of 6 or 7 values takes 2 lanes
    (else 4); ``wide_ties``: the vector loop's epilogue takes 8 lanes where
    8 and 4 tie in steps (remainders 28 to 31; else 4); ``unrolled_ties``:
    so does the unrolled epilogue.  K4 takes these as arguments
    (:func:`_k4_form_args`)."""

    chain_max: int
    unrolled_max: int
    pairs_at_6: bool
    wide_ties: bool
    unrolled_ties: bool = False


#: The producers read (:func:`fused_dot_batch`).  "laplacian" was read in
#: its program, on graphs wider than 32, which have 34 nodes or more: its
#: scalar loop below 34 values was not read.  In the solves' programs the
#: safe degrees are an operand of its loop (a fusion of their own, which the
#: steps read too): the loop unrolls to 223 values, with no 8-lane tie,
#: fitted at 34-418 values, 4 draws each, and to the sign and momentum exits
#: at 195-223 values (ROADMAP.md C9; with the degrees' select in the loop,
#: as in a program of the quotient alone, it unrolls only to 191).  "recount" is the JAX mega
#: engine's verified cut ``vdot(1 - 2 fs, A s)`` in its own program (the
#: replayed split against the plan's SpMV, inside ``_finalize_batch``'s
#: ``lax.map``, single start and batched alike), fitted at 34-3,000 values
#: to the cuts that program returns; "signs" is the same dot in a
#: standalone program.  "walk" is the momentum check's quotient
#: ``vdot(w, opm_sym(w))`` on a graph wider than 32 (the walk's row sums a
#: fusion of their own, its epilogue in the dot's loop), fitted to that
#: quotient alone at 34-329 values, 8 draws each, and to whole JAX momentum
#: runs: unrolled from 34 values to 223, 8 lanes at a tie in the unrolled
#: epilogue and in the vector loop's (ROADMAP.md C).  Both were read on
#: graphs of two row windows (33-64 columns); with three (65-96; read at 72)
#: each loop reads one window more, and LLVM unrolls both only to 191 values
#: with no 8-lane tie: "windows3", fitted to both quotients at 62-329 values.
LANES_FORMS = {
    "lanes": LanesForm(49, 128, True, True),
    "slice": LanesForm(59, 128, True, True),
    "signs": LanesForm(37, 351, False, False),
    "laplacian": LanesForm(33, 223, False, False),
    "recount": LanesForm(37, 128, False, True),
    "walk": LanesForm(33, 223, False, True, True),
    "windows3": LanesForm(33, 191, False, False),
}
#: The orders of a fused dot (:func:`fused_dot_batch`) by name.
FUSED_ORDERS = ("chain", "rows", *LANES_FORMS)


def _check_order(order: str) -> None:
    if order not in FUSED_ORDERS:
        raise ValueError(f"fused_dot: order is one of {FUSED_ORDERS}, got {order!r}")

#: The lanes of XLA's vectorized dot loop: 4 accumulators of 8.
_DOT_LANES, _DOT_VECTOR = 32, 8


def _fold_lanes(acc: np.ndarray) -> np.float32:
    """An accumulator's lanes folded in halves, ``l[i] + l[i + h]``."""
    while acc.size > 1:
        h = acc.size // 2
        acc = acc[:h] + acc[h:]
    return acc[0]


def dot_epilogue_width(remainder: int, wide_ties: bool = True) -> int:
    """The vector epilogue's lanes for the ``remainder`` (< 32) elements
    after the main loop of :func:`fused_dot_batch`'s vectorized orders: 8
    or 4, the one with fewer steps ``r // w + r % w`` (on a tie 8 where
    ``wide_ties``, else 4), or 0 (none) below 4."""
    steps8, steps4 = remainder // 8 + remainder % 8, remainder // 4 + remainder % 4
    if remainder >= 8 and (steps8 < steps4 or (steps8 == steps4 and wide_ties)):
        return 8
    return 4 if remainder >= 4 else 0


def _fma_f32_np(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """``ops/spmv.py:fma_f32`` on NumPy arrays: the exact f64 product, the
    f64 sum rounded to odd, then one rounding to f32."""
    p = a.astype(np.float64) * b
    c = c.astype(np.float64)
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    odd = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(odd, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def unrolled_lanes_plan(n: int, pairs_at_6: bool = True, unrolled_ties: bool = False) -> tuple[list[int], int]:
    """The order of a vectorized fused dot of ``n`` values that LLVM
    unrolls fully and reassociates (:class:`LanesForm`): ``(blocks,
    width)``.  One 8-lane accumulator (lane 0 from +0, the others from -0)
    takes the blocks of 8 values in the order ``blocks`` (block b: values
    8b .. 8b + 7), a lane fused multiply-adding its value of each; its
    lanes fold in halves.  The loop it came from interleaved I = 2 (48 to
    63 values) or 4 accumulators over the first ``nv = n // (8 I) * 8 I``
    values: the first accumulator's blocks in order, then for each other
    accumulator k its second block, its first, and the rest.  The
    remaining ``r = n - nv`` values go through one vector epilogue of
    ``width`` lanes (lane 0 from that sum, the others from -0): 2 lanes
    for r = 2 or 3 (and 6 or 7 where ``pairs_at_6``), else from r = 4 on
    4 lanes where ``r // 4`` is odd and 8 where it is even, and 8 at r =
    28 to 31 where ``unrolled_ties`` (none for r < 2); its lanes fold in
    halves, then scalar fused multiply-adds take the rest."""
    interleave = 2 if 48 <= n < 64 else 4
    trips = n // (8 * interleave)
    blocks = [interleave * t for t in range(trips)]
    for k in range(1, interleave):
        mine = [k + interleave * t for t in range(trips)]
        blocks += mine[1:2] + mine[:1] + mine[2:]
    r = n - 8 * interleave * trips
    pairs = (2, 3, 6, 7) if pairs_at_6 else (2, 3)
    width = 2 if r in pairs else 0 if r < 4 else 8 if unrolled_ties and r >= 28 else 4 if r // 4 % 2 else 8
    return blocks, width


def _unrolled_lanes_plain(x: torch.Tensor, y: torch.Tensor, form: LanesForm) -> torch.Tensor:
    """The fully unrolled order (:func:`unrolled_lanes_plan`) on the host."""
    xs, ys = x.detach().cpu().numpy(), y.detach().cpu().numpy()
    n = xs.size
    blocks, width = unrolled_lanes_plan(n, form.pairs_at_6, form.unrolled_ties)
    acc = np.full(_DOT_VECTOR, -0.0, np.float32)
    acc[0] = 0.0
    for b in blocks:
        acc = _fma_f32_np(xs[8 * b : 8 * b + 8], ys[8 * b : 8 * b + 8], acc)
    total, i = _fold_lanes(acc), 8 * len(blocks)
    if width:
        acc = np.full(width, -0.0, np.float32)
        acc[0] = total
        while n - i >= width:
            acc = _fma_f32_np(xs[i : i + width], ys[i : i + width], acc)
            i += width
        total = _fold_lanes(acc)
    for j in range(i, n):
        total = _fma_f32_np(xs[j : j + 1], ys[j : j + 1], np.array([total], np.float32))[0]
    return torch.tensor(np.float32(total), device=x.device)


def _lanes_dot_plain(x: torch.Tensor, y: torch.Tensor, form: LanesForm) -> torch.Tensor:
    """The vectorized loop's order of :func:`fused_dot_batch` for the
    producer ``form`` on the host (f32): one 32-lane step at a time, in NumPy, whose small-array
    operations cost a fraction of PyTorch's."""
    xs, ys = x.detach().cpu().numpy(), y.detach().cpu().numpy()
    n = xs.size
    main = n // _DOT_LANES * _DOT_LANES
    acc = np.full(_DOT_LANES, -0.0, np.float32)
    acc[0] = 0.0
    for i in range(0, main, _DOT_LANES):
        acc = _fma_f32_np(xs[i : i + _DOT_LANES], ys[i : i + _DOT_LANES], acc)
    a = acc.reshape(-1, _DOT_VECTOR)
    v = a[1] + a[0]
    for u in range(2, a.shape[0]):
        v = a[u] + v
    total, i = _fold_lanes(v), main
    width = dot_epilogue_width(n - main, form.wide_ties)
    if width:
        acc = np.full(width, -0.0, np.float32)
        acc[0] = total
        while n - i >= width:
            acc = _fma_f32_np(xs[i : i + width], ys[i : i + width], acc)
            i += width
        total = _fold_lanes(acc)
    for j in range(i, n):
        total = _fma_f32_np(xs[j : j + 1], ys[j : j + 1], np.array([total], np.float32))[0]
    return torch.tensor(np.float32(total), device=x.device)


def rows_dot_lanes(n: int) -> int:
    """The lanes of the "rows" order's vector loop for a dot of ``n``
    values (0: one scalar chain).  Read from the optimised LLVM IR and the
    x86-64 code of the JAX package's f32 power solve on graphs of ELL width
    8 at every length from 1 to 420 and at 173 lengths up to 4,095 (jax
    0.9.0; both quotients, the check's and the final one, alike): LLVM's
    loop vectorizer weighs the vector loop's cost over the known trip count
    against the scalar remainder's.  Below 16 values (its tiny-trip-count
    rule) the loop stays scalar, but for one vector trip of 4 or 8; from 16
    on it takes 8 lanes where ``n % 8 < 4`` and 4 lanes otherwise, until
    the 8-lane loop's saving outweighs the longer scalar rest, from 84
    values on (8 lanes at every length)."""
    if n in (4, 8):
        return n
    if n < 16:
        return 0
    return 8 if n % 8 < 4 or n >= 84 else 4


def rows_dot_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The "rows" order (:func:`fused_dot_batch`) on the host, f32: lane j
    of ``rows_dot_lanes(n)`` lanes, from +0 (j = 0) or -0, chains the fused
    multiply-adds of the values ``i = j (mod lanes)`` below ``n // lanes *
    lanes``; the lanes fold in halves (``l[i] + l[i + h]``: LLVM's
    ``vector.reduce.fadd`` on x86-64, an extract of the upper half and an
    add, down to one lane); then a scalar chain of fused multiply-adds over
    the rest.  With no lanes, one chain from +0; a dot of one value is its
    product (XLA emits no loop for it)."""
    xs, ys = x.detach().cpu().numpy(), y.detach().cpu().numpy()
    n = xs.size
    if n == 1:
        return (x * y)[0]
    lanes = rows_dot_lanes(n)
    if not lanes:
        return fma_dot_plain(x, y, unfused=0)
    acc = np.full(lanes, -0.0, np.float32)
    acc[0] = 0.0
    main = n // lanes * lanes
    for i in range(0, main, lanes):
        acc = _fma_f32_np(xs[i : i + lanes], ys[i : i + lanes], acc)
    total = _fold_lanes(acc)
    for j in range(main, n):
        total = _fma_f32_np(xs[j : j + 1], ys[j : j + 1], np.array([total], np.float32))[0]
    return torch.tensor(np.float32(total), device=x.device)


def _k4_form_args(order: str) -> tuple[int, int, int]:
    """K4's fused entry point's ``chain_max, unrolled_max, flags`` for
    ``order``: a :class:`LanesForm`'s lengths, and its flags as bits
    (``pairs_at_6`` 1, ``wide_ties`` 2, a vectorized order 4, whose dot
    of one value is its product, ``unrolled_ties`` 8, the "rows" order 16,
    whose lengths K4 takes from :func:`rows_dot_lanes`); "chain" is the
    chain at every length."""
    if order == "chain":
        return 2**31 - 1, 2**31 - 1, 0
    if order == "rows":
        return 2**31 - 1, 2**31 - 1, 4 | 16
    form = LANES_FORMS[order]
    return form.chain_max, form.unrolled_max, form.pairs_at_6 | form.wide_ties << 1 | 4 | form.unrolled_ties << 3


def _k4_fused_launch(xs, ys, order: str) -> torch.Tensor:
    """Launch K4's fused entry point on the current stream for the pairs
    of :func:`fused_dot_batch` (checked by :func:`_k4_checked`, f32)."""
    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError("fused_dot_batch_cuda: the vectors must lie on a CUDA device")
    out = torch.empty(len(xs), dtype=xs[0].dtype, device=dev)
    pointers = ctypes.c_void_p * len(xs)
    K4_FUSED(pointers(*(t.data_ptr() for t in xs)), pointers(*(t.data_ptr() for t in ys)), out.data_ptr(),
             len(xs), xs[0].numel(), *_k4_form_args(order), torch.cuda.current_stream(dev).cuda_stream)
    return out


def fused_dot_batch_cuda(xs, ys, order: str) -> torch.Tensor:
    """Launch K4's fused entry point once for f32 pairs on one card, at any
    length (:func:`fused_dot_batch` takes it below 4,096 values only)."""
    _check_order(order)
    if _k4_checked(xs, ys) is not K4:
        raise TypeError("fused_dot_batch_cuda is float32 only")
    return _k4_fused_launch(xs, ys, order)


def _k4_checked(xs, ys) -> Kernel:
    """K4's instantiation for the pairs ``xs[k], ys[k]``, which must be
    1 to 4 contiguous vectors of one length, f32 or f64, on one device."""
    both = (*xs, *ys)
    if not 1 <= len(xs) == len(ys) <= K4_MAX_PAIRS:
        raise ValueError(f"K4 takes 1 to {K4_MAX_PAIRS} pairs of vectors, got {len(xs)} and {len(ys)}")
    dev = xs[0].device
    if any(t.device != dev for t in both):
        raise ValueError(f"fma_dot: the vectors must lie on one CUDA card or all on the CPU, got "
                         f"{[str(t.device) for t in both]}")
    kernel = _typed(K4, both, "fma_dot")
    n = xs[0].numel()
    if any(t.dim() != 1 or t.numel() != n or not t.is_contiguous() for t in both):
        raise ValueError(f"fma_dot: contiguous vectors of one length, got {[tuple(t.shape) for t in both]}")
    if n >= 2**31:
        raise ValueError(f"fma_dot: {n} values do not fit K4's int32 indices")
    return kernel


def _k4_launch(kernel: Kernel, xs, ys) -> torch.Tensor:
    """Launch ``kernel`` (checked by :func:`_k4_checked`) on the current
    stream for the pairs ``xs[k], ys[k]``: one value per pair."""
    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError("fma_dot_batch_cuda: the vectors must lie on a CUDA device")
    out = torch.empty(len(xs), dtype=xs[0].dtype, device=dev)
    pointers = ctypes.c_void_p * len(xs)
    kernel(pointers(*(t.data_ptr() for t in xs)), pointers(*(t.data_ptr() for t in ys)), out.data_ptr(),
           len(xs), xs[0].numel(), torch.cuda.current_stream(dev).cuda_stream)
    return out


def fma_dot_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch K4 on the current stream for one pair: :func:`fma_dot`'s
    chain on the card, a 0-d tensor."""
    return fma_dot_batch_cuda((x,), (y,))[0]


def fma_dot_batch_cuda(xs, ys) -> torch.Tensor:
    """Launch K4 once on the current stream for the pairs of
    :func:`fma_dot_batch`, which must lie on one card: a tensor of their
    :func:`fma_dot` chains, one block each."""
    return _k4_launch(_k4_checked(xs, ys), xs, ys)


def axpy(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``a * x + y`` with one rounding in f32, as XLA's CPU fusion contracts
    a product into the add that takes it (the momentum exit's deflation
    ``w - c q0`` and the padded lazy walk); in f64 the rounded product,
    then the add.  ``a`` is a 0-d tensor or a
    tensor of ``x``'s shape.  K6's axpy entry point for a tensor on the
    card, :func:`axpy_plain` on the CPU."""
    if x.device.type == "cpu":
        return axpy_plain(a, x, y)
    return axpy_cuda(a, x, y)


def axpy_plain(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """:func:`axpy` in plain PyTorch (f64 keeps the rounded product)."""
    if x.dtype != torch.float32:
        return a * x + y
    return fma_f32(a.expand_as(x), x, y)


def axpy_cuda(a: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch K6's axpy entry point on the current stream: contiguous
    tensors of one shape on one card, all f32 or all f64, ``a`` 0-d or of
    that shape."""
    ts = (a, x, y)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError("axpy_cuda needs a, x and y on one CUDA device")
    kernel = _typed(K6_AXPY, ts, "axpy_cuda")
    scalar = a.dim() == 0
    if y.shape != x.shape or not (scalar or a.shape == x.shape) or not all(t.is_contiguous() for t in ts):
        raise ValueError(f"axpy_cuda: contiguous x, y of one shape and a 0-d or alike, got {[tuple(t.shape) for t in ts]}")
    if x.numel() >= 2**31:
        raise ValueError(f"axpy_cuda: {x.numel()} values do not fit its int32 indices")
    out = torch.empty_like(x)
    kernel(a.data_ptr(), int(scalar), x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    return out


def padded_step(x: torch.Tensor, ax: torch.Tensor, deg: torch.Tensor, inv_shift: float) -> torch.Tensor:
    """The power step on the padded ``(P/128, 128)`` state of a v3 plan, from
    its SpMV ``ax``: ``x - inv_shift * (2 x - 2 ax / deg)``, the last
    operation one fused multiply-add as XLA's CPU fusion contracts it
    (``eig_kl_tpu/spectral/power.py:184``; ROADMAP.md C7).  K6's padded-step
    entry point for a tensor on the card, :func:`padded_step_plain` on the
    CPU."""
    if x.device.type == "cpu":
        return padded_step_plain(x, ax, deg, inv_shift)
    return padded_step_cuda(x, ax, deg, inv_shift)


def padded_step_plain(x: torch.Tensor, ax: torch.Tensor, deg: torch.Tensor, inv_shift: float) -> torch.Tensor:
    """:func:`padded_step` in plain PyTorch."""
    lap = 2.0 * x - 2.0 * ax / deg
    c = torch.tensor(-np.float32(inv_shift), device=x.device)
    return fma_f32(c, lap, x)


def padded_step_cuda(x: torch.Tensor, ax: torch.Tensor, deg: torch.Tensor, inv_shift: float) -> torch.Tensor:
    """Launch K6's padded-step entry point on the current stream: contiguous
    f32 tensors of one shape on one card."""
    ts = (x, ax, deg)
    if x.device.type != "cuda" or any(t.device != x.device for t in ts):
        raise ValueError("padded_step_cuda needs x, ax and deg on one CUDA device")
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(
            "padded_step_cuda is float32 only: a v3 plan is f32 only, as the JAX "
            f"package's is (eig_kl_tpu/models/pipelines.py:128); got {[t.dtype for t in ts]}"
        )
    if any(t.shape != x.shape or not t.is_contiguous() for t in ts) or x.numel() >= 2**31:
        raise ValueError(f"padded_step_cuda: contiguous tensors of one shape, got {[tuple(t.shape) for t in ts]}")
    out = torch.empty_like(x)
    K6_STEP(x.data_ptr(), ax.data_ptr(), deg.data_ptr(), float(np.float32(inv_shift)), out.data_ptr(),
            x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    return out
