"""The v3 SpMV ``y = A @ x`` through a Benes permutation: its plan, kernels
K3a, K3b and K3c (``csrc/spmv_v3.cu``), their plain versions, and
:func:`spmv_v3` (the port of ``eig_kl_tpu/ops/spmv_pallas.py:1501-1911``).

The matrix's entries sit in 512-slot chunks twice.  On the gather side
they are sorted by column, so each chunk reads one 1,024-wide window of
``x``; on the reduce side they are in CSR order, so each chunk adds into
one 1,024-row window of ``y``.  Between the two, a Benes network of
``2m - 1`` exchange stages (``N = 2^m`` slots) moves every product from
its gather slot to its CSR slot, with switch bits from the host router
(:func:`eig_kl_tpu_torch.io.native_io.benes_route_native`).

* K3a ``gather_v3`` (TPU ``_gather_v3_kernel``, ``:1698``):
  ``e[s] = (0 + x[128 * cw8[s // 512] + col_local[s]]) * w[s]``.
* K3b ``benes_v3`` (TPU ``_benes_kernel``, ``:1718``):
  ``e'[p] = bit_s(p) ? e[p ^ d_s] : e[p]`` for each stage, with distances
  ``N/2, ..., 2, 1, 2, ..., N/2``, in the groups of :func:`benes_groups`:
  one launch per group, each block running the group's stages on one tile
  of :data:`BENES_TILE` slots in shared memory (three launches per
  network of more than one tile).
* K3c ``reduce_v3`` (TPU ``_reduce_v3_kernel``, ``:1802``): per chunk, a
  9-step segmented Hillis-Steele scan keyed on ``row_local``, then each
  row's segment-last value is routed into the chunk's row window.

The result equals the TPU kernels' bit for bit, zero signs included: the
gather adds ``+0`` before its product, the scan adds ``+0`` where a step
masks, the routing adds ``+0``, and ``y`` is ``((+0 + p_1) + p_2) + ...``
over the chunks that hold part of a row, in chunk order.  Padding slots
have weight 0.

The plan lives on the device as torch tensors.  On the CPU the plain
versions run; a CUDA tensor always goes to the kernels, and a failed build
or launch raises.  f32 only, on both (:data:`F32_ONLY`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from eig_kl_tpu_torch.ops._build import Kernel

BENES_MAX = 1 << 21  #: largest padded slot count N a plan may have
CHUNK = 512  #: slots per chunk
WINDOW = 1024  #: x-window and y-window size of a chunk
SCAN_STEPS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
#: slots per tile of K3b: 64 KB of f32 in one block's shared memory
#: (2^14 measured faster than 2^13 on the H100, PERF.md).  The high groups
#: need ``m <= 2 log2(BENES_TILE) - 5`` (N = 2^m): 2^23, above BENES_MAX.
BENES_TILE = 1 << 14

_P, _I = ctypes.c_void_p, ctypes.c_int
K3A = Kernel("spmv_v3", "gather_v3_f32", [_P, _P, _P, _P, _P, _I, _P])
K3B = Kernel("spmv_v3", "benes_v3_f32", [_P, _P, _P, _I, _P, _I, _P])
K3C = Kernel("spmv_v3", "reduce_v3_f32", [_P, _P, _P, _P, _P, _I, _P])


@dataclasses.dataclass(frozen=True)
class SpmvPlanV3:
    """Benes-permutation plan of one matrix, on one device.

    Attributes:
      cw8: int32[C] per gather chunk, the start of its x window in units
        of 128.
      col_local: int16[C, 4, 128] column offsets in the window, in column
        order.
      weights: f32[C, 4, 128] weights in column order (0 = padding).
      masks: int32[2m - 1, N / 32] switch bits in the router's flat layout
        (uint32 words held as int32): bit ``p & 31`` of word ``p >> 5`` of
        row ``s`` switches position ``p`` at stage ``s``.
      rw8: int32[C] per reduce chunk, the start of its y window in units of
        128.
      row_local: int16[C, 4, 128] row offsets in the window, in CSR order;
        padding slots continue the last real segment.
      route_src: int16[C, 8, 128] per window row, the chunk position of the
        row's segment-last slot, or -1.
      padded_nodes: P, the node count rounded up to a multiple of 1,024.
      padded_nnz: N = 2^m, the slot count.
    """

    cw8: torch.Tensor
    col_local: torch.Tensor
    weights: torch.Tensor
    masks: torch.Tensor
    rw8: torch.Tensor
    row_local: torch.Tensor
    route_src: torch.Tensor
    padded_nodes: int
    padded_nnz: int

    @property
    def num_chunks(self) -> int:
        return int(self.cw8.shape[0])


def benes_distances(n_slots: int) -> list[int]:
    """Exchange distance of each Benes stage on ``n_slots = 2^m`` slots,
    in mask-row order: ``N/2, ..., 2, 1, 2, ..., N/2`` (the router's row
    ``lev`` is the first half, row ``2m - 2 - lev`` the last half)."""
    m = n_slots.bit_length() - 1
    return [n_slots >> (s + 1) for s in range(m)] + [2 << s for s in range(m - 1)]


class BenesGroup(NamedTuple):
    """Consecutive Benes stages that K3b runs in one launch.

    Block ``b`` holds ``tile`` slots in runs of ``run`` contiguous slots:
    its tile position ``i`` is slot ``(i // run) * tile + b * run + i % run``
    (``run == tile``: the contiguous tile from ``b * tile``).  A stage's
    distance ``d`` is the tile distance ``d`` if ``d < tile``, else
    ``d // tile * run``.
    """

    first: int  #: first stage (a row of the plan's masks)
    last: int  #: last stage, inclusive
    tile: int  #: slots per block, 2^t
    run: int  #: contiguous slots per run, 2^l, a multiple of 32


def benes_groups(n_slots: int, tile: int = BENES_TILE) -> list[BenesGroup]:
    """K3b's launches for a network on ``n_slots = 2^m`` slots, in order.

    ``n_slots <= tile``: one group of all stages on one tile of
    ``n_slots``.  Otherwise three: the first ``h = m - t`` stages
    (distances ``>= tile``), the ``2t - 1`` middle ones (``< tile``) and
    the last ``h``, the high groups in runs of ``tile >> h`` slots.  A run
    must hold at least one 32-bit switch word, so ``m <= 2t - 5``.

    Raises ``ValueError`` for a slot count or tile that is not a power of
    two of at least 32, or an ``m`` above ``2t - 5``.
    """
    m, t = n_slots.bit_length() - 1, tile.bit_length() - 1
    if n_slots != 1 << m or m < 5 or tile != 1 << t or t < 5:
        raise ValueError(f"the slot count {n_slots} and tile {tile} must be powers of two >= 32")
    if m <= t:
        return [BenesGroup(0, 2 * m - 2, n_slots, n_slots)]
    h = m - t
    if t - h < 5:
        raise ValueError(
            f"a network of 2^{m} slots needs m <= 2t - 5 = {2 * t - 5} with tiles of 2^{t} "
            "slots (each run of the high groups one switch word or more)"
        )
    run = tile >> h
    return [
        BenesGroup(0, h - 1, tile, run),
        BenesGroup(h, h + 2 * t - 2, tile, tile),
        BenesGroup(h + 2 * t - 1, 2 * m - 2, tile, run),
    ]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_plan_v3(
    n: int,
    rows: np.ndarray,
    cols: np.ndarray,
    weights: np.ndarray,
    device: torch.device | str,
) -> SpmvPlanV3:
    """The v3 plan of the n x n matrix with entries ``(rows, cols,
    weights)``, on ``device`` (a NumPy copy of ``build_plan_v3``,
    ``spmv_pallas.py:1585``; the switch bits come from the host library).

    Raises ``ValueError`` if the padded slot count exceeds
    :data:`BENES_MAX`, or if a 512-entry CSR chunk spans 1,024 or more
    rows from its 128-aligned base (long runs of empty rows).
    """
    from eig_kl_tpu_torch.io import native_io

    P = _round_up(max(n, 1), WINDOW)
    nnz = rows.shape[0]
    if nnz == 0:
        rows = np.zeros(1, np.int64)
        cols = np.zeros(1, np.int64)
        weights = np.zeros(1, np.float32)
        nnz = 1
    rows, cols = rows.astype(np.int64), cols.astype(np.int64)
    if not bool((np.diff(rows) >= 0).all()):
        order = np.lexsort((cols, rows))
        rows, cols, weights = rows[order], cols[order], weights[order]

    # Gather side: entries grouped by column stripe (1024 columns), each
    # group padded to whole 512-slot chunks, so every chunk's columns fit
    # one 1024-wide window.
    order = np.argsort(cols, kind="stable")
    cs_col = cols[order]
    stripe = cs_col // WINDOW
    uniq, s_start, s_cnt = np.unique(stripe, return_index=True, return_counts=True)
    chunks_per = (s_cnt + CHUNK - 1) // CHUNK
    g_chunk0 = np.concatenate([[0], np.cumsum(chunks_per)])
    Cg = int(g_chunk0[-1])
    n_slots = Cg * CHUNK
    N = 1 << max(int(max(n_slots, nnz) - 1).bit_length(), 13)
    if N > BENES_MAX:
        raise ValueError(f"padded nnz {N} exceeds BENES_MAX {BENES_MAX}")
    C = N // CHUNK

    in_grp = np.arange(nnz) - np.repeat(s_start, s_cnt)
    gslot = (np.repeat(g_chunk0[:-1], s_cnt) * CHUNK + in_grp).astype(np.int64)
    cw_base = np.zeros(C, np.int64)
    cw_base[:Cg] = np.repeat(uniq * WINDOW, chunks_per)
    cl = np.zeros(N, np.int16)
    w_arr = np.zeros(N, np.float32)
    cl[gslot] = cs_col - cw_base[gslot // CHUNK]
    w_arr[gslot] = weights.astype(np.float32)[order]

    # Permutation: gather slot gslot[j] holds CSR entry order[j] and must
    # land at CSR slot order[j]; padding slots map onto the unused slots.
    dest = np.full(N, -1, np.int32)
    dest[gslot] = order.astype(np.int32)
    dest[np.flatnonzero(dest == -1)] = np.arange(nnz, N, dtype=np.int32)
    masks = native_io.benes_route_native(N, dest).view(np.int32)
    for_c = np.arange(nnz) // CHUNK
    starts = np.arange(C) * CHUNK
    valid_chunks = starts < nnz

    # Reduce side: CSR order; one 1024-row window per 512-slot chunk.
    rw_base = np.zeros(C, np.int64)
    rw_base[valid_chunks] = np.minimum((rows[starts[valid_chunks]] // 128) * 128, P - WINDOW)
    rw_base[~valid_chunks] = rw_base[valid_chunks][-1]
    span = rows - rw_base[for_c]
    if span.max() >= WINDOW or span.min() < 0:
        raise ValueError(
            "build_plan_v3: a CSR chunk spans "
            f"{int(span.max()) + 1} row indices (> WINDOW={WINDOW}); "
            "this graph's row density is too skewed for the v3 plan"
        )
    rl = np.concatenate([span.astype(np.int16), np.zeros(N - nnz, np.int16)]).reshape(C, CHUNK)
    # Padding slots continue the last real segment.
    if nnz % CHUNK or nnz < N:
        last_c = (nnz - 1) // CHUNK
        fill = nnz - last_c * CHUNK
        rl[last_c, fill:] = rl[last_c, fill - 1]
        rl[last_c + 1 :, :] = 0
    # Segment-last routing per chunk.
    is_last = np.empty((C, CHUNK), dtype=bool)
    is_last[:, -1] = True
    np.not_equal(rl[:, 1:], rl[:, :-1], out=is_last[:, :-1])
    c_idx, p_idx = np.nonzero(is_last)
    route_src = np.full((C, WINDOW), -1, np.int16)
    route_src[c_idx, rl[c_idx, p_idx].astype(np.int64)] = p_idx
    route_src[~valid_chunks] = -1

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device)

    return SpmvPlanV3(
        cw8=dev((cw_base // 128).astype(np.int32)),
        col_local=dev(cl.reshape(C, 4, 128)),
        weights=dev(w_arr.reshape(C, 4, 128)),
        masks=dev(masks),
        rw8=dev((rw_base // 128).astype(np.int32)),
        row_local=dev(rl.reshape(C, 4, 128)),
        route_src=dev(route_src.reshape(C, 8, 128)),
        padded_nodes=P,
        padded_nnz=N,
    )


def build_plan_v3_for_graph(graph, device: torch.device | str) -> SpmvPlanV3:
    """The v3 plan of a host :class:`~eig_kl_tpu_torch.graph.csr.Graph`,
    its weights rounded to f32 (as the JAX package's callers build it)."""
    rows = np.repeat(np.arange(graph.num_nodes, dtype=np.int64), graph.degrees)
    return build_plan_v3(
        graph.num_nodes,
        rows,
        graph.indices.astype(np.int64),
        graph.data.astype(np.float32),
        device,
    )


def plan_v3_from_jax(
    cw8, col_local, weights, masks, rw8, row_local, route_src,
    padded_nodes: int, padded_nnz: int, device: torch.device | str,
) -> SpmvPlanV3:
    """The port's plan from the arrays of a JAX package ``SpmvPlanV3``
    (passed as numpy, in the order of its fields).

    The TPU masks are ``(2m - 1, N/4096, 128)`` int32 in which bit ``b`` of
    ``masks[s, rq, l]`` switches position ``(b * N/4096 + rq) * 128 + l``
    (``spmv_pallas.py:_benes_masks``); they are unpacked to the router's
    flat layout.
    """
    def dev(a):
        return torch.as_tensor(np.array(a)).to(device)

    return SpmvPlanV3(
        cw8=dev(np.asarray(cw8, np.int32)),
        col_local=dev(np.asarray(col_local, np.int16)),
        weights=dev(np.asarray(weights, np.float32)),
        masks=dev(unpack_tpu_masks(masks)),
        rw8=dev(np.asarray(rw8, np.int32)),
        row_local=dev(np.asarray(row_local, np.int16)),
        route_src=dev(np.asarray(route_src, np.int16)),
        padded_nodes=int(padded_nodes),
        padded_nnz=int(padded_nnz),
    )


def unpack_tpu_masks(masks) -> np.ndarray:
    """The TPU kernel's switch bits, ``(2m - 1, N/4096, 128)`` int32 with
    bit ``b`` of ``[s, rq, l]`` for position ``(b * N/4096 + rq) * 128 + l``,
    in the router's flat layout: ``(2m - 1, N/32)`` words as int32."""
    tpu = np.asarray(masks).view(np.uint32)
    stages = tpu.shape[0]
    bits = (tpu[:, None, :, :] >> np.arange(32, dtype=np.uint32)[None, :, None, None]) & 1
    flat = np.packbits(bits.astype(np.uint8).reshape(stages, -1), axis=1, bitorder="little")
    return flat.view("<u4").astype(np.uint32).view(np.int32)


# --- plain versions (CPU tensors and tests) ---------------------------------


def gather_v3_plain(plan: SpmvPlanV3, x: torch.Tensor) -> torch.Tensor:
    """K3a in plain PyTorch: f32[N] products in gather-slot order from the
    padded state ``x`` (f32[P])."""
    slot_chunk = torch.arange(plan.padded_nnz, device=x.device) // CHUNK
    idx = 128 * plan.cw8.long()[slot_chunk] + plan.col_local.reshape(-1).long()
    return (x[idx] + 0.0) * plan.weights.reshape(-1)


def benes_v3_plain(masks: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """K3b in plain PyTorch: all stages of the network with switch bits
    ``masks`` (a plan's) on f32[N]."""
    shifts = torch.arange(32, dtype=torch.int32, device=e.device)
    for s, d in enumerate(benes_distances(e.numel())):
        bits = ((masks[s][:, None] >> shifts) & 1).reshape(-1).bool()
        partner = e.view(-1, 2, d).flip(1).reshape(-1)  # e[p ^ d]
        e = torch.where(bits, partner, e)
    return e


def reduce_v3_plain(plan: SpmvPlanV3, e: torch.Tensor) -> torch.Tensor:
    """K3c in plain PyTorch: f32[P] from the CSR-ordered products f32[N]."""
    C, dev = plan.num_chunks, e.device
    v = e.view(C, CHUNK)
    rl = plan.row_local.reshape(C, CHUNK)
    for k in SCAN_STEPS:
        same = torch.zeros(C, CHUNK, dtype=torch.bool, device=dev)
        same[:, k:] = rl[:, :-k] == rl[:, k:]
        shifted = torch.zeros_like(v)
        shifted[:, k:] = v[:, :-k]
        v = v + torch.where(same, shifted, 0.0)
    src = plan.route_src.reshape(C, WINDOW).long()
    routed = src >= 0
    out = v.gather(1, src.clamp(min=0)) + 0.0
    # Chunk-ordered accumulation: the rows each chunk routes, in chunk
    # order; a row's j-th contribution is added in round j.
    c_idx, r_idx = routed.nonzero(as_tuple=True)
    rows = 128 * plan.rw8.long()[c_idx] + r_idx
    vals = out[c_idx, r_idx]
    order = torch.sort(rows, stable=True).indices
    rows, vals = rows[order], vals[order]
    first = torch.ones_like(rows, dtype=torch.bool)
    first[1:] = rows[1:] != rows[:-1]
    starts = torch.cummax(torch.where(first, torch.arange(rows.numel(), device=dev), 0), 0).values
    rank = torch.arange(rows.numel(), device=dev) - starts
    y = torch.zeros(plan.padded_nodes, dtype=torch.float32, device=dev)
    for j in range(int(rank.max()) + 1 if rank.numel() else 0):
        sel = rank == j
        y[rows[sel]] = y[rows[sel]] + vals[sel]
    return y


# --- kernels -------------------------------------------------------------------


#: Why the v3 route refuses f64: the JAX package builds a v3 plan only on
#: the TPU, where its KL engine and power solve run in f32.
F32_ONLY = (
    "the v3 SpMV is float32 only, as in the JAX package, which builds a v3 plan only "
    "on the TPU, where it runs in f32 (eig_kl_tpu/models/pipelines.py:128, :192)"
)


def _check_f32(t: torch.Tensor, what: str) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{F32_ONLY}; got {what} {t.dtype}")


def _check(on: torch.Tensor, t: torch.Tensor, size: int, what: str) -> None:
    if t.device.type != "cuda" or on.device != t.device:
        raise ValueError(f"{what} and the plan must lie on one CUDA device")
    _check_f32(t, what)
    if t.numel() != size or not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous with {size} elements, got {tuple(t.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def gather_v3_cuda(plan: SpmvPlanV3, x: torch.Tensor) -> torch.Tensor:
    """Launch K3a on the current stream: f32[N] from the padded f32[P]."""
    _check(plan.weights, x, plan.padded_nodes, "x")
    e = torch.empty(plan.padded_nnz, dtype=torch.float32, device=x.device)
    K3A(
        plan.cw8.data_ptr(), plan.col_local.data_ptr(), plan.weights.data_ptr(),
        x.data_ptr(), e.data_ptr(), plan.padded_nnz, _stream(x),
    )
    return e


def benes_v3_cuda(masks: torch.Tensor, e: torch.Tensor, *, _tile: int = BENES_TILE) -> torch.Tensor:
    """Launch K3b on the current stream: the whole network, one launch per
    group of :func:`benes_groups`, into a new tensor (``e`` is not
    modified).  ``_tile`` is for tests and measurements only."""
    n_slots = e.numel()
    groups = benes_groups(n_slots, _tile)
    stages = len(benes_distances(n_slots))
    if masks.dtype != torch.int32 or masks.shape != (stages, n_slots // 32) or not masks.is_contiguous():
        raise ValueError(f"masks must be contiguous int32 ({stages}, {n_slots // 32})")
    _check(masks, e, n_slots, "e")
    out = torch.empty_like(e)
    spec = (ctypes.c_int * (4 * len(groups)))(
        *(v for gr in groups for v in (
            gr.first, gr.last - gr.first + 1, gr.tile.bit_length() - 1, gr.run.bit_length() - 1,
        ))
    )
    K3B(
        masks.data_ptr(), e.data_ptr(), out.data_ptr(), n_slots.bit_length() - 1,
        ctypes.cast(spec, ctypes.c_void_p), len(groups), _stream(e),
        launches=len(groups),
    )
    return out


def reduce_v3_cuda(plan: SpmvPlanV3, e: torch.Tensor) -> torch.Tensor:
    """Launch K3c on the current stream: f32[P] from f32[N]."""
    _check(plan.weights, e, plan.padded_nnz, "e")
    y = torch.zeros(plan.padded_nodes, dtype=torch.float32, device=e.device)
    K3C(
        plan.rw8.data_ptr(), plan.row_local.data_ptr(), plan.route_src.data_ptr(),
        e.data_ptr(), y.data_ptr(), plan.num_chunks, _stream(e),
    )
    return y


def spmv_v3_padded(plan: SpmvPlanV3, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` on padded state (P elements, any shape; the padding must
    be zero), of the same shape; the result's padding is zero.  The
    kernels for a tensor on the card, the plain versions on the CPU; f32
    only on both."""
    _check_f32(x, "x")
    flat = x.reshape(-1)
    if x.device.type == "cpu":
        e = benes_v3_plain(plan.masks, gather_v3_plain(plan, flat))
        return reduce_v3_plain(plan, e).view(x.shape)
    e = benes_v3_cuda(plan.masks, gather_v3_cuda(plan, flat.contiguous()))
    return reduce_v3_cuda(plan, e).view(x.shape)


def spmv_v3(plan: SpmvPlanV3, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for f32[n]: zero-padded to P, through the v3 kernels, cut
    back to n (``spmv_pallas`` with a v3 plan)."""
    _check_f32(x, "x")
    n = x.shape[0]
    xp = torch.zeros(plan.padded_nodes, dtype=torch.float32, device=x.device)
    xp[:n] = x
    return spmv_v3_padded(plan, xp)[:n]
