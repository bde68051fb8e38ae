"""The TPU SpMVs' own orders: the v1 and v2 plans' layouts, their plain
versions, and K1's entry points ``spmv_v1_f32`` and ``spmv_v2_f32``
(``csrc/spmv_csr.cu``) that compute them on the card.

Wherever the JAX package's f32 SpMV has a plan, it runs the TPU kernel of
that plan: the mega engine's initial ``A @ s`` and recount
(``eig_kl_tpu/kl/megakernel.py:_batch_init``, ``:763``, and
``_finalize_batch``, ``:753``, with the plan of ``plan_for_graph``,
``ops/spmv_pallas.py:556``), and every f32 SpMV of a device graph that
carries a plan (``ops/partition.py:spmv``, ``:48-51``; the power solve's
plan branch, ``spectral/power.py:140-165``, through ``spmv_pallas_2d``).
At up to :data:`~eig_kl_tpu_torch.graph.csr.V1_MAX_NNZ` stored entries
that plan is a v1 plan, above it a v2 plan.  Neither kernel adds a row as
XLA's ELL SpMV does (K1's order, :mod:`eig_kl_tpu_torch.ops.spmv`); each
plan's layout decides the order of its sums.

**v1** (``_spmv_kernel``, ``:339``):

* the entries, sorted by (column stripe of 1,024, aligned row window of
  1,024, row), fill 512-entry chunks, a new chunk at every 512 entries of
  a (stripe, window) group; a chunk's padding slots continue its last row
  with weight 0 (``build_plan``, ``:193``);
* per chunk, in flat order: the products ``(x[col] + 0) * w``, rounded;
  a 9-round Hillis-Steele segmented inclusive scan, round ``k`` (1, 2,
  ..., 256) adding ``where(row[p - k] == row[p] and p >= k, e[p - k], 0)``
  to every ``e[p]``; each row's total is the scan's value at the row's
  last slot in the chunk, where the next slot holds another row (or at
  slot 511);
* the chunk's totals are added into the y window of its rows, chunk after
  chunk in plan order.

The TPU plan also stores, per chunk, a 1,024-row ``route_src`` table of
where each row's total lies; that is the slot that ends the row's segment,
so the port derives it from ``row_local`` and keeps no table.  The chunk
axis's padding to a multiple of 8 (``_pad_v1_chunks``) adds exact zeros
and is left out.

**v2** (``build_plan_v2``, ``:850``; ``_gather_kernel``, ``:1049``, and
the default reduce ``_reduce_kernel_mxu``, ``:1118``):

* a geometry search over the exact bucket histogram picks the row block
  ``rblock`` and the slot count ``Q`` of a (column block of 1,024, row
  block) bucket (``_search_v2_geometry``, ``:785``); each bucket keeps its
  first ``Q`` entries in (row, column) order, and the rest spill into a
  tail (``_build_tail``, ``:683``): a v1 plan of the spilled entries, or,
  for a scattered spill, a COO tail in rank groups;
* pass 1 forms every kept product ``x[col] * w`` in f32, rounded to bf16
  where the intermediates are bf16;
* pass 2 reduces each 512-slot sub-chunk of a row block by a one-hot
  ``dot_general``, which adds a row's slots one after the other from +0
  in slot order, and adds each sub-chunk's partial into ``y`` in turn; a
  row's slots lie in column order, and a sub-chunk holds ``512 / Q``
  column blocks, so a row is a walk over its kept entries in CSR order
  whose partial restarts from +0 wherever ``col >> (19 - log2 Q)``
  changes, each partial added into the row's sum;
* then the tail: ``y + v1(tail)``, or the COO tail's rank groups, each
  ``y[row] + round(w * x[col])``, a row's tail entries in column order.

So the port keeps, for v2, the CSR arrays of the kept entries, the shift
that marks a partial's restart, and the tail; not the TPU's slot grid.
The TPU plan's other geometry (``n_cb``, ``n_rbp``, ``g1``, ``g2``) is kept
too: the bf16 rule reads ``g1`` (:attr:`V2Layout.g1`).  The environment
pins ``EIG_KL_TPU_RBLOCK`` / ``EIG_KL_TPU_QUANTUM`` are not copied
(:func:`build_v2_layout` takes ``rblock`` and ``quantum`` as arguments).

The v2 SpMV's other forms, which only the power solve's plan branch reads
(``spmv_pallas_2d``, ``:444``; ``spmv_pallas`` and so the mega engine and
``ops/partition.py:spmv`` ignore them):

* ``EIG_KL_TPU_REDUCE_IMPL`` (``:83-97``, ``:1470-1480``) picks the reduce
  kernel, in f32 and with bf16 products alike (:func:`reduce_impl_from_env`).
  "mxuv" (``_reduce_kernel_mxuv``, ``:1207``) is the default's dot with
  its one-hot built otherwise: the same order.  "mxu2"
  (``_reduce_kernel_mxu2``, ``:1276``) contracts ``(H A, 512) x (B,
  512)^T`` (``H = rblock / 128``); XLA's CPU dot at ``B`` <= 16 keeps 4
  interleaved partials over the 512 slots (slot ``s`` adds into partial ``s
  % 4`` from +0) and adds them ``(p0 + p1) + (p2 + p3)``, at ``B`` = 32 two,
  ``p0 + p1``, and from ``B`` = 64 (``H`` >= 17) adds in slot order as the
  default does (:func:`mxu2_lanes`).  "vpu" (``_reduce_kernel``, ``:1080``,
  any other value) sums the ``(512, 128)`` one-hot products over the slots,
  which XLA adds 32 slots at a time from +0, then those block sums one after
  the other.  Both orders need each kept entry's slot in its sub-chunk
  (:attr:`V2Layout.slots`).  Read from the dot's and the sum's programs run
  alone on every ``H`` (the one-hot's zeros pass through the adds), and held
  by ``tests/test_torch_v2_forms.py`` against ``spmv_pallas_2d`` at row
  blocks 512-4,096.  ``EIG_KL_TPU_REDUCE_DOT`` and
  ``EIG_KL_TPU_REDUCE_ROWWISE`` change no bit there, and are not read.
* ``EIG_KL_TPU_BF16_W=1`` (``:109-123``) makes a v2 plan keep its weights
  rounded to bf16 too (:attr:`V2Layout.weights_bf16`, read by
  :func:`build_v2_layout` as ``build_plan_v2`` reads it, ``:930``,
  ``:1024``); the pass-1 products read them only where they are bf16
  (``:477-482``): ``round_bf16(x * w_bf16)``, the product in f32 first.
  The tail keeps its f32 weights.

Each kernel's arithmetic as it runs in interpret mode on the CPU was read
from the program itself (no product is contracted into an add):
:func:`spmv_v1_plain` equals ``spmv_pallas`` of a v1 plan, and
:func:`spmv_v2_plain` equals ``spmv_pallas`` and ``spmv_pallas_2d(...,
inter_dtype=bfloat16)`` of a v2 plan, bit for bit
(``tests/test_torch_faults.py``, ``tests/test_torch_plan_order.py``).  The
JAX package also builds both plans natively (``native/eigkl_native.cpp``)
and says the builders give the same plans, so the port keeps these NumPy
builders only.  A graph keeps its layout
(:attr:`~eig_kl_tpu_torch.graph.csr.DeviceGraph.plan_layout`), as the
JAX ``MegaGraph`` keeps its plan.

Every SpMV here takes a flat ``(n,)`` vector, or the zero-padded
``(P/128, 128)`` state of the power solve, and returns the same shape
(the padding +0).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import PLAN_WINDOW
from eig_kl_tpu_torch.ops._build import Kernel

CHUNK = 512  #: entries per chunk (the TPU kernel's (4, 128) tile)
SCAN_SHIFTS = (1, 2, 4, 8, 16, 32, 64, 128, 256)  #: the scan's rounds

#: The v2 geometry search's row blocks and bucket slot counts
#: (``_search_v2_geometry``), its bound on spilled entries and their cost
#: in slots; a row block of the TPU plan holds at most 16,384 rows.
V2_RBLOCKS = (512, 1024, 2048, 4096, 8192, 16384)
V2_QUANTA = (4, 8, 16, 32, 64, 128, 256, 512)
_SPILL_MAX = 40_000
_SPILL_COST = 64
#: The tail's rule (``_build_tail``): a v1 tail where the spill fills its
#: chunks (at least 9 entries per chunk) or where a row spills more than
#: 32 entries, else COO.
_COO_ENTRIES_PER_CHUNK = 9
_COO_MAX_GROUPS = 32

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``spmv_v1_f32(x_base, col_local, row_local, weights, win_ptr,
#: win_chunks, x, y, scratch, tickets, n, rows, windows, chunks, stream)``:
#: one block per chunk.
K1_V1 = Kernel("spmv_csr", "spmv_v1_f32", [_P] * 10 + [_I] * 4 + [_P])
#: The v2 order's entry points, a warp per 32 rows, by (reduce order,
#: products, lazy walk): reduce order "mxu" (the default's, and "mxuv"'s),
#: "mxu2" or "vpu"; products "f32", "bf16i" (bf16) or "bf16w" (bf16, of the
#: bf16 weights).  ``spmv_v2[_mxu2 | _vpu][_bf16i | _bf16w]_f32`` and
#: ``lazy_walk_v2...`` each take ``(ptr, cols, w, slot, shift, lanes,
#: tail_warp, tail_rows, tail_cols, tail_w, tail_y, x, dsinv, y, n, rows,
#: stream)``.
V2_ORDERS = ("mxu", "mxu2", "vpu")
V2_PRODUCTS = ("f32", "bf16i", "bf16w")
K1_V2_FORMS = {
    (order, prod, lazy): Kernel(
        "spmv_csr",
        f"{'lazy_walk' if lazy else 'spmv'}_v2{'' if order == 'mxu' else '_' + order}"
        f"{'' if prod == 'f32' else '_' + prod}_f32",
        [_P] * 4 + [_I, _I] + [_P] * 8 + [_I, _I, _P])
    for order in V2_ORDERS for prod in V2_PRODUCTS for lazy in (False, True)
}
K1_V2, K1_V2_BF16I = K1_V2_FORMS["mxu", "f32", False], K1_V2_FORMS["mxu", "bf16i", False]
K1_LAZY_V2, K1_LAZY_V2_BF16I = K1_V2_FORMS["mxu", "f32", True], K1_V2_FORMS["mxu", "bf16i", True]
#: ``EIG_KL_TPU_REDUCE_IMPL``'s names (``_spmv_v2_call``, ``:1470-1480``).
V2_REDUCES = ("mxu", "mxuv", "mxu2", "vpu")


def reduce_impl_from_env() -> str:
    """``EIG_KL_TPU_REDUCE_IMPL`` as the JAX package's v2 SpMV takes it:
    "mxu" where unset, "mxuv" and "mxu2" as named, any other value
    "vpu" (the ``else`` of ``:1479``)."""
    impl = os.environ.get("EIG_KL_TPU_REDUCE_IMPL", "mxu")
    return impl if impl in ("mxu", "mxuv", "mxu2") else "vpu"


def bf16_weights_from_env() -> bool:
    """``EIG_KL_TPU_BF16_W=1``: a v2 plan keeps bf16 weights
    (``_bf16_w_enabled``, ``:109``)."""
    return os.environ.get("EIG_KL_TPU_BF16_W") == "1"


def mxu2_lanes(rblock: int) -> int:
    """The interleaved partials of ``_reduce_kernel_mxu2``'s dot at a row
    block (module docstring): its lane factor ``B`` as the kernel picks it
    (``:1312-1316``), then 4 partials at ``B`` <= 16, 2 at 32, and 1 (the
    default's slot order) from 64."""
    H = rblock // 128
    B = min((8, 16, 32, 64, 128), key=lambda b: 2 * H * (128 // b) + 2 * b)
    return 4 if B <= 16 else 2 if B == 32 else 1


def v2_order(layout: "V2Layout", reduce: str = "mxu") -> tuple[str, int]:
    """``(order, lanes)``: the order of adds in a sub-chunk that ``reduce``
    (one of :data:`V2_REDUCES`) takes on ``layout``: "mxu" (slot order;
    "mxuv", and "mxu2" from 2,176 rows per block), "mxu2" with 2 or 4
    lanes, or "vpu"."""
    if reduce not in V2_REDUCES:
        raise ValueError(f"the v2 reduce is one of {V2_REDUCES}, got {reduce!r}")
    if reduce == "vpu":
        return "vpu", 0
    lanes = mxu2_lanes(layout.rblock) if reduce == "mxu2" else 1
    return ("mxu", 0) if lanes == 1 else ("mxu2", lanes)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _up(a, dtype, device):
    return torch.as_tensor(np.ascontiguousarray(a).astype(dtype)).to(device)


@dataclasses.dataclass(frozen=True)
class V1Layout:
    """The v1 plan of one matrix, on one device, without the chunk axis's
    inert padding.

    Attributes:
      num_nodes: n.
      padded_nodes: n rounded up to a multiple of 1,024 (``P``).
      x_base: int32[C] each chunk's x window base (its column stripe
        times 1,024; the TPU plan's ``cw8`` times 128).
      col_local: int16[C, 512] each slot's column minus ``x_base`` (0 in
        padding slots).
      row_local: int16[C, 512] each slot's row minus its y window's base;
        padding slots continue the chunk's last row.
      weights: float32[C, 512] each slot's weight (0 in padding slots).
      win_ptr: int32[P / 1024 + 1] where each y window's chunks start in
        ``win_chunks``.
      win_chunks: int32[C] the chunks of each y window, in plan order.
    """

    num_nodes: int
    padded_nodes: int
    x_base: torch.Tensor
    col_local: torch.Tensor
    row_local: torch.Tensor
    weights: torch.Tensor
    win_ptr: torch.Tensor
    win_chunks: torch.Tensor

    @property
    def num_chunks(self) -> int:
        return int(self.col_local.shape[0])

    @property
    def num_windows(self) -> int:
        return self.padded_nodes // PLAN_WINDOW


def _v1_host(n: int, rows: np.ndarray, cols: np.ndarray, weights: np.ndarray) -> dict[str, np.ndarray]:
    """The arrays of :class:`V1Layout` on the host, as NumPy."""
    P = _round_up(max(n, 1), PLAN_WINDOW)
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    weights = np.asarray(weights, np.float32)
    nnz = rows.shape[0]
    if nnz == 0:
        rows, cols, weights, nnz = np.zeros(1, np.int64), np.zeros(1, np.int64), np.zeros(1, np.float32), 1
    stripe = cols // PLAN_WINDOW
    rblock = np.minimum((rows // PLAN_WINDOW) * PLAN_WINDOW, P - PLAN_WINDOW)
    key = stripe * (P // PLAN_WINDOW + 1) + rblock // PLAN_WINDOW
    order = np.lexsort((rows, key))  # stable: CSR order within a row
    rows, cols, weights = rows[order], cols[order], weights[order]
    stripe, rblock, key = stripe[order], rblock[order], key[order]

    new_group = np.empty(nnz, dtype=bool)
    new_group[0] = True
    np.not_equal(key[1:], key[:-1], out=new_group[1:])
    group_first = np.flatnonzero(new_group)
    group_start = np.repeat(group_first, np.diff(group_first, append=nnz))
    starts = np.flatnonzero((np.arange(nnz) - group_start) % CHUNK == 0)
    C = len(starts)
    counts = np.diff(starts, append=nnz)
    chunk_id = np.repeat(np.arange(C), counts)
    flat_pos = np.arange(nnz) - starts[chunk_id]

    x_base = stripe[starts] * PLAN_WINDOW
    y_base = rblock[starts]
    col_local = np.zeros((C, CHUNK), np.int64)
    row_local = np.zeros((C, CHUNK), np.int64)
    w = np.zeros((C, CHUNK), np.float32)
    col_local[chunk_id, flat_pos] = cols - x_base[chunk_id]
    row_local[chunk_id, flat_pos] = rows - y_base[chunk_id]
    w[chunk_id, flat_pos] = weights
    last = row_local[np.arange(C), counts - 1]
    row_local = np.where(np.arange(CHUNK)[None, :] >= counts[:, None], last[:, None], row_local)

    window = y_base // PLAN_WINDOW
    win_ptr = np.zeros(P // PLAN_WINDOW + 1, np.int64)
    np.cumsum(np.bincount(window, minlength=P // PLAN_WINDOW), out=win_ptr[1:])
    return dict(x_base=x_base, col_local=col_local, row_local=row_local, weights=w, win_ptr=win_ptr,
                win_chunks=np.argsort(window, kind="stable"))


def _v1_upload(n: int, host: dict[str, np.ndarray], device: torch.device | str) -> V1Layout:
    dtypes = dict(x_base=np.int32, col_local=np.int16, row_local=np.int16, weights=np.float32, win_ptr=np.int32,
                  win_chunks=np.int32)
    return V1Layout(n, _round_up(max(n, 1), PLAN_WINDOW),
                    **{k: _up(v, dtypes[k], device) for k, v in host.items()})


def build_v1_layout(
    n: int, rows: np.ndarray, cols: np.ndarray, weights: np.ndarray, device: torch.device | str
) -> V1Layout:
    """The v1 plan of the COO entries ``(rows, cols, weights)`` (in CSR
    order: rows ascending, columns ascending within a row), as
    ``eig_kl_tpu/ops/spmv_pallas.py:build_plan`` decides it."""
    return _v1_upload(n, _v1_host(n, rows, cols, weights), device)


@dataclasses.dataclass(frozen=True)
class CooTail:
    """A v2 plan's scattered spill (the JAX package's ``CooTail``) as
    ``(row, column, weight)`` triplets in CSR order: rows ascending, a row's
    entries in column order, which is the order of the TPU plan's rank
    groups (group ``k`` holds each row's ``k``-th spilled entry).
    ``warp_ptr[i]`` is where the triplets of rows ``32 i`` on start
    (int32[ceil(n / 32) + 1]): a warp of ``spmv_v2_f32`` finds its rows'
    there."""

    rows: torch.Tensor
    cols: torch.Tensor
    weights: torch.Tensor
    warp_ptr: torch.Tensor

    @property
    def num_entries(self) -> int:
        return int(self.cols.shape[0])

    @property
    def num_groups(self) -> int:
        """The TPU plan's rank groups: the most entries one row spills."""
        return int(torch.bincount(self.rows.long()).max()) if self.num_entries else 0


@dataclasses.dataclass(frozen=True)
class V2Layout:
    """The v2 plan of one matrix, on one device, in the form its order needs
    (module docstring).

    Attributes:
      num_nodes: n.
      padded_nodes: ``P``, n rounded up to a multiple of 1,024.
      rblock, quantum: the plan's row block and bucket slot count ``Q``.
      n_cb, n_rbp, g1, g2: the TPU plan's slot grid: column blocks, row
        blocks padded, pass-1 slots per column block, pass-2 slots per row
        block.
      ptr, cols, weights: the CSR arrays of the entries the buckets keep
        (int32[n + 1], int32[m], float32[m]), columns ascending in a row.
      shift: a row's partial restarts from +0 where ``col >> shift``
        changes (one sub-chunk of 512 slots: ``19 - log2 Q``).
      tail: the spill: a :class:`V1Layout`, a :class:`CooTail`, or None.
      weights_bf16: with bf16 weights (``EIG_KL_TPU_BF16_W``) the kept
        entries' weights rounded to bf16 (round to nearest even, bfloat16[m]),
        else None.
    """

    num_nodes: int
    padded_nodes: int
    rblock: int
    quantum: int
    n_cb: int
    n_rbp: int
    g1: int
    g2: int
    ptr: torch.Tensor
    cols: torch.Tensor
    weights: torch.Tensor
    shift: int
    tail: V1Layout | CooTail | None
    weights_bf16: torch.Tensor | None = None

    @functools.cached_property
    def slots(self) -> torch.Tensor:
        """int16[m]: each kept entry's slot in its pass-2 sub-chunk of 512
        (0-511), which the "mxu2" and "vpu" orders read: a bucket's entries
        take its ``Q`` slots in (row, column) order, and a row block's
        buckets lie in column-block order, so an entry's place in its row
        block's slots is ``(col >> 10) * Q`` plus its rank in its bucket.
        Made on first use, on the host, and kept on the layout's device."""
        ptr = self.ptr.cpu().numpy().astype(np.int64)
        cols = self.cols.cpu().numpy().astype(np.int64)
        rows = np.repeat(np.arange(self.num_nodes, dtype=np.int64), np.diff(ptr))
        n_rb = -(-self.padded_nodes // self.rblock)
        bucket = cols // PLAN_WINDOW * n_rb + rows // self.rblock
        order = np.argsort(bucket, kind="stable")  # CSR order is (row, column) order in a bucket
        first = np.ones(len(order), bool)
        first[1:] = bucket[order[1:]] != bucket[order[:-1]]
        starts = np.flatnonzero(first)
        rank = np.empty(len(order), np.int64)
        rank[order] = np.arange(len(order)) - np.repeat(starts, np.diff(starts, append=len(order)))
        return _up((cols // PLAN_WINDOW * self.quantum + rank) % CHUNK, np.int16, self.ptr.device)

    @property
    def num_subchunks(self) -> int:
        """The TPU plan's pass-2 sub-chunks of 512 slots, before its padding
        to whole grid steps."""
        return self.n_rbp * self.g2 // CHUNK


def search_v2_geometry(n: int, rows: np.ndarray, cols: np.ndarray) -> tuple[int, int]:
    """``(rblock, Q)`` from the exact bucket histogram, as
    ``eig_kl_tpu/ops/spmv_pallas.py:_search_v2_geometry`` picks them: the
    fewest slots ``n_cb * n_rbp * Q`` plus 64 per spilled entry, with at
    most 40,000 spilled; (512, 512) where every pair spills more."""
    P = _round_up(max(n, 1), PLAN_WINDOW)
    n_cb = P // PLAN_WINDOW
    n_rb0 = P // 512
    key = (np.asarray(cols) >> 10).astype(np.int32) * np.int32(n_rb0)
    key += (np.asarray(rows) >> 9).astype(np.int32)
    counts0 = np.bincount(key, minlength=n_cb * n_rb0).reshape(n_cb, n_rb0)
    best = None  # (cost, rblock, Q)
    for rb_cand in V2_RBLOCKS:
        f = rb_cand // 512
        n_rb = -(-n_rb0 // f)
        counts = counts0
        if f > 1:
            pad = n_rb * f - n_rb0
            if pad:
                counts = np.pad(counts, ((0, 0), (0, pad)))
            counts = counts.reshape(n_cb, n_rb, f).sum(axis=2)
        occ_hist = np.bincount(counts.reshape(-1))
        ks = np.arange(occ_hist.shape[0], dtype=np.int64)
        for Q in V2_QUANTA:
            spill = int((np.maximum(ks - Q, 0) * occ_hist).sum())
            if spill > _SPILL_MAX:
                continue
            cost = n_cb * _round_up(n_rb, 2048 // Q) * Q + _SPILL_COST * spill
            if best is None or cost < best[0]:
                best = (cost, rb_cand, Q)
    return (512, 512) if best is None else (best[1], best[2])


def _csr_ptr(n: int, rows: np.ndarray) -> np.ndarray:
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=ptr[1:])
    return ptr


def build_v2_layout(
    n: int, rows: np.ndarray, cols: np.ndarray, weights: np.ndarray, device: torch.device | str,
    rblock: int | None = None, quantum: int | None = None, bf16_weights: bool | None = None,
) -> V2Layout:
    """The v2 plan of the COO entries ``(rows, cols, weights)`` (in CSR
    order), as ``eig_kl_tpu/ops/spmv_pallas.py:build_plan_v2`` decides it
    with ``use_native=False``: ``rblock`` and ``quantum`` pin the geometry
    (the search's where None; ``Q`` from the mean bucket occupancy where
    only ``rblock`` is pinned), and ``Q`` is a power of two, 4 to 512.
    ``bf16_weights`` keeps the weights in bf16 too
    (:attr:`V2Layout.weights_bf16`); None reads ``EIG_KL_TPU_BF16_W``."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    weights = np.asarray(weights, np.float32)
    nnz = rows.shape[0]
    if nnz == 0:
        raise ValueError("a v2 plan takes at least one stored entry")
    if rblock is None:
        rblock, q_auto = search_v2_geometry(n, rows, cols)
        quantum = q_auto if quantum is None else quantum
    if rblock % 128 or not 0 < rblock <= 16384:
        raise ValueError(f"rblock is a multiple of 128 up to 16,384, got {rblock}")
    P = _round_up(max(n, 1), PLAN_WINDOW)
    n_cb = P // PLAN_WINDOW
    n_rb = -(-P // rblock)
    if quantum is not None and 4 <= quantum <= 512:
        Q = quantum
    else:
        lam = max(nnz / (n_cb * n_rb), 1.0)
        Q = 4
        while Q < min(512, lam * 1.5):
            Q *= 2
    if Q & (Q - 1):
        raise ValueError(f"the port's v2 order takes a power-of-two quantum, got {Q}")

    bucket = cols // PLAN_WINDOW * n_rb + rows // rblock
    # A bucket keeps its first Q entries in (row, column) order, which is
    # the entries' CSR order; only the entries of buckets that hold more
    # than Q need their rank, by a stable sort of those alone.
    over = np.flatnonzero(np.bincount(bucket, minlength=n_cb * n_rb)[bucket] > Q)
    keep = np.ones(nnz, bool)
    if len(over):
        order = np.argsort(bucket[over], kind="stable")
        sorted_bucket = bucket[over[order]]
        first = np.ones(len(over), bool)
        first[1:] = sorted_bucket[1:] != sorted_bucket[:-1]
        starts = np.flatnonzero(first)
        rank = np.arange(len(over)) - np.repeat(starts, np.diff(starts, append=len(over)))
        keep[over[order]] = rank < Q

    n_rbp = _round_up(n_rb, 2048 // Q)
    m_rows = rows[keep]
    tail = None
    if not keep.all():
        # The tail's kind is decided on the host; only the kept one is
        # uploaded.
        tr, tc, tw = rows[~keep], cols[~keep], weights[~keep]
        v1 = _v1_host(n, tr, tc, tw)
        chunks = _round_up(max(len(v1["x_base"]), 1), 8)
        if len(tr) >= _COO_ENTRIES_PER_CHUNK * chunks or np.bincount(tr).max() > _COO_MAX_GROUPS:
            tail = _v1_upload(n, v1, device)
        else:
            warp_ptr = np.searchsorted(tr, 32 * np.arange(-(-n // 32) + 1))
            tail = CooTail(_up(tr, np.int32, device), _up(tc, np.int32, device), _up(tw, np.float32, device),
                           _up(warp_ptr, np.int32, device))
    if bf16_weights is None:
        bf16_weights = bf16_weights_from_env()
    kept_w = _up(weights[keep], np.float32, device)
    return V2Layout(
        n, P, rblock, Q, n_cb, n_rbp, n_rbp * Q, _round_up(n_cb * Q, CHUNK),
        _up(_csr_ptr(n, m_rows), np.int32, device), _up(cols[keep], np.int32, device),
        kept_w, 19 - (Q.bit_length() - 1), tail,
        to_bf16(kept_w) if bf16_weights else None,
    )


def bf16_round(p: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to bf16 with round to nearest even and widened
    back to f32, as ``__float2bfloat16_rn`` does, subnormals and infinities
    included (NaNs stay NaN): the bits plus ``0x7FFF`` plus the kept half's
    last bit, the dropped half cleared.  Done on the bits, since a CPU's
    vector conversion may flush subnormals."""
    bits = p.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    bits = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    return torch.where(torch.isnan(p), p, bits.view(torch.float32).view(p.shape))


def to_bf16(p: torch.Tensor) -> torch.Tensor:
    """:func:`bf16_round` of f32 values as a bfloat16 tensor, made from the
    rounded bits (2 bytes each)."""
    return (bf16_round(p).view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16)


def segment_ends(layout: V1Layout) -> torch.Tensor:
    """bool[C, 512]: the slots that end a row's segment in their chunk,
    where the next slot holds another row, and slot 511.  A row has one
    such slot per chunk that holds it, the TPU plan's ``route_src``."""
    rl = layout.row_local
    ends = torch.ones_like(rl, dtype=torch.bool)
    ends[:, :-1] = rl[:, 1:] != rl[:, :-1]
    return ends


def _flat(layout, x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """``x``'s first n values, and whether ``x`` is the padded state."""
    n, P = layout.num_nodes, layout.padded_nodes
    if x.dtype != torch.float32:
        raise TypeError(f"the plan SpMVs are float32 only, got {x.dtype}")
    if x.shape == (n,):
        return x, False
    if x.shape == (P // 128, 128):
        return x.reshape(-1)[:n], True
    raise ValueError(f"x is ({n},) or the padded ({P // 128}, 128) state, got {tuple(x.shape)}")


def _shaped(layout, y: torch.Tensor, padded: bool) -> torch.Tensor:
    if not padded:
        return y
    out = torch.zeros(layout.padded_nodes, dtype=y.dtype, device=y.device)
    out[: layout.num_nodes] = y
    return out.view(-1, 128)


def spmv_v1_plain(layout: V1Layout, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in the v1 kernel's order, in plain PyTorch (module
    docstring)."""
    x, padded = _flat(layout, x)
    n = layout.num_nodes
    xp = torch.zeros(layout.padded_nodes, dtype=torch.float32, device=x.device)
    xp[:n] = x
    col = layout.x_base.long()[:, None] + layout.col_local.long()
    e = (xp[col] + 0.0) * layout.weights
    rl = layout.row_local.long()
    for k in SCAN_SHIFTS:
        shifted = torch.zeros_like(e)
        shifted[:, k:] = torch.where(rl[:, k:] == rl[:, :-k], e[:, :-k], 0.0)
        e = e + shifted
    c_idx, p_idx = torch.nonzero(segment_ends(layout), as_tuple=True)
    out = torch.zeros(layout.num_chunks, PLAN_WINDOW, dtype=torch.float32, device=x.device)
    out[c_idx, rl[c_idx, p_idx]] = e[c_idx, p_idx]
    ptr, chunks = layout.win_ptr.long(), layout.win_chunks.long()
    counts = ptr[1:] - ptr[:-1]
    y = torch.zeros(layout.num_windows, PLAN_WINDOW, dtype=torch.float32, device=x.device)
    for r in range(int(counts.max()) if layout.num_chunks else 0):
        has = counts > r  # the r-th chunk of each window: the adds in plan order
        y[has] += out[chunks[ptr[:-1][has] + r]]
    return _shaped(layout, y.reshape(-1)[:n], padded)


def _check_card(tensors, what: str) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} needs its vectors and the layout on one CUDA device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} takes contiguous tensors")


_V1_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def _v1_tickets(device: torch.device, stream, windows: int) -> torch.Tensor:
    """``spmv_v1_f32``'s ticket counters for one stream, one per y window,
    grown to ``windows``: zero between launches (the last block of each
    window resets its own), so launches on one stream share them and
    launches on two streams never do."""
    key = (device.index, stream.cuda_stream)
    if key not in _V1_TICKETS or _V1_TICKETS[key].numel() < windows:
        _V1_TICKETS[key] = torch.zeros(max(windows, 1), dtype=torch.int32, device=device)
    return _V1_TICKETS[key]


def spmv_v1_cuda(layout: V1Layout, x: torch.Tensor) -> torch.Tensor:
    """Launch ``spmv_v1_f32`` on the current stream: one block per chunk,
    and the last of a window's blocks adds the window's chunk totals in plan
    order (through the stream's tickets and its scratch, K6's)."""
    from eig_kl_tpu_torch.ops.reduce import _scratch  # reduce imports this module

    _flat(layout, x)  # checks the dtype and the shape
    _check_card((x, layout.col_local), "spmv_v1_cuda")
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device)
    scratch = _scratch(x.device, stream, torch.float32, layout.num_chunks * PLAN_WINDOW)
    tickets = _v1_tickets(x.device, stream, layout.num_windows)
    K1_V1(
        layout.x_base.data_ptr(), layout.col_local.data_ptr(), layout.row_local.data_ptr(),
        layout.weights.data_ptr(), layout.win_ptr.data_ptr(), layout.win_chunks.data_ptr(),
        x.data_ptr(), y.data_ptr(), scratch.data_ptr(), tickets.data_ptr(),
        layout.num_nodes, x.numel(), layout.num_windows, layout.num_chunks, stream.cuda_stream,
    )
    return y


def spmv_v1(layout: V1Layout, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in the v1 kernel's order: ``spmv_v1_f32`` for a tensor on
    the card, the plain version for one on the CPU."""
    fn = spmv_v1_plain if x.device.type == "cpu" else spmv_v1_cuda
    return fn(layout, x)


def _walk_rows(n: int, ptr: torch.Tensor, e: torch.Tensor, y: torch.Tensor, restart=None, slots=None,
               lanes: int = 1) -> torch.Tensor:
    """Each row's values ``e[ptr[r] .. ptr[r + 1]]`` added one after the
    other: into ``y`` itself, or (``restart``: bool per value) into a
    partial from +0, added into ``y`` where a value restarts it and after
    the row's last.  With ``slots`` (each value's slot in its sub-chunk) the
    partial is the opt-in reduces' (module docstring): ``lanes`` (2 or 4)
    interleaved partials by slot, added pairwise ("mxu2"), or with ``lanes``
    0 the sums of 32-slot blocks added one after the other ("vpu")."""
    ptr = ptr.long()
    deg = ptr[1:] - ptr[:-1]
    order = torch.argsort(deg, descending=True, stable=True)
    active = torch.bincount(deg, minlength=1).flip(0).cumsum(0).flip(0)  # rows with degree >= j
    acc = y if restart is None else torch.zeros(max(lanes, 1), *y.shape, dtype=y.dtype, device=y.device)
    blk = torch.zeros_like(y) if slots is not None and lanes == 0 else None

    def flush(f):
        if blk is not None:
            part = acc[0, f] + blk[f]
            blk[f] = 0.0
        elif lanes == 4:
            part = (acc[0, f] + acc[1, f]) + (acc[2, f] + acc[3, f])
        elif lanes == 2:
            part = acc[0, f] + acc[1, f]
        else:
            part = acc[0, f]
        y[f] = y[f] + part
        acc[:, f] = 0.0

    for j in range(int(deg.max()) if n else 0):
        r = order[: int(active[j + 1])]
        i = ptr[r] + j
        if restart is None:
            acc[r] = acc[r] + e[i]
            continue
        if j:
            flush(r[restart[i]])
            if blk is not None:  # a new 32-slot block within the sub-chunk
                b = r[(slots[i] >> 5 != slots[i - 1] >> 5) & ~restart[i]]
                acc[0, b] = acc[0, b] + blk[b]
                blk[b] = 0.0
        if blk is not None:
            blk[r] = blk[r] + e[i]
        else:
            lane = slots[i] % lanes if slots is not None else 0
            acc[lane, r] = acc[lane, r] + e[i]
    if restart is None:
        return acc
    flush(torch.arange(n, device=y.device))
    return y


def _v2_form(layout: V2Layout, bf16: bool, reduce: str, bf16_weights: bool) -> tuple[str, int, str]:
    """``(order, lanes, products)`` of a v2 SpMV call (:func:`v2_order`;
    products "f32", "bf16i" or "bf16w"), its arguments checked."""
    order, lanes = v2_order(layout, reduce)
    if bf16_weights and not bf16:
        raise ValueError("bf16 weights are read only with bf16 products (spmv_pallas.py:477-482)")
    if bf16_weights and layout.weights_bf16 is None:
        raise ValueError("the layout keeps no bf16 weights (build it with bf16_weights=True)")
    return order, lanes, "bf16w" if bf16_weights else "bf16i" if bf16 else "f32"


def spmv_v2_plain(layout: V2Layout, x: torch.Tensor, bf16: bool = False, reduce: str = "mxu",
                  bf16_weights: bool = False) -> torch.Tensor:
    """``A @ x`` in the v2 kernels' order, in plain PyTorch (module
    docstring): the kept products in f32 (``bf16``: rounded to bf16;
    ``bf16_weights``: of the bf16 weights), each row's partials in the order
    of ``reduce`` (:data:`V2_REDUCES`; "mxu": in slot order from +0), each
    partial added into ``y``, then the tail in f32."""
    order, lanes, _ = _v2_form(layout, bf16, reduce, bf16_weights)
    x, padded = _flat(layout, x)
    n = layout.num_nodes
    cols = layout.cols.long()
    e = x[cols] * (layout.weights_bf16.float() if bf16_weights else layout.weights)
    if bf16:
        e = bf16_round(e)
    grp = cols >> layout.shift
    restart = torch.zeros_like(grp, dtype=torch.bool)
    restart[1:] = grp[1:] != grp[:-1]
    slots = None if order == "mxu" else layout.slots.long()
    y = _walk_rows(n, layout.ptr, e, torch.zeros(n, dtype=torch.float32, device=x.device), restart, slots, lanes)
    tail = layout.tail
    if isinstance(tail, V1Layout):
        y = y + spmv_v1_plain(tail, x)
    elif isinstance(tail, CooTail):
        y = coo_tail_add(tail, y, x)
    return _shaped(layout, y, padded)


def coo_tail_add(tail: CooTail, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y + A_tail @ x`` for the vectors ``y`` and ``x`` of n values, as the
    JAX package's ``_coo_tail_add`` (``spmv_pallas.py:662``) adds its rank
    groups: each row's spilled entries in column order, each ``y[row] +
    round(w * x[col])``."""
    ptr = torch.zeros(y.shape[0] + 1, dtype=torch.int64, device=y.device)
    ptr[1:] = torch.bincount(tail.rows.long(), minlength=y.shape[0]).cumsum(0)
    return _walk_rows(y.shape[0], ptr, tail.weights * x[tail.cols.long()], y.clone())


def v2_kernel(layout: V2Layout, bf16: bool = False, reduce: str = "mxu", bf16_weights: bool = False,
              lazy: bool = False) -> Kernel:
    """The entry point that :func:`spmv_v2_cuda` launches for these
    arguments (:data:`K1_V2_FORMS`)."""
    order, _, products = _v2_form(layout, bf16, reduce, bf16_weights)
    return K1_V2_FORMS[order, products, lazy]


def spmv_v2_cuda(layout: V2Layout, x: torch.Tensor, bf16: bool = False, dsinv: torch.Tensor | None = None,
                 reduce: str = "mxu", bf16_weights: bool = False) -> torch.Tensor:
    """Launch ``spmv_v2_f32`` (``bf16``: ``spmv_v2_bf16i_f32``;
    ``bf16_weights``: ``spmv_v2_bf16w_f32``; the "mxu2" and "vpu" orders:
    ``spmv_v2_mxu2...`` and ``spmv_v2_vpu...``, :func:`v2_kernel`) on the
    current stream, and for a v1 tail ``spmv_v1_f32`` first, whose result it
    adds.  With ``dsinv`` (the shape of ``x``) the lazy walk ``0.5 *
    fma(dsinv, A (dsinv * x), x)``: ``lazy_walk_v2...``.  "mxuv", and "mxu2"
    where its order is the default's, launch the default's form."""
    order, lanes, _ = _v2_form(layout, bf16, reduce, bf16_weights)
    kernel = v2_kernel(layout, bf16, reduce, bf16_weights, dsinv is not None)
    flat, _ = _flat(layout, x)
    ts = (x, layout.cols) if dsinv is None else (x, dsinv, layout.cols)
    _check_card(ts, "spmv_v2_cuda")
    if dsinv is not None and dsinv.shape != x.shape:
        raise ValueError(f"dsinv has x's shape {tuple(x.shape)}, got {tuple(dsinv.shape)}")
    slots = None if order == "mxu" else layout.slots
    tail = layout.tail
    tail_y = coo = None
    if isinstance(tail, V1Layout):
        xs = flat if dsinv is None else _flat(layout, dsinv)[0] * flat
        tail_y = spmv_v1_cuda(tail, xs.contiguous())
    elif isinstance(tail, CooTail):
        coo = tail
    y = torch.empty_like(x)
    kernel(
        layout.ptr.data_ptr(), layout.cols.data_ptr(),
        (layout.weights_bf16 if bf16_weights else layout.weights).data_ptr(),
        None if slots is None else slots.data_ptr(), layout.shift, lanes,
        *((None,) * 4 if coo is None else (t.data_ptr() for t in (coo.warp_ptr, coo.rows, coo.cols, coo.weights))),
        None if tail_y is None else tail_y.data_ptr(), x.data_ptr(), None if dsinv is None else dsinv.data_ptr(),
        y.data_ptr(), layout.num_nodes, x.numel(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    return y


def spmv_v2(layout: V2Layout, x: torch.Tensor, bf16: bool = False, reduce: str = "mxu",
            bf16_weights: bool = False) -> torch.Tensor:
    """``A @ x`` in the v2 kernels' order: ``spmv_v2_f32`` (or the form of
    :func:`v2_kernel`) for a tensor on the card, the plain version for one
    on the CPU."""
    if x.device.type == "cpu":
        return spmv_v2_plain(layout, x, bf16, reduce, bf16_weights)
    return spmv_v2_cuda(layout, x, bf16, reduce=reduce, bf16_weights=bf16_weights)


def plan_spmv(layout: V1Layout | V2Layout, x: torch.Tensor, bf16: bool = False, reduce: str = "mxu",
              bf16_weights: bool = False) -> torch.Tensor:
    """``A @ x`` in the order of the plan's TPU kernel; for a v2 plan ``bf16``
    rounds the products, ``reduce`` picks the reduce kernel's order and
    ``bf16_weights`` reads the bf16 weights (a v1 plan has none of these, and
    ignores them, as ``spmv_pallas_2d`` does)."""
    if isinstance(layout, V1Layout):
        return spmv_v1(layout, x)
    return spmv_v2(layout, x, bf16, reduce, bf16_weights)


def lazy_walk_v2_plain(layout: V2Layout, w: torch.Tensor, dsinv: torch.Tensor, bf16: bool = False,
                       reduce: str = "mxu", bf16_weights: bool = False) -> torch.Tensor:
    """The lazy-walk form of ``spmv_v2_f32`` in plain PyTorch: ``0.5 *
    fma(dsinv, A (dsinv * w), w)``, the product ``dsinv * w`` rounded once,
    the SpMV :func:`spmv_v2_plain`."""
    from eig_kl_tpu_torch.ops.spmv import fma_f32

    return 0.5 * fma_f32(dsinv, spmv_v2_plain(layout, dsinv * w, bf16, reduce, bf16_weights), w)


def plan_lazy_walk(layout: V1Layout | V2Layout, w: torch.Tensor, dsinv: torch.Tensor, bf16: bool = False,
                   reduce: str = "mxu", bf16_weights: bool = False) -> torch.Tensor:
    """The lazy walk ``0.5 * (w + dsinv * A (dsinv * w))`` through the plan's
    SpMV (the JAX package's ``opm_sym`` on a planned graph,
    ``eig_kl_tpu/spectral/power.py:297-305``): the product ``dsinv * w``
    rounded once, ``w + dsinv * Ax`` one fused multiply-add, the halving
    exact.  A v2 layout: ``spmv_v2_f32``'s lazy form on the card (the form
    of :func:`v2_kernel`), :func:`lazy_walk_v2_plain` on the CPU; a v1
    layout: the scaled vector, :func:`spmv_v1` and K6's axpy (``bf16``,
    ``reduce`` and ``bf16_weights`` ignored)."""
    if isinstance(layout, V2Layout):
        if w.device.type == "cpu":
            return lazy_walk_v2_plain(layout, w, dsinv, bf16, reduce, bf16_weights)
        return spmv_v2_cuda(layout, w, bf16, dsinv=dsinv, reduce=reduce, bf16_weights=bf16_weights)
    from eig_kl_tpu_torch.ops.reduce import axpy

    return 0.5 * axpy(dsinv, spmv_v1(layout, dsinv * w), w)
