"""The v1 TPU SpMV's own order: its chunk layout, its plain version, and
K1's entry point ``spmv_v1_f32`` (``csrc/spmv_csr.cu``) that computes it
on the card.

The JAX mega engine takes its initial ``A @ s`` and its recount from the
TPU SpMV of its plan (``eig_kl_tpu/kl/megakernel.py:_batch_init``,
``:763``, and ``_finalize_batch``, ``:753``), and at up to
:data:`~eig_kl_tpu_torch.graph.csr.V1_MAX_NNZ` stored entries that plan is
a v1 plan (``ops/spmv_pallas.py:plan_for_graph``, ``:569``).  The v1
kernel (``_spmv_kernel``, ``:339``) does not add a row as XLA's ELL SpMV
does (K1's order, :mod:`eig_kl_tpu_torch.ops.spmv`); its layout decides
the order of the sums:

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
so the port derives it from ``row_local`` and keeps no table.  The
kernel's arithmetic as it runs in interpret mode on the CPU was read from
the program itself (no product is contracted into a scan add):
:func:`spmv_v1_plain` equals ``spmv_pallas(plan_for_graph(g), x,
interpret=True)`` bit for bit (``tests/test_torch_faults.py``).  The chunk
axis's padding to a multiple of 8 (``_pad_v1_chunks``) adds exact zeros
and is left out.  The JAX package also builds the plan natively
(``native/eigkl_native.cpp``) and says the two builders give the same
plan, so the port keeps this NumPy builder only.  A graph keeps its
layout (:attr:`~eig_kl_tpu_torch.graph.csr.DeviceGraph.v1_layout`), as the
JAX ``MegaGraph`` keeps its plan.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import PLAN_WINDOW
from eig_kl_tpu_torch.ops._build import Kernel

CHUNK = 512  #: entries per chunk (the TPU kernel's (4, 128) tile)
SCAN_SHIFTS = (1, 2, 4, 8, 16, 32, 64, 128, 256)  #: the scan's rounds

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``spmv_v1_f32(x_base, col_local, row_local, weights, win_ptr,
#: win_chunks, x, y, n, windows, stream)``: one block per y window.
K1_V1 = Kernel("spmv_csr", "spmv_v1_f32", [_P] * 8 + [_I, _I, _P])


@dataclasses.dataclass(frozen=True)
class V1Layout:
    """The v1 plan of one matrix, on one device, without the chunk axis's
    inert padding.

    Attributes:
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


def build_v1_layout(
    n: int, rows: np.ndarray, cols: np.ndarray, weights: np.ndarray, device: torch.device | str
) -> V1Layout:
    """The v1 plan of the COO entries ``(rows, cols, weights)`` (in CSR
    order: rows ascending, columns ascending within a row), as
    ``eig_kl_tpu/ops/spmv_pallas.py:build_plan`` decides it."""
    P = -(-max(n, 1) // PLAN_WINDOW) * PLAN_WINDOW
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

    def up(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a).astype(dtype)).to(device)

    return V1Layout(
        P, up(x_base, np.int32), up(col_local, np.int16), up(row_local, np.int16), up(w, np.float32),
        up(win_ptr, np.int32), up(np.argsort(window, kind="stable"), np.int32),
    )


def segment_ends(layout: V1Layout) -> torch.Tensor:
    """bool[C, 512]: the slots that end a row's segment in their chunk,
    where the next slot holds another row, and slot 511.  A row has one
    such slot per chunk that holds it, the TPU plan's ``route_src``."""
    rl = layout.row_local
    ends = torch.ones_like(rl, dtype=torch.bool)
    ends[:, :-1] = rl[:, 1:] != rl[:, :-1]
    return ends


def spmv_v1_plain(layout: V1Layout, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for the f32 vector ``x`` in the v1 kernel's order, in
    plain PyTorch (module docstring)."""
    n = x.shape[0]
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
    return y.reshape(-1)[:n]


def spmv_v1_cuda(layout: V1Layout, x: torch.Tensor) -> torch.Tensor:
    """Launch ``spmv_v1_f32`` on the current stream: one block per y
    window walks its chunks in plan order."""
    if x.device.type != "cuda" or layout.col_local.device != x.device:
        raise ValueError("spmv_v1_cuda needs x and the layout on one CUDA device")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise TypeError(f"spmv_v1_cuda takes a contiguous float32 vector, got {x.dtype} {tuple(x.shape)}")
    n = x.shape[0]
    if n > layout.padded_nodes or layout.padded_nodes - n >= PLAN_WINDOW:
        raise ValueError(f"x has {n} values, the layout {layout.padded_nodes} padded nodes")
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    K1_V1(
        layout.x_base.data_ptr(), layout.col_local.data_ptr(), layout.row_local.data_ptr(),
        layout.weights.data_ptr(), layout.win_ptr.data_ptr(), layout.win_chunks.data_ptr(),
        x.data_ptr(), y.data_ptr(), n, layout.num_windows,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    return y


def spmv_v1(layout: V1Layout, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in the v1 kernel's order: ``spmv_v1_f32`` for a vector on
    the card, the plain version for one on the CPU."""
    fn = spmv_v1_plain if x.device.type == "cpu" else spmv_v1_cuda
    return fn(layout, x)
