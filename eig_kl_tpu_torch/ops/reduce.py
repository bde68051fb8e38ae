"""Sums in one fixed order, the same on every device.

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
sequence.
"""

from __future__ import annotations

import ctypes
import math
import struct

import numpy as np
import torch

from eig_kl_tpu_torch.ops._build import Kernel

_WINDOW = 32
K4 = Kernel("fma_dot", "fma_dot_f32", [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of the 1-D tensor ``v`` in the fixed order above (0-d tensor)."""
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


def tree_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x . y`` with the products summed by :func:`tree_sum`."""
    return tree_sum(x * y)


def tree_norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm with the squares summed by :func:`tree_sum`.

    An f32 root is taken in f64 and rounded once, which gives the
    correctly rounded f32 root on every device (PyTorch's f32 ``sqrt`` on
    the CPU is sometimes an ulp off; XLA's is correctly rounded).
    """
    return _root(tree_sum(x * x))


def _root(s: torch.Tensor) -> torch.Tensor:
    if s.dtype == torch.float32:
        return torch.sqrt(s.double()).float()
    return torch.sqrt(s)


def tree_sum_2d(v: torch.Tensor) -> torch.Tensor:
    """Sum of the 2-D tensor ``v`` in the order XLA's CPU backend adds a
    reduction over both axes (``jnp.linalg.norm`` of the power solver's
    padded ``(P/128, 128)`` state): each axis longer than 32 is cut into
    windows of 32 after a centred zero pad (the smaller half in front), an
    axis of at most 32 is one window; each window adds its elements in
    row-major order; repeat until no axis is longer than 32, then add what
    remains in row-major order.

    Matched bit for bit where the last block is one row of windows
    (``P <= 4,096``: gen 0.02x) or where the first round leaves more than
    32 rows of windows (``P > 131,072``: gen 1.0x).  In between, the last
    block is ``(k, 4)`` with 2 <= k <= 32, and XLA's final reduce is a
    loop that LLVM vectorizes across the k rows for some k (on x86, k = 4:
    a lane per row, then a shuffle tree of the lanes), which this does not
    reproduce; for other k, such as 6 (P = 24,576), the loop stays scalar
    in row-major order and is matched.  Unmatched sums differ in the last
    bits only."""
    while max(v.shape) > _WINDOW:
        spec = []
        for size in v.shape:
            if size > _WINDOW:
                m = -(-size // _WINDOW)
                spec.append((m, _WINDOW, (m * _WINDOW - size) // 2))
            else:
                spec.append((1, size, 0))
        (ma, wa, la), (mb, wb, lb) = spec
        w = torch.zeros(ma * wa, mb * wb, dtype=v.dtype, device=v.device)
        w[la : la + v.shape[0], lb : lb + v.shape[1]] = v
        w = w.view(ma, wa, mb, wb).permute(1, 3, 0, 2).reshape(wa * wb, ma, mb)
        acc = torch.zeros(ma, mb, dtype=v.dtype, device=v.device)
        for k in range(wa * wb):
            acc = acc + w[k]
        v = acc
    acc = torch.zeros((), dtype=v.dtype, device=v.device)
    for x in v.reshape(-1).unbind():
        acc = acc + x
    return acc


def tree_norm_2d(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of the 2-D tensor ``x``, the squares summed by
    :func:`tree_sum_2d`; an f32 root is taken as in :func:`tree_norm`."""
    return _root(tree_sum_2d(x * x))


def fma_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x . y`` for f32 vectors as XLA's CPU backend computes a vector dot
    (``jnp.vdot``): one chain of fused multiply-adds in index order.

    K4 (``csrc/fma_dot.cu``) runs the chain for tensors on the card,
    :func:`fma_dot_plain` for tensors on the CPU.  Returns a 0-d f32
    tensor on ``x``'s device.
    """
    if x.device.type == "cpu":
        return fma_dot_plain(x, y)
    return fma_dot_cuda(x, y)


def fma_dot_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The chain of :func:`fma_dot` on the host: each product is exact in
    f64, and the f64 sum is rounded to odd (its TwoSum error decides the
    last bit) before the rounding to f32, which makes each step the
    correctly rounded ``fmaf`` (see ``ops/spmv.py:fma_f32``)."""
    prods = (x.double() * y.double()).cpu().tolist()
    acc = 0.0
    for p in prods:
        s = p + acc
        bp = s - acc
        err = (p - bp) + (acc - (s - bp))
        if err != 0.0 and not struct.unpack("<q", struct.pack("<d", s))[0] & 1:
            s = math.nextafter(s, math.copysign(math.inf, err))
        acc = float(np.float32(s))
    return torch.tensor(acc, dtype=torch.float32, device=x.device)


def fma_dot_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Launch K4 on the current stream: the chain of :func:`fma_dot` for
    two contiguous f32 vectors of one length on one card."""
    if x.device.type != "cuda" or y.device != x.device:
        raise ValueError("fma_dot_cuda: x and y must lie on one CUDA device")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"fma_dot_cuda is float32 only; got {x.dtype} and {y.dtype}")
    if x.dim() != 1 or x.shape != y.shape or not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"fma_dot_cuda: two contiguous vectors of one length, got {tuple(x.shape)}, {tuple(y.shape)}")
    out = torch.empty((), dtype=torch.float32, device=x.device)
    K4(x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    return out
