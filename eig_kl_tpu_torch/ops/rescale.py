"""The vector ``z = dsinv * w`` that the lazy walks gather
(``csrc/spmv_csr.cu``), each product rounded once: the momentum step's
rescale, which writes it with the step's two carries in one pass
(:func:`lazy_rescale`), and the standalone z pass (:func:`lazy_z`).

The card's wrappers sit on the momentum loop's every step, which the host
paces: each checks its tensors in one test, allocates its outputs in one
call and reads the stream's handle directly (``_build.stream_handle``).
``ops/spmv.py`` and ``ops/spmv_plan.py`` import this module (and
``ops/spmv.py`` exports its names); it imports neither.
"""

from __future__ import annotations

import ctypes

import torch

from eig_kl_tpu_torch.ops._build import Kernel, stream_handle

_P, _I = ctypes.c_void_p, ctypes.c_int

#: The momentum step's rescale with its next walk's z, and the standalone z
#: pass (the same kernel without the rescale), each with its own count.
K1_RESCALE, K1_RESCALE_F64 = (Kernel("spmv_csr", f"lazy_rescale_{s}", [_P] * 7 + [_I, _P]) for s in ("f32", "f64"))
K1_Z, K1_Z_F64 = (Kernel("spmv_csr", f"lazy_z_{s}", [_P] * 3 + [_I, _P]) for s in ("f32", "f64"))
_RESCALE = {torch.float32: K1_RESCALE, torch.float64: K1_RESCALE_F64}
_Z = {torch.float32: K1_Z, torch.float64: K1_Z_F64}


def checked_z(z: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``z``, if it is contiguous, of ``w``'s shape, dtype and device."""
    if z.shape != w.shape or z.dtype != w.dtype or z.device != w.device or not z.is_contiguous():
        raise ValueError(f"z must be a contiguous {w.dtype} tensor of shape {tuple(w.shape)} on {w.device}; got "
                         f"{z.dtype} {tuple(z.shape)} on {z.device}")
    return z


def lazy_z(w: torch.Tensor, dsinv: torch.Tensor) -> torch.Tensor:
    """``z = dsinv * w``, each product rounded once: the vector a lazy walk
    of ``w`` gathers (``ops/spmv.py:lazy_walk``, ``plan_lazy_walk``), for a
    vector no :func:`lazy_rescale` made.  ``w`` and ``dsinv`` of one shape
    (the flat vector or the padded state), f32 or f64; ``lazy_z_f32`` /
    ``lazy_z_f64`` on the card, :func:`lazy_z_plain` on the CPU."""
    if w.device.type == "cpu":
        return lazy_z_plain(w, dsinv)
    return lazy_z_cuda(w, dsinv)


def lazy_z_plain(w: torch.Tensor, dsinv: torch.Tensor) -> torch.Tensor:
    """:func:`lazy_z` in plain PyTorch."""
    return dsinv * w


def lazy_z_cuda(w: torch.Tensor, dsinv: torch.Tensor) -> torch.Tensor:
    """Launch the z pass on the current stream."""
    kernel, device = _Z.get(w.dtype), w.device
    if (kernel is None or device.type != "cuda" or not w.is_contiguous() or not dsinv.is_contiguous()
            or dsinv.shape != w.shape or dsinv.dtype != w.dtype or dsinv.device != device):
        raise ValueError(f"the z pass takes w and dsinv contiguous, f32 or f64, of one shape on one CUDA device; "
                         f"got {_described(w, dsinv)}")
    z = torch.empty_like(w)
    kernel(w.data_ptr(), dsinv.data_ptr(), z.data_ptr(), w.numel(), stream_handle(device))
    return z


def lazy_rescale(u: torch.Tensor, w: torch.Tensor, inv: torch.Tensor, dsinv: torch.Tensor):
    """The momentum step's rescale of its carries, ``(w * inv, u * inv)``
    (``eig_kl_tpu/spectral/power.py:322``; ``inv`` 0-d), and the next lazy
    walk's ``z = dsinv * (u * inv)``, each product rounded once.  Returns
    ``(wp', w', z')`` = ``(w * inv, u * inv, dsinv * (u * inv))``.  ``u``,
    ``w`` and ``dsinv`` of one shape (the flat vector or the padded state),
    f32 or f64; ``lazy_rescale_f32`` / ``lazy_rescale_f64`` on the card,
    one launch for the three, :func:`lazy_rescale_plain` on the CPU."""
    if u.device.type == "cpu":
        return lazy_rescale_plain(u, w, inv, dsinv)
    return lazy_rescale_cuda(u, w, inv, dsinv)


def lazy_rescale_plain(u: torch.Tensor, w: torch.Tensor, inv: torch.Tensor, dsinv: torch.Tensor):
    """:func:`lazy_rescale` in plain PyTorch."""
    w_new = u * inv
    return w * inv, w_new, dsinv * w_new


def lazy_rescale_cuda(u: torch.Tensor, w: torch.Tensor, inv: torch.Tensor, dsinv: torch.Tensor):
    """Launch ``lazy_rescale_f32`` (``_f64``) on the current stream: one
    pass writes the three vectors, three rows of one allocation."""
    kernel, shape, dtype, device = _RESCALE.get(u.dtype), u.shape, u.dtype, u.device
    if (kernel is None or device.type != "cuda" or not (u.is_contiguous() and w.is_contiguous()
                                                        and dsinv.is_contiguous())
            or w.shape != shape or dsinv.shape != shape or w.dtype != dtype or dsinv.dtype != dtype
            or inv.dtype != dtype or inv.dim() != 0 or w.device != device or dsinv.device != device
            or inv.device != device):
        raise ValueError(f"lazy_rescale takes u, w and dsinv contiguous, f32 or f64, of one shape on one CUDA "
                         f"device, and inv 0-d of their dtype there; got {_described(u, w, dsinv)}, inv "
                         f"{_described(inv)}")
    wp_new, w_new, z = torch.empty((3, *shape), dtype=dtype, device=device).unbind(0)
    kernel(u.data_ptr(), w.data_ptr(), inv.data_ptr(), dsinv.data_ptr(), w_new.data_ptr(), wp_new.data_ptr(),
           z.data_ptr(), u.numel(), stream_handle(device))
    return wp_new, w_new, z


def _described(*tensors: torch.Tensor) -> str:
    return ", ".join(f"{t.dtype} {tuple(t.shape)} on {t.device}" for t in tensors)
