"""The exact rank select (the port of ``eig_kl_tpu/ops/select.py``): kernel
K7 (``csrc/select.cu``) and its plain version.

The reference's "upper" median ``sorted[n // 2]`` (gKL2.cu:396-398) is one
order statistic.  :func:`kth_smallest` finds it without a sort, on keys
whose integer order is the float order:

* f32 (``_f32_keys``, ``:42``): the bits ``b`` as an unsigned 32-bit key,
  ``~b`` where the sign bit is set, else ``b ^ 0x80000000`` (held in int64
  here, since PyTorch's uint32 support on the CPU is thin); the key of
  rank ``k`` is built bit by bit from the top, a bit kept where the count
  of keys below the candidate stays ``<= k`` (``_kth_key_bits``, ``:53``;
  the 4-pass histogram ``_kth_key_radix``, ``:68``, returns the same key);
* f64: the same flip of the 64-bit pattern, held as a signed int64 whose
  order is the float order (``b`` where the sign bit is clear, ``b ^
  0x7fff...f`` where it is set), searched over 64 bits.  The JAX package
  sorts f64 instead (``kth_smallest``, ``:118``); the key of rank ``k`` is
  the sorted element.

The keys order -0.0 just below +0.0 and every NaN by its sign: a NaN
without its sign bit lies above +inf, as in a sort; one with its sign bit
lies below -inf, as the JAX package's f32 keys put it.  The value is the
sorted element bit for bit, except that -0.0 and +0.0 may stand in for
each other where a sort keeps them in input order; they compare equal in
``median > v``, the only place the median is used.

K7 runs one select in one launch, f32 or f64, and leaves the result on the
card (no host synchronisation, so ``median > v`` stays there): a radix
select of 8-bit digits that stops once the bin of rank ``k`` holds one
key, in one block up to 8,192 values and on a cooperative grid above
(``csrc/select.cu``).  The JAX
package chooses between its sort and its select, and between the select's
two forms, by ``EIG_KL_TPU_MEDIAN_SELECT`` and ``EIG_KL_TPU_SELECT_IMPL``
for the TPU's sake; they give one value, and the port has neither knob.
"""

from __future__ import annotations

import ctypes

import torch

from eig_kl_tpu_torch.ops._build import Kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
#: ``kth_smallest_{f32,f64}(v, n, k, out, scratch, stream)``: a radix
#: select of 8-bit digits (at most 4 rounds in f32, 8 in f64), in one block
#: of 1,024 threads up to 8,192 values, else on a cooperative grid of up to
#: one such block per SM with a grid barrier per round.
K7, K7_F64 = (Kernel("select", f"kth_smallest_{t}", [_P, _I, _I, _P, _P, _P]) for t in ("f32", "f64"))
#: K7's scratch in 4-byte words (``csrc/select.cu:kScratch``): a 256-bin
#: histogram per round of f64's 8, the barrier's count, the finished blocks.
K7_SCRATCH_WORDS = 8 * 256 + 2
_SIGN32 = 1 << 31
_MASK32 = (1 << 32) - 1
_SIGN64 = 1 << 63
_LOW63 = (1 << 63) - 1


def f32_keys(v: torch.Tensor) -> torch.Tensor:
    """int64 keys in ``[0, 2^32)`` of an f32 tensor: the JAX package's
    ``_f32_keys``, unsigned order = float order."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & _MASK32
    return torch.where(bits >= _SIGN32, _MASK32 - bits, bits ^ _SIGN32)


def f32_from_key(key: torch.Tensor) -> torch.Tensor:
    """The f32 value of an :func:`f32_keys` key (an int64 tensor)."""
    bits = torch.where(key >= _SIGN32, key ^ _SIGN32, _MASK32 - key)
    return (bits - ((bits >= _SIGN32).to(torch.int64) << 32)).to(torch.int32).view(torch.float32)


def f64_keys(v: torch.Tensor) -> torch.Tensor:
    """Signed int64 keys of an f64 tensor whose order is the float order:
    :func:`f32_keys`'s flip on 64 bits, shifted by ``2^63``."""
    bits = v.contiguous().view(torch.int64)
    return torch.where(bits < 0, bits ^ _LOW63, bits)


def f64_from_key(key: torch.Tensor) -> torch.Tensor:
    """The f64 value of an :func:`f64_keys` key."""
    return torch.where(key < 0, key ^ _LOW63, key).view(torch.float64)


def _kth_key(keys: torch.Tensor, k: int, bits: int, offset: int) -> int:
    """The key of rank ``k``: the largest ``K`` with ``#{keys < K} <= k``,
    built bit by bit from the top over ``bits`` bits; candidates are
    unsigned and compared as ``candidate - offset``."""
    result = 0
    for i in range(bits - 1, -1, -1):
        cand = result | (1 << i)
        if int((keys < cand - offset).sum()) <= k:
            result = cand
    return result - offset


def kth_smallest_plain(v: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`kth_smallest` in plain PyTorch."""
    if v.dtype == torch.float32:
        return f32_from_key(torch.tensor(_kth_key(f32_keys(v), k, 32, 0), device=v.device))
    return f64_from_key(torch.tensor(_kth_key(f64_keys(v), k, 64, _SIGN64), device=v.device))


def _check(v: torch.Tensor, k: int) -> None:
    if v.dtype not in (torch.float32, torch.float64) or v.dim() != 1:
        raise TypeError(f"kth_smallest takes a 1-D float32 or float64 tensor, got {v.dtype} {tuple(v.shape)}")
    if not 0 <= k < v.shape[0]:
        raise ValueError(f"rank {k} outside a vector of {v.shape[0]} values")


_SCRATCH: dict[tuple[int, int], torch.Tensor] = {}


def _scratch(device: torch.device, stream) -> torch.Tensor:
    """K7's scratch for one stream: zero between launches (the last block of
    each launch zeroes it), so launches on one stream share it and launches
    on two streams never do."""
    key = (device.index, stream.cuda_stream)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(K7_SCRATCH_WORDS, dtype=torch.int32, device=device)
    return _SCRATCH[key]


def kth_smallest_cuda(v: torch.Tensor, k: int) -> torch.Tensor:
    """Launch K7 on the current stream; a 0-d tensor on the card."""
    _check(v, k)
    if v.device.type != "cuda":
        raise ValueError("kth_smallest_cuda needs a tensor on a CUDA device")
    v = v.contiguous()
    out = torch.empty((), dtype=v.dtype, device=v.device)
    stream = torch.cuda.current_stream(v.device)
    (K7 if v.dtype == torch.float32 else K7_F64)(
        v.data_ptr(), v.shape[0], k, out.data_ptr(), _scratch(v.device, stream).data_ptr(), stream.cuda_stream
    )
    return out


def kth_smallest(v: torch.Tensor, k: int) -> torch.Tensor:
    """``sort(v)[k]`` (0-indexed rank ``k``) of the 1-D f32 or f64 tensor
    ``v``, as a 0-d tensor on its device: K7 for a tensor on the card, the
    plain version for one on the CPU."""
    _check(v, k)
    if v.device.type == "cpu":
        return kth_smallest_plain(v, k)
    return kth_smallest_cuda(v, k)


def upper_median(v: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """``sort(v)[n // 2]`` as a 0-d tensor on ``v``'s device."""
    if n is None:
        n = v.shape[0]
    return kth_smallest(v, n // 2)
