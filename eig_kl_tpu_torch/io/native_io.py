"""ctypes bindings for the port's host library ``csrc/eigkl_native.cpp``
(the port of ``eig_kl_tpu/io/native_io.py``; the port never loads the JAX
package's ``native/libeigkl.so``).

The library holds the ``.hgr`` tokenizer, the clique expansion and the
Benes router of the v3 SpMV plan.  It is built with the host C++
compiler at first use into ``eig_kl_tpu_torch/_build/``
(:mod:`eig_kl_tpu_torch.ops._build`); a failed build raises
``ImportError`` with the compiler's output, and later calls in the same
process raise it again without rebuilding.  The parser and the expansion
give the same arrays as the NumPy routes in :mod:`eig_kl_tpu_torch.io.hgr`
and :mod:`eig_kl_tpu_torch.graph.expand`.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None
_load_error: str | None = None


class _EklHgr(ctypes.Structure):
    _fields_ = [
        ("num_nets", ctypes.c_int64),
        ("num_nodes", ctypes.c_int64),
        ("num_pins", ctypes.c_int64),
        ("pins", ctypes.POINTER(ctypes.c_int32)),
        ("net_offsets", ctypes.POINTER(ctypes.c_int64)),
        ("status", ctypes.c_int32),
    ]


class _EklCsr(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("indptr", ctypes.POINTER(ctypes.c_int64)),
        ("indices", ctypes.POINTER(ctypes.c_int32)),
        ("data", ctypes.POINTER(ctypes.c_double)),
        ("status", ctypes.c_int32),
    ]


def _load():
    global _lib, _load_error
    if _lib is not None:
        return _lib
    if _load_error is not None:
        raise ImportError(_load_error)
    from eig_kl_tpu_torch.ops import _build

    try:
        _build.build(_build.HOST_SOURCES)
        lib = ctypes.CDLL(str(_build.library_path("eigkl_native")))
    except (RuntimeError, OSError) as e:
        _load_error = f"cannot build the host library csrc/eigkl_native.cpp: {e}"
        raise ImportError(_load_error) from e
    lib.ekl_read_hgr.restype = ctypes.POINTER(_EklHgr)
    lib.ekl_read_hgr.argtypes = [ctypes.c_char_p]
    lib.ekl_free_hgr.argtypes = [ctypes.POINTER(_EklHgr)]
    lib.ekl_clique_expand.restype = ctypes.POINTER(_EklCsr)
    lib.ekl_clique_expand.argtypes = [
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
    ]
    lib.ekl_free_csr.argtypes = [ctypes.POINTER(_EklCsr)]
    lib.ekl_benes_route.restype = ctypes.c_int32
    lib.ekl_benes_route.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the host library builds and loads here."""
    try:
        _load()
        return True
    except ImportError:
        return False


def read_hgr_native(path: str):
    """Parse a .hgr with the native tokenizer; returns Hypergraph."""
    from eig_kl_tpu_torch.io.hgr import Hypergraph

    lib = _load()
    h = lib.ekl_read_hgr(path.encode())
    try:
        if not h or h.contents.status != 0:
            code = h.contents.status if h else -1
            raise OSError(f"native .hgr parse failed (status {code}): {path}")
        c = h.contents
        pins = np.ctypeslib.as_array(c.pins, shape=(max(c.num_pins, 1),))[
            : c.num_pins
        ].copy()
        offs = np.ctypeslib.as_array(c.net_offsets, shape=(c.num_nets + 1,)).copy()
        return Hypergraph(
            num_nodes=int(c.num_nodes),
            num_nets=int(c.num_nets),
            pins=pins.astype(np.int32),
            net_offsets=offs.astype(np.int64),
        )
    finally:
        if h:
            lib.ekl_free_hgr(h)


def clique_expand_native(hg, weighting: str, dtype=np.float64):
    """Clique expansion via the native builder; returns Graph."""
    from eig_kl_tpu_torch.graph.csr import Graph

    lib = _load()
    mode = 0 if weighting == "eig" else 1
    pins = np.ascontiguousarray(hg.pins, dtype=np.int32)
    offs = np.ascontiguousarray(hg.net_offsets, dtype=np.int64)
    c = lib.ekl_clique_expand(
        hg.num_nodes,
        hg.num_nets,
        pins.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        mode,
    )
    try:
        if not c or c.contents.status != 0:
            raise OSError("native clique expansion failed")
        s = c.contents
        indptr = np.ctypeslib.as_array(s.indptr, shape=(s.n + 1,)).copy()
        nnz = int(s.nnz)
        indices = np.ctypeslib.as_array(s.indices, shape=(max(nnz, 1),))[:nnz].copy()
        data = np.ctypeslib.as_array(s.data, shape=(max(nnz, 1),))[:nnz].copy()
        return Graph(
            num_nodes=int(s.n),
            indptr=indptr.astype(np.int64),
            indices=indices.astype(np.int32),
            data=data.astype(dtype),
        )
    finally:
        if c:
            lib.ekl_free_csr(c)


def benes_route_native(N: int, dest: np.ndarray) -> np.ndarray:
    """Benes switch bits for out[dest[j]] = in[j]; (2*log2(N)-1, N/32)
    uint32, flat little-endian bit packing."""
    lib = _load()
    m = N.bit_length() - 1
    if (1 << m) != N or N < 32:
        raise ValueError(f"N must be a power of two >= 32, got {N}")
    d = np.ascontiguousarray(dest, dtype=np.int32)
    if d.shape != (N,) or d.min() < 0 or d.max() >= N or np.unique(d).size != N:
        raise ValueError(f"dest must be a permutation of range({N})")
    masks = np.zeros((2 * m - 1, N // 32), np.uint32)
    st = lib.ekl_benes_route(
        N,
        d.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        masks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    if st != 0:
        raise OSError(f"benes route failed (status {st})")
    return masks
