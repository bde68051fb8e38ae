"""``spmv_v1_f32``'s design (``csrc/spmv_csr.cu``: a block per chunk, the
scan's steps 1..16 in each warp with a 32-slot halo and 32..256 in shared
memory, each chunk's totals spread over its window's 1,024 rows in a
scratch row, and the last block of a window adding those rows in plan
order) emulated on the CPU against ``spmv_v1_plain``, bit for bit: the only
check of that layout on a host without a card.  The module imports
neither JAX nor the JAX package; ``tests/test_torch_cuda.py`` takes its
layouts for the card.
"""

import os

import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401  (autouse: PyTorch on one thread)

GEN_002 = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "data", "gen_0.02_42.hgr")
V1_KINDS = ("gen_0.02", "crafted", "6000_tail")


def _crafted_coo():
    """4,096 nodes in four y windows, in CSR order.  Window 0 holds row 7
    alone, 600 entries in each of column stripes 0-2: six chunks, a segment
    of 512 slots in three of them, and row 7 ends in every one.  Window 1:
    random rows, and row 1,500 with 200 entries in stripe 3 (a segment of
    more than 32 slots).  Window 2: row 2,100 alone, 400 entries of weight
    -0 in stripe 1, one chunk.  Window 3 holds no entry."""
    rng = np.random.default_rng(16)
    parts = [(np.full(600, 7), s * 1024 + np.arange(600), rng.uniform(0.1, 1.0, 600)) for s in range(3)]
    r = rng.integers(1024, 2048, 3000)
    parts.append((r, rng.integers(0, 4096, 3000), rng.uniform(0.1, 1.0, 3000)))
    parts.append((np.full(200, 1500), 3072 + np.arange(0, 800, 4), rng.uniform(0.1, 1.0, 200)))
    parts.append((np.full(400, 2100), 1024 + np.arange(400), np.full(400, -0.0)))
    rows, cols, w = (np.concatenate(a) for a in zip(*parts))
    key, first = np.unique(rows * 4096 + cols, return_index=True)  # sorted: CSR order
    return 4096, key // 4096, key % 4096, w[first].astype(np.float32)


def _host_graph(kind):
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import Hypergraph, read_hgr

    if kind == "gen_0.02":
        return clique_expand(read_hgr(GEN_002), "kl")
    # tests/conftest.py:random_hypergraph(default_rng(21), 6000, 7800, 5)
    rng = np.random.default_rng(21)
    n, nets, max_net = 6000, 7800, 5
    sizes = rng.integers(2, max_net + 1, size=nets)
    pins = np.concatenate([rng.choice(n, size=k, replace=False) for k in sizes]).astype(np.int32)
    offs = np.zeros(nets + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])
    return clique_expand(Hypergraph(n, nets, pins, offs), "kl")


def v1_layout(kind, device):
    """A v1 layout of ``kind`` (:data:`V1_KINDS`) on ``device``: gen 0.02x's
    plan, the crafted matrix of :func:`_crafted_coo`, or the v1 tail of the
    6,000-node graph's v2 plan at row block 512."""
    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.ops.spmv_plan import V1Layout, build_v1_layout

    if kind == "crafted":
        return build_v1_layout(*_crafted_coo(), device)
    host = _host_graph(kind)
    if kind == "gen_0.02":
        return host.to_device(device).plan_layout
    tail = CsrPlan.for_graph(host.to_device(device), kernel="v2", rblock=512).layout.tail
    assert isinstance(tail, V1Layout)
    return tail


def v1_vector(lay, seed):
    """A seeded x of the layout's n values: normal values with -0 and +0
    among them, non-negative over the columns of the crafted matrix's -0
    row (so its products are -0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lay.num_nodes).astype(np.float32)
    x[::11] = -0.0
    x[5::13] = 0.0
    x[1024:1424] = np.abs(x[1024:1424])
    return torch.as_tensor(x)


def _warp_steps(e, r, lane):
    """Steps 1..16 of the segmented scan per warp, as
    ``seg_scan.cuh:warp_scan_steps`` runs them: ``e``, ``r`` of shape
    ``(C, 16, 32)``; each lane carries its slot and the one 32 below."""
    f0 = np.float32(0)
    lo = np.concatenate([np.zeros_like(e[:, :1]), e[:, :-1]], axis=1)
    rlo = np.concatenate([np.full_like(r[:, :1], -1), r[:, :-1]], axis=1)
    hi = e.copy()
    for k in (1, 2, 4, 8, 16):
        src = (lane - k) & 31
        hi_s, lo_s, rhi_s, rlo_s = hi[..., src], lo[..., src], r[..., src], rlo[..., src]
        in_warp = lane >= k
        up, r_up = np.where(in_warp, hi_s, lo_s), np.where(in_warp, rhi_s, rlo_s)
        hi = hi + np.where(r_up == r, up, f0)
        lo = lo + np.where(in_warp & (rlo_s == rlo), lo_s, f0)
    return hi


def _v1_kernel_layout(lay, x, rows, used):
    """y = A @ x as ``spmv_v1_kernel`` computes it (module docstring), in
    NumPy; ``used`` collects the paths taken."""
    n, C, W = lay.num_nodes, lay.num_chunks, lay.num_windows
    f0 = np.float32(0)
    ptr, order = lay.win_ptr.numpy().astype(np.int64), lay.win_chunks.numpy().astype(np.int64)
    xs = x.numpy()
    c = order  # block b takes the b-th chunk in plan order
    col = lay.x_base.numpy()[c][:, None].astype(np.int64) + lay.col_local.numpy()[c]
    g = np.where(col < n, xs[np.minimum(col, n - 1)], f0) + f0
    e = g * lay.weights.numpy()[c]
    r = lay.row_local.numpy()[c].astype(np.int64)
    v = _warp_steps(e.reshape(C, 16, 32), r.reshape(C, 16, 32), np.arange(32)).reshape(C, 512)
    for k in (32, 64, 128, 256):
        shifted = np.zeros_like(v)
        shifted[:, k:] = np.where(r[:, k:] == r[:, :-k], v[:, :-k], f0)
        v = v + shifted
    ends = np.ones((C, 512), bool)
    ends[:, :-1] = r[:, 1:] != r[:, :-1]
    if np.any(np.diff(np.flatnonzero(np.concatenate([[True], ends.reshape(-1)]))) > 32):
        used.add("segment over 32")
    if np.any(ends.sum(axis=1) == 1):
        used.add("segment of 512")
    totals = np.zeros((C, 1024), np.float32)
    b_idx, p_idx = np.nonzero(ends)
    totals[b_idx, r[b_idx, p_idx]] = v[b_idx, p_idx]
    y = np.full(W * 1024, np.nan, np.float32)
    for w in range(W):
        first, count = ptr[w], ptr[w + 1] - ptr[w]
        if count == 0:
            used.add("empty window")
            acc = np.zeros(1024, np.float32)
        elif count == 1:
            used.add("one chunk")
            acc = f0 + totals[first]
        else:
            used.add("ticket")
            acc = np.zeros(1024, np.float32)
            for i in range(count):
                acc = acc + totals[first + i]
            if np.any((totals[first : first + count] != 0).all(axis=0)):
                used.add("a row in every chunk")
        y[w * 1024 : (w + 1) * 1024] = acc
    return torch.as_tensor(y[:rows])


@pytest.mark.parametrize("kind, paths", [
    ("gen_0.02", {"ticket", "segment over 32"}),
    ("crafted", {"ticket", "one chunk", "empty window", "segment of 512", "segment over 32",
                 "a row in every chunk"}),
    ("6000_tail", {"ticket", "segment over 32"}),
])
def test_spmv_v1_design_equals_plain(kind, paths):
    """The emulated kernel equals ``spmv_v1_plain`` bit for bit, on x with
    -0 and +0 values (and the crafted matrix's row of -0 products), as n
    rows and as the padded state's P rows (its padding +0); ``paths``: the
    design's paths each layout takes."""
    from eig_kl_tpu_torch.ops.spmv_plan import spmv_v1_plain

    lay = v1_layout(kind, "cpu")
    n, P = lay.num_nodes, lay.padded_nodes
    used = set()
    for seed in (0, 1):
        x = v1_vector(lay, seed)
        want = spmv_v1_plain(lay, x)
        got = _v1_kernel_layout(lay, x, n, used)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        xp = torch.zeros(P)
        xp[:n] = x
        want_p = spmv_v1_plain(lay, xp.view(-1, 128)).reshape(-1)
        assert torch.equal(_v1_kernel_layout(lay, x, P, used).view(torch.int32), want_p.view(torch.int32))
    assert paths <= used
