"""The port's v3 SpMV on the CPU against the JAX package's: the Benes
router, the plan, each of the three kernels (the TPU kernels in interpret
mode, the port's plain versions), the whole SpMV bit for bit, the padded
power solve's sums, and the v3-planned fused pipeline end to end.
"""

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401  (autouse: PyTorch on one thread)

from conftest import random_hypergraph

REPO = pathlib.Path(__file__).resolve().parent.parent
GEN_002 = str(REPO / "benchmarks" / "data" / "gen_0.02_42.hgr")


def _bits(a) -> np.ndarray:
    """int32 view of an f32 array: equal views mean equal values with
    equal zero signs."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _coo(g):
    """``(n, rows, cols, f32 weights)`` of a host graph, as the JAX
    package's callers hand them to ``build_plan_v3``."""
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), np.diff(g.indptr))
    return g.num_nodes, rows, g.indices.astype(np.int64), g.data.astype(np.float32)


def _gen002():
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import read_hgr

    return clique_expand(read_hgr(GEN_002, use_native=False), "kl", use_native=False)


def _random():
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import Hypergraph

    hg = random_hypergraph(np.random.default_rng(3), num_nodes=700, num_nets=900, max_net=7)
    hg = Hypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets)
    return clique_expand(hg, "kl", use_native=False)


def _hub():
    """2,000 nodes: a sparse random graph plus node 700 joined to 1,300
    others, so that row 700 (degree > 1,024) spans at least three chunks."""
    from eig_kl_tpu_torch.graph.csr import Graph

    rng = np.random.default_rng(7)
    n, hub = 2000, 700
    u, v = rng.integers(0, n, 6000), rng.integers(0, n, 6000)
    others = rng.choice(np.delete(np.arange(n), hub), 1300, replace=False)
    u, v = np.concatenate([u, np.full(1300, hub)]), np.concatenate([v, others])
    keep = u != v
    key = np.unique(np.minimum(u, v)[keep] * n + np.maximum(u, v)[keep])
    w = rng.uniform(0.1, 1.0, key.size).astype(np.float32).astype(np.float64)
    g = Graph.from_upper_coo(n, key // n, key % n, w)
    assert g.degrees[hub] > 1024
    return g


GRAPHS = {"gen_0.02": _gen002, "random": _random, "hub": _hub}


@functools.lru_cache(maxsize=None)
def _plans(kind):
    """(host graph, JAX plan, the port's plan on the CPU) of one graph."""
    from eig_kl_tpu.ops import spmv_pallas as SP
    from eig_kl_tpu_torch.ops import spmv_v3 as V

    g = GRAPHS[kind]()
    return g, SP.build_plan_v3(*_coo(g)), V.build_plan_v3(*_coo(g), "cpu")


def _port_of(jplan):
    from eig_kl_tpu_torch.ops.spmv_v3 import plan_v3_from_jax

    leaves, aux = jplan.tree_flatten()
    return plan_v3_from_jax(*(np.asarray(a) for a in leaves), *aux, device="cpu")


def _state(n, P, seed):
    """A padded f32 state with some -0.0 entries and zero padding."""
    x = np.zeros(P, np.float32)
    x[:n] = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[: n : 37] = -0.0
    return x


# ----------------------------------------------------------------- router


@pytest.mark.parametrize("N", [32, 256, 4096, 1 << 15])
def test_router_words_equal_the_jax_router(N):
    from eig_kl_tpu.io import native_io as jax_native
    from eig_kl_tpu_torch.io import native_io

    dest = np.random.default_rng(N).permutation(N).astype(np.int32)
    got = native_io.benes_route_native(N, dest)
    assert got.dtype == np.uint32 and got.shape == (2 * (N.bit_length() - 1) - 1, N // 32)
    np.testing.assert_array_equal(got, jax_native.benes_route_native(N, dest))


def test_router_rejects_what_it_cannot_route():
    from eig_kl_tpu_torch.io import native_io

    with pytest.raises(ValueError, match="power of two"):
        native_io.benes_route_native(48, np.arange(48, dtype=np.int32))
    with pytest.raises(ValueError, match="permutation"):
        native_io.benes_route_native(64, np.zeros(64, np.int32))


# ------------------------------------------------------------------- plan


@pytest.mark.parametrize("kind", ["gen_0.02", "random"])
def test_plan_equals_the_jax_plan(kind):
    _, jplan, plan = _plans(kind)
    ported = _port_of(jplan)
    for f in dataclasses.fields(plan):
        a, b = getattr(plan, f.name), getattr(ported, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name
    assert plan.masks.shape == (2 * plan.padded_nnz.bit_length() - 3, plan.padded_nnz // 32)


def test_plan_raises_as_the_jax_plan_does():
    from eig_kl_tpu.ops import spmv_pallas as SP
    from eig_kl_tpu_torch.ops import spmv_v3 as V

    # More than BENES_MAX slots.
    rows = np.repeat(np.arange(4096, dtype=np.int64), 513)
    cols = np.tile(np.arange(513, dtype=np.int64), 4096)
    w = np.ones(rows.size, np.float32)
    for build in (SP.build_plan_v3, functools.partial(V.build_plan_v3, device="cpu")):
        with pytest.raises(ValueError, match="exceeds BENES_MAX"):
            build(4096, rows, cols, w)
    # A chunk whose rows lie more than 1,024 apart (a run of empty rows).
    rows = np.concatenate([np.arange(10), np.arange(4000, 4010)]).astype(np.int64)
    cols = rows[::-1].copy()
    w = np.ones(20, np.float32)
    for build in (SP.build_plan_v3, functools.partial(V.build_plan_v3, device="cpu")):
        with pytest.raises(ValueError, match="row indices"):
            build(5000, rows, cols, w)


# ---------------------------------------------------------------- kernels


def _jax_gather(jplan, x):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from eig_kl_tpu.ops import spmv_pallas as SP

    C, R, G = jplan.col_local.shape[0], jplan.padded_nodes // 128, SP.GB3
    return pl.pallas_call(
        SP._gather_v3_kernel,
        out_shape=jax.ShapeDtypeStruct((C * 4, 128), jnp.float32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(C // G,),
            in_specs=[
                pl.BlockSpec((R, 128), lambda c, *_: (0, 0), memory_space=pltpu.VMEM),
                pl.BlockSpec((G, 4, 128), lambda c, *_: (c, 0, 0)),
                pl.BlockSpec((G, 4, 128), lambda c, *_: (c, 0, 0)),
            ],
            out_specs=pl.BlockSpec((G * 4, 128), lambda c, *_: (c, 0)),
        ),
        interpret=True,
    )(jplan.cw8, jnp.asarray(x.reshape(R, 128)), jplan.col_local, jplan.weights)


def _jax_benes(masks, e):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from eig_kl_tpu.ops import spmv_pallas as SP

    N = e.size
    Rn = N // 128
    return pl.pallas_call(
        functools.partial(SP._benes_kernel, n_pad=N),
        out_shape=jax.ShapeDtypeStruct((Rn, 128), jnp.float32),
        in_specs=[
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[
            pltpu.VMEM((2, Rn // 32, 128), jnp.int32),
            pltpu.SemaphoreType.DMA((2,)),
        ],
        input_output_aliases={1: 0},
        interpret=True,
    )(jnp.asarray(masks), jnp.asarray(np.asarray(e).reshape(Rn, 128)))


def _jax_reduce(jplan, e):
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    from eig_kl_tpu.ops import spmv_pallas as SP

    C, R, G = jplan.col_local.shape[0], jplan.padded_nodes // 128, SP.GB3
    return pl.pallas_call(
        SP._reduce_v3_kernel,
        out_shape=jax.ShapeDtypeStruct((R, 128), jnp.float32),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(C // G,),
            in_specs=[
                pl.BlockSpec((G * 4, 128), lambda c, *_: (c, 0)),
                pl.BlockSpec((G, 4, 128), lambda c, *_: (c, 0, 0)),
                pl.BlockSpec((G, 8, 128), lambda c, *_: (c, 0, 0)),
            ],
            out_specs=pl.BlockSpec((R, 128), lambda c, *_: (0, 0), memory_space=pltpu.VMEM),
        ),
        interpret=True,
    )(jplan.rw8, jnp.asarray(np.asarray(e).reshape(-1, 128)), jplan.row_local, jplan.route_src)


@pytest.mark.parametrize("kind", ["gen_0.02", "hub"])
def test_gather_and_reduce_equal_the_tpu_kernels(kind):
    from eig_kl_tpu_torch.ops import spmv_v3 as V

    g, jplan, plan = _plans(kind)
    x = _state(g.num_nodes, plan.padded_nodes, 1)
    e = V.gather_v3_plain(plan, torch.as_tensor(x))
    np.testing.assert_array_equal(_bits(e), _bits(_jax_gather(jplan, x)).reshape(-1))
    # The reduce on products in CSR order, some of them -0.0.
    e_csr = np.random.default_rng(2).standard_normal(plan.padded_nnz).astype(np.float32)
    e_csr[::53] = -0.0
    y = V.reduce_v3_plain(plan, torch.as_tensor(e_csr))
    np.testing.assert_array_equal(_bits(y), _bits(_jax_reduce(jplan, e_csr)).reshape(-1))


def test_benes_equals_the_tpu_kernel():
    """As ``tests/test_pallas_kernels.py`` calls the Benes kernel: N =
    8,192, a random permutation, switch bits from the router."""
    from eig_kl_tpu.ops import spmv_pallas as SP
    from eig_kl_tpu_torch.ops import spmv_v3 as V
    from eig_kl_tpu_torch.io import native_io

    N = 8192
    rng = np.random.default_rng(0)
    dest = rng.permutation(N).astype(np.int32)
    x = rng.standard_normal(N).astype(np.float32)
    x[::11] = -0.0
    tpu_masks = SP._benes_masks(dest)
    masks = V.unpack_tpu_masks(tpu_masks)
    np.testing.assert_array_equal(masks, native_io.benes_route_native(N, dest).view(np.int32))
    got = V.benes_v3_plain(torch.as_tensor(masks), torch.as_tensor(x))
    np.testing.assert_array_equal(_bits(got), _bits(_jax_benes(tpu_masks, x)).reshape(-1))
    exp = np.empty(N, np.float32)
    exp[dest] = x
    np.testing.assert_array_equal(_bits(got), _bits(exp))


@pytest.mark.parametrize("kind", ["gen_0.02", "hub"])
def test_spmv_v3_equals_spmv_pallas_bitwise(kind):
    from eig_kl_tpu.ops import spmv_pallas as SP
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.ops import spmv_v3 as V
    from eig_kl_tpu_torch.ops.spmv import spmv

    g, jplan, plan = _plans(kind)
    n = g.num_nodes
    x = _state(n, n, 3)
    ref = np.asarray(SP.spmv_pallas(jplan, jnp.asarray(x), interpret=True))
    got = V.spmv_v3(plan, torch.as_tensor(x))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    # The dispatch: an f32 graph with a plan takes the v3 route.
    gd = dataclasses.replace(Graph.from_arrays(g.indptr, g.indices, g.data).to_device("cpu"), plan=plan)
    np.testing.assert_array_equal(_bits(spmv(gd, torch.as_tensor(x))), _bits(ref))
    if kind == "hub":
        # Row 700 crosses at least two chunk boundaries.
        lo, hi = g.indptr[700], g.indptr[701]
        assert hi // V.CHUNK - lo // V.CHUNK >= 2


# ------------------------------------------------------- K3b's grouping


def _benes_tiled(masks, e, groups):
    """K3b's launches emulated tile by tile, in the kernel's layout: for
    each group, block b's tile position i holds slot ``(i // run) * tile +
    b * run + i % run``; its switch bit is bit ``i % 32`` of the tile's
    word ``i // 32``, loaded from the word of the slot at ``32 * (i //
    32)``; a stage at distance d exchanges tile positions at distance d
    (d < tile) or ``d // tile * run``."""
    from eig_kl_tpu_torch.ops.spmv_v3 import benes_distances

    dists = benes_distances(e.numel())
    shifts = torch.arange(32, dtype=torch.int32)
    out = e.clone()
    for gr in groups:
        blocks = e.numel() // gr.tile
        i = torch.arange(gr.tile)
        slot = (i // gr.run) * gr.tile + torch.arange(blocks)[:, None] * gr.run + i % gr.run
        tile = out[slot]
        for s in range(gr.first, gr.last + 1):
            d = dists[s]
            dt = d if d < gr.tile else d // gr.tile * gr.run
            words = masks[s][slot[:, ::32] // 32]
            bits = ((words[..., None] >> shifts) & 1).reshape(blocks, gr.tile).bool()
            partner = tile.view(blocks, -1, 2, dt).flip(2).reshape(blocks, gr.tile)
            tile = torch.where(bits, partner, tile)
        out[slot] = tile
    return out


@pytest.mark.parametrize(
    "m, tile",
    [(m, 1 << 14) for m in (5, 12, 13, 14, 17, 21)]
    + [(m, 1 << 13) for m in (13, 14, 17, 21)]
    + [(m, 1 << 11) for m in (5, 12, 17)],
)
def test_benes_groups_in_the_kernel_layout_equal_the_plain_network(m, tile):
    """Random switch bits (not a permutation: each position decides
    alone), some values -0.0: the groups cover every stage once, in order,
    and the tiled emulation equals ``benes_v3_plain`` bit for bit."""
    from eig_kl_tpu_torch.ops import spmv_v3 as V

    N = 1 << m
    groups = V.benes_groups(N, tile)
    stages = [s for gr in groups for s in range(gr.first, gr.last + 1)]
    assert stages == list(range(2 * m - 1))
    assert len(groups) == (1 if N <= tile else 3)
    assert all(gr.run % 32 == 0 and gr.tile == min(N, tile) for gr in groups)
    rng = np.random.default_rng(m)
    masks = torch.as_tensor(rng.integers(0, 2**32, (2 * m - 1, N // 32), dtype=np.uint32).view(np.int32))
    x = rng.standard_normal(N).astype(np.float32)
    x[::13] = -0.0
    e = torch.as_tensor(x)
    got = _benes_tiled(masks, e, groups)
    np.testing.assert_array_equal(_bits(got), _bits(V.benes_v3_plain(masks, e)))


def test_benes_groups_route_the_gen002_plan():
    """The plan's own switch bits: the tiled emulation moves every product
    to its CSR slot, as the plain network does."""
    from eig_kl_tpu_torch.ops import spmv_v3 as V

    _, _, plan = _plans("gen_0.02")
    N = plan.padded_nnz
    groups = V.benes_groups(N)
    assert N > V.BENES_TILE and len(groups) == 3
    e = V.gather_v3_plain(plan, torch.as_tensor(_state(4038, plan.padded_nodes, 5)))
    np.testing.assert_array_equal(
        _bits(_benes_tiled(plan.masks, e, groups)), _bits(V.benes_v3_plain(plan.masks, e))
    )


def _k3c_first_segment_end(ec, src, used):
    """K3c's warp 0 on the first segment (positions 0..src) of a chunk's
    products ``ec``: in registers up to 32 slots (steps 32..256 add +0),
    else the whole loop over the segment's slots."""
    f0 = np.float32(0.0)
    if src < 32:
        used.add("registers")
        lane = np.arange(32)
        v = np.where(lane <= src, ec[:32], f0)
        for k in (1, 2, 4, 8, 16):
            v = v + np.where(lane >= k, np.roll(v, k), f0)
        for _ in (32, 64, 128, 256):
            v = v + f0
        return v[src]
    used.add("scratch")
    cur = ec[: src + 1].copy()
    j = np.arange(src + 1)
    for k in (1, 2, 4, 8, 16, 32, 64, 128, 256):
        shifted = np.zeros_like(cur)
        shifted[k:] = cur[:-k]
        cur = cur + np.where(j >= k, shifted, f0)
    return cur[src]


def _k3c_kernel_layout(plan, e, used):
    """K3c as the kernel runs it, in NumPy: per chunk steps 1..16 within
    each warp of 32 slots, each lane holding its slot and the one 32 below
    it (row -1 below the chunk), then steps 32..256 over the chunk; rows in
    one chunk written by it, a crossing row summed in chunk order by the
    chunk where it starts, from the following chunks' first segments
    alone."""
    f0 = np.float32(0.0)
    C = plan.num_chunks
    ev = e.numpy().reshape(C, 512)
    rl = plan.row_local.numpy().reshape(C, 512).astype(np.int32)
    route = plan.route_src.numpy().reshape(C, 1024).astype(np.int64)
    base = 128 * plan.rw8.numpy().astype(np.int64)
    hi, rhi = ev.reshape(C, 16, 32).copy(), rl.reshape(C, 16, 32)
    lo, rlo = np.zeros_like(hi), np.full_like(rhi, -1)
    lo[:, 1:], rlo[:, 1:] = hi[:, :-1], rhi[:, :-1]
    lane = np.arange(32)
    for k in (1, 2, 4, 8, 16):
        src = (lane - k) & 31
        hi_s, lo_s, rhi_s, rlo_s = hi[..., src], lo[..., src], rhi[..., src], rlo[..., src]
        in_warp = lane >= k
        up, r_up = np.where(in_warp, hi_s, lo_s), np.where(in_warp, rhi_s, rlo_s)
        hi, lo = hi + np.where(r_up == rhi, up, f0), lo + np.where(in_warp & (rlo_s == rlo), lo_s, f0)
    v = hi.reshape(C, 512)
    for k in (32, 64, 128, 256):
        same = np.zeros((C, 512), bool)
        same[:, k:] = rl[:, :-k] == rl[:, k:]
        shifted = np.zeros_like(v)
        shifted[:, k:] = v[:, :-k]
        v = v + np.where(same, shifted, f0)

    def valid(c):
        return route[c, rl[c, 511]] >= 0

    y = np.zeros(plan.padded_nodes, np.float32)
    for c in range(C):
        if not valid(c):
            continue
        head, tail = base[c] + rl[c, 0], base[c] + rl[c, 511]
        head_cont = c > 0 and base[c - 1] + rl[c - 1, 511] == head
        tail_cont = c + 1 < C and valid(c + 1) and base[c + 1] + rl[c + 1, 0] == tail
        for r in np.flatnonzero(route[c] >= 0):
            row = base[c] + r
            if not ((head_cont and row == head) or (tail_cont and row == tail)):
                y[row] = f0 + v[c, route[c, r]]
        if tail_cont and not (head_cont and head == tail):
            acc, cc = f0 + v[c, 511], c + 1
            while True:
                src = route[cc, tail - base[cc]]
                acc = acc + (f0 + _k3c_first_segment_end(ev[cc], src, used))
                if not (src == 511 and cc + 1 < C and valid(cc + 1) and base[cc + 1] + rl[cc + 1, 0] == tail):
                    break
                used.add("three chunks or more")
                cc += 1
            y[tail] = acc
    return y


@pytest.mark.parametrize(
    "kind, branches",
    [
        ("gen_0.02", {"registers"}),
        ("random", {"registers", "scratch"}),
        ("hub", {"registers", "scratch", "three chunks or more"}),
    ],
)
@pytest.mark.parametrize("seed", [0, 1])
def test_k3c_in_the_kernel_layout_equals_the_plain_reduce(kind, branches, seed):
    """K3c's warp steps with their halo and its first-segment scans of the
    following chunks, emulated, equal ``reduce_v3_plain`` bit for bit on
    gen 0.02x, the 700-node random graph and the hub graph (a row of
    degree 1,300 over three chunks or more), with -0 products: scattered,
    and whole rows of them (their sums turn +0 only through the scan's +0
    adds).  ``branches``: the first-segment scans each graph takes (in
    registers up to 32 slots, in the scratch buffer beyond, a row over
    three chunks or more)."""
    from eig_kl_tpu_torch.ops import spmv_v3 as V

    g, _, plan = _plans(kind)
    rows = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    x = np.random.default_rng(seed).standard_normal(plan.padded_nnz).astype(np.float32)
    x[seed::53] = -0.0
    x[: rows.size][rows % 17 == seed] = -0.0
    e = torch.as_tensor(x)
    used = set()
    np.testing.assert_array_equal(_bits(_k3c_kernel_layout(plan, e, used)), _bits(V.reduce_v3_plain(plan, e)))
    assert used == branches


def test_benes_wrapper_refuses_what_the_tiles_cannot_hold():
    """m <= 2t - 5: 2^21 slots fit tiles of 2^13, not 2^22; 2^23 fit the
    kernel's tiles of 2^14, not 2^24; 2^14 slots do not fit tiles of 2^9.
    The wrapper refuses before it looks at the device."""
    from eig_kl_tpu_torch.ops import spmv_v3 as V

    assert V.BENES_TILE == 1 << 14
    assert [len(V.benes_groups(N)) for N in (V.BENES_MAX, 1 << 23)] == [3, 3]
    assert V.benes_groups(V.BENES_MAX)[0].run == 128
    assert len(V.benes_groups(V.BENES_MAX, 1 << 13)) == 3
    with pytest.raises(ValueError, match="2t - 5 = 21"):
        V.benes_groups(2 * V.BENES_MAX, 1 << 13)
    with pytest.raises(ValueError, match="2t - 5 = 23"):
        V.benes_groups(1 << 24)
    with pytest.raises(ValueError, match="power"):
        V.benes_groups(3 << 12)
    masks = torch.zeros(27, (1 << 14) // 32, dtype=torch.int32)
    before = V.K3B.launches
    with pytest.raises(ValueError, match="2t - 5 = 13"):
        V.benes_v3_cuda(masks, torch.zeros(1 << 14), _tile=1 << 9)
    with pytest.raises(ValueError, match="CUDA"):
        V.benes_v3_cuda(masks, torch.zeros(1 << 14), _tile=1 << 10)
    assert V.K3B.launches == before


# ------------------------------------------------------ padded power solve


@pytest.mark.parametrize("rows", [8, 32, 192, 1584])
def test_padded_norm_equals_jnp_linalg_norm(rows):
    """The power solve's norm of its ``(P/128, 128)`` state, in XLA's
    order for a 2-D reduction (1,584 rows: gen 1.0x; 32: gen 0.02x)."""
    from eig_kl_tpu_torch.ops.reduce import tree_norm_2d

    rng = np.random.default_rng(rows)
    norm = jax.jit(jnp.linalg.norm)
    for _ in range(4):
        x = _state(rows * 128 - int(rng.integers(0, 1000)), rows * 128, int(rng.integers(1 << 30)))
        x *= rng.uniform(0.1, 10.0, x.size).astype(np.float32)
        x2d = x.reshape(rows, 128)
        got = tree_norm_2d(torch.as_tensor(x2d))
        assert got.dtype == torch.float32
        assert _bits(got) == _bits(norm(jnp.asarray(x2d)))


@pytest.mark.parametrize("P", [4096, 202752])
def test_padded_dot_equals_jnp_vdot(P):
    """The Rayleigh quotient's dot over the padded state: XLA's vector dot
    is one chain of fused multiply-adds."""
    from eig_kl_tpu_torch.ops.reduce import fma_dot

    x, y = _state(P - 58, P, 5), _state(P - 58, P, 6)
    got = fma_dot(torch.as_tensor(x), torch.as_tensor(y))
    ref = jax.jit(jnp.vdot)(jnp.asarray(x.reshape(-1, 128)), jnp.asarray(y.reshape(-1, 128)))
    assert _bits(got) == _bits(ref)


def test_padded_norm_order_differs_where_xla_vectorizes_its_last_block():
    """Between 32 and 1,024 rows the last block is ``(k, 4)``; at k = 4
    (128 rows) XLA's final reduce is vectorized across rows, an order other
    than row-major: ``tree_sum_2d`` takes it (ROADMAP.md C6), and the sums
    equal XLA's on the same 40 seeded inputs, bit for bit."""
    from eig_kl_tpu_torch.ops.reduce import last_block_lanes, tree_norm_2d

    assert last_block_lanes((128, 128)) == 4
    rng = np.random.default_rng(128)
    norm = jax.jit(jnp.linalg.norm)
    for _ in range(40):
        x2d = (_state(128 * 128, 128 * 128, int(rng.integers(1 << 30))) * rng.uniform(
            0.1, 10.0, 128 * 128).astype(np.float32)).reshape(128, 128)
        assert _bits(tree_norm_2d(torch.as_tensor(x2d))) == _bits(norm(jnp.asarray(x2d)))


@pytest.mark.parametrize("k", range(2, 33))
def test_padded_norm_equals_xla_at_every_last_block(k):
    """Every last block ``(k, 4)`` of 33 to 1,024 rows, vectorized by XLA
    or not (``ops/reduce.py:_LAST_BLOCK_LANES``): the norm of two seeded
    states of ``32 k - r`` rows equals ``jnp.linalg.norm``'s bits."""
    from eig_kl_tpu_torch.ops.reduce import tree_norm_2d

    rng = np.random.default_rng(1000 + k)
    norm = jax.jit(jnp.linalg.norm)
    for _ in range(2):
        rows = 32 * k - int(rng.integers(0, 32))
        x2d = (rng.standard_normal((rows, 128)) * rng.uniform(0.1, 10.0, (rows, 128))).astype(np.float32)
        assert _bits(tree_norm_2d(torch.as_tensor(x2d))) == _bits(norm(jnp.asarray(x2d)))


def test_fma_dot_runs_the_host_chain_for_cpu_tensors_only():
    """On the CPU ``fma_dot`` is the host chain; K4's wrapper refuses a
    tensor that is not on the card and launches nothing."""
    from eig_kl_tpu_torch.ops.reduce import K4, fma_dot, fma_dot_cuda, fma_dot_plain

    x, y = torch.as_tensor(_state(4000, 4096, 7)), torch.as_tensor(_state(4000, 4096, 8))
    before = K4.launches
    assert _bits(fma_dot(x, y)) == _bits(fma_dot_plain(x, y))
    with pytest.raises(ValueError, match="CUDA"):
        fma_dot_cuda(x, y)
    assert K4.launches == before


@pytest.mark.parametrize("shift", [2.0, 3.0])
def test_v3_padded_power_steps_equal_the_jax_steps(shift):
    """The v3-planned f32 power solve on the padded state against the JAX
    package's (its v3 kernels in interpret mode), three steps, bit for
    bit.  At shift 3.0 the step's ``x - inv_shift * lap`` rounds once as
    XLA's fused multiply-add: rounding the product first (the port's padded
    step before) moved about half of the values by an ulp or more
    (ROADMAP.md C7)."""
    from eig_kl_tpu.graph.csr import Graph as JaxGraph
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.spectral.power import _power_core

    g, jplan, plan = _plans("gen_0.02")
    jdev = JaxGraph(g.num_nodes, g.indptr, g.indices, g.data).to_device()._replace(plan=jplan)
    gd = dataclasses.replace(Graph.from_arrays(g.indptr, g.indices, g.data).to_device("cpu"), plan=plan)
    kw = dict(shift=shift, tolerance=1e-6, min_iters=100, max_iters=3, seed=42, convergence="gkl2")
    lam_j, v_j, it_j = jax_core(jdev, dtype="float32", **kw)
    lam_t, v_t, it_t = _power_core(gd, dtype=torch.float32, **kw)
    assert int(it_j) == it_t == 3
    np.testing.assert_array_equal(_bits(v_t), _bits(v_j))
    assert float(lam_t) == float(lam_j)


def test_v3_padded_momentum_equals_the_jax_run():
    """The momentum exit on the padded state of a v3 plan (the lazy walk
    through the v3 SpMV, the deflation fused) against the JAX package's,
    through its first check, bit for bit.  The JAX package's dots take a
    slice of the padded state as their operand, which XLA fuses into the
    dot below 4,096 values: the port adds them in that loop's vectorized
    order (``fused_dot``, "lanes"; ROADMAP.md C9)."""
    from eig_kl_tpu.graph.csr import Graph as JaxGraph
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.spectral.power import _power_core

    g, jplan, plan = _plans("gen_0.02")
    jdev = JaxGraph(g.num_nodes, g.indptr, g.indices, g.data).to_device()._replace(plan=jplan)
    gd = dataclasses.replace(Graph.from_arrays(g.indptr, g.indices, g.data).to_device("cpu"), plan=plan)
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=6, seed=42, convergence="momentum",
              check_interval=5)
    _, v_j, it_j = jax_core(jdev, dtype="float32", **kw)
    _, v_t, it_t = _power_core(gd, dtype=torch.float32, **kw)
    assert int(it_j) == it_t == 6
    np.testing.assert_array_equal(_bits(v_t), _bits(v_j))


# ------------------------------------------------------------ the slice


@pytest.fixture(scope="module")
def v3_fused():
    """The v3-planned fused pipeline on gen 0.02x: the JAX package's
    (interpret mode) and the port's (on the CPU)."""
    from eig_kl_tpu.kl.megakernel import MegaGraph, fused_refine_mega as jax_fused
    from eig_kl_tpu.utils.config import KLConfig as JaxKL, SpectralConfig as JaxSpec
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.kl.megakernel import fused_refine_mega
    from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig

    from eig_kl_tpu.graph.csr import Graph as JaxGraph

    g, jplan, plan = _plans("gen_0.02")
    jg = JaxGraph(g.num_nodes, g.indptr, g.indices, g.data)
    jdev = jg.to_device()._replace(plan=jplan)
    ref = jax_fused(MegaGraph(jg, plan=jplan, device_graph=jdev), jdev, JaxSpec(solver="power"),
                    JaxKL(gain_eps=1e-6), interpret=True)
    gd = dataclasses.replace(Graph.from_arrays(g.indptr, g.indices, g.data).to_device("cpu"), plan=plan)
    got = fused_refine_mega(gd, SpectralConfig(solver="power"), KLConfig(gain_eps=1e-6))
    return ref, got


def test_v3_fused_equals_the_jax_run(v3_fused):
    """Tolerance 0: the same power steps, eigenvalue, split and swaps."""
    (jeig, jkl), (eig, kl, iters) = v3_fused
    assert iters == 201
    assert eig.eigenvalue == jeig.eigenvalue == 1.2118805646896362
    np.testing.assert_array_equal(eig.sides, jeig.sides)
    assert int(eig.sides.sum()) == 1932
    np.testing.assert_array_equal(_bits(eig.values), _bits(jeig.values))
    assert kl.initial_cut == jkl.initial_cut == 1042.352294921875
    assert kl.best_cut == jkl.best_cut == 815.5189819335938
    assert kl.iterations == jkl.iterations == 171
    assert kl.final_cut == jkl.final_cut
    np.testing.assert_array_equal(kl.cut_trajectory, jkl.cut_trajectory)
    np.testing.assert_array_equal(kl.gain_trajectory, jkl.gain_trajectory)
    np.testing.assert_array_equal(kl.sides, jkl.sides)
    np.testing.assert_array_equal(kl.best_sides, jkl.best_sides)
    # The recount of the final partition: 0.25 * (wsum - s . A s) with the
    # dot in the order of XLA's loop with the signs fused in (ROADMAP.md
    # C5; the tree order landed 2.4e-4 lower).
    assert kl.verified_cut == jkl.verified_cut == 815.5191650390625


def test_mega_cut_equals_the_jax_batch_init():
    """The mega paths' from-scratch cut (``kl/megakernel.py:_batch_init``)
    against the JAX package's ``_batch_init`` (v3 SpMV in interpret mode)
    for 5 seeded states at once (two dot batches of K4's 4): ``A @ s`` and
    ``0.25 * (wsum - s . A s)`` bit for bit, the dot in XLA's fused loop
    order (ROADMAP.md C5)."""
    from eig_kl_tpu.graph.csr import Graph as JaxGraph
    from eig_kl_tpu.kl.megakernel import MegaGraph, _batch_init as jax_batch_init
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.kl.megakernel import _batch_init

    g, jplan, plan = _plans("gen_0.02")
    n, P = g.num_nodes, plan.padded_nodes
    mg = MegaGraph(JaxGraph(g.num_nodes, g.indptr, g.indices, g.data), plan=jplan)
    s = np.stack([_state(n, P, 40 + k) for k in range(5)])
    a2d, cut = jax_batch_init(mg.spmv_plan, mg.weighted_degrees.sum(), jnp.asarray(s.reshape(5, -1, 128)),
                              n=n, P=P, interp=True)
    gd = dataclasses.replace(Graph.from_arrays(g.indptr, g.indices, g.data).to_device("cpu"), plan=plan)
    st = torch.as_tensor(s[:, :n])
    a_s, got = _batch_init(gd, st)
    np.testing.assert_array_equal(_bits(a_s), _bits(np.asarray(a2d).reshape(5, -1)[:, :n]))
    np.testing.assert_array_equal(_bits(got), _bits(cut))


def test_v3_fused_differs_from_the_unplanned_run(v3_fused):
    """The v3 route is another summation order, so another run of the
    system, not K1's relabelled: without a plan the power solve lands on
    another eigenvalue."""
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.spectral.power import power_partition_fiedler
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    g, _, _ = _plans("gen_0.02")
    (_, _), (eig, _, _) = v3_fused
    gd = Graph.from_arrays(g.indptr, g.indices, g.data).to_device("cpu")
    lam = power_partition_fiedler(gd, SpectralConfig(solver="power"))[0]
    assert lam == pytest.approx(eig.eigenvalue, rel=1e-4) and lam != eig.eigenvalue
