"""The port's sharded KL pass (smega; kernel K5's plain version) against
the JAX package, on the CPU.

* 1 shard: ``smega_refine(device="cpu")`` against the JAX ``smega_refine``
  in interpret mode, on ``tests/test_smega.py``'s 61-node dyadic problem,
  at tolerance 0.
* 2, 4 and 8 shards: against the JAX XLA engine ``refine``, which
  ``tests/test_smega.py`` shows the JAX smega to equal bit for bit.  No
  multi-shard JAX interpret run here: one took 92.7 s on a small host, and
  8 shards can deadlock its thread pool (``tests/test_smega.py:8-16``).
* The shard runs K5 walks (each CSR row split by the shards' node ranges)
  against the JAX column-transpose layout, entry by entry.
* gen 0.02x from the port's f32 spectral split: the swaps equal across
  1/2/4/8 shards and equal the single-chip pass (K2's plain version).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_kl import dyadic_hypergraph

GEN_002 = os.path.join(
    os.path.dirname(__file__), "..", "benchmarks", "data", "gen_0.02_42.hgr"
)
FIELDS = ("initial_cut", "final_cut", "best_cut", "verified_cut", "iterations")


def _port_graph(g_jax):
    from eig_kl_tpu_torch.graph.csr import Graph

    return Graph.from_arrays(g_jax.indptr, g_jax.indices, g_jax.data)


@pytest.fixture(scope="module")
def dyadic():
    """tests/test_smega.py's problem: 61 nodes, 140 nets, dyadic weights."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.kl.init import random_split

    hg = dyadic_hypergraph(np.random.default_rng(21), num_nodes=61, num_nets=140)
    g = clique_expand(hg, "kl")
    return g, random_split(g.num_nodes, seed=9)


@pytest.fixture(scope="module")
def overflow():
    """tests/test_smega.py's graph with six 33-pin nets: columns of more
    than 15 entries per shard, the JAX layout's overflow level."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.io.hgr import Hypergraph
    from eig_kl_tpu.kl.init import random_split

    rng = np.random.default_rng(5)
    nn = 61
    sizes = np.concatenate([np.full(6, 33), rng.choice([2, 3, 5], size=80, p=[0.5, 0.3, 0.2])])
    pins = np.concatenate([rng.choice(nn, size=k, replace=False) for k in sizes]).astype(np.int32)
    offs = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=offs[1:])
    g = clique_expand(Hypergraph(num_nodes=nn, num_nets=len(sizes), pins=pins, net_offsets=offs), "kl")
    return g, random_split(nn, seed=3)


def _jax_refine(g, sides, max_iterations=None):
    from eig_kl_tpu.kl.engine import refine
    from eig_kl_tpu.utils.config import KLConfig

    return refine(g.to_device(dtype=jnp.float32), sides, KLConfig(max_iterations=max_iterations))


def _assert_same(got, ref):
    for name in FIELDS:
        assert getattr(got, name) == getattr(ref, name), name
    for name in ("cut_trajectory", "gain_trajectory", "sides", "best_sides"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)), name)


def _assert_same_run(got, ref):
    """The fields the XLA engine shares with smega (its verified cut is a
    device recount, not the host f64 one)."""
    assert got.iterations == ref.iterations
    for name in ("cut_trajectory", "gain_trajectory", "sides", "best_sides"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)), np.asarray(getattr(ref, name)), name)
    assert got.verified_cut == got.final_cut  # dyadic weights: every sum is exact


def test_one_shard_equals_jax_smega_interpret(dyadic):
    from eig_kl_tpu.parallel.mesh import make_mesh
    from eig_kl_tpu.parallel.smega import smega_refine as jax_smega
    from eig_kl_tpu.utils.config import KLConfig as JaxKL
    from eig_kl_tpu_torch.parallel.smega import smega_refine
    from eig_kl_tpu_torch.utils.config import KLConfig

    g, sides = dyadic
    ref = jax_smega(g, sides, make_mesh(1), JaxKL(), interpret=True)
    got = smega_refine(_port_graph(g), sides, 1, KLConfig(), device="cpu")
    assert got.iterations > 10
    _assert_same(got, ref)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_equals_jax_refine(dyadic, n_shards):
    from eig_kl_tpu_torch.parallel.smega import smega_refine
    from eig_kl_tpu_torch.utils.config import KLConfig

    g, sides = dyadic
    got = smega_refine(_port_graph(g), sides, n_shards, KLConfig(), device="cpu", align=128)
    _assert_same_run(got, _jax_refine(g, sides))


@pytest.mark.parametrize("n_shards", [1, 2])
def test_overflow_columns_equal_jax_refine(overflow, n_shards):
    from eig_kl_tpu.parallel.smega import _build_colT
    from eig_kl_tpu_torch.parallel.smega import smega_refine
    from eig_kl_tpu_torch.utils.config import KLConfig

    g, sides = overflow
    align = 128 if n_shards > 1 else 1024
    oi = _build_colT(g, align * n_shards, n_shards)[2]
    assert (oi[:, :, 0] > 0).any(), "the JAX layout must overflow, or this case is vacuous"
    got = smega_refine(_port_graph(g), sides, n_shards, KLConfig(), device="cpu", align=align)
    _assert_same_run(got, _jax_refine(g, sides))


@pytest.mark.parametrize("cap", [0, 1, 7])
def test_cap_equals_jax_refine(dyadic, cap):
    from eig_kl_tpu_torch.parallel.smega import smega_refine
    from eig_kl_tpu_torch.utils.config import KLConfig

    g, sides = dyadic
    got = smega_refine(
        _port_graph(g), sides, 2, KLConfig(max_iterations=cap), device="cpu", align=128
    )
    assert got.iterations == cap
    _assert_same_run(got, _jax_refine(g, sides, max_iterations=cap))


def test_plan_reuse_and_shard_count_mismatch(dyadic):
    from eig_kl_tpu.kl.init import random_split
    from eig_kl_tpu_torch.parallel.smega import SmegaPlan, smega_refine
    from eig_kl_tpu_torch.utils.config import KLConfig

    g, sides = dyadic
    pg = _port_graph(g)
    plan = SmegaPlan(pg, 2, align=128)
    for split in (sides, random_split(g.num_nodes, seed=17)):
        with_plan = smega_refine(pg, split, 2, KLConfig(), device="cpu", plan=plan)
        _assert_same(with_plan, smega_refine(pg, split, 2, KLConfig(), device="cpu", align=128))
        _assert_same_run(with_plan, _jax_refine(g, split))
    assert len(plan._dev) == 1  # one upload served both calls
    with pytest.raises(ValueError, match="2 shards"):
        smega_refine(pg, sides, 4, KLConfig(), device="cpu", plan=plan)


def _jax_colT_entries(g, n_pad, n_shards):
    """Every (shard, column) run of the JAX layout: {(d, v): (local rows,
    weights)}, read back from the dense level and the overflow level."""
    from eig_kl_tpu.parallel.smega import _build_colT

    ci, cw, oi, ow = _build_colT(g, n_pad, n_shards)
    runs = {}
    for d in range(n_shards):
        for v in range(n_pad):
            r, base = v // 8, (v % 8) * 16
            c = int(ci[d, r, base])
            dense = c if c <= 15 else 14
            idx = list(ci[d, r, base + 1: base + 1 + dense])
            w = list(cw[d, r, base + 1: base + 1 + dense])
            if c > 15:
                o = int(ci[d, r, base + 15])
                t = int(oi[d, o, 0])
                assert t == c - 14
                idx += list(oi[d, o, 1: 1 + t])
                w += list(ow[d, o, 1: 1 + t])
            runs[d, v] = (np.asarray(idx, np.int64), np.asarray(w, np.float32))
    return runs


@pytest.mark.parametrize(
    "graph,n_shards,align", [("dyadic", 1, 1024), ("dyadic", 4, 128), ("dyadic", 8, 128),
                             ("overflow", 1, 1024), ("overflow", 2, 128)],
)
def test_split_table_equals_build_colT(request, graph, n_shards, align):
    """Shard d's entries of CSR row v (those K5's block d keeps: columns in
    d's node range) are the JAX layout's column v of shard d, in the same
    order, overflow columns included; padded columns are empty in both."""
    from eig_kl_tpu_torch.parallel.smega import SmegaPlan

    g, _ = request.getfixturevalue(graph)
    plan = SmegaPlan(_port_graph(g), n_shards, align)
    runs = _jax_colT_entries(g, plan.n_pad, n_shards)
    assert len(runs) == n_shards * plan.n_pad
    w32 = g.data.astype(np.float32)
    for (d, v), (idx, w) in runs.items():
        row = slice(g.indptr[v], g.indptr[v + 1]) if v < g.num_nodes else slice(0, 0)
        keep = g.indices[row] // plan.n_local == d
        np.testing.assert_array_equal(g.indices[row][keep] - d * plan.n_local, idx, f"shard {d} column {v}")
        np.testing.assert_array_equal(w32[row][keep], w, f"shard {d} column {v}")


@pytest.fixture(scope="module")
def gen002():
    """gen 0.02x (4,038 nodes, weights 1/(k-1)) and the port's f32
    spectral split of it."""
    from eig_kl_tpu_torch import clique_expand, read_hgr
    from eig_kl_tpu_torch.spectral.partition import eig_partition
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    hg = read_hgr(GEN_002)
    eig, _ = eig_partition(hg, SpectralConfig(solver="power"), device="cpu")
    return clique_expand(hg, "kl"), np.asarray(eig.sides, np.int8)


def test_initial_a_s_equals_the_xla_row_sum(gen002):
    """smega_refine's initial A@s (the port's spmv) equals the JAX smega's
    per-shard ELL row sum (smega.py:721) under jit, bitwise."""
    import jax

    from eig_kl_tpu.graph.csr import Graph as JaxGraph
    from eig_kl_tpu.parallel.sharded_kl import _pad_ell
    from eig_kl_tpu_torch.ops.spmv import spmv
    from eig_kl_tpu_torch.parallel.smega import SmegaPlan

    g, sides = gen002
    plan = SmegaPlan(g, 2, align=1024)
    ell_idx, ell_w, _ = _pad_ell(JaxGraph(g.num_nodes, g.indptr, g.indices, g.data), plan.n_pad, np.float32)
    s0 = np.zeros(plan.n_pad, np.float32)
    s0[: g.num_nodes] = 1.0 - 2.0 * sides.astype(np.float32)
    row_sum = jax.jit(lambda w, idx, s: (w * s[idx]).sum(axis=1))
    n_l = plan.n_local
    ref = np.concatenate([
        np.asarray(row_sum(ell_w[d * n_l: (d + 1) * n_l], ell_idx[d * n_l: (d + 1) * n_l], s0))
        for d in range(2)
    ])
    dg = plan.device_graph(torch.device("cpu"))
    got = spmv(dg, torch.as_tensor(s0[: g.num_nodes])).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref[: g.num_nodes].view(np.int32))


def test_gen002_swaps_equal_across_shards_and_the_single_chip_pass(gen002):
    """From the f32 spectral split: the swap logs, gains and iterations are
    bitwise equal at 1, 2, 4 and 8 shards and equal the single-chip pass
    (K2's plain version, and ``refine_mega`` around it, from the ELL row
    sums that smega starts from, smega.py:721: ``spmv_order="ell"``).  The
    cut trajectories start from different cut0s: smega's is the host f64
    recount rounded to f32 (smega.py:885-891), refine_mega's the cut in
    the tree order of ``ops/reduce.py``.  After that both add the same
    gains, so they stay |cut0 - cut0'| apart up to the f32 rounding of the
    Kahan steps (2 ulp of the cut)."""
    from eig_kl_tpu_torch.kl.megakernel import kl_pass_plain, refine_mega
    from eig_kl_tpu_torch.ops.partition import sides_to_signs
    from eig_kl_tpu_torch.ops.spmv import spmv
    from eig_kl_tpu_torch.parallel.smega import SmegaPlan, smega_pass, smega_refine
    from eig_kl_tpu_torch.utils.config import KLConfig

    g, sides = gen002
    cfg = KLConfig(gain_eps=1e-6)
    n, n1 = g.num_nodes, int(sides.sum())
    cap, limit = min(n1, n - n1), cfg.terminate_limit(n)
    dg = g.to_device("cpu")
    s = sides_to_signs(torch.as_tensor(sides), torch.float32)
    a_s = spmv(dg, s)
    mega = refine_mega(dg, sides, cfg, spmv_order="ell")
    single = kl_pass_plain(dg, s, a_s, mega.initial_cut, cap, limit, cfg.gain_eps)
    it = int(single.scalars[2])
    assert it == mega.iterations > 100
    for n_shards in (1, 2, 4, 8):
        plan = SmegaPlan(g, n_shards, align=128)
        got = smega_refine(g, sides, n_shards, cfg, device="cpu", plan=plan)
        assert got.iterations == it
        np.testing.assert_array_equal(got.gain_trajectory, mega.gain_trajectory)
        np.testing.assert_array_equal(got.sides, mega.sides)
        np.testing.assert_array_equal(got.best_sides, mega.best_sides)
        assert got.best_cut <= got.initial_cut
        assert abs(got.final_cut - got.verified_cut) <= 1e-5 * got.final_cut
        gap = abs(float(got.cut_trajectory[0]) - float(mega.cut_trajectory[0]))
        ulp = 2 * np.spacing(np.float32(got.initial_cut))
        diff = np.abs(got.cut_trajectory.astype(np.float64) - mega.cut_trajectory)
        assert diff.max() <= gap + ulp, (diff.max(), gap)
        # The pass's own logs against the single-chip pass's.
        sf0, as0 = torch.zeros(plan.n_pad), torch.zeros(plan.n_pad)
        sf0[:n], as0[:n] = s, a_s
        out = smega_pass(dg, n_shards, sf0, as0, got.initial_cut, cap, n - n1, n1, cap + 1, limit, cfg.gain_eps)
        assert int(out.scalars[2]) == it
        for name in ("log_a", "log_b", "log_gain"):
            assert torch.equal(getattr(out, name)[: it + 1], getattr(single, name)[: it + 1]), name
        assert torch.equal(out.sf[:n], single.sf)


def test_smega_refine_runs_on_the_card_unless_told_otherwise(dyadic, monkeypatch):
    from eig_kl_tpu_torch.parallel.smega import smega_refine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, sides = dyadic
    with pytest.raises(RuntimeError, match="no CUDA device"):
        smega_refine(_port_graph(g), sides, 1)


# --------------------------------------------- K5's layouts and its cache


def _gen_n_local(num_nodes, n_shards, align=1024):
    from eig_kl_tpu_torch.parallel.smega import _round_up

    return _round_up(num_nodes, n_shards * align) // n_shards


@pytest.mark.parametrize(
    "num_nodes, n_shards, n_local, layout, shared_bytes",
    [
        # gen 1.0x (201,920 nodes), align 1,024: 1,584 / 792 / 400 / 200 rows.
        (201_920, 1, 202_752, "global", 4 * (3 * 1584 + 50)),
        (201_920, 2, 101_376, "global", 4 * (3 * 792 + 25)),
        (201_920, 4, 51_200, "global", 4 * (3 * 400 + 13)),
        (201_920, 8, 25_600, "shared", 8 * 25_600 + 4 * (3 * 200 + 7)),
        # gen 0.02x (4,038 nodes): below the crossover at every S.
        (4038, 1, 4096, "flat", 0),
        (4038, 8, 1024, "flat", 0),
    ],
)
def test_k5_layout_at_gen_scales(num_nodes, n_shards, n_local, layout, shared_bytes):
    """K5's layout and its block's dynamic shared memory from the shard
    size alone: at gen 1.0x the state fits shared memory only at S = 8
    (207,228 B of the 227 KB opt-in)."""
    from eig_kl_tpu_torch.parallel.smega import K5_SHARED_BYTES, k5_layout, k5_shared_bytes

    assert _gen_n_local(num_nodes, n_shards) == n_local
    assert k5_layout(n_local, n_shards) == layout
    assert k5_shared_bytes(n_local, layout) == shared_bytes <= K5_SHARED_BYTES


@pytest.mark.parametrize(
    "n_local, layout",
    [
        ("a row below the crossover", "flat"),
        ("the crossover", "cache"),  # "shared" or "global", whichever fits
        ("the crossover + 4", "flat"),  # no multiple of 128
        (28_544, "shared"),  # the most nodes whose state fits: 231,056 B
        (28_672, "global"),  # 232,092 B: one row more does not
        (2_443_008, "global"),  # the cache alone: 231,420 B of 231,424
        (2_443_136, "flat"),  # one row more: 231,432 B, so the flat scan
    ],
)
def test_k5_layout_branches(n_local, layout):
    from eig_kl_tpu_torch.parallel.smega import (
        K5_CACHE_MIN_NODES,
        K5_SHARED_BYTES,
        ROW,
        k5_layout,
        k5_shared_bytes,
    )

    base = -(-K5_CACHE_MIN_NODES // ROW) * ROW
    n_local = {
        "a row below the crossover": base - ROW, "the crossover": base, "the crossover + 4": base + 4,
    }.get(n_local, n_local)
    fits = {lay: k5_shared_bytes(n_local, lay) <= K5_SHARED_BYTES for lay in ("shared", "global")}
    if layout == "cache":
        layout = "shared" if fits["shared"] else "global"
    for n_shards in (1, 2, 4, 8):
        assert k5_layout(n_local, n_shards) == layout
    if layout == "shared":
        assert fits["shared"]
    elif layout == "global":
        assert fits["global"] and not fits["shared"]
    with pytest.raises(ValueError, match="1, 2, 4 or 8"):
        k5_layout(n_local, 3)


def _k5_cached_pass(g, n_shards, sf0, as0, cut0, cap, nf0, nf1, log_len, limit, eps):
    """K5's cached loop (``smega.cu``, kCacheGlobal and kCacheShared) in
    NumPy: per shard a row-max cache of its own 128-node rows, the first
    maximum row by row, the lane search reporting the node's own D, the
    S candidates combined by "larger, then lower shard", and the
    owner-computes refresh: shard r refreshes only the rows of its stripe
    that its own entries, or its own locks, touched.  After every refresh
    the cache must equal one recomputed from scratch."""
    t = np.float32
    neg = t(-np.inf)
    sf, a_s = sf0.numpy().copy(), as0.numpy().copy()
    n_pad = sf.size
    n_local = n_pad // n_shards
    rows = n_local // 128
    indptr, cols, data = (x.numpy() for x in (g.indptr, g.indices, g.data))
    lane = np.arange(128)

    def row_maxes(shard, row):
        """Both sides' maxima of local rows ``row`` of shards ``shard``."""
        nodes = (shard * n_local + row * 128)[:, None] + lane
        f = sf[nodes]
        d = -(f * a_s[nodes])
        return np.where(f > 0, d, neg).max(axis=1), np.where(f < 0, d, neg).max(axis=1)

    everything = np.repeat(np.arange(n_shards), rows), np.tile(np.arange(rows), n_shards)
    cache = np.stack(row_maxes(*everything)).reshape(2, n_shards, rows)
    log_cut, log_gain = np.zeros(log_len, t), np.zeros(log_len, t)
    log_a, log_b = np.zeros(log_len, np.int32), np.zeros(log_len, np.int32)
    cut = log_cut[0] = t(cut0)
    best, comp, two = cut, t(0.0), t(2.0)
    it = term = stop = 0
    shard_ids = np.arange(n_shards)
    while stop == 0 and it < cap and nf0 > 0 and nf1 > 0:
        picked = []
        for side in (0, 1):
            row = cache[side].argmax(axis=1)  # first maximum row of each shard
            m = cache[side][shard_ids, row]
            nodes = (shard_ids * n_local + row * 128)[:, None] + lane
            f = sf[nodes]
            d = -(f * a_s[nodes])
            hit = ((f > 0) if side == 0 else (f < 0)) & (d == m[:, None])
            has = m > neg
            assert hit[has].any(axis=1).all(), "the cache disagrees with a row"
            k = hit.argmax(axis=1)
            val = np.where(has, d[shard_ids, k], neg)
            win = int(val.argmax())  # larger, then lower shard
            picked.append((int(nodes[win, k[win]]), val[win], bool(has[win])))
        (a, m_l, has_a), (b, m_r, has_b) = picked
        if not (has_a and has_b):
            break
        touched = []
        w_ab = t(0.0)
        for node, coef in ((a, t(-2.0)), (b, two)):
            lo, hi = indptr[node], indptr[node + 1]
            c = cols[lo:hi]
            a_s[c] = a_s[c] + coef * data[lo:hi]  # each owner's entries: one add each
            if node == a:
                w_ab = data[lo:hi][c == b].sum(dtype=t)
            touched.append(c)
        sf[a] = sf[b] = 0.0
        touched = np.unique(np.concatenate(touched + [np.array([a, b])]))
        owner, row = touched // n_local, (touched % n_local) // 128
        dirty = np.unique(owner * rows + row)
        cache[:, dirty // rows, dirty % rows] = np.stack(row_maxes(dirty // rows, dirty % rows))
        assert np.array_equal(cache, np.stack(row_maxes(*everything)).reshape(2, n_shards, rows))
        gain = (m_l + m_r) - two * w_ab
        y = -gain - comp
        tot = cut + y
        comp = (tot - cut) - y
        cut = tot
        best = min(cut, best)
        it += 1
        log_cut[it], log_gain[it], log_a[it], log_b[it] = cut, gain, a, b
        term = term + 1 if gain <= t(eps) else 0
        stop = int(term > limit)
        nf0 -= 1
        nf1 -= 1
    scalars = np.array([cut, best, it, term, nf0, nf1, t(cut0), stop], dtype=t)
    return sf, log_cut, log_gain, log_a, log_b, scalars


def _k5_case(kind, n_shards, frac):
    """(device graph, K5's arguments) of a split of ``kind``'s graph with
    ``frac`` of the nodes on side 1, padded for ``n_shards`` shards.  An
    unequal split runs with no termination rule, to its cap: until the
    smaller side has no free node left, shard by shard."""
    from eig_kl_tpu_torch.graph.expand import clique_expand as port_expand
    from eig_kl_tpu_torch.io.hgr import Hypergraph, read_hgr
    from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
    from eig_kl_tpu_torch.ops.spmv import spmv
    from eig_kl_tpu_torch.parallel.smega import SmegaPlan
    from eig_kl_tpu_torch.utils.config import KLConfig

    if kind == "gen_0.02":
        hg = read_hgr(GEN_002)
    else:
        # Dyadic weights 1, 1/2, 1/4 and many nets: exact sums, many tied
        # gains, +0 and -0 among them (a_s cancels to +0, -(1 * 0) = -0).
        h = dyadic_hypergraph(np.random.default_rng(31), num_nodes=1700, num_nets=1900)
        hg = Hypergraph(h.num_nodes, h.num_nets, h.pins, h.net_offsets)
    g_host = port_expand(hg, "kl", use_native=False)
    plan = SmegaPlan(g_host, n_shards, align=128)
    g = plan.device_graph(torch.device("cpu"))
    n = g.num_nodes
    sides = (np.random.default_rng(n_shards).random(n) < frac).astype(np.int8)
    s = sides_to_signs(torch.as_tensor(sides), torch.float32)
    sf0, as0 = torch.zeros(plan.n_pad), torch.zeros(plan.n_pad)
    sf0[:n], as0[:n] = s, spmv(g, s)
    n1 = int(sides.sum())
    cap = min(n1, n - n1)
    cut0 = float(cut_size(g, s, as0[:n]))
    limit = KLConfig().terminate_limit(n) if frac == 0.5 else n
    return g, (n_shards, sf0, as0, cut0, cap, n - n1, n1, cap + 1, limit, 1e-6)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("kind, frac", [("dyadic", 0.5), ("dyadic", 0.3), ("gen_0.02", 0.5)])
def test_k5_cached_selection_equals_the_flat_pass(kind, frac, n_shards):
    """K5's per-shard cached selection and owner-only refresh, emulated,
    run the whole pass of ``smega_pass_plain`` (the flat first maximum)
    bit for bit: swaps, gains, cuts, final sf and scalars.  The unequal
    split (30 %) runs to its cap, shards running out of free nodes on one
    side one after another; at S = 8 the last shard is all padding."""
    from eig_kl_tpu_torch.parallel.smega import smega_pass_plain

    g, args = _k5_case(kind, n_shards, frac)
    ref = smega_pass_plain(g, *args)
    got = _k5_cached_pass(g, *args)
    assert int(ref.scalars[2]) == args[4] if frac != 0.5 else int(ref.scalars[2]) > 300
    for name, x in zip(("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"), got):
        np.testing.assert_array_equal(
            x.view(np.int32), getattr(ref, name).numpy().view(np.int32), name
        )
