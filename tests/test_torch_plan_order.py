"""The v2 TPU SpMV's own order (``eig_kl_tpu_torch/ops/spmv_plan.py``)
against the JAX package on the CPU: the port's v2 layout against
``build_plan_v2(..., use_native=False)``'s slots, spill and tail;
``spmv_v2_plain`` against the v2 kernels in interpret mode with ``==``, in
f32 and with bf16 products; the COO tail's add against ``_coo_tail_add``;
the mega engine above 32,768 stored entries against the JAX mega engine;
and the CSR plan path's power solve against the JAX plan branch.  The plain
versions run on one thread (``tests/test_torch_bf16i.py:_one_thread``).
"""

import contextlib
import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_hypergraph

GEN_002 = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "data" / "gen_0.02_42.hgr")


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@functools.lru_cache(maxsize=None)
def _host(kind):
    """A KL-weighted host graph (the port's): gen 1.0x seed 42 (1,107,844
    entries, a COO tail); the 6,000-node random graph (78,752 entries, a v1
    tail); a sparser one of 30,000 nodes whose plan has ``Q`` = 128."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import Hypergraph
    from eig_kl_tpu_torch.models.generator import CircuitGenerator

    if kind == "gen_1.0":
        return clique_expand(CircuitGenerator(1.0, 42).generate(), "kl", use_native=False)
    n, nets, pins, seed = {"6000": (6000, 7800, 5, 21), "sparse": (30000, 12000, 4, 8)}[kind]
    hg = random_hypergraph(np.random.default_rng(seed), n, nets, pins)
    return clique_expand(Hypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets), "kl", use_native=False)


def _coo(g):
    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), np.diff(g.indptr))
    return rows, g.indices.astype(np.int64), g.data.astype(np.float32)


def _plans(kind, rblock):
    """(the JAX package's v2 plan, the port's layout) of one host graph."""
    from eig_kl_tpu.ops.spmv_pallas import build_plan_v2
    from eig_kl_tpu_torch.ops.spmv_plan import build_v2_layout

    g = _host(kind)
    coo = _coo(g)
    return g, build_plan_v2(g.num_nodes, *coo, use_native=False, rblock=rblock), \
        build_v2_layout(g.num_nodes, *coo, "cpu", rblock=rblock)


def _jax_slots(plan):
    """The kept entries of a JAX v2 plan, by pass-1 slot: (slot, row, col,
    weight), read back from its slot grid and its transposed row table."""
    Q, g1, n_cb, n_rbp, g2 = plan.quantum, plan.g1, plan.n_cb, plan.n_rbp, plan.g2
    rl = np.asarray(plan.rl_t).reshape(-1)[: n_rbp * g2].reshape(n_rbp, g2)[:, : n_cb * Q]
    rl = rl.reshape(n_rbp, n_cb, Q).transpose(1, 0, 2).reshape(-1).astype(np.int64)
    slot = np.flatnonzero(rl >= 0)
    cl = np.asarray(plan.col_local).reshape(-1).astype(np.int64)
    w = np.asarray(plan.weights).reshape(-1)
    return slot, (slot % g1) // Q * plan.rblock + rl[slot], slot // g1 * 1024 + cl[slot], w[slot]


def _port_slots(lay):
    """The same for the port's layout: each kept entry's slot from its
    bucket and its rank there in (row, column) order."""
    ptr = lay.ptr.numpy().astype(np.int64)
    rows = np.repeat(np.arange(lay.num_nodes), np.diff(ptr))
    cols = lay.cols.numpy().astype(np.int64)
    n_rb = -(-lay.padded_nodes // lay.rblock)
    bucket = cols // 1024 * n_rb + rows // lay.rblock
    order = np.lexsort((cols, rows, bucket))
    b = bucket[order]
    first = np.ones(len(b), bool)
    first[1:] = b[1:] != b[:-1]
    starts = np.flatnonzero(first)
    rank = np.arange(len(b)) - np.repeat(starts, np.diff(starts, append=len(b)))
    slot = cols[order] // 1024 * lay.g1 + rows[order] // lay.rblock * lay.quantum + rank
    return slot, rows[order], cols[order], lay.weights.numpy()[order]


@pytest.mark.parametrize("kind, rblock", [("gen_1.0", None), ("6000", 512), ("6000", 4096), ("6000", 16384)])
def test_v2_layout_equals_the_jax_plan(kind, rblock):
    """The port's v2 layout is ``build_plan_v2(..., use_native=False)``'s:
    its geometry (the search's at gen 1.0x: row block 16,384, Q 512), every
    kept entry in its slot, the pass-2 sub-chunks' row blocks, and the
    spill: the same entries in the tail, a COO tail in the same rank groups
    (gen 1.0x: 125 entries) or a v1 tail chunk by chunk."""
    from eig_kl_tpu.ops.spmv_pallas import CooTail as JaxCoo
    from eig_kl_tpu_torch.ops.spmv_plan import CooTail, V1Layout

    g, plan, lay = _plans(kind, rblock)
    for name in ("padded_nodes", "rblock", "quantum", "n_cb", "n_rbp", "g1", "g2"):
        assert getattr(lay, name) == getattr(plan, name), name
    assert lay.shift == 19 - int(np.log2(lay.quantum))
    ref, got = _jax_slots(plan), _port_slots(lay)
    for a, b in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(_bits(ref[3]), _bits(got[3]))
    C2 = lay.num_subchunks
    rb_of = np.asarray(plan.rb_of)
    np.testing.assert_array_equal(rb_of[:C2], np.arange(C2) // (lay.g2 // 512))
    assert not rb_of[C2:].any()
    if kind == "gen_1.0":
        assert (lay.rblock, lay.quantum) == (16384, 512) and isinstance(plan.tail, JaxCoo)
        tail = lay.tail
        assert isinstance(tail, CooTail) and tail.num_entries == 125 and tail.num_groups == 2
        rows = tail.rows.numpy().astype(np.int64)
        assert (np.diff(rows) >= 0).all()
        warp_ptr = tail.warp_ptr.numpy().astype(np.int64)  # each 32 rows' triplets
        assert len(warp_ptr) == -(-g.num_nodes // 32) + 1 and warp_ptr[0] == 0 and warp_ptr[-1] == len(rows)
        np.testing.assert_array_equal(np.repeat(np.arange(len(warp_ptr) - 1), np.diff(warp_ptr)), rows // 32)
        ptr = np.searchsorted(rows, np.arange(g.num_nodes + 1))
        rank = np.arange(len(rows)) - ptr[rows]
        order = np.lexsort((rows, rank))  # the TPU plan's groups: by rank, then row
        np.testing.assert_array_equal(rows[order], np.asarray(plan.tail.rows))
        np.testing.assert_array_equal(tail.cols.numpy()[order], np.asarray(plan.tail.cols))
        np.testing.assert_array_equal(_bits(tail.weights.numpy()[order]), _bits(plan.tail.w))
        assert plan.tail.offsets == tuple(np.searchsorted(rank[order], np.arange(tail.num_groups + 1)))
    else:
        tail, jt = lay.tail, plan.tail
        assert isinstance(tail, V1Layout) and not isinstance(jt, JaxCoo)
        C = tail.num_chunks
        assert C <= jt.num_chunks < C + 8
        np.testing.assert_array_equal(tail.x_base.numpy(), 128 * np.asarray(jt.cw8[:C]))
        np.testing.assert_array_equal(tail.col_local.numpy(), np.asarray(jt.col_local[:C]).reshape(C, -1))
        np.testing.assert_array_equal(tail.row_local.numpy(), np.asarray(jt.row_local[:C]).reshape(C, -1))
        np.testing.assert_array_equal(_bits(tail.weights), _bits(np.asarray(jt.weights[:C]).reshape(C, -1)))
    assert len(ref[0]) + (tail.num_entries if kind == "gen_1.0" else int((tail.weights != 0).sum())) == g.nnz


@pytest.mark.parametrize("kind, rblock", [("6000", 512), ("6000", 4096), ("6000", 16384), ("sparse", None)])
def test_spmv_v2_plain_equals_the_v2_kernels(kind, rblock):
    """``spmv_v2_plain`` equals the JAX package's v2 kernels in interpret
    mode with ``==``: ``spmv_pallas`` of a vector (f32 products) and
    ``spmv_pallas_2d(..., inter_dtype=bfloat16)`` of the padded state (bf16
    products), for a normal ``x`` and for signs, at three row blocks with a
    v1 tail, and on a plan whose sub-chunks hold 4 column blocks (``Q`` =
    128, no tail).  K1's ELL order parts from them."""
    from eig_kl_tpu.ops import spmv_pallas as SP
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.ops.spmv import spmv_plain
    from eig_kl_tpu_torch.ops.spmv_plan import spmv_v2_plain

    g, plan, lay = _plans(kind, rblock)
    assert lay.quantum == (512 if kind == "6000" else 128) and (lay.tail is None) == (kind == "sparse")
    n, P = g.num_nodes, plan.padded_nodes
    run = jax.jit(lambda x, x2d: (SP.spmv_pallas(plan, x, interpret=True),
                                  SP.spmv_pallas_2d(plan, x2d, interpret=True, inter_dtype=jnp.bfloat16)))
    rng = np.random.default_rng(3)
    gd = Graph.from_arrays(g.indptr, g.indices, g.data).to_device("cpu")
    parted = 0
    for x in (rng.standard_normal(n).astype(np.float32), np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)):
        x2d = np.zeros(P, np.float32)
        x2d[:n] = x
        x2d = x2d.reshape(-1, 128)
        ref, ref2d = run(jnp.asarray(x), jnp.asarray(x2d))
        with _one_thread():
            got = spmv_v2_plain(lay, torch.as_tensor(x))
            got2d = spmv_v2_plain(lay, torch.as_tensor(x2d), bf16=True)
            parted += int((_bits(spmv_plain(gd, torch.as_tensor(x))) != _bits(ref)).sum())
        np.testing.assert_array_equal(_bits(got), _bits(ref))
        np.testing.assert_array_equal(_bits(got2d), _bits(ref2d))
    assert parted > 0


def test_coo_tail_add_equals_jax():
    """The COO tail's add at gen 1.0x (125 spilled entries in two rank
    groups) equals ``_coo_tail_add`` bit for bit, eager and under ``jit``
    (where XLA could fuse the products into the scatter; it does not
    contract them)."""
    from eig_kl_tpu.ops import spmv_pallas as SP
    from eig_kl_tpu_torch.ops.spmv_plan import coo_tail_add

    g, plan, lay = _plans("gen_1.0", None)
    n, P = g.num_nodes, plan.padded_nodes
    rng = np.random.default_rng(4)
    x2d, y2d = (np.zeros(P, np.float32) for _ in range(2))
    x2d[:n], y2d[:n] = rng.standard_normal(n), rng.standard_normal(n)
    x2d, y2d = x2d.reshape(-1, 128), y2d.reshape(-1, 128)
    eager = np.asarray(SP._coo_tail_add(jnp.asarray(y2d), plan.tail, jnp.asarray(x2d))).reshape(-1)
    jitted = np.asarray(jax.jit(lambda y, x: SP._coo_tail_add(y, plan.tail, x))(jnp.asarray(y2d), jnp.asarray(x2d)))
    got = coo_tail_add(lay.tail, torch.as_tensor(y2d.reshape(-1)[:n]), torch.as_tensor(x2d.reshape(-1)[:n]))
    np.testing.assert_array_equal(_bits(got), _bits(eager[:n]))
    np.testing.assert_array_equal(_bits(got), _bits(jitted.reshape(-1)[:n]))
    assert (_bits(got) != _bits(y2d.reshape(-1)[:n])).sum() >= 100  # the tail's 122 rows moved


def test_refine_mega_batch_equals_jax_above_32768_entries():
    """The port's ``refine_mega_batch`` on the 6,000-node graph (78,752
    entries: a v2 plan) from the splits of seeds 100-102, as one batch of
    three starts, against the JAX package's in interpret mode: iterations,
    initial, final and best cuts, both trajectories and both splits bit for
    bit (1,450 / 1,454 / 1,396 swaps; with K1's ELL order for the starting
    ``A @ s`` all three parted).  The verified cut keeps the tree order from
    4,096 nodes (ROADMAP.md C, settled) and lies within its rounding bound
    of the JAX engine's sequential dot."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.kl.megakernel import MegaGraph, refine_mega_batch as jax_batch
    from eig_kl_tpu.utils.config import KLConfig as JaxKL
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.kl.megakernel import refine_mega_batch
    from eig_kl_tpu_torch.ops.spmv_plan import V2Layout
    from eig_kl_tpu_torch.utils.config import KLConfig

    gh = clique_expand(random_hypergraph(np.random.default_rng(21), 6000, 7800, 5), "kl", use_native=False)
    g = Graph.from_arrays(gh.indptr, gh.indices, gh.data).to_device("cpu")
    assert gh.nnz == 78_752 and isinstance(g.plan_layout, V2Layout)
    sides = np.stack([(np.random.default_rng(s).random(6000) < 0.5).astype(np.int8) for s in (100, 101, 102)])
    refs = jax_batch(MegaGraph(gh), sides, JaxKL(), interpret=True)
    with _one_thread():
        gots = refine_mega_batch(g, sides, KLConfig())
    u = 2.0**-24
    gamma = 6000 * u / (1 - 6000 * u)
    assert [r.iterations for r in refs] == [1450, 1454, 1396]
    for got, ref in zip(gots, refs):
        assert got.iterations == ref.iterations
        for name in ("initial_cut", "final_cut", "best_cut"):
            assert getattr(got, name) == getattr(ref, name), name
        for name in ("sides", "best_sides"):
            np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
        for name in ("cut_trajectory", "gain_trajectory"):
            np.testing.assert_array_equal(_bits(getattr(got, name)), _bits(getattr(ref, name)))
        # Both verified cuts are 0.25 (wsum - s . A s) of the same A s: within
        # 0.5 gamma_n sum|s_i (A s)_i| <= 0.5 gamma_n sum(deg), plus a rounding each.
        bound = 0.5 * gamma * float(gh.data.sum()) + u * (abs(got.verified_cut) + abs(ref.verified_cut))
        assert abs(got.verified_cut - ref.verified_cut) <= bound


@pytest.mark.parametrize("kind, inter, knob", [
    ("v2", "bfloat16", None), ("v2", "float32", None), ("v1", "float32", None),
    ("v2", "bfloat16", ("EIG_KL_TPU_BF16_W", "1")), ("v2", "float32", ("EIG_KL_TPU_REDUCE_IMPL", "mxu2")),
    ("v2", "float32", ("EIG_KL_TPU_REDUCE_IMPL", "vpu")),
])
def test_plan_path_sign_exit_equals_jax(monkeypatch, kind, inter, knob):
    """The CSR plan path's power solve (the sign exit, seed 42, 400 steps
    at most) on gen 0.02x's largest component (3,694 nodes, 22,380 entries)
    with a v2 plan (its search's geometry and a v1 tail of 7,501 entries)
    or its rule's v1 plan, against the JAX package's ``_power_core`` on
    the same plan with its kernels in interpret mode: the iterations, the
    eigenvalue and every value of the iterate bit for bit (bf16 products:
    401 steps, lambda 1.3969650899525732e-04; f32: 201 steps).  Also under
    the v2 SpMV's other forms, set as a user sets them: bf16 weights
    (``EIG_KL_TPU_BF16_W=1``) and, in f32 (with bf16 products their orders
    move no bit here), the reduce kernels "mxu2" (4 partials at this plan's
    row block of 512) and "vpu" (``EIG_KL_TPU_REDUCE_IMPL``), each of which
    parted from the default's run; the JAX solve reads them when it traces
    its SpMV (here a new function under a new ``jax.jit``: ``jax.jit`` of
    the same function shares its traces, which would reuse a program
    traced under another setting)."""
    from test_torch_lanczos import largest_component

    from eig_kl_tpu.graph.expand import clique_expand as jax_expand
    from eig_kl_tpu.io.hgr import Hypergraph as JaxHypergraph
    from eig_kl_tpu.ops.spmv_pallas import build_plan, build_plan_v2
    from eig_kl_tpu.spectral import power as jax_power
    from eig_kl_tpu_torch.graph.csr import CsrPlan, Graph
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.spectral.power import _power_core

    for name in ("EIG_KL_TPU_BF16_W", "EIG_KL_TPU_REDUCE_IMPL"):
        monkeypatch.delenv(name, raising=False)
    if knob is not None:
        monkeypatch.setenv(*knob)
    jax_core = jax_power._power_core if knob is None else jax.jit(
        lambda *a, **k: jax_power._power_core_impl(*a, **k), static_argnames=jax_power._POWER_STATICS)
    hg = largest_component(read_hgr(GEN_002, use_native=False))
    gh = jax_expand(JaxHypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets), "kl", use_native=False)
    plan = (build_plan_v2 if kind == "v2" else build_plan)(gh.num_nodes, *_coo(gh))
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=400, seed=42, convergence="sign",
              inter_dtype=inter)
    lam_j, v_j, it_j = jax_core(gh.to_device()._replace(plan=plan), dtype="float32", **kw)
    base = Graph.from_arrays(gh.indptr, gh.indices, gh.data).to_device("cpu")
    gd = dataclasses.replace(base, plan=CsrPlan.for_graph(base, kernel=kind))
    assert gd.plan.runs_bf16(inter) == (inter == "bfloat16")
    with _one_thread():
        lam, v, it = _power_core(gd, dtype=torch.float32, **kw)
    assert it == int(it_j)
    assert _bits(float(lam)) == _bits(lam_j)
    np.testing.assert_array_equal(_bits(v.numpy()), _bits(v_j))
    if knob is None:
        assert it == {"bfloat16": 401, "float32": 201}[inter]
    if inter == "bfloat16" and knob is None:
        assert float(lam) == 1.3969650899525732e-04
