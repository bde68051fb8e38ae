"""The port's kernels on the card against their plain versions.

Every test here needs a CUDA card and skips without one.  The module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; run it on the card, without the JAX-side ``conftest.py``, with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

GEN_002 = os.path.join(
    os.path.dirname(__file__), "..", "benchmarks", "data", "gen_0.02_42.hgr"
)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hypergraph(kind):
    from eig_kl_tpu_torch.io.hgr import Hypergraph, read_hgr

    if kind == "gen_0.02":
        return read_hgr(GEN_002)
    if kind in ("w8", "w16"):
        # Rows of at most 6 or 10 entries (ELL width 8 or 16, where XLA adds a
        # row in one chain): windows of 4 or 6 consecutive nodes, 70 % of
        # them, over all but the last 50 nodes (rows of degree 0).
        rng = np.random.default_rng(13)
        n, k = 3000, 4 if kind == "w8" else 6
        nets = [np.arange(i, i + k) for i in range(n - 50 - k) if rng.random() < 0.7]
        offs = np.zeros(len(nets) + 1, np.int64)
        np.cumsum([k] * len(nets), out=offs[1:])
        return Hypergraph(n, len(nets), np.concatenate(nets).astype(np.int32), offs)
    if kind == "dyadic":
        # KL weights 1/(k-1) in {1, 1/2, 1/4, 1/8}: exact sums, many ties.
        rng = np.random.default_rng(12)
        n = 3000
        sizes = rng.choice([2, 3, 5, 9], size=3600, p=[0.6, 0.2, 0.15, 0.05])
        nets = [rng.choice(n, k, replace=False) for k in sizes]
        offs = np.zeros(len(nets) + 1, np.int64)
        np.cumsum(sizes, out=offs[1:])
        return Hypergraph(n, len(nets), np.concatenate(nets).astype(np.int32), offs)
    rng = np.random.default_rng(11)
    n, hub = 1500, int(kind[3:])
    sizes = rng.choice([2, 3, 4, 5, 6, 8], size=n, p=[.84, .02, .06, .02, .04, .02])
    nets = [rng.choice(n, k, replace=False) for k in sizes] + [rng.choice(n, hub, replace=False)]
    offs = np.zeros(len(nets) + 1, np.int64)
    np.cumsum([len(a) for a in nets], out=offs[1:])
    return Hypergraph(n, len(nets), np.concatenate(nets).astype(np.int32), offs)


def _graphs(kind, device):
    """The same KL-weighted f32 graph on the CPU and on the card."""
    from eig_kl_tpu_torch.graph.expand import clique_expand

    g_host = clique_expand(_hypergraph(kind), "kl")
    return g_host.to_device("cpu"), g_host.to_device(device)


@pytest.mark.parametrize("kind", ["gen_0.02", "hub10", "hub44", "hub130"])
def test_k1_equals_plain_bitwise_and_is_deterministic(cuda, kind):
    from eig_kl_tpu_torch.ops.spmv import K1, spmv, spmv_plain

    g_cpu, g = _graphs(kind, cuda)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(g.num_nodes).astype(np.float32))
    before = K1.launches
    y1, y2 = spmv(g, x.to(cuda)), spmv(g, x.to(cuda))
    assert K1.launches == before + 2
    y_plain_card = spmv_plain(g, x.to(cuda))
    y_plain_cpu = spmv_plain(g_cpu, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    assert torch.equal(y1, y_plain_card)
    assert torch.equal(y1.cpu(), y_plain_cpu)


def test_k1_refuses_f64(cuda):
    """An f64 x on an f32 graph: K1 takes both in one dtype."""
    from eig_kl_tpu_torch.ops.spmv import spmv

    g_host_dev = _graphs("gen_0.02", cuda)[1]
    with pytest.raises(TypeError, match="float32"):
        spmv(g_host_dev, torch.zeros(g_host_dev.num_nodes, dtype=torch.float64, device=cuda))


#: K2's cases: (graph, starts, split, selection, cap).  gen 0.02x has
#: 4,038 nodes (not a multiple of the cache's 128-node rows); "dyadic" is
#: full of ties; "lopsided" puts a tenth of the nodes on side 1 and turns
#: the termination rule off, so side 1 runs out.  The selection is the
#: wrapper's choice (None: the flat scan on these small graphs) or forced:
#: the row-max cache in shared memory, in its global-memory branch, or
#: the flat scan.
K2_CASES = {
    "gen_0.02": ("gen_0.02", 1, "random", None, None),
    "gen_0.02-shared": ("gen_0.02", 1, "random", "shared", None),
    "gen_0.02-global": ("gen_0.02", 1, "random", "global", None),
    "hub44": ("hub44", 1, "random", None, None),
    "hub44-shared": ("hub44", 1, "random", "shared", None),
    "dyadic-shared": ("dyadic", 1, "random", "shared", None),
    "dyadic-global": ("dyadic", 1, "random", "global", None),
    "dyadic-flat": ("dyadic", 1, "random", "flat", None),
    "lopsided-shared": ("gen_0.02", 1, "lopsided", "shared", None),
    "lopsided-flat": ("gen_0.02", 1, "lopsided", "flat", None),
    "dyadic-8-shared": ("dyadic", 8, "random", "shared", None),
    "gen_0.02-8-global": ("gen_0.02", 8, "random", "global", 400),
    "gen_0.02-32-shared": ("gen_0.02", 32, "random", "shared", 150),
    "gen_0.02-32-flat": ("gen_0.02", 32, "random", "flat", 150),
}


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_equals_plain_bitwise(cuda, case):
    from eig_kl_tpu_torch.kl.megakernel import K2, kl_pass, kl_pass_batch_cuda, kl_pass_batch_plain

    kind, starts, split, cache, cap = K2_CASES[case]
    _, g = _graphs(kind, cuda)
    n = g.num_nodes
    if split == "lopsided":
        rng = np.random.default_rng(3)
        sides = np.zeros((1, n), np.int8)
        sides[0, rng.choice(n, n // 10, replace=False)] = 1
        s, a_s, cut0 = _batch_inputs(g, sides=sides)
        limit, caps = n, [n // 2]
    else:
        s, a_s, cut0 = _batch_inputs(g, list(range(5, 5 + starts)))
        n1 = (s < 0).sum(dim=1).tolist()
        limit, caps = 16, [min(k, n - k) if cap is None else cap for k in n1]
    cap_t = torch.tensor(caps, dtype=torch.int32, device=cuda)
    args = (g, s, a_s, cut0, cut0, cap_t, torch.zeros_like(cap_t), max(caps) + 1, limit, 1e-6)
    before = K2.launches
    got = kl_pass_batch_cuda(*args, _cache=cache)
    assert K2.launches == before + 1
    ref = kl_pass_batch_plain(*args)
    torch.cuda.synchronize()
    its = got.scalars[:, 2].long().tolist()
    assert min(its) > 50
    if split == "lopsided":
        assert its == [n // 10] and float(got.scalars[0, 5]) == 0.0
    for name in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    if starts == 1 and cache is None and split == "random":
        one = kl_pass(g, s[0], a_s[0], float(cut0[0]), caps[0], limit, 1e-6)
        for name in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"):
            assert torch.equal(getattr(one, name), getattr(got.start(0), name)), name


def test_fused_on_the_card_equals_the_cpu_run(cuda):
    """The card computes the same bits as the CPU path (which the CPU
    tests hold to the JAX package), and goes through both kernels."""
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.kl.megakernel import K2
    from eig_kl_tpu_torch.models.pipelines import fused_partition
    from eig_kl_tpu_torch.ops.reduce import K4, K4_FUSED, K6, K6_SCALE
    from eig_kl_tpu_torch.ops.spmv import K1, K1_STEP

    hg = read_hgr(GEN_002)
    K1.launches = K1_STEP.launches = K2.launches = K6.launches = K6_SCALE.launches = 0
    K4.launches = K4_FUSED.launches = 0
    card = fused_partition(hg)  # the default device is the card
    k1, k1_step, k2, k6, k6_scale = K1.launches, K1_STEP.launches, K2.launches, K6.launches, K6_SCALE.launches
    k4, k4_fused = K4.launches, K4_FUSED.launches
    cpu = fused_partition(hg, device="cpu")
    assert card.spectral_iterations == cpu.spectral_iterations == 201
    # K1: the Rayleigh quotient's L x, the pass's A @ s and its recount;
    # K6: a norm per step, the two cuts' degree sums; K4's fused dot: the
    # Rayleigh quotient and the two cuts' dots (4,038 values, below XLA's
    # 4,096-value fusion: ROADMAP.md C5, C9).
    iters = card.spectral_iterations
    assert (k1, k1_step, k2, k6, k6_scale) == (3, iters, 1, iters + 2, iters)
    assert (k4, k4_fused) == (0, 3)
    np.testing.assert_array_equal(card.eig.sides, cpu.eig.sides)
    np.testing.assert_array_equal(card.eig.values, cpu.eig.values)
    for name in ("iterations", "initial_cut", "best_cut", "final_cut", "verified_cut"):
        assert getattr(card.kl, name) == getattr(cpu.kl, name), name
    np.testing.assert_array_equal(card.kl.best_sides, cpu.kl.best_sides)
    np.testing.assert_array_equal(card.kl.cut_trajectory, cpu.kl.cut_trajectory)


def _batch_inputs(g, seeds=(), sides=None):
    """Signs, ``A @ s`` and cuts of one start per seeded random split (or
    per row of ``sides``), on the graph's device, in its dtype."""
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.kl.megakernel import _batch_init
    from eig_kl_tpu_torch.ops.partition import sides_to_signs

    if sides is None:
        sides = np.stack([random_split(g.num_nodes, s) for s in seeds])
    sides = torch.as_tensor(sides).to(g.device)
    s = sides_to_signs(sides, g.dtype)
    a_s, cut0 = _batch_init(g, s)
    return s, a_s, cut0


@pytest.mark.parametrize("cache", [None, "shared", "global"])
@pytest.mark.parametrize("kind", ["gen_0.02", "hub44"])
def test_k2_batched_equals_plain_and_single_launches_bitwise(cuda, kind, cache):
    """One launch of 3 starts: a full pass, a zero cap, and a re-entry with
    a best cut below the cut and a termination count carried in; the
    wrapper's selection (the flat scan here), or the row-max cache in
    shared memory or in its global-memory branch."""
    from eig_kl_tpu_torch.kl.megakernel import (
        K2, K2_STARTS, kl_pass_batch, kl_pass_batch_cuda, kl_pass_batch_plain, kl_pass_cuda,
    )

    _, g = _graphs(kind, cuda)
    n = g.num_nodes
    s, a_s, cut0 = _batch_inputs(g, [5, 6, 7])
    best0 = cut0.clone()
    best0[2] -= 3.25
    cap = torch.tensor([n // 2, 0, 90], dtype=torch.int32, device=cuda)
    term0 = torch.tensor([0, 0, 4], dtype=torch.int32, device=cuda)
    args = (g, s, a_s, cut0, best0, cap, term0, n // 2 + 1, 16, 1e-6)
    before, before3 = K2.launches, K2_STARTS[3]
    if cache is None:
        got = kl_pass_batch(*args)
    else:
        got = kl_pass_batch_cuda(*args, _cache=cache)
    assert (K2.launches, K2_STARTS[3]) == (before + 1, before3 + 1)  # a batch is one launch
    ref = kl_pass_batch_plain(*args)
    torch.cuda.synchronize()
    its = got.scalars[:, 2].tolist()
    assert its[0] > 50 and its[1] == 0 and 0 < its[2] <= 90
    assert float(got.scalars[2, 1]) <= float(best0[2])
    for name in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    # Start 0 is what a launch of that start alone gives.
    one = kl_pass_cuda(g, s[0], a_s[0], float(cut0[0]), n // 2, 16, 1e-6)
    for name in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"):
        assert torch.equal(getattr(got.start(0), name), getattr(one, name)), name


def test_k2_batched_wrapper_checks_its_arguments(cuda):
    from eig_kl_tpu_torch.kl.megakernel import kl_pass_batch_cuda

    _, g = _graphs("gen_0.02", cuda)
    s, a_s, cut0 = _batch_inputs(g, [1, 2])
    cap = torch.tensor([5, 5], dtype=torch.int32, device=cuda)
    zero = torch.zeros_like(cap)
    with pytest.raises(TypeError, match="float32"):
        kl_pass_batch_cuda(g, s.double(), a_s, cut0, cut0, cap, zero, 6, 16, 0.0)
    with pytest.raises(TypeError, match="int32"):
        kl_pass_batch_cuda(g, s, a_s, cut0, cut0, cap.long(), zero, 6, 16, 0.0)
    with pytest.raises(ValueError, match="matrices"):
        kl_pass_batch_cuda(g, s[0], a_s[0], cut0, cut0, cap, zero, 6, 16, 0.0)
    with pytest.raises(ValueError, match="cut0"):
        kl_pass_batch_cuda(g, s, a_s, cut0[:1], cut0, cap, zero, 6, 16, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        kl_pass_batch_cuda(g, s, a_s, cut0.cpu(), cut0, cap, zero, 6, 16, 0.0)


@pytest.mark.parametrize("selection", ["flat", "cache"])
def test_refresh_interval_on_the_card_equals_the_cpu_run(cuda, selection, monkeypatch):
    """Kernel re-entry every 100 swaps, through the flat scan (the size's
    own choice) and through the row-max cache (its threshold lowered)."""
    from eig_kl_tpu_torch.kl import megakernel
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.kl.megakernel import K2_STARTS, refine_mega
    from eig_kl_tpu_torch.utils.config import KLConfig

    if selection == "cache":
        monkeypatch.setattr(megakernel, "K2_CACHE_MIN_NODES", 0)

    g_cpu, g = _graphs("gen_0.02", cuda)
    sides = random_split(g.num_nodes, 9)
    cfg = KLConfig(gain_eps=1e-6, refresh_interval=100)
    before = K2_STARTS[1]
    card = refine_mega(g, sides, cfg)
    assert K2_STARTS[1] - before == -(-card.iterations // 100)  # one launch per chunk
    cpu = refine_mega(g_cpu, sides, cfg)
    for name in ("iterations", "initial_cut", "best_cut", "final_cut", "verified_cut"):
        assert getattr(card, name) == getattr(cpu, name), name
    np.testing.assert_array_equal(card.best_sides, cpu.best_sides)
    np.testing.assert_array_equal(card.cut_trajectory, cpu.cut_trajectory)


def test_fused_multi_start_on_the_card_equals_the_cpu_run(cuda):
    """3 starts, passes until converged: one batched launch per pass, and
    the card's bits are the CPU path's."""
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.kl.megakernel import K2, K2_STARTS
    from eig_kl_tpu_torch.models.pipelines import fused_partition
    from eig_kl_tpu_torch.utils.config import KLConfig

    hg = read_hgr(GEN_002)
    cfg = KLConfig(gain_eps=1e-6, passes=0)
    K2.launches = 0
    K2_STARTS.clear()
    card = fused_partition(hg, starts=3, kl_config=cfg)
    assert 2 <= K2_STARTS[3] == K2.launches <= 16
    cpu = fused_partition(hg, starts=3, kl_config=cfg, device="cpu")
    assert card.start_cuts == cpu.start_cuts
    for name in ("iterations", "initial_cut", "best_cut", "final_cut", "verified_cut"):
        assert getattr(card.kl, name) == getattr(cpu.kl, name), name
    np.testing.assert_array_equal(card.kl.sides, cpu.kl.sides)
    np.testing.assert_array_equal(card.kl.best_sides, cpu.kl.best_sides)
    np.testing.assert_array_equal(card.kl.cut_trajectory, cpu.kl.cut_trajectory)


def _v3_graph(kind):
    """A host graph for the v3 kernels: gen 0.02x, or 2,000 nodes with one
    row of degree 1,300 (it spans three chunks or more)."""
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.graph.expand import clique_expand

    if kind == "gen_0.02":
        return clique_expand(_hypergraph(kind), "kl")
    rng = np.random.default_rng(7)
    n, hub = 2000, 700
    u, v = rng.integers(0, n, 6000), rng.integers(0, n, 6000)
    others = rng.choice(np.delete(np.arange(n), hub), 1300, replace=False)
    u, v = np.concatenate([u, np.full(1300, hub)]), np.concatenate([v, others])
    keep = u != v
    key = np.unique(np.minimum(u, v)[keep] * n + np.maximum(u, v)[keep])
    w = rng.uniform(0.1, 1.0, key.size).astype(np.float32).astype(np.float64)
    return Graph.from_upper_coo(n, key // n, key % n, w)


@pytest.mark.parametrize("kind", ["gen_0.02", "hub"])
def test_v3_kernels_equal_plain_bitwise_and_are_deterministic(cuda, kind):
    from eig_kl_tpu_torch.ops import spmv_v3 as V

    g_host = _v3_graph(kind)
    plan = V.build_plan_v3_for_graph(g_host, cuda)
    n, P = g_host.num_nodes, plan.padded_nodes
    x = np.zeros(P, np.float32)
    x[:n] = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    x[:n:37] = -0.0
    xp = torch.as_tensor(x).to(cuda)
    e_csr = torch.as_tensor(np.random.default_rng(2).standard_normal(plan.padded_nnz).astype(np.float32))
    e_csr[::53] = -0.0
    before = (V.K3A.launches, V.K3B.launches, V.K3C.launches)
    for kernel, plain, first, arg in (
        (V.gather_v3_cuda, V.gather_v3_plain, plan, xp),
        (V.benes_v3_cuda, V.benes_v3_plain, plan.masks, e_csr.to(cuda)),
        (V.reduce_v3_cuda, V.reduce_v3_plain, plan, e_csr.to(cuda)),
    ):
        a, b = kernel(first, arg), kernel(first, arg)
        torch.cuda.synchronize()
        ref = plain(first, arg)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), ref.view(torch.int32))
    groups = len(V.benes_groups(plan.padded_nnz))
    assert (V.K3A.launches, V.K3B.launches, V.K3C.launches) == (
        before[0] + 2, before[1] + 2 * groups, before[2] + 2
    )
    # The whole SpMV on the card equals the plain route on the CPU.
    cpu_plan = V.build_plan_v3_for_graph(g_host, "cpu")
    y = V.spmv_v3(plan, xp[:n])
    y_cpu = V.spmv_v3(cpu_plan, torch.as_tensor(x[:n]))
    assert torch.equal(y.cpu().view(torch.int32), y_cpu.view(torch.int32))


@pytest.mark.parametrize("m, tile", [(m, 1 << 14) for m in (5, 12, 13, 14, 17, 21)] + [(13, 1 << 13), (21, 1 << 13)])
def test_k3b_equals_plain_bitwise(cuda, m, tile):
    """K3b on random switch bits at N = 2^m: one launch per group, bitwise
    equal to the plain network and to a second call, its input unchanged."""
    from eig_kl_tpu_torch.ops import spmv_v3 as V

    N = 1 << m
    rng = np.random.default_rng(m)
    masks = torch.as_tensor(rng.integers(0, 2**32, (2 * m - 1, N // 32), dtype=np.uint32).view(np.int32))
    x = rng.standard_normal(N).astype(np.float32)
    x[::13] = -0.0
    e = torch.as_tensor(x)
    before = V.K3B.launches
    a = V.benes_v3_cuda(masks.to(cuda), e.to(cuda), _tile=tile)
    b = V.benes_v3_cuda(masks.to(cuda), e.to(cuda), _tile=tile)
    torch.cuda.synchronize()
    assert V.K3B.launches == before + 2 * len(V.benes_groups(N, tile))
    ref = V.benes_v3_plain(masks, e)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(a.cpu().view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("size", [0, 1, 2047, 2048, 4097, 202_752])
def test_k4_equals_the_host_chain_bitwise(cuda, size):
    from eig_kl_tpu_torch.ops.reduce import K4, fma_dot, fma_dot_plain

    rng = np.random.default_rng(size)
    x = rng.standard_normal(size).astype(np.float32)
    y = (rng.standard_normal(size) * rng.uniform(0.1, 10.0, size)).astype(np.float32)
    x[::7], y[::11] = 0.0, -0.0
    xc, yc = torch.as_tensor(x).to(cuda), torch.as_tensor(y).to(cuda)
    before = K4.launches
    a, b = fma_dot(xc, yc), fma_dot(xc, yc)
    assert K4.launches == before + 2 and a.device.type == "cuda"
    ref = fma_dot_plain(torch.as_tensor(x), torch.as_tensor(y))
    assert a.cpu().view(torch.int32) == b.cpu().view(torch.int32) == ref.view(torch.int32)


def test_v3_fused_on_the_card_equals_the_cpu_run(cuda):
    """fused_refine_mega on the v3-planned gen 0.02x graph: the card's
    bits are the CPU path's (which the CPU tests hold to the JAX
    package), every SpMV goes through K3a, K3b and K3c, and the Rayleigh
    quotient through K4."""
    import dataclasses

    from eig_kl_tpu_torch.kl.megakernel import K2, fused_refine_mega
    from eig_kl_tpu_torch.ops import spmv_v3 as V
    from eig_kl_tpu_torch.ops.reduce import K4
    from eig_kl_tpu_torch.ops.spmv import K1
    from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig

    g_host = _v3_graph("gen_0.02")
    runs = []
    for dev in (cuda, torch.device("cpu")):
        g = dataclasses.replace(g_host.to_device(dev), plan=V.build_plan_v3_for_graph(g_host, dev))
        for kern in (K1, K2, V.K3A, V.K3B, V.K3C, K4):
            kern.launches = 0
        runs.append(fused_refine_mega(g, SpectralConfig(solver="power"), KLConfig(gain_eps=1e-6)))
        if dev.type == "cuda":
            groups = len(V.benes_groups(g.plan.padded_nnz))
            launches = (K1.launches, K2.launches, V.K3A.launches, V.K3B.launches, V.K3C.launches, K4.launches)
    (eig, kl, iters), (ceig, ckl, citers) = runs
    assert iters == citers == 201
    spmvs = launches[2]
    assert launches == (0, 1, spmvs, groups * spmvs, spmvs, 1) and spmvs >= iters + 2
    assert eig.eigenvalue == ceig.eigenvalue
    np.testing.assert_array_equal(eig.sides, ceig.sides)
    np.testing.assert_array_equal(eig.values, ceig.values)
    for name in ("iterations", "initial_cut", "best_cut", "final_cut", "verified_cut"):
        assert getattr(kl, name) == getattr(ckl, name), name
    np.testing.assert_array_equal(kl.best_sides, ckl.best_sides)
    np.testing.assert_array_equal(kl.cut_trajectory, ckl.cut_trajectory)


def _smega_inputs(g_host, n_shards, device, seed=5):
    """A seeded random split of ``g_host`` as K5's padded inputs on
    ``device``: (graph, shard count, sf0, as0, cut0, cap, nf0, nf1)."""
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
    from eig_kl_tpu_torch.ops.spmv import spmv
    from eig_kl_tpu_torch.parallel.smega import SmegaPlan

    plan = SmegaPlan(g_host, n_shards, align=128)
    g = plan.device_graph(torch.device(device))
    n = g.num_nodes
    sides = random_split(n, seed)
    s = sides_to_signs(torch.as_tensor(sides).to(device), torch.float32)
    sf0 = torch.zeros(plan.n_pad, device=device)
    as0 = torch.zeros(plan.n_pad, device=device)
    sf0[:n] = s
    as0[:n] = spmv(g, s)
    n1 = int(sides.sum())
    return g, n_shards, sf0, as0, float(cut_size(g, s, as0[:n])), min(n1, n - n1), n - n1, n1


@pytest.mark.parametrize("layout", [None, "flat", "global", "shared"])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_k5_equals_plain_bitwise(cuda, n_shards, layout):
    """One cluster of S blocks in each of K5's layouts (None: the
    wrapper's choice): the whole pass from a random split, and a pass
    capped at 50 swaps, bitwise equal to the plain version on the card
    and on the CPU, and to the single-chip K2's swaps."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.kl.megakernel import kl_pass_cuda
    from eig_kl_tpu_torch.parallel.smega import K5, smega_pass, smega_pass_cuda, smega_pass_plain

    g_host = clique_expand(_hypergraph("gen_0.02"), "kl")
    args = _smega_inputs(g_host, n_shards, cuda)
    g, _, sf0, as0, cut0, cap, nf0, nf1 = args
    cpu_args = _smega_inputs(g_host, n_shards, "cpu")
    passes = []
    for c in (cap, 50):
        tail = (c, nf0, nf1, cap + 1, 16, 1e-6)
        before = K5.launches
        if layout is None:
            got = smega_pass(g, n_shards, sf0, as0, cut0, *tail)
        else:
            got = smega_pass_cuda(g, n_shards, sf0, as0, cut0, *tail, _layout=layout)
        assert K5.launches == before + 1
        ref = smega_pass_plain(g, n_shards, sf0, as0, cut0, *tail)
        ref_cpu = smega_pass(*cpu_args[:5], *tail)
        torch.cuda.synchronize()
        it = int(got.scalars[2])
        assert it > 50 if c == cap else it == 50
        for name in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"):
            assert torch.equal(getattr(got, name), getattr(ref, name)), name
            assert torch.equal(getattr(got, name).cpu(), getattr(ref_cpu, name)), name
        passes.append(got)
    n = g.num_nodes
    single = kl_pass_cuda(g, sf0[:n].contiguous(), as0[:n].contiguous(), cut0, cap, 16, 1e-6)
    for name in ("log_cut", "log_gain", "log_a", "log_b", "scalars"):
        assert torch.equal(getattr(passes[0], name), getattr(single, name)), name


@pytest.mark.parametrize("layout", ["flat", "global", "shared"])
@pytest.mark.parametrize("n_shards", [1, 8])
def test_k5_ties_and_a_side_running_out(cuda, n_shards, layout):
    """The dyadic graph (exact sums, many tied gains, +0 and -0 among
    them) from a 30/70 split with no termination rule: the pass runs to
    its cap, until the smaller side has no free node left, shards running
    out one by one.  Bitwise equal to the plain version and to K2's pass
    with its row-max cache (forced to "shared") on the same input."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.kl.megakernel import kl_pass_batch_cuda
    from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
    from eig_kl_tpu_torch.ops.spmv import spmv
    from eig_kl_tpu_torch.parallel.smega import SmegaPlan, smega_pass_cuda, smega_pass_plain

    g_host = clique_expand(_hypergraph("dyadic"), "kl")
    plan = SmegaPlan(g_host, n_shards, align=128)
    g = plan.device_graph(cuda)
    n = g.num_nodes
    sides = (np.random.default_rng(4).random(n) < 0.3).astype(np.int8)
    s = sides_to_signs(torch.as_tensor(sides).to(cuda), torch.float32)
    sf0 = torch.zeros(plan.n_pad, device=cuda)
    as0 = torch.zeros_like(sf0)
    sf0[:n], as0[:n] = s, spmv(g, s)
    n1 = int(sides.sum())
    cap, cut0 = min(n1, n - n1), float(cut_size(g, s, as0[:n]))
    args = (g, n_shards, sf0, as0, cut0, cap, n - n1, n1, cap + 1, n, 1e-6)
    got = smega_pass_cuda(*args, _layout=layout)
    ref = smega_pass_plain(*args)
    torch.cuda.synchronize()
    assert int(got.scalars[2]) == cap and int(got.scalars[5]) == 0
    for name in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    one = torch.tensor([cut0], device=cuda)
    cap_t = torch.tensor([cap], dtype=torch.int32, device=cuda)
    k2 = kl_pass_batch_cuda(
        g, s[None], as0[:n][None].contiguous(), one, one, cap_t, torch.zeros_like(cap_t), cap + 1, n, 1e-6,
        _cache="shared",
    ).start(0)
    for name in ("log_cut", "log_gain", "log_a", "log_b", "scalars"):
        assert torch.equal(getattr(got, name), getattr(k2, name)), name
    assert torch.equal(got.sf[:n], k2.sf)


def test_smega_refine_on_the_card_equals_the_cpu_run(cuda):
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.ops.spmv import K1
    from eig_kl_tpu_torch.parallel.smega import K5, smega_refine
    from eig_kl_tpu_torch.utils.config import KLConfig

    g_host = clique_expand(_hypergraph("gen_0.02"), "kl")
    sides = random_split(g_host.num_nodes, 3)
    cfg = KLConfig(gain_eps=1e-6)
    K1.launches = K5.launches = 0
    card = smega_refine(g_host, sides, 4, cfg)  # the default device is the card
    assert (K1.launches, K5.launches) == (1, 1)
    cpu = smega_refine(g_host, sides, 4, cfg, device="cpu")
    for name in ("iterations", "initial_cut", "best_cut", "final_cut", "verified_cut"):
        assert getattr(card, name) == getattr(cpu, name), name
    for name in ("sides", "best_sides", "cut_trajectory", "gain_trajectory"):
        np.testing.assert_array_equal(getattr(card, name), getattr(cpu, name))


@pytest.mark.parametrize("n_shards", [3, 16])
def test_k5_refuses_other_shard_counts(cuda, n_shards):
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.parallel.smega import K5, smega_pass_cuda

    g_host = clique_expand(_hypergraph("gen_0.02"), "kl")
    g, _, sf0, as0, cut0, cap, nf0, nf1 = _smega_inputs(g_host, n_shards, cuda)
    before = K5.launches
    with pytest.raises(ValueError, match="A8c"):
        smega_pass_cuda(g, n_shards, sf0, as0, cut0, cap, nf0, nf1, cap + 1, 16, 1e-6)
    assert K5.launches == before


def test_k5_layout_refusals(cuda):
    """A cached layout needs shards of whole 128-node rows, and the
    "shared" layout a stripe that fits one block; nothing is launched."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.parallel.smega import K5, smega_pass_cuda

    g_host = clique_expand(_hypergraph("gen_0.02"), "kl")
    g, shards, sf0, as0, cut0, cap, nf0, nf1 = _smega_inputs(g_host, 1, cuda)
    tail = (cut0, cap, nf0, nf1, cap + 1, 16, 1e-6)
    before = K5.launches
    odd = torch.zeros(4100, device=cuda)
    odd[: sf0.numel()] = sf0
    with pytest.raises(ValueError, match="multiple of 128"):
        smega_pass_cuda(g, 1, odd, odd, *tail, _layout="global")
    big = torch.zeros(40_960, device=cuda)
    big[: sf0.numel()] = sf0
    with pytest.raises(ValueError, match="does not fit"):
        smega_pass_cuda(g, 1, big, big, *tail, _layout="shared")
    with pytest.raises(ValueError, match="_layout"):
        smega_pass_cuda(g, 1, sf0, as0, *tail, _layout="cache")
    assert K5.launches == before


def test_k3c_equals_plain_bitwise_with_negative_zero_rows(cuda):
    """K3c alone on the hub graph's plan (a row of degree 1,300 over three
    chunks or more) and gen 0.02x's, with -0 products scattered and in
    whole rows: bitwise equal to ``reduce_v3_plain``."""
    from eig_kl_tpu_torch.ops import spmv_v3 as V

    for kind in ("gen_0.02", "hub"):
        g_host = _v3_graph(kind)
        plan = V.build_plan_v3_for_graph(g_host, cuda)
        cpu_plan = V.build_plan_v3_for_graph(g_host, "cpu")
        rows = np.repeat(np.arange(g_host.num_nodes), np.diff(g_host.indptr))
        for seed in (0, 1):
            x = np.random.default_rng(seed).standard_normal(plan.padded_nnz).astype(np.float32)
            x[seed::53] = -0.0
            x[: rows.size][rows % 17 == seed] = -0.0
            e = torch.as_tensor(x)
            got = V.reduce_v3_cuda(plan, e.to(cuda))
            ref = V.reduce_v3_plain(cpu_plan, e)
            assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32)), (kind, seed)


def test_k5_wrapper_checks_its_arguments(cuda):
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.parallel.smega import K5, smega_pass, smega_pass_cuda

    g_host = clique_expand(_hypergraph("gen_0.02"), "kl")
    g, shards, sf0, as0, cut0, cap, nf0, nf1 = _smega_inputs(g_host, 2, cuda)
    tail = (cut0, cap, nf0, nf1, cap + 1, 16, 1e-6)
    before = K5.launches
    with pytest.raises(TypeError, match="float32"):
        smega_pass(g, shards, sf0.double(), as0, *tail)
    with pytest.raises(TypeError, match="int32"):
        smega_pass(dataclasses.replace(g, indices=g.indices.long()), shards, sf0, as0, *tail)
    with pytest.raises(ValueError, match="CUDA"):
        smega_pass_cuda(g, shards, sf0.cpu(), as0, *tail)
    with pytest.raises(ValueError, match="CUDA"):
        smega_pass_cuda(dataclasses.replace(g, indptr=g.indptr.cpu()), shards, sf0, as0, *tail)
    with pytest.raises(ValueError, match="nodes"):
        smega_pass(g, shards, sf0[:3840], as0[:3840], *tail)  # fewer than the graph's 4,038
    with pytest.raises(ValueError, match="multiple"):
        smega_pass(g, shards, sf0[:-1], as0[:-1], *tail)
    with pytest.raises(ValueError, match="log_len"):
        smega_pass(g, shards, sf0, as0, cut0, cap, nf0, nf1, cap, 16, 1e-6)
    assert K5.launches == before


K6_SHAPES = [(0,), (1,), (31,), (32,), (33,), (1023,), (1025,), (4038,), (201_920,), (100_003,),
             (32, 128), (192, 128), (1584, 128), (33, 70), (1, 1000), (64_000, 10), (5, 7), (0, 100)]


def _k6_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(shape) * 10.0 ** rng.uniform(-1.0, 1.0, shape)
    w = rng.standard_normal(shape)
    pick = rng.random(shape)
    v[pick < 0.1], v[(pick >= 0.1) & (pick < 0.2)] = 0.0, -0.0
    return torch.as_tensor(v.astype(np.float32)), torch.as_tensor(w.astype(np.float32))


def _k6_plain(mode, v, w):
    from eig_kl_tpu_torch.ops import reduce as R

    one_d = v.dim() == 1
    if mode == "sum":
        return (R.tree_sum_plain if one_d else R.tree_sum_2d_plain)(v)
    if mode == "norm":
        return R.sqrt_rn(R._products_plain(v, v, R.tree_sum_plain if one_d else R.tree_sum_2d_plain))
    return R._products_plain(v, w, R.tree_sum_plain if one_d else R.tree_sum_2d_plain)


@pytest.mark.parametrize("shape", K6_SHAPES)
@pytest.mark.parametrize("mode", ["sum", "norm", "dot"])
def test_k6_equals_plain_bitwise_and_is_deterministic(cuda, shape, mode):
    """K6 (the sum, the norm with its root, the dot) against the plain
    versions on the card and on the CPU, +0 and -0 among the inputs, and
    equal over repeated launches."""
    from eig_kl_tpu_torch.ops.reduce import K6, tree_sum_cuda

    v, w = _k6_inputs(shape, sum(shape))
    vc, wc = v.to(cuda), w.to(cuda)
    kw = {"sum": {}, "norm": {"square": True, "root": True}, "dot": {}}[mode]
    args = (vc, wc) if mode == "dot" else (vc,)
    before = K6.launches
    outs = [tree_sum_cuda(*args, **kw) for _ in range(5)]
    assert K6.launches == before + 5
    ref_card = _k6_plain(mode, vc, wc)
    ref_cpu = _k6_plain(mode, v, w)
    torch.cuda.synchronize()
    bits = {int(o.cpu().view(torch.int32)) for o in outs}
    assert bits == {int(ref_card.cpu().view(torch.int32))} == {int(ref_cpu.view(torch.int32))}


def test_k6_dispatch_on_the_card(cuda):
    """tree_sum, tree_dot, tree_norm, tree_sum_2d and tree_norm_2d launch
    K6 once each on a CUDA tensor and give the CPU's bits."""
    from eig_kl_tpu_torch.ops import reduce as R

    v, w = _k6_inputs((4096,), 1)
    before = R.K6.launches
    for fn, args in ((R.tree_sum, (v,)), (R.tree_dot, (v, w)), (R.tree_norm, (v,)),
                     (R.tree_sum_2d, (v.view(32, 128),)), (R.tree_norm_2d, (v.view(32, 128),))):
        got = fn(*(a.to(cuda) for a in args))
        assert got.device.type == "cuda"
        assert got.cpu().view(torch.int32) == fn(*args).view(torch.int32)
    assert R.K6.launches == before + 5


def test_k6_ticket_resets_between_launches_and_streams(cuda):
    """Back-to-back launches of different shapes on the default stream,
    then interleaved on two more streams without a synchronisation between
    them: every result right, every stream's ticket 0 afterwards."""
    from eig_kl_tpu_torch.ops import reduce as R

    shapes = [(201_920,), (1584, 128), (7,), (4038,), (64_000, 10)]
    inputs = [_k6_inputs(shape, k)[0] for k, shape in enumerate(shapes)]
    want = [int(_k6_plain("sum", v, v).view(torch.int32)) for v in inputs]
    on_card = [v.to(cuda) for v in inputs]
    first = [R.tree_sum_cuda(v) for _ in range(3) for v in on_card]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    later = []
    for _ in range(4):
        for k, v in enumerate(on_card):
            with torch.cuda.stream(streams[k % 2]):
                later.append((k, R.tree_sum_cuda(v)))
    torch.cuda.synchronize()
    assert [int(o.cpu().view(torch.int32)) for o in first] == want * 3
    assert all(int(o.cpu().view(torch.int32)) == want[k] for k, o in later)
    assert all(int(t.item()) == 0 for t in R._TICKETS.values())


def test_k6_refuses_f64_and_odd_tensors(cuda):
    """An f64 vector beside an f32 one, or an f16 one: K6 takes f32 or f64
    tensors of one dtype (its f64 runs are test_k6_f64_*)."""
    from eig_kl_tpu_torch.ops.reduce import K6, K6_F64, tree_norm, tree_sum_cuda

    before = K6.launches, K6_F64.launches
    with pytest.raises(TypeError, match="f32 or f64"):
        tree_sum_cuda(torch.zeros(100, device=cuda), torch.zeros(100, dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError, match="f32 or f64"):
        tree_norm(torch.zeros(100, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        tree_sum_cuda(torch.zeros(64, 2, device=cuda).t())
    with pytest.raises(ValueError, match="contiguous"):
        tree_sum_cuda(torch.zeros(2, 2, 2, device=cuda))
    assert (K6.launches, K6_F64.launches) == before


def test_k6_scale_equals_plain_bitwise(cuda):
    from eig_kl_tpu_torch.ops.reduce import K6_SCALE, normalize_cuda, normalize_plain

    y = _k6_inputs((201_920,), 3)[0].to(cuda)
    before = K6_SCALE.launches
    for nrm in (torch.tensor(3.7, device=cuda), torch.tensor(0.0, device=cuda), torch.tensor(float("nan"), device=cuda)):
        got = normalize_cuda(y, nrm)
        assert torch.equal(got.view(torch.int32), normalize_plain(y, nrm).view(torch.int32))
    assert K6_SCALE.launches == before + 3


@pytest.mark.parametrize("kind", ["w8", "w16", "gen_0.02", "hub10", "hub44", "hub130", "hub1300"])
def test_k1_and_its_step_equal_plain_bitwise(cuda, kind):
    """K1 against spmv_plain, and K1's power step entry point against
    power_step_plain (on the card and on the CPU) at shift 2.0 and 3.0,
    for W <= 16 (w8, w16: one chain; the step also with ``lanes``, the
    solve's first step), W <= 32 (gen 0.02x, hub10: 8 lanes), W > 32
    (hub44: two windows), a row of more than 64 entries (hub130; it, w8,
    w16 and gen 0.02x have rows of degree 0) and one of 1,300 (its warp's
    span crosses K1's buffers of 1,024 entries)."""
    from eig_kl_tpu_torch.ops.spmv import K1, K1_STEP, power_step, power_step_plain, spmv_csr, spmv_plain

    if kind == "hub1300":
        g_host = _v3_graph("hub")
        g_cpu, g = g_host.to_device("cpu"), g_host.to_device(cuda)
        assert g_host.max_degree >= 1300
    else:
        g_cpu, g = _graphs(kind, cuda)
        assert kind in ("hub10", "hub44") or bool((g_cpu.degrees == 0).any())
    assert g.row_width == {"w8": 8, "w16": 16}.get(kind, g.row_width)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(g.num_nodes).astype(np.float32))
    deg = torch.where(g_cpu.degrees > 0, g_cpu.degrees, 1.0)
    before = (K1_STEP.launches, K1.launches)
    for inv, lanes in ((0.5, False), (1.0 / 3.0, False), (0.5, True)):
        y = power_step(g, x.to(cuda), deg.to(cuda), inv, lanes=lanes)
        want = power_step_plain(g_cpu, x, deg, inv, lanes=lanes)
        assert torch.equal(y.view(torch.int32), power_step_plain(g, x.to(cuda), deg.to(cuda), inv, lanes=lanes).view(torch.int32))
        assert torch.equal(y.cpu().view(torch.int32), want.view(torch.int32))
    ax = spmv_csr(g, x.to(cuda))
    assert torch.equal(ax.cpu().view(torch.int32), spmv_plain(g_cpu, x).view(torch.int32))
    assert (K1_STEP.launches, K1.launches) == (before[0] + 3, before[1] + 1)


def test_power_step_on_the_card_launches_at_most_4_kernels(cuda):
    """On gen 0.02x, an f32 CSR power step is K1's step, K6 and K6's scale:
    the profiler sees at most 4 kernels per step (3 here), and the steps'
    bits are the CPU's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from eig_kl_tpu_torch.spectral.power import power_operator

    g_cpu, g = _graphs("gen_0.02", cuda)
    op, op_cpu = power_operator(g, 2.0, torch.float32), power_operator(g_cpu, 2.0, torch.float32)
    x0 = torch.as_tensor(np.random.default_rng(0).random(g.num_nodes).astype(np.float32) - 0.5)
    x = op.step(x0.to(cuda))[0]
    torch.cuda.synchronize()
    steps = 10
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            x = op.step(x)[0]
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert 0 < len(kernels) <= 4 * steps, sorted({e.name for e in kernels})
    x_cpu = op_cpu.step(x0)[0]
    for _ in range(steps):
        x_cpu = op_cpu.step(x_cpu)[0]
    assert torch.equal(x.cpu().view(torch.int32), x_cpu.view(torch.int32))


# ------------------------------------------------ K1's Laplacian, SpMM, walk


def _eig_graphs(kind, device):
    """The same "eig"-weighted f32 graph on the CPU and on the card."""
    from eig_kl_tpu_torch.graph.expand import clique_expand

    g_host = clique_expand(_hypergraph(kind), "eig")
    return g_host.to_device("cpu"), g_host.to_device(device)


@pytest.mark.parametrize("kind", ["w8", "w16", "gen_0.02", "hub10", "hub44", "hub130"])
def test_k1_epilogues_equal_plain_bitwise(cuda, kind):
    """K1's Laplacian, blocked and lazy-walk entry points against their plain
    versions on the card and on the CPU, bit for bit, and deterministic;
    each column of the blocked product equals K1 on that column."""
    import importlib

    S = importlib.import_module("eig_kl_tpu_torch.ops.spmv")
    g_cpu, g = _eig_graphs(kind, cuda)
    rng = np.random.default_rng(2)
    n = g.num_nodes
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
    x[::53] = -0.0
    d = torch.as_tensor((1.0 / np.sqrt(rng.uniform(0.5, 9.0, n))).astype(np.float32))
    before = (S.K1_LAPLACIAN.launches, S.K1_SPMM.launches, S.K1_LAZY.launches)
    lap = S.laplacian(g, x.to(cuda))
    assert torch.equal(lap, S.laplacian_cuda(g, x.to(cuda)))
    assert torch.equal(lap, S.laplacian_plain(g, x.to(cuda)))
    assert torch.equal(lap.cpu(), S.laplacian_plain(g_cpu, x))
    walk = S.lazy_walk(g, x.to(cuda), d.to(cuda))
    assert torch.equal(walk, S.lazy_walk_cuda(g, x.to(cuda), d.to(cuda)))
    assert torch.equal(walk.cpu(), S.lazy_walk_plain(g_cpu, x, d))
    spmm_launches = 0
    for k in (1, 4, 12, 16):
        X = torch.as_tensor(rng.standard_normal((n, k)).astype(np.float32))
        for laplacian in (False, True):
            Y = S.spmm(g, X.to(cuda), laplacian=laplacian)
            assert torch.equal(Y, S.spmm_cuda(g, X.to(cuda), laplacian=laplacian))
            assert torch.equal(Y.cpu(), S.spmm_plain(g_cpu, X, laplacian=laplacian))
            spmm_launches += 2
        for j in range(k):
            assert torch.equal(S.spmm(g, X.to(cuda))[:, j], S.spmv_csr(g, X[:, j].contiguous().to(cuda)))
            spmm_launches += 1
        # A contiguous X that is not 16-byte aligned takes the kernel's
        # column-at-a-time branch: the same bits.
        store = torch.empty(n * k + 1, device=cuda)
        X_odd = store[1:].view(n, k)
        X_odd.copy_(X.to(cuda))
        assert torch.equal(S.spmm(g, X_odd, laplacian=True).cpu(), S.spmm_plain(g_cpu, X, laplacian=True))
        spmm_launches += 1
    torch.cuda.synchronize()
    after = (S.K1_LAPLACIAN.launches, S.K1_SPMM.launches, S.K1_LAZY.launches)
    assert after == (before[0] + 2, before[1] + spmm_launches, before[2] + 2)


def test_k1_spmm_checks_its_arguments(cuda):
    from eig_kl_tpu_torch.ops.spmv import spmm_cuda

    _, g = _eig_graphs("gen_0.02", cuda)
    n = g.num_nodes
    with pytest.raises(ValueError, match="1 <= k <= 16"):
        spmm_cuda(g, torch.zeros(n, 17, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        spmm_cuda(g, torch.zeros(4, n, device=cuda).T)
    with pytest.raises(TypeError, match="float32"):
        spmm_cuda(g, torch.zeros(n, 4, dtype=torch.float64, device=cuda))


def test_k6_axpy_and_padded_step_equal_plain_bitwise(cuda):
    from eig_kl_tpu_torch.ops import reduce as R

    rng = np.random.default_rng(4)
    x, y, a = (torch.as_tensor(rng.standard_normal((1584, 128)).astype(np.float32)) for _ in range(3))
    deg = torch.as_tensor(rng.uniform(0.5, 9.0, (1584, 128)).astype(np.float32))
    c = torch.tensor(np.float32(-0.3712))
    for aa in (c, a):
        got = R.axpy(aa.to(cuda), x.to(cuda), y.to(cuda))
        assert torch.equal(got, R.axpy_cuda(aa.to(cuda), x.to(cuda), y.to(cuda)))
        assert torch.equal(got.cpu(), R.axpy_plain(aa, x, y))
    for inv_shift in (0.5, 1.0 / 3.0):
        got = R.padded_step(x.to(cuda), y.to(cuda), deg.to(cuda), inv_shift)
        assert torch.equal(got.cpu(), R.padded_step_plain(x, y, deg, inv_shift))


def test_momentum_on_the_card_equals_the_cpu_run(cuda):
    """The momentum exit at f32 on gen 0.02x: the card's run (K1's lazy
    walk, K4, K6 and its axpy) equals the CPU's plain run bit for bit."""
    from eig_kl_tpu_torch.ops.reduce import K6_AXPY
    from eig_kl_tpu_torch.ops.spmv import K1_LAZY
    from eig_kl_tpu_torch.spectral.power import power_partition_fiedler
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    g_cpu, g = _graphs("gen_0.02", cuda)
    cfg = SpectralConfig(solver="power", convergence="momentum", max_iterations=201)
    before = (K1_LAZY.launches, K6_AXPY.launches)
    card = power_partition_fiedler(g, cfg)
    assert K1_LAZY.launches > before[0] and K6_AXPY.launches > before[1]
    cpu = power_partition_fiedler(g_cpu, cfg)
    assert card[4] == cpu[4] == 201
    assert card[1] == cpu[1]
    np.testing.assert_array_equal(card[2].view(np.int32), cpu[2].view(np.int32))
    np.testing.assert_array_equal(card[3], cpu[3])


@pytest.mark.parametrize("solver", ["lanczos", "lobpcg"])
def test_other_solvers_on_the_card_equal_the_cpu_run(cuda, solver):
    """Lanczos and LOBPCG at f32 with the host refinement, on the card and
    on the CPU, on gen 0.02x's largest component: the f32 trajectories
    part (cuBLAS and the CPU add in other orders), the refined lambda_2
    agrees to 1e-6 relative."""
    from eig_kl_tpu_torch.io.hgr import Hypergraph
    from eig_kl_tpu_torch.ops.spmv import K1_LAPLACIAN, K1_SPMM
    from eig_kl_tpu_torch.spectral.partition import eig_partition_solve
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    hg = _hypergraph("gen_0.02")
    sizes = np.diff(hg.net_offsets)
    first = np.repeat(hg.pins[hg.net_offsets[:-1]], sizes)
    adj = sp.coo_matrix((np.ones(len(first)), (first, hg.pins)), shape=(hg.num_nodes,) * 2)
    _, label = csgraph.connected_components(adj, directed=False)
    keep = label == np.argmax(np.bincount(label))
    nets = np.add.reduceat(keep[hg.pins].astype(np.int64), hg.net_offsets[:-1]) == sizes
    pins = (np.cumsum(keep) - 1)[hg.pins[np.repeat(nets, sizes)]].astype(np.int32)
    offsets = np.zeros(int(nets.sum()) + 1, np.int64)
    np.cumsum(sizes[nets], out=offsets[1:])
    lcc = Hypergraph(int(keep.sum()), int(nets.sum()), pins, offsets)
    before = K1_LAPLACIAN.launches + K1_SPMM.launches
    card, solve = eig_partition_solve(lcc, SpectralConfig(solver=solver), device="cuda")
    assert K1_LAPLACIAN.launches + K1_SPMM.launches > before
    cpu, _ = eig_partition_solve(lcc, SpectralConfig(solver=solver), device="cpu")
    assert card.eigenvalue == pytest.approx(cpu.eigenvalue, rel=1e-6)
    assert card.eigenvalue == pytest.approx(0.0973479036, rel=1e-6)
    assert solve.refined is not None and solve.refined[1] <= 1e-5
    assert sorted(card.balance()) == [1847, 1847]


# ------------------------------------------------------------- the f64 engine


@pytest.mark.parametrize("kind", ["w8", "w16", "gen_0.02", "hub10", "hub44", "hub130", "hub1300"])
def test_k1_f64_entry_points_equal_plain_bitwise(cuda, kind):
    """K1's five f64 entry points against their plain versions on the card
    and on the CPU, bit for bit: the SpMV and the power step (shift 2 and 3)
    on the KL graph, the Laplacian, the blocked product (k = 1, 2, 4, 12,
    16; four columns per walk where k is a multiple of 4, one at a time
    for other k or an unaligned X) and the lazy walk on the "eig" graph; the f32
    kernels launch nothing."""
    import importlib

    from eig_kl_tpu_torch.graph.expand import clique_expand

    S = importlib.import_module("eig_kl_tpu_torch.ops.spmv")
    if kind == "hub1300":
        g_kl = g_eig = _v3_graph("hub")
    else:
        hg = _hypergraph(kind)
        g_kl, g_eig = clique_expand(hg, "kl"), clique_expand(hg, "eig")
    f32 = [S.K1, S.K1_STEP, S.K1_LAPLACIAN, S.K1_SPMM, S.K1_LAZY]
    f32_before = [k.launches for k in f32]
    rng = np.random.default_rng(6)

    def both(host):
        return host.to_device("cpu", torch.float64), host.to_device(cuda, torch.float64)

    def same(a, b):
        assert a.dtype == b.dtype == torch.float64
        assert torch.equal(a.cpu().view(torch.int64), b.cpu().view(torch.int64))

    g_cpu, g = both(g_kl)
    n = g.num_nodes
    x = torch.as_tensor(rng.standard_normal(n))
    x[::53] = -0.0
    deg = torch.where(g_cpu.degrees > 0, g_cpu.degrees, 1.0)
    same(S.spmv(g, x.to(cuda)), S.spmv_plain(g_cpu, x))
    same(S.spmv(g, x.to(cuda)), S.spmv_plain(g, x.to(cuda)))
    for inv in (0.5, 1.0 / 3.0):
        y = S.power_step(g, x.to(cuda), deg.to(cuda), inv)
        same(y, S.power_step_plain(g_cpu, x, deg, inv))
        same(y, S.power_step_plain(g, x.to(cuda), deg.to(cuda), inv))
    e_cpu, e = both(g_eig)
    d = torch.as_tensor(1.0 / np.sqrt(rng.uniform(0.5, 9.0, n)))
    same(S.laplacian(e, x.to(cuda)), S.laplacian_plain(e_cpu, x))
    same(S.lazy_walk(e, x.to(cuda), d.to(cuda)), S.lazy_walk_plain(e_cpu, x, d))
    for k in (1, 2, 4, 12, 16):
        X = torch.as_tensor(rng.standard_normal((n, k)))
        for laplacian in (False, True):
            same(S.spmm(e, X.to(cuda), laplacian=laplacian), S.spmm_plain(e_cpu, X, laplacian=laplacian))
        store = torch.empty(n * k + 1, dtype=torch.float64, device=cuda)
        X_odd = store[1:].view(n, k)
        X_odd.copy_(X.to(cuda))
        same(S.spmm(e, X_odd, laplacian=True), S.spmm_plain(e_cpu, X, laplacian=True))
    torch.cuda.synchronize()
    assert [k.launches for k in f32] == f32_before
    assert S.K1_F64.launches and S.K1_STEP_F64.launches and S.K1_SPMM_F64.launches


@pytest.mark.parametrize("shape", K6_SHAPES)
@pytest.mark.parametrize("mode", ["sum", "norm", "dot"])
def test_k6_f64_equals_plain_bitwise(cuda, shape, mode):
    """K6 at f64 (the sum, the norm with its f64 root, the dot) against the
    plain versions on the card and on the CPU, +0 and -0 among the inputs,
    equal over repeated launches."""
    from eig_kl_tpu_torch.ops.reduce import K6, K6_F64, tree_sum_cuda

    v, w = (t.double() * (1.0 + 2.0**-30) for t in _k6_inputs(shape, sum(shape)))
    vc, wc = v.to(cuda), w.to(cuda)
    kw = {"sum": {}, "norm": {"square": True, "root": True}, "dot": {}}[mode]
    args = (vc, wc) if mode == "dot" else (vc,)
    before = K6.launches, K6_F64.launches
    outs = [tree_sum_cuda(*args, **kw) for _ in range(3)]
    assert (K6.launches, K6_F64.launches) == (before[0], before[1] + 3)
    ref_card, ref_cpu = _k6_plain(mode, vc, wc), _k6_plain(mode, v, w)
    torch.cuda.synchronize()
    bits = {int(o.cpu().view(torch.int64)) for o in outs}
    assert bits == {int(ref_card.cpu().view(torch.int64))} == {int(ref_cpu.view(torch.int64))}


def test_k6_f64_scale_and_axpy_equal_plain_bitwise(cuda):
    from eig_kl_tpu_torch.ops import reduce as R

    rng = np.random.default_rng(8)
    x, y, a = (torch.as_tensor(rng.standard_normal(184_406)) for _ in range(3))
    before = R.K6_SCALE.launches, R.K6_AXPY.launches
    for nrm in (torch.tensor(3.25), torch.tensor(0.0), R.tree_norm(x)):
        nrm = nrm.double()
        assert torch.equal(R.normalize(x.to(cuda), nrm.to(cuda)).cpu(), R.normalize_plain(x, nrm))
    for aa in (torch.tensor(-0.3712, dtype=torch.float64), a):
        got = R.axpy(aa.to(cuda), x.to(cuda), y.to(cuda))
        assert torch.equal(got.cpu().view(torch.int64), R.axpy_plain(aa, x, y).view(torch.int64))
    assert (R.K6_SCALE.launches, R.K6_AXPY.launches) == before
    assert R.K6_SCALE_F64.launches >= 3 and R.K6_AXPY_F64.launches >= 2


@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 1023, 1024, 1025, 4038, 184_406])
def test_k4_f64_equals_the_host_chain_bitwise(cuda, size):
    """K4 at f64: the first 8 products rounded and added, then the fused
    chain (XLA's vdot), equal to the host's exact chain."""
    from eig_kl_tpu_torch.ops.reduce import K4, K4_F64, fma_dot, fma_dot_plain

    rng = np.random.default_rng(size)
    x = rng.standard_normal(size)
    y = rng.standard_normal(size) * rng.uniform(0.1, 10.0, size)
    x[::7], y[::11] = 0.0, -0.0
    xc, yc = torch.as_tensor(x).to(cuda), torch.as_tensor(y).to(cuda)
    before = K4.launches, K4_F64.launches
    a, b = fma_dot(xc, yc), fma_dot(xc, yc)
    assert (K4.launches, K4_F64.launches) == (before[0], before[1] + 2) and a.dtype == torch.float64
    ref = fma_dot_plain(torch.as_tensor(x), torch.as_tensor(y))
    assert a.cpu().view(torch.int64) == b.cpu().view(torch.int64) == ref.view(torch.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("size", [0, 1, 7, 8, 9, 2047, 2048, 4097, 202_752])
def test_k4_batch_equals_the_host_chain_bitwise(cuda, dtype, size):
    """``fma_dot_batch`` at 1 to 4 pairs per launch: each dot bit for bit
    the host chain (8 rounded products, then the fused chain), one launch
    per batch.  The fourth pair starts 8 bytes after an aligned address, so
    its copies are not the 16-byte ones."""
    from eig_kl_tpu_torch.ops.reduce import K4, K4_F64, fma_dot_batch, fma_dot_plain

    rng = np.random.default_rng(size + 7)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    pairs = []
    for k in range(4):
        x = rng.standard_normal(size + 2)
        y = rng.standard_normal(size + 2) * rng.uniform(0.1, 10.0, size + 2)
        x[::7], y[::11] = 0.0, -0.0
        lo = 2 if dtype == torch.float32 and k == 3 else 1 if k == 3 else 0
        pairs.append((torch.as_tensor(x.astype(np_dtype)), torch.as_tensor(y.astype(np_dtype)), lo))
    host = [fma_dot_plain(x[lo : lo + size], y[lo : lo + size]) for x, y, lo in pairs]
    kern = K4 if dtype == torch.float32 else K4_F64
    on_card = [(x.to(cuda)[lo : lo + size], y.to(cuda)[lo : lo + size]) for x, y, lo in pairs]
    assert size == 0 or on_card[3][0].data_ptr() % 16 == 8
    for count in range(1, 5):
        before = kern.launches
        got = fma_dot_batch([x for x, _ in on_card[:count]], [y for _, y in on_card[:count]])
        assert kern.launches == before + 1 and got.shape == (count,) and got.dtype == dtype
        assert torch.equal(got.cpu(), torch.stack(host[:count]))


def test_k4_batch_refuses_what_it_cannot_run(cuda):
    """Five pairs, vectors of two lengths or dtypes, a CPU tensor: refused,
    no launch counted."""
    from eig_kl_tpu_torch.ops.reduce import K4, K4_F64, fma_dot_batch_cuda

    x = torch.zeros(100, device=cuda)
    before = K4.launches, K4_F64.launches
    with pytest.raises(ValueError, match="1 to 4 pairs"):
        fma_dot_batch_cuda([x] * 5, [x] * 5)
    with pytest.raises(ValueError, match="one length"):
        fma_dot_batch_cuda([x, x[:50]], [x, x[:50]])
    with pytest.raises(TypeError, match="f32 or f64"):
        fma_dot_batch_cuda([x, x.double()], [x, x.double()])
    with pytest.raises(ValueError, match="CUDA"):
        fma_dot_batch_cuda([x, x.cpu()], [x, x.cpu()])
    assert (K4.launches, K4_F64.launches) == before


def test_k6_plan_and_scratch_are_kept_per_shape_and_stream(cuda):
    """K6's plan is built once per shape; its scratch is one buffer per
    stream and dtype, grown for a larger shape, so a launch allocates only
    its output; shapes interleaved on two streams give the plain sums."""
    from eig_kl_tpu_torch.ops import reduce as R

    shapes = [(7,), (4038,), (1584, 128), (201_920,), (64_000, 10)]
    assert all(R.k6_plan(s) is R.k6_plan(s) for s in shapes)
    inputs = [_k6_inputs(s, k)[0] for k, s in enumerate(shapes)]
    want = [int(_k6_plain("sum", v, v).view(torch.int32)) for v in inputs]
    on_card = [v.to(cuda) for v in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    outs = []
    for k, v in enumerate(on_card * 2):
        with torch.cuda.stream(streams[k % 2]):
            outs.append((k % len(shapes), R.tree_sum_cuda(v)))
    torch.cuda.synchronize()
    assert all(int(o.cpu().view(torch.int32)) == want[k] for k, o in outs)
    keys = {(cuda.index or 0, s.cuda_stream, torch.float32) for s in streams}
    assert keys <= set(R._SCRATCH) and len({R._SCRATCH[k].data_ptr() for k in keys}) == 2
    need = max(R.k6_plan(s)[1] for s in shapes)
    assert all(R._SCRATCH[k].numel() >= need for k in keys)
    v = on_card[3]
    R.tree_sum_cuda(v)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    out = R.tree_sum_cuda(v)
    after = torch.cuda.memory_allocated(cuda)
    one = torch.empty((), device=cuda)
    assert after - before == torch.cuda.memory_allocated(cuda) - after  # the output alone
    del one
    assert int(out.cpu().view(torch.int32)) == want[3]


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_f64_equals_plain_bitwise(cuda, case):
    """K2's f64 instantiation in every case of test_k2_equals_plain_bitwise:
    the flat scan, the row-max cache in shared and in global memory, one
    start and batches, ties and a side that runs out."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.kl.megakernel import K2, K2_F64, kl_pass, kl_pass_batch_cuda, kl_pass_batch_plain

    kind, starts, split, cache, cap = K2_CASES[case]
    g = clique_expand(_hypergraph(kind), "kl").to_device(cuda, torch.float64)
    n = g.num_nodes
    if split == "lopsided":
        rng = np.random.default_rng(3)
        sides = np.zeros((1, n), np.int8)
        sides[0, rng.choice(n, n // 10, replace=False)] = 1
        s, a_s, cut0 = _batch_inputs(g, sides=sides)
        limit, caps = n, [n // 2]
    else:
        s, a_s, cut0 = _batch_inputs(g, list(range(5, 5 + starts)))
        n1 = (s < 0).sum(dim=1).tolist()
        limit, caps = 16, [min(k, n - k) if cap is None else cap for k in n1]
    cap_t = torch.tensor(caps, dtype=torch.int32, device=cuda)
    args = (g, s, a_s, cut0, cut0, cap_t, torch.zeros_like(cap_t), max(caps) + 1, limit, 1e-6)
    before = K2.launches, K2_F64.launches
    got = kl_pass_batch_cuda(*args, _cache=cache)
    assert (K2.launches, K2_F64.launches) == (before[0], before[1] + 1)
    ref = kl_pass_batch_plain(*args)
    torch.cuda.synchronize()
    assert got.log_cut.dtype == got.scalars.dtype == torch.float64
    its = got.scalars[:, 2].long().tolist()
    assert min(its) > 50
    for name in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    if starts == 1 and cache is None and split == "random":
        one = kl_pass(g, s[0], a_s[0], float(cut0[0]), caps[0], limit, 1e-6)
        for name in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"):
            assert torch.equal(getattr(one, name), getattr(got.start(0), name)), name


def _f64_kernels():
    """The f32 and the f64 kernels of K1, K2, K4 and K6, their counts set
    to 0."""
    import importlib

    from eig_kl_tpu_torch.kl.megakernel import K2, K2_F64
    from eig_kl_tpu_torch.ops import reduce as R

    S = importlib.import_module("eig_kl_tpu_torch.ops.spmv")

    f32 = (S.K1, S.K1_STEP, S.K1_LAPLACIAN, S.K1_SPMM, S.K1_LAZY, K2, R.K4, R.K6, R.K6_SCALE, R.K6_AXPY)
    f64 = (S.K1_F64, S.K1_STEP_F64, S.K1_LAPLACIAN_F64, S.K1_SPMM_F64, S.K1_LAZY_F64, K2_F64, R.K4_F64,
           R.K6_F64, R.K6_SCALE_F64, R.K6_AXPY_F64)
    for k in f32 + f64:
        k.launches = 0
    return f32, f64


def _same_solve(card, cpu):
    """Two runs of ``power_partition_fiedler`` bit for bit: the eigenvalue,
    the median, the vector and the sides.  The f64 roots are correctly
    rounded on both devices (``sqrt_rn``, ROADMAP.md C11)."""
    assert card[0] == cpu[0] and card[1] == cpu[1] and card[4] == cpu[4]
    np.testing.assert_array_equal(card[2].view(np.int64), cpu[2].view(np.int64))
    np.testing.assert_array_equal(card[3], cpu[3])


def test_f64_power_solve_on_the_card_against_the_cpu_run(cuda):
    """The f64 power solve (the gkl2 exit, 1,000 steps) on gen 0.02x, on the
    card through the f64 kernels alone and on the CPU: the same bits."""
    from eig_kl_tpu_torch.spectral.power import power_partition_fiedler
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    g_cpu, g = (_graphs_host("gen_0.02").to_device(d, torch.float64) for d in ("cpu", cuda))
    cfg = SpectralConfig(solver="power", convergence="gkl2")
    f32, f64 = _f64_kernels()
    card = power_partition_fiedler(g, cfg, dtype=torch.float64)
    launches = {k.symbol: k.launches for k in f32 + f64}
    cpu = power_partition_fiedler(g_cpu, cfg, dtype=torch.float64)
    assert card[4] == cpu[4] == 1000
    assert not any(k.launches for k in f32), launches
    assert (launches["power_step_f64"], launches["tree_sum_f64"], launches["scale_by_f64"]) == (1000, 1001, 1000)
    _same_solve(card, cpu)


def test_f64_kl_on_the_card_equals_the_cpu_run(cuda):
    """One f64 KL pass from a seeded split, then passes until converged
    and a kick, and 3 random starts batched: the card's bits are the CPU
    path's (no root on this path), through the f64 kernels alone."""
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.kl.megakernel import K2_STARTS
    from eig_kl_tpu_torch.models.pipelines import fused_partition, kl_partition
    from eig_kl_tpu_torch.utils.config import KLConfig

    hg = read_hgr(GEN_002)
    sides = random_split(hg.num_nodes, 7)
    f32, f64 = _f64_kernels()
    K2_STARTS.clear()
    runs = []
    for device in ("cuda", "cpu"):
        one = kl_partition(hg, init=sides, dtype=torch.float64, device=device)
        more = kl_partition(hg, init=sides, dtype=torch.float64, device=device,
                            kl_config=KLConfig(passes=0, kicks=1))
        multi = fused_partition(hg, use_eig=False, starts=3, dtype=torch.float64, device=device,
                                kl_config=KLConfig(gain_eps=1e-6, passes=0, kicks=1))
        runs.append((one.kl, more.kl, multi.kl, multi.start_cuts))
        if device == "cuda":
            assert not any(k.launches for k in f32) and K2_STARTS[3] >= 2
    (c1, c2, c3, c_cuts), (p1, p2, p3, p_cuts) = runs
    assert c_cuts == p_cuts
    for card, cpu in ((c1, p1), (c2, p2), (c3, p3)):
        for name in ("iterations", "initial_cut", "best_cut", "final_cut", "verified_cut"):
            assert getattr(card, name) == getattr(cpu, name), name
        np.testing.assert_array_equal(card.best_sides, cpu.best_sides)
        np.testing.assert_array_equal(card.cut_trajectory, cpu.cut_trajectory)


def test_momentum_f64_on_the_card_against_the_cpu_run(cuda):
    """The momentum exit at f64 on gen 0.02x: the lazy walk, K4 (a check's
    two deflation dots in one launch), K6 and its axpy at f64 on the card,
    and the CPU's plain run: the same bits."""
    from eig_kl_tpu_torch.spectral.power import power_partition_fiedler
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    g_cpu, g = (_graphs_host("gen_0.02").to_device(d, torch.float64) for d in ("cpu", cuda))
    cfg = SpectralConfig(solver="power", convergence="momentum", max_iterations=201)
    f32, f64 = _f64_kernels()
    card = power_partition_fiedler(g, cfg, dtype=torch.float64)
    assert not any(k.launches for k in f32)
    assert all(k.launches for k in f64 if k.symbol in ("lazy_walk_f64", "fma_dot_batch_f64", "axpy_f64"))
    # 201 steps are 8 checks: a dot for the start's deflation, then two
    # launches per check (the paired deflation, the Rayleigh quotient).
    assert next(k.launches for k in f64 if k.symbol == "fma_dot_batch_f64") == 1 + 2 * 8
    cpu = power_partition_fiedler(g_cpu, cfg, dtype=torch.float64)
    assert card[4] == cpu[4] == 201
    _same_solve(card, cpu)


def _graphs_host(kind):
    from eig_kl_tpu_torch.graph.expand import clique_expand

    return clique_expand(_hypergraph(kind), "kl")


@pytest.mark.parametrize("solver", ["lanczos", "lobpcg"])
def test_other_solvers_f64_on_the_card(cuda, solver):
    """Lanczos and LOBPCG at spectral_partition's default, f64 with no host
    refinement, on the card and on the CPU, on gen 0.02x's largest
    component: lambda_2 agrees to 1e-10 (cuBLAS and the CPU add the basis
    products in other orders), through the f64 kernels alone."""
    from eig_kl_tpu_torch.io.hgr import Hypergraph
    from eig_kl_tpu_torch.models.pipelines import spectral_partition
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph

    hg = _hypergraph("gen_0.02")
    sizes = np.diff(hg.net_offsets)
    first = np.repeat(hg.pins[hg.net_offsets[:-1]], sizes)
    adj = sp.coo_matrix((np.ones(len(first)), (first, hg.pins)), shape=(hg.num_nodes,) * 2)
    _, label = csgraph.connected_components(adj, directed=False)
    keep = label == np.argmax(np.bincount(label))
    nets = np.add.reduceat(keep[hg.pins].astype(np.int64), hg.net_offsets[:-1]) == sizes
    pins = (np.cumsum(keep) - 1)[hg.pins[np.repeat(nets, sizes)]].astype(np.int32)
    offsets = np.zeros(int(nets.sum()) + 1, np.int64)
    np.cumsum(sizes[nets], out=offsets[1:])
    lcc = Hypergraph(int(keep.sum()), int(nets.sum()), pins, offsets)
    f32, f64 = _f64_kernels()
    card = spectral_partition(lcc, SpectralConfig(solver=solver))
    assert not any(k.launches for k in f32)
    cpu = spectral_partition(lcc, SpectralConfig(solver=solver), device="cpu")
    assert card.spectral_solve.refined is None and cpu.spectral_solve.refined is None
    assert card.eig.eigenvalue == pytest.approx(cpu.eig.eigenvalue, abs=1e-10)
    assert card.eig.eigenvalue == pytest.approx(0.0973479036, rel=1e-8)
    assert sorted(card.eig.balance()) == [1847, 1847]


# ------------------------------------------ the CSR plan path (ROADMAP A10)


def _plan_graph(kind):
    """Host graphs for K1's plan entry points: gen 0.02x; hub44 (a row
    of degree 43, rows wider than 32); "edges", 1,025 nodes (P - n =
    1,023) with empty rows and rows of degree 1 whose products are +-0 and
    subnormal; "full", 2,048 nodes (P - n = 0); "6000", the random graph of
    ``tests/test_torch_plan_order.py`` (78,752 entries); "sparse", its
    30,000-node graph (81,072 entries); gen 1.0x (a COO tail)."""
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import Hypergraph
    from eig_kl_tpu_torch.models.generator import CircuitGenerator

    if kind in ("gen_0.02", "hub44"):
        return _graphs_host(kind)
    if kind == "gen_1.0":
        return clique_expand(CircuitGenerator(1.0, 42).generate(), "kl")
    rng = np.random.default_rng({"6000": 21, "sparse": 8}.get(kind, 31))
    if kind in ("6000", "sparse"):  # tests/conftest.py:random_hypergraph(rng, n, nets, max_net)
        n, nets, max_net = (6000, 7800, 5) if kind == "6000" else (30000, 12000, 4)
        sizes = rng.integers(2, max_net + 1, size=nets)
        pins = np.concatenate([rng.choice(n, size=k, replace=False) for k in sizes]).astype(np.int32)
        offs = np.zeros(nets + 1, np.int64)
        np.cumsum(sizes, out=offs[1:])
        return clique_expand(Hypergraph(n, nets, pins, offs), "kl")
    if kind == "hubs":
        # 16,384 nodes: random edges among nodes 3 on, and three hubs whose
        # rows cross every sub-chunk: node 0 with one entry per column block
        # (the first row of its row block: rank 0 in each bucket, so one slot
        # class), node 1 with 40 per block, node 2 with 3.
        n = 16384
        u, v = rng.integers(3, n, 3 * n), rng.integers(3, n, 3 * n)
        cb = np.arange(16) * 1024
        hub_u = np.concatenate([np.zeros(16, int), np.ones(640, int), np.full(48, 2)])
        hub_v = np.concatenate([cb + 517, (cb[:, None] + rng.choice(np.arange(3, 1024), 40, replace=False)).ravel(),
                                (cb[:, None] + np.array([5, 300, 901])).ravel()])
        u, v = np.concatenate([u, hub_u]), np.concatenate([v, hub_v])
    else:
        n = 1025 if kind == "edges" else 2048
        u, v = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    if kind == "edges":
        # Nodes 0-99 have no edge; 100-299 are joined in pairs (degree 1).
        u, v = u[(u >= 300) & (v >= 300)], v[(u >= 300) & (v >= 300)]
        u, v = np.concatenate([u, np.arange(100, 300, 2)]), np.concatenate([v, np.arange(101, 300, 2)])
    keep = u != v
    key = np.unique(np.minimum(u, v)[keep] * n + np.maximum(u, v)[keep])
    w = rng.uniform(0.1, 1.0, key.size).astype(np.float32).astype(np.float64)
    return Graph.from_upper_coo(n, key // n, key % n, w)


def _padded_state(n, P, seed):
    """A padded f32 state: seeded values with +0, -0 and subnormal (and
    so subnormal products) entries, zero padding."""
    x = np.zeros(P, np.float32)
    x[:n] = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    x[: n : 7] = 0.0
    x[3 : n : 11] = -0.0
    x[5 : n : 13] = 3e-39
    return torch.as_tensor(x.reshape(P // 128, 128))


@pytest.mark.parametrize("kind, rblock, quantum", [
    ("gen_0.02", None, None), ("hub44", None, None), ("edges", None, None), ("full", None, None),
    ("6000", 512, None), ("6000", 4096, None), ("6000", 16384, None), ("sparse", 512, 64), ("gen_1.0", None, None),
])
@pytest.mark.parametrize("bf16", [True, False])
def test_spmv_v2_equals_plain_bitwise(cuda, kind, rblock, quantum, bf16):
    """K1's ``spmv_v2_f32`` (the v2 TPU SpMV's order), with bf16 or f32
    products, on a flat vector, on the padded state and in its lazy-walk
    form, against ``spmv_v2_plain`` and ``plan_lazy_walk``'s plain version
    on the CPU, bit for bit, padding rows +0 included; one launch per call,
    and one ``spmv_v1_f32`` launch first where the plan has a v1 tail (gen
    0.02x and the 6,000-node graph; the COO tails, gen 1.0x's 125 entries
    and the sparse graph's 38 at row block 512 and Q 64, up to 7 in one
    warp's rows and 2 in a row, are in the launch)."""
    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.ops.spmv_plan import (
        K1_LAZY_V2, K1_LAZY_V2_BF16I, K1_V1, K1_V2, K1_V2_BF16I, CooTail, V1Layout, lazy_walk_v2_plain,
        plan_lazy_walk, spmv_v2, spmv_v2_plain,
    )

    host = _plan_graph(kind)
    geometry = {k: v for k, v in (("rblock", rblock), ("quantum", quantum)) if v is not None}
    lay_c, lay = (CsrPlan.for_graph(host.to_device(d), kernel="v2", **geometry).layout for d in ("cpu", cuda))
    n, P = host.num_nodes, lay.padded_nodes
    assert kind != "edges" or P - n == 1023
    assert kind != "full" or P == n
    assert kind != "sparse" or (isinstance(lay.tail, CooTail) and (lay.tail.num_entries, lay.tail.num_groups) == (38, 2))
    x = _padded_state(n, P, 1)
    dsinv = torch.zeros(P)
    degrees = torch.as_tensor(host.weighted_degrees.astype(np.float32))
    dsinv[:n] = 1.0 / torch.sqrt(torch.where(degrees > 0, degrees, 1.0))
    dsinv = dsinv.view(P // 128, 128)
    v1_tail = int(isinstance(lay.tail, V1Layout))
    kern, lazy_kern = (K1_V2_BF16I, K1_LAZY_V2_BF16I) if bf16 else (K1_V2, K1_LAZY_V2)
    before = (kern.launches, lazy_kern.launches, K1_V1.launches)
    got = [spmv_v2(lay, x.view(-1)[:n].contiguous().to(cuda), bf16), spmv_v2(lay, x.to(cuda), bf16),
           plan_lazy_walk(lay, x.to(cuda), dsinv.to(cuda), bf16)]
    assert (kern.launches, lazy_kern.launches, K1_V1.launches) == (
        before[0] + 2, before[1] + 1, before[2] + 3 * v1_tail)
    want = [spmv_v2_plain(lay_c, x.view(-1)[:n].contiguous(), bf16), spmv_v2_plain(lay_c, x, bf16),
            lazy_walk_v2_plain(lay_c, x, dsinv, bf16)]
    assert torch.equal(want[2], plan_lazy_walk(lay_c, x, dsinv, bf16))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    assert (want[1].view(-1)[n:].view(torch.int32) == 0).all()
    assert torch.equal(want[1].view(-1)[:n], want[0])


def test_spmv_v2_refuses_what_it_cannot_run(cuda):
    """f64, a state shorter than n or not of 128 columns, CPU tensors and a
    layout on another device: refused, no launch."""
    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.ops.spmv_plan import K1_V2, K1_V2_BF16I, spmv_v2_cuda

    host = _plan_graph("gen_0.02")
    lay = CsrPlan.for_graph(host.to_device(cuda), kernel="v2").layout
    lay_c = CsrPlan.for_graph(host.to_device("cpu"), kernel="v2").layout
    before = K1_V2.launches + K1_V2_BF16I.launches
    with pytest.raises(TypeError, match="float32"):
        spmv_v2_cuda(lay, torch.zeros(32, 128, dtype=torch.float64, device=cuda), True)
    for shape in ((8, 128), (64, 64)):
        with pytest.raises(ValueError, match="padded"):
            spmv_v2_cuda(lay, torch.zeros(*shape, device=cuda))
    with pytest.raises(ValueError, match="CUDA"):
        spmv_v2_cuda(lay, torch.zeros(32, 128))
    with pytest.raises(ValueError, match="CUDA"):
        spmv_v2_cuda(lay_c, torch.zeros(32, 128, device=cuda))
    assert K1_V2.launches + K1_V2_BF16I.launches == before


_V2_LAYOUTS = {}


def _v2_layouts(kind, rblock, device):
    """(the CPU layout, the card's) of a v2 plan with bf16 weights kept,
    built once per graph and row block."""
    from eig_kl_tpu_torch.graph.csr import CsrPlan

    key = (kind, rblock)
    if key not in _V2_LAYOUTS:
        host = _plan_graph(kind)
        geometry = {"bf16_weights": True, **({} if rblock is None else {"rblock": rblock})}
        _V2_LAYOUTS[key] = host, tuple(CsrPlan.for_graph(host.to_device(d), kernel="v2", **geometry).layout
                                       for d in ("cpu", device))
    return _V2_LAYOUTS[key]


@pytest.mark.parametrize("kind, rblock", [("6000", 512), ("6000", 2048), ("hubs", 512), ("hubs", 2048),
                                          ("gen_1.0", None)])
@pytest.mark.parametrize("reduce, products", [
    ("mxu", "bf16w"), ("mxu2", "f32"), ("mxu2", "bf16i"), ("mxu2", "bf16w"), ("vpu", "f32"), ("vpu", "bf16i"),
    ("vpu", "bf16w"),
])
def test_spmv_v2_forms_equal_plain_bitwise(cuda, kind, rblock, reduce, products):
    """K1's other v2 forms: the orders of the opt-in reduces "mxu2" (4
    interleaved partials at row block 512, 2 at 2,048, the default's order
    and entry point at gen 1.0x's 16,384; "hubs": rows over every sub-chunk
    with uneven slot classes, one of them with a single class) and "vpu"
    (32-slot blocks), with
    f32 products, bf16 products and bf16 products of bf16 weights, and the
    default's order with bf16 weights: on a flat vector, on the padded state
    and in the lazy-walk form, against their plain versions on the CPU bit
    for bit; each call launches the entry point of ``v2_kernel`` once."""
    from eig_kl_tpu_torch.ops.spmv_plan import (
        K1_V2, K1_V2_BF16I, lazy_walk_v2_plain, plan_lazy_walk, spmv_v2, spmv_v2_plain, v2_kernel,
    )

    host, (lay_c, lay) = _v2_layouts(kind, rblock, cuda)
    n, P = host.num_nodes, lay.padded_nodes
    bf16, bf16w = products != "f32", products == "bf16w"
    form = dict(reduce=reduce, bf16_weights=bf16w)
    kern, lazy_kern = (v2_kernel(lay, bf16, reduce, bf16w, lazy) for lazy in (False, True))
    if reduce == "mxu2" and kind == "gen_1.0":
        assert kern is {"f32": K1_V2, "bf16i": K1_V2_BF16I}.get(products, kern) and "mxu2" not in kern.symbol
    else:
        suffix = ("" if reduce == "mxu" else f"_{reduce}") + ("" if products == "f32" else f"_{products}") + "_f32"
        assert (kern.symbol, lazy_kern.symbol) == (f"spmv_v2{suffix}", f"lazy_walk_v2{suffix}")
    x = _padded_state(n, P, 2)
    dsinv = torch.zeros(P)
    degrees = torch.as_tensor(host.weighted_degrees.astype(np.float32))
    dsinv[:n] = 1.0 / torch.sqrt(torch.where(degrees > 0, degrees, 1.0))
    dsinv = dsinv.view(P // 128, 128)
    before = (kern.launches, lazy_kern.launches)
    got = [spmv_v2(lay, x.view(-1)[:n].contiguous().to(cuda), bf16, **form), spmv_v2(lay, x.to(cuda), bf16, **form),
           plan_lazy_walk(lay, x.to(cuda), dsinv.to(cuda), bf16, **form)]
    assert (kern.launches, lazy_kern.launches) == (before[0] + 2, before[1] + 1)
    want = [spmv_v2_plain(lay_c, x.view(-1)[:n].contiguous(), bf16, **form), spmv_v2_plain(lay_c, x, bf16, **form),
            lazy_walk_v2_plain(lay_c, x, dsinv, bf16, **form)]
    for a, b in zip(got, want):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))
    assert (want[1].view(-1)[n:].view(torch.int32) == 0).all()
    # Where the form's order or weights part from the default's, some row does.
    if bf16w or (products == "f32" and (reduce == "vpu" or kind != "gen_1.0")):
        assert not torch.equal(spmv_v2_plain(lay_c, x, bf16).view(torch.int32), want[1].view(torch.int32))


@pytest.mark.parametrize("order", ["lanes", "slice", "signs", "laplacian", "windows3", "chain", "rows"])
def test_k4_fused_dot_equals_plain(cuda, order):
    """K4's fused entry point in each order, 1 to 4 pairs per launch, at 0
    to 6,000 values (remainders 0-31 of XLA's 32 lanes, the epilogues and
    their ties, the scalar and unrolled lengths of each producer's form,
    the 4,096 threshold and past it, where the block stages a second tile),
    +-0 and subnormal inputs: bit for bit the plain order; ``fused_dot``
    routes below 4,096 values to it, above to K4."""
    from eig_kl_tpu_torch.ops import reduce as R

    rng = np.random.default_rng(17)
    for size in list(range(0, 70)) + [127, 128, 129, 159, 160, 161, 191, 192, 221, 351, 352, 380, 1000, 1031, 3694,
                                      4038, 4063, 4095, 4096, 6000]:
        vals = []
        for _ in range(4):
            v = rng.standard_normal(size).astype(np.float32)
            v[::9], v[1::13], v[2::17] = 0.0, -0.0, 1e-40
            vals.append(torch.as_tensor(v))
        for count in (1, 2, 3, 4):
            xs, ys = vals[:count], vals[::-1][:count]
            got = R.fused_dot_batch_cuda([t.to(cuda) for t in xs], [t.to(cuda) for t in ys], order)
            want = torch.stack([R.fused_dot_plain(a, b, order) for a, b in zip(xs, ys)])
            assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)), (size, count)
    x, y = (torch.as_tensor(rng.standard_normal(4038).astype(np.float32)) for _ in range(2))
    before = (R.K4_FUSED.launches, R.K4.launches)
    assert torch.equal(R.fused_dot(x.to(cuda), y.to(cuda), order).cpu(), R.fused_dot(x, y, order))
    big = torch.as_tensor(rng.standard_normal(5000).astype(np.float32))
    assert torch.equal(R.fused_dot(big.to(cuda), big.to(cuda), order).cpu(), R.fma_dot_plain(big, big))
    assert (R.K4_FUSED.launches, R.K4.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("kind", ["hub10", "hub30", "hub44"])
def test_k1_f64_blocked_product_equals_plain_bitwise(cuda, kind):
    """K1's f64 blocked product at k = 2, 4, 6, 8, 12 and 16 on graphs of
    ELL width 24, 48 and 64, with and without the Laplacian's epilogue, on a
    16-byte aligned X (four columns per walk where k is a multiple of 4,
    a column at a time for k = 2 and 6) and an unaligned one (a column at
    a time): bit for bit the plain version, and each column K1 on that
    column."""
    import importlib

    from eig_kl_tpu_torch.graph.expand import clique_expand

    S = importlib.import_module("eig_kl_tpu_torch.ops.spmv")
    host = clique_expand(_hypergraph(kind), "eig")
    g_cpu, g = host.to_device("cpu", torch.float64), host.to_device(cuda, torch.float64)
    assert g.row_width == {"hub10": 24, "hub30": 48, "hub44": 64}[kind]
    rng = np.random.default_rng(21)
    n = g.num_nodes
    for k in (2, 4, 6, 8, 12, 16):
        X = torch.as_tensor(rng.standard_normal((n, k)))
        X[::37, :] = -0.0
        store = torch.empty(n * k + 1, dtype=torch.float64, device=cuda)
        X_odd = store[1:].view(n, k)
        X_odd.copy_(X.to(cuda))
        for laplacian in (False, True):
            want = S.spmm_plain(g_cpu, X, laplacian=laplacian).view(torch.int64)
            for Xc in (X.to(cuda), X_odd):
                got = S.spmm(g, Xc, laplacian=laplacian)
                assert torch.equal(got.cpu().view(torch.int64), want), (k, laplacian)
        AX = S.spmm(g, X.to(cuda))
        for j in range(k):
            assert torch.equal(AX[:, j], S.spmv_csr(g, X[:, j].contiguous().to(cuda)))


def _window_hypergraph(width):
    """Rows of at most ``width`` entries (ELL width ``width``, 8 to 64):
    windows of ``width / 2 + 1`` consecutive nodes, 70 % of them, over all
    but the last 50 of 3,000 nodes (rows of degree 0); ``width`` "tiny":
    19 nodes, five nets of 3 and one across them, four rows of degree 0."""
    from eig_kl_tpu_torch.io.hgr import Hypergraph

    if width == "tiny":
        pins = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 1, 5, 9], np.int32)
        return Hypergraph(19, 6, pins, np.arange(0, 19, 3, dtype=np.int64))
    rng = np.random.default_rng(14)
    n, k = 3000, width // 2 + 1
    nets = [np.arange(i, i + k) for i in range(n - 50 - k) if rng.random() < 0.7]
    offs = np.zeros(len(nets) + 1, np.int64)
    np.cumsum([k] * len(nets), out=offs[1:])
    return Hypergraph(n, len(nets), np.concatenate(nets).astype(np.int32), offs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", [8, 16, 24, 32, 48, 64, "tiny"])
def test_k1_blocked_walk_equals_plain_bitwise(cuda, width, dtype):
    """The blocked product's one walk of the rows for all k columns (k = 4,
    8, 12, 16; X 16-byte aligned) on graphs of ELL width 8 to 64 with rows
    of degree 0, at n = 3,000 (not a multiple of a block's rows) and n =
    19: bit for bit the plain version, with and without the Laplacian's
    epilogue, deterministic, one launch per product, and each column K1 on
    that column; an X one value off 16-byte alignment takes the walk per
    column, to the same bits."""
    import importlib

    from eig_kl_tpu_torch.graph.expand import clique_expand

    S = importlib.import_module("eig_kl_tpu_torch.ops.spmv")
    host = clique_expand(_window_hypergraph(width), "eig")
    g_cpu, g = host.to_device("cpu", dtype), host.to_device(cuda, dtype)
    assert g.row_width == (8 if width == "tiny" else width)
    kernel, bits = (S.K1_SPMM, torch.int32) if dtype == torch.float32 else (S.K1_SPMM_F64, torch.int64)
    rng = np.random.default_rng(23)
    n = g.num_nodes
    for k in (4, 8, 12, 16):
        X = torch.as_tensor(rng.standard_normal((n, k))).to(dtype)
        X[::37] = -0.0
        Xc = X.to(cuda)
        X_odd = torch.empty(n * k + 1, dtype=dtype, device=cuda)[1:].view(n, k)
        X_odd.copy_(Xc)
        assert Xc.data_ptr() % 16 == 0 and X_odd.data_ptr() % 16 != 0
        for laplacian in (False, True):
            want = S.spmm_plain(g_cpu, X, laplacian=laplacian).view(bits)
            before = kernel.launches
            outs = [S.spmm(g, Xi, laplacian=laplacian) for Xi in (Xc, Xc, X_odd)]
            assert kernel.launches == before + 3
            for Y in outs:
                assert torch.equal(Y.cpu().view(bits), want), (k, laplacian)
        AX = S.spmm(g, Xc)
        for j in range(k):
            assert torch.equal(AX[:, j].view(bits), S.spmv_csr(g, Xc[:, j].contiguous()).view(bits)), (k, j)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lazy_z_vectors_equal_plain_bitwise(cuda, dtype):
    """The z pass at n = 1, 3, 4, 5, 1,023, 1,024, 2,049 and 184,406 (two
    16-byte vectors of each array per thread, a block's 1,024 f32 or 512
    f64 values; the last block's values one per thread), and with w, dsinv
    or both one value off 16-byte alignment (a value per thread): bit for
    bit ``lazy_z_plain``, one launch each."""
    import importlib

    S = importlib.import_module("eig_kl_tpu_torch.ops.spmv")
    kernel, bits = (S.K1_Z, torch.int32) if dtype == torch.float32 else (S.K1_Z_F64, torch.int64)
    rng = np.random.default_rng(43)
    for n in (1, 3, 4, 5, 1023, 1024, 2049, 184406):
        w_host = torch.as_tensor(rng.standard_normal(n)).to(dtype)
        w_host[::7] = -0.0
        d_host = torch.as_tensor(rng.uniform(0.1, 1.0, n)).to(dtype)
        want = S.lazy_z_plain(w_host, d_host).view(bits)
        for w_off, d_off in ((0, 0), (1, 0), (0, 1), (1, 1)):
            w = torch.empty(n + 1, dtype=dtype, device=cuda)[w_off:w_off + n]
            d = torch.empty(n + 1, dtype=dtype, device=cuda)[d_off:d_off + n]
            w.copy_(w_host)
            d.copy_(d_host)
            assert (w.data_ptr() % 16 != 0, d.data_ptr() % 16 != 0) == (bool(w_off), bool(d_off))
            before = kernel.launches
            z = S.lazy_z(w, d)
            assert kernel.launches == before + 1
            assert torch.equal(z.cpu().view(bits), want), (n, w_off, d_off)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["hub10", "hub30"])
def test_k1_lazy_walk_scaled_equals_plain_bitwise(cuda, kind, dtype):
    """K1's lazy walk with its scaled epilogue ``0.5 * (u * c + dsinv *
    Ax)`` (the momentum check's walk on a graph wider than 32; ELL width
    24 and 48 here), ``w = u * c``: bit for bit the plain version; the
    unscaled walk too."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.ops.spmv import K1_LAZY, K1_LAZY_F64, lazy_walk, lazy_walk_plain

    host = clique_expand(_hypergraph(kind), "kl")
    g_cpu, g = host.to_device("cpu", dtype), host.to_device(cuda, dtype)
    rng = np.random.default_rng(22)
    n = g.num_nodes
    u = torch.as_tensor(rng.standard_normal(n)).to(dtype)
    u[::41] = -0.0
    c = torch.tensor(1.0 / float(np.linalg.norm(u.double().numpy())), dtype=dtype)
    w = u * c
    d = torch.as_tensor(1.0 / np.sqrt(rng.uniform(0.5, 9.0, n))).to(dtype)
    kernel = K1_LAZY if dtype == torch.float32 else K1_LAZY_F64
    before = kernel.launches
    got = lazy_walk(g, w.to(cuda), d.to(cuda), scaled=(u.to(cuda), c.to(cuda)))
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    assert torch.equal(got.cpu().view(bits), lazy_walk_plain(g_cpu, w, d, scaled=(u, c)).view(bits))
    got = lazy_walk(g, w.to(cuda), d.to(cuda))
    assert torch.equal(got.cpu().view(bits), lazy_walk_plain(g_cpu, w, d).view(bits))
    assert kernel.launches == before + 2


def test_k6_second_round_lanes_equal_plain(cuda):
    """K6's 2-D norm and sum above 1,024 rows of 128, whose second round's
    (32, 4) windows XLA adds across 8 lanes of rows (no pad) or 4 (a pad of
    1) and row by row otherwise: bit for bit the plain versions at every k
    = 2-32 windows of that round, -0 inputs included."""
    from eig_kl_tpu_torch.ops import reduce as R

    rng = np.random.default_rng(19)
    for k in range(2, 33):
        for pad in (0, 1, int(rng.integers(2, 32))):
            rows = 32 * (32 * k - pad) - int(rng.integers(0, 32))
            v = (rng.standard_normal((rows, 128)) * 10.0 ** rng.uniform(-1, 1, (rows, 128))).astype(np.float32)
            v[::5, ::7] = -0.0
            t = torch.as_tensor(v)
            for fn in (R.tree_norm_2d, R.tree_sum_2d):
                assert torch.equal(fn(t.to(cuda)).cpu().view(torch.int32), fn(t).view(torch.int32)), (rows, fn)


def test_k6_last_block_lanes_equal_plain(cuda):
    """K6's 2-D norm and sum at every last block (k, 4), k = 2-32 (33 to
    1,024 rows), whose lanes follow XLA's vectorized loop: bit for bit the
    plain versions, -0 inputs included."""
    from eig_kl_tpu_torch.ops import reduce as R

    rng = np.random.default_rng(18)
    for k in range(2, 33):
        rows = 32 * k - int(rng.integers(0, 32))
        v = (rng.standard_normal((rows, 128)) * 10.0 ** rng.uniform(-1, 1, (rows, 128))).astype(np.float32)
        v[::5, ::7] = -0.0
        t = torch.as_tensor(v)
        assert torch.equal(R.tree_norm_2d(t.to(cuda)).cpu().view(torch.int32), R.tree_norm_2d(t).view(torch.int32)), k
        assert torch.equal(R.tree_sum_2d(t.to(cuda)).cpu().view(torch.int32), R.tree_sum_2d(t).view(torch.int32)), k


@pytest.mark.parametrize("inter", ["bfloat16", "float32"])
def test_plan_power_solve_on_the_card_equals_the_cpu_run(cuda, inter):
    """The f32 power solve on the padded state of a CSR plan (a v2 plan
    forced on gen 0.02x's graph; the momentum exit, 60 steps, and the sign
    exit, 101 steps): the card (``spmv_v1_f32`` for its tail,
    ``spmv_v2_f32``, K6, K4) and the CPU (their plain versions) give the
    same bits."""
    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.spectral.power import _power_core

    host = _plan_graph("gen_0.02")
    gs = [dataclasses.replace(g, plan=CsrPlan.for_graph(g, kernel="v2")) for g in (host.to_device(d) for d in ("cpu", cuda))]
    for conv, cap in (("momentum", 60), ("sign", 101)):
        kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=cap, seed=42, dtype=torch.float32,
                  convergence=conv, inter_dtype=inter)
        (lam_c, v_c, it_c), (lam_g, v_g, it_g) = (_power_core(g, **kw) for g in gs)
        assert it_c == it_g and float(lam_c) == float(lam_g)
        assert torch.equal(v_g.cpu().view(torch.int32), v_c.view(torch.int32))


def _v1_host(kind):
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import Hypergraph

    if kind == "gen_0.02":
        return clique_expand(_hypergraph("gen_0.02"), "kl")
    rng = np.random.default_rng(7)  # 20,000 nodes, about 28,000 entries in 400 chunks
    n, sizes = 20000, rng.integers(2, 4, size=7000)
    nets = [rng.choice(n, k, replace=False) for k in sizes]
    offs = np.zeros(len(nets) + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])
    return clique_expand(Hypergraph(n, len(nets), np.concatenate(nets).astype(np.int32), offs), "kl")


@pytest.mark.parametrize("kind", ["gen_0.02", "random", "crafted", "6000_tail"])
def test_spmv_v1_equals_plain_bitwise(cuda, kind):
    """K1's spmv_v1_f32 (the v1 TPU SpMV's order) against spmv_v1_plain, bit
    for bit, on signs and on normal values with -0 and +0 among them, as a
    flat vector and as the padded state of the plan path (its padding +0);
    one launch per call.  "crafted" and "6000_tail" are
    tests/test_torch_v1_chunks.py's: a row of 1,800 entries that ends in
    every one of its window's six chunks (segments of 512 slots), a row of
    200 in one chunk, a one-chunk window whose row's products are all -0,
    an empty window; and the v1 tail of the 6,000-node graph's v2 plan."""
    from eig_kl_tpu_torch.ops.spmv_plan import K1_V1, spmv_v1_cuda, spmv_v1_plain
    from test_torch_v1_chunks import v1_layout, v1_vector

    if kind in ("gen_0.02", "random"):
        host = _v1_host(kind)
        assert host.nnz <= 32_768
        lay_c, lay_g = host.to_device("cpu").plan_layout, host.to_device(cuda).plan_layout
    else:
        lay_c, lay_g = v1_layout(kind, "cpu"), v1_layout(kind, cuda)
    rng = np.random.default_rng(5)
    n, P = lay_c.num_nodes, lay_c.padded_nodes
    x = v1_vector(lay_c, 5).numpy()
    for v in (x, np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)):
        v2d = np.zeros(P, np.float32)
        v2d[:n] = v
        for t in (torch.as_tensor(v), torch.as_tensor(v2d.reshape(-1, 128))):
            before = K1_V1.launches
            got = spmv_v1_cuda(lay_g, t.to(cuda))
            assert K1_V1.launches == before + 1
            want = spmv_v1_plain(lay_c, t)
            assert got.shape == t.shape and torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
        assert (want.view(-1)[n:].view(torch.int32) == 0).all()


def _select_vector(n, dtype, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n).astype(dtype)
    v[rng.random(n) < 0.2] = v[0]  # ties
    if n >= 16:
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45 if dtype == np.float32 else 5e-324, 1.0, -1.0])
        at = rng.choice(n, min(n // 8, 64), replace=False)
        v[at] = rng.choice(special.astype(dtype), at.size)
        neg_nan = np.array([0xFFC00001 if dtype == np.float32 else 0xFFF8000000000001],
                           np.uint32 if dtype == np.float32 else np.uint64).view(dtype)
        v[1] = neg_nan[0]
    return v


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [1, 2, 37, 4038, 8192, 8193, 184406, 201920])
def test_k7_equals_plain_bitwise(cuda, n, dtype):
    """K7 against kth_smallest_plain bit for bit (NaN of both signs, +-0,
    +-inf, subnormals and ties among the values): every rank of a small
    vector, several of a large one; one launch per call, the result a 0-d
    tensor on the card."""
    from eig_kl_tpu_torch.ops.select import K7, K7_F64, kth_smallest_cuda, kth_smallest_plain

    v = _select_vector(n, dtype, n)
    t = torch.as_tensor(v)
    tg = t.to(cuda)
    ks = range(n) if n <= 64 else sorted({0, 1, n // 3, n // 2, n - 2, n - 1})
    kern = K7 if dtype == np.float32 else K7_F64
    bits = torch.int32 if dtype == np.float32 else torch.int64
    for k in ks:
        before = kern.launches
        got = kth_smallest_cuda(tg, k)
        assert kern.launches == before + 1 and got.dim() == 0 and got.device.type == "cuda"
        assert torch.equal(got.cpu().view(bits), kth_smallest_plain(t, k).view(bits)), k


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("n", [4038, 201920])
def test_k7_heavy_ties_run_every_round(cuda, n, dtype):
    """Values drawn from {-0.0, 0, 1, 2}: no bin of rank k ever holds one
    key, so K7 runs all its rounds (4 in f32, 8 in f64) in both its forms;
    bit for bit the plain version at several ranks."""
    from eig_kl_tpu_torch.ops.select import kth_smallest_cuda, kth_smallest_plain

    rng = np.random.default_rng(n)
    v = np.array([-0.0, 0.0, 1.0, 2.0], dtype)[rng.integers(0, 4, n)]
    t = torch.as_tensor(v)
    bits = torch.int32 if dtype == np.float32 else torch.int64
    for k in (0, n // 4, n // 2, n - 1):
        got = kth_smallest_cuda(t.to(cuda), k)
        assert torch.equal(got.cpu().view(bits), kth_smallest_plain(t, k).view(bits)), k


def test_mega_engine_on_the_card_equals_the_cpu_run(cuda):
    """fused_refine_mega on gen 0.02x (the JAX mega engine's order: K1's
    spmv_v1_f32 for the starting A @ s and the recount, K7 for the median):
    the card and the CPU give the same bits."""
    from eig_kl_tpu_torch.kl.megakernel import fused_refine_mega
    from eig_kl_tpu_torch.ops.select import K7
    from eig_kl_tpu_torch.ops.spmv_plan import K1_V1
    from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig

    host = _gen002_host()
    runs = []
    for dev in ("cpu", cuda):
        v1, k7 = K1_V1.launches, K7.launches
        runs.append(fused_refine_mega(host.to_device(dev), SpectralConfig(solver="power"), KLConfig(gain_eps=1e-6)))
    assert K1_V1.launches == v1 + 2 and K7.launches > k7
    (e_c, k_c, it_c), (e_g, k_g, it_g) = runs
    assert it_c == it_g == 201 and e_c.eigenvalue == e_g.eigenvalue
    assert (k_g.iterations, k_g.best_cut, k_g.verified_cut) == (k_c.iterations, k_c.best_cut, k_c.verified_cut)
    np.testing.assert_array_equal(k_g.cut_trajectory, k_c.cut_trajectory)
    np.testing.assert_array_equal(k_g.sides, k_c.sides)


def _gen002_host():
    from eig_kl_tpu_torch.graph.expand import clique_expand

    return clique_expand(_hypergraph("gen_0.02"), "kl")


@pytest.fixture()
def one_rank(cuda):
    """A one-rank NCCL group on the card (the port's make_mesh makes it),
    destroyed after the test."""
    from eig_kl_tpu_torch.parallel.mesh import make_mesh, release_default_group

    yield make_mesh(device="cuda")
    release_default_group()


def test_sharded_oc_one_rank_equals_k2_on_gen002(cuda, one_rank):
    """sharded_refine_oc at one rank (NCCL) on gen 0.02x from a random
    split: K2's one-start pass from the same split, swap for swap and gain
    for gain; the recount agrees with the tracked cut."""
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.kl.megakernel import kl_pass_cuda
    from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
    from eig_kl_tpu_torch.ops.spmv import spmv
    from eig_kl_tpu_torch.parallel import sharded_kl
    from eig_kl_tpu_torch.parallel.sharded_kl2 import sharded_refine_oc
    from eig_kl_tpu_torch.utils.config import KLConfig

    host = _gen002_host()
    n = host.num_nodes
    sides = random_split(n, 5)
    got = sharded_refine_oc(host, sides, one_rank, KLConfig(gain_eps=1e-6))
    g = host.to_device(cuda)
    s = sides_to_signs(torch.as_tensor(sides).to(cuda), torch.float32)
    a_s = spmv(g, s)
    n1 = int(sides.sum())
    out = kl_pass_cuda(g, s, a_s, float(cut_size(g, s, a_s)), min(n1, n - n1), KLConfig().terminate_limit(n), 1e-6)
    it = int(out.scalars[2])
    assert got.iterations == it > 100
    np.testing.assert_array_equal(sharded_kl.last_swaps[0], out.log_a[1 : it + 1].cpu().numpy())
    np.testing.assert_array_equal(sharded_kl.last_swaps[1], out.log_b[1 : it + 1].cpu().numpy())
    np.testing.assert_array_equal(got.gain_trajectory[1:], out.log_gain[1 : it + 1].cpu().numpy())
    assert abs(got.final_cut - got.verified_cut) <= 1e-5 * got.final_cut


def test_multi_start_sharded_dp1_equals_multi_start(cuda, one_rank):
    """multi_start_refine_mega_sharded at dp = 1 on the card: every start's
    best cut and the best start equal multi_start_refine_mega's, one batched
    K2 launch per pass."""
    from eig_kl_tpu_torch.kl.megakernel import K2_STARTS
    from eig_kl_tpu_torch.parallel import multi_start_refine_mega, multi_start_refine_mega_sharded
    from eig_kl_tpu_torch.utils.config import KLConfig

    g = _gen002_host().to_device(cuda)
    cfg = KLConfig(gain_eps=1e-6, passes=0)
    K2_STARTS.clear()
    best_s, cuts_s = multi_start_refine_mega_sharded(g, 4, mesh=one_rank, config=cfg, base_seed=3)
    assert set(K2_STARTS) == {4}
    best_1, cuts_1 = multi_start_refine_mega(g, 4, config=cfg, base_seed=3)
    np.testing.assert_array_equal(cuts_s, cuts_1)
    assert (best_s.best_cut, best_s.iterations, best_s.verified_cut) == (
        best_1.best_cut, best_1.iterations, best_1.verified_cut)
    np.testing.assert_array_equal(best_s.best_sides, best_1.best_sides)


def test_profiled_cli_trace_names_k1_step_and_k2(cuda, tmp_path, monkeypatch, capsys):
    """``fused -EIG`` on gen 0.02x with EIG_KL_TPU_PROFILE_DIR set: one
    Chrome trace, whose kernel events include K1's power step and K2."""
    import json

    from eig_kl_tpu_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("EIG_KL_TPU_PROFILE_DIR", str(tmp_path / "profile"))
    assert main(["fused", GEN_002, "-EIG"]) == 0
    assert "Power iterations: 201" in capsys.readouterr().out
    (trace,) = (tmp_path / "profile").iterdir()
    with open(trace) as f:
        names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
    assert any("power_step_kernel" in s for s in names), sorted(names)[:20]
    assert any("kl_pass_kernel" in s for s in names), sorted(names)[:20]


def _k5r_rank(rank: int, tmp: str, mode: str) -> None:
    """One of two ranks on the one card (gloo for the host side), run in a
    process of its own: "pass" runs smega_refine across the two ranks (K5R)
    on the dyadic graph, whole and capped at 50 swaps, the pass itself in
    each of K5R's three layouts, and K5 at S = 2 in this process from the
    same inputs; "timeout" makes rank 1 map the
    buffers and pass the launch barrier but never launch, and rank 0's K5R
    wait for it with a 1 s bound.  Writes its results for the test."""
    import datetime
    import pickle
    import time

    import torch.distributed as dist

    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.parallel import smega
    from eig_kl_tpu_torch.parallel.mesh import make_mesh
    from eig_kl_tpu_torch.utils.config import KLConfig

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 2), rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh(2, device="cuda")
    g = clique_expand(_hypergraph("dyadic"), "kl")
    sides = random_split(g.num_nodes, 5)
    plan = smega.SmegaPlan(g, 2, align=128)
    out = {}
    try:
        if mode == "pass":
            for cap in (None, 50):
                cfg = KLConfig(gain_eps=1e-6, max_iterations=cap)
                smega.K5R.launches = 0
                r = smega.smega_refine(g, sides, mesh, cfg, plan=plan)
                part = plan.rank_part(rank, mesh.device)
                k5 = smega.smega_pass_cuda(plan.device_graph(mesh.device), 2,
                                           *smega.pass_inputs(plan, sides, cfg, mesh.device))
                stripe = slice(part.r0, part.r0 + part.n_local)
                out[cap] = {
                    "launches": smega.K5R.launches,
                    "result": {f: getattr(r, f) for f in ("iterations", "initial_cut", "final_cut", "best_cut",
                                                          "verified_cut", "sides", "best_sides", "cut_trajectory",
                                                          "gain_trajectory")},
                }
                for layout in smega.K5_LAYOUTS:
                    k5r = smega.smega_pass_ranks_cuda(
                        mesh, part, *smega.pass_inputs(plan, sides, cfg, mesh.device, part), _layout=layout)
                    out[cap][layout] = {
                        name: (getattr(k5r, name).cpu().numpy(),
                               (getattr(k5, name)[stripe] if name == "sf" else getattr(k5, name)).cpu().numpy())
                        for name in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars")}
        elif rank == 0:
            cfg = KLConfig(gain_eps=1e-6)
            part = plan.rank_part(0, mesh.device)
            t0 = time.monotonic()
            try:
                smega.smega_pass_ranks_cuda(mesh, part, *smega.pass_inputs(plan, sides, cfg, mesh.device, part),
                                            spin_timeout_s=1.0)
            except RuntimeError as e:
                out["error"] = str(e)
            out["seconds"] = time.monotonic() - t0
            open(os.path.join(tmp, "done"), "w").close()
        else:
            smega.peer_buffers(mesh).launch_barrier(mesh)
            t0 = time.monotonic()
            while not os.path.exists(os.path.join(tmp, "done")) and time.monotonic() - t0 < 60:
                time.sleep(0.05)
    except Exception:  # noqa: BLE001 -- the test reports it
        import traceback

        out["exception"] = traceback.format_exc()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _two_ranks(tmp_path, mode: str) -> list[dict]:
    """Runs _k5r_rank in two processes on the one card, killed after 120 s."""
    import pickle
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    code = f"import sys; sys.path.insert(0, {here!r}); from test_torch_cuda import _k5r_rank; _k5r_rank({{}}, {str(tmp_path)!r}, {mode!r})"
    env = dict(os.environ, PYTHONPATH=os.path.dirname(here), OMP_NUM_THREADS="1", LOCAL_RANK="0")
    procs = [subprocess.Popen([sys.executable, "-c", code.format(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            logs.append(p.communicate()[0])
    outs = []
    for r in range(2):
        path = tmp_path / f"rank{r}.pkl"
        assert path.exists(), b"\n".join(logs).decode(errors="replace")[-3000:]
        outs.append(pickle.loads(path.read_bytes()))
        assert "exception" not in outs[-1], outs[-1]["exception"]
    return outs


def test_k5r_two_processes_equal_k5_at_two_shards(cuda, tmp_path):
    """K5R in two processes on the one card (CUDA IPC between them, the card
    time-slicing their contexts), on a 3,000-node dyadic graph from a random
    split, whole and capped at 50 swaps: one launch per rank for
    smega_refine; in each of its layouts (flat, the row-max cache with the
    state in global and in shared memory) each rank's logs, scalars and
    stripe of sf bit for bit K5's at S = 2 in one process; smega_refine's
    results the same on both ranks."""
    outs = _two_ranks(tmp_path, "pass")
    for cap in (None, 50):
        for r, out in enumerate(outs):
            run = out[cap]
            assert run["launches"] == 1
            for layout in ("flat", "global", "shared"):
                for name, (got, want) in run[layout].items():
                    np.testing.assert_array_equal(got, want, err_msg=f"rank {r}, cap {cap}, {layout}: {name}")
            for f, v in run["result"].items():
                np.testing.assert_array_equal(v, outs[0][cap]["result"][f], err_msg=f)
        assert outs[0][cap]["result"]["iterations"] == (cap or outs[0][None]["result"]["iterations"]) > 0


def test_k5r_rank_whose_peer_never_launches_raises(cuda, tmp_path):
    """Rank 1 maps the buffers and passes the launch barrier but never
    launches: rank 0's K5R gives up round A after its 1 s bound and raises,
    naming itself, the round and the peer, instead of hanging."""
    outs = _two_ranks(tmp_path, "timeout")
    err = outs[0].get("error", "")
    assert "rank 0 of 2" in err and "round A" in err and "from rank 1" in err, err
    assert 1.0 <= outs[0]["seconds"] < 15.0, outs[0]["seconds"]


@pytest.mark.parametrize("form", ["ell f32", "ell f64", "ell scaled f32", "ell scaled f64", "v2 mxu f32",
                                  "v2 mxu bf16i", "v2 mxu bf16w", "v2 mxu2 bf16i", "v2 vpu f32", "v1"])
def test_lazy_walks_with_z_equal_plain_bitwise(cuda, form):
    """Every lazy walk gathers ``z = dsinv * w``: given z (no z pass), and
    given only w (the z pass first, one launch), bit for bit its plain
    version on the CPU; K1's ELL walk on a graph of ELL width 48 in f32 and
    f64 and its scaled epilogue, the v2 order's walks at row block 512 (the
    6,000-node graph, a v1 tail) in each reduce order and products, the v1
    plan's walk (gen 0.02x)."""
    import importlib

    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.ops.spmv_plan import K1_V1, plan_lazy_walk, v2_kernel

    S = importlib.import_module("eig_kl_tpu_torch.ops.spmv")
    dtype = torch.float64 if form.endswith("f64") else torch.float32
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    rng = np.random.default_rng(31)
    if form.startswith("ell"):
        host = _graphs_host("hub44")
        g_cpu, g = host.to_device("cpu", dtype), host.to_device(cuda, dtype)
        n = g.num_nodes
        u = torch.as_tensor(rng.standard_normal(n)).to(dtype)
        u[::41] = -0.0
        c = torch.tensor(0.37, dtype=dtype)
        w = u * c
        d = torch.as_tensor(1.0 / np.sqrt(rng.uniform(0.5, 9.0, n))).to(dtype)
        scaled = (u, c) if "scaled" in form else None
        kernel = S.K1_LAZY if dtype == torch.float32 else S.K1_LAZY_F64
        z_pass = S.K1_Z if dtype == torch.float32 else S.K1_Z_F64

        def walk(graph, dev, **kw):
            sc = None if scaled is None else tuple(t.to(dev) for t in scaled)
            return S.lazy_walk(graph, w.to(dev), d.to(dev), sc, **kw)
        graphs = (g_cpu, g)
    else:
        kind = "v1" if form == "v1" else "v2"
        _, order, products = ("v1", "mxu", "f32") if kind == "v1" else form.split()
        host = _plan_graph("gen_0.02" if kind == "v1" else "6000")
        geometry = {} if kind == "v1" else dict(rblock=512, bf16_weights=True)
        lay_c, lay = (CsrPlan.for_graph(host.to_device(dv), kernel=kind, **geometry).layout for dv in ("cpu", cuda))
        n, P = host.num_nodes, lay.padded_nodes
        w = _padded_state(n, P, 3)
        degrees = torch.as_tensor(host.weighted_degrees.astype(np.float32))
        d = torch.zeros(P)
        d[:n] = 1.0 / torch.sqrt(torch.where(degrees > 0, degrees, 1.0))
        d = d.view(P // 128, 128)
        bf16 = products != "f32"
        form_kw = dict(reduce=order, bf16_weights=products == "bf16w")
        kernel = K1_V1 if kind == "v1" else v2_kernel(lay, bf16, order, products == "bf16w", lazy=True)
        z_pass = S.K1_Z

        def walk(layout, dev, **kw):
            return plan_lazy_walk(layout, w.to(dev), d.to(dev), bf16, **form_kw, **kw)
        graphs = (lay_c, lay)
    z = S.lazy_z(w.to(cuda), d.to(cuda))
    assert torch.equal(z.cpu().view(bits), (d * w).view(bits))
    want = walk(graphs[0], "cpu")
    before = (kernel.launches, z_pass.launches)
    got_z, got_w = walk(graphs[1], cuda, z=z), walk(graphs[1], cuda)
    assert (kernel.launches, z_pass.launches) == (before[0] + 2, before[1] + 1)
    for got in (got_z, got_w):
        assert torch.equal(got.cpu().view(bits), want.view(bits))
    with pytest.raises(ValueError, match="z"):
        walk(graphs[1], cuda, z=z.to(torch.float64 if dtype == torch.float32 else torch.float32))


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lazy_rescale_and_z_pass_equal_plain_bitwise(cuda, dtype, padded):
    """``lazy_rescale_f32`` / ``_f64`` writes ``(w * inv, u * inv, dsinv *
    (u * inv))`` in one launch, and the z pass ``dsinv * w`` in one, bit for
    bit their plain versions, on the component's length (184,406) and on a
    padded state whose dsinv is +0 in the padding; -0 inputs and an inv of
    1 (a zero norm) included."""
    import importlib

    S = importlib.import_module("eig_kl_tpu_torch.ops.spmv")
    rng = np.random.default_rng(41)
    n = 184406
    shape = (1441, 128) if padded else (n,)
    u, w = (torch.as_tensor(rng.standard_normal(shape)).to(dtype) for _ in range(2))
    d = torch.as_tensor(rng.uniform(0.1, 1.0, shape)).to(dtype)
    if padded:
        d.view(-1)[n:] = 0.0
    u.view(-1)[::97] = -0.0
    bits = torch.int32 if dtype == torch.float32 else torch.int64
    rescale, z_pass = (S.K1_RESCALE, S.K1_Z) if dtype == torch.float32 else (S.K1_RESCALE_F64, S.K1_Z_F64)
    for inv in (torch.tensor(1.0 / 2.9, dtype=dtype), torch.tensor(1.0, dtype=dtype)):
        before = (rescale.launches, z_pass.launches)
        got = S.lazy_rescale(u.to(cuda), w.to(cuda), inv.to(cuda), d.to(cuda))
        z = S.lazy_z(u.to(cuda), d.to(cuda))
        assert (rescale.launches, z_pass.launches) == (before[0] + 1, before[1] + 1)
        for a, b in zip(got, S.lazy_rescale_plain(u, w, inv, d)):
            assert a.shape == u.shape and torch.equal(a.cpu().view(bits), b.view(bits))
        assert torch.equal(z.cpu().view(bits), (d * u).view(bits))
    with pytest.raises(ValueError, match="inv"):
        S.lazy_rescale(u.to(cuda), w.to(cuda), inv.reshape(1).to(cuda), d.to(cuda))


def test_stream_handle_is_the_current_stream(cuda):
    """The handle the momentum step's wrappers pass their entry points
    (``ops/_build.py:stream_handle``) is ``torch.cuda.current_stream``'s, on
    the default stream and inside another, for a tensor's device and for
    ``torch.device("cuda")``; the rescale launched there is ordered on
    it."""
    from eig_kl_tpu_torch.ops._build import stream_handle
    from eig_kl_tpu_torch.ops.rescale import lazy_rescale_cuda, lazy_rescale_plain

    u = torch.linspace(-1.0, 1.0, 1 << 20, device=cuda)
    inv = torch.tensor(0.25, device=cuda)
    for device in (cuda, u.device):
        assert stream_handle(device) == torch.cuda.current_stream(device).cuda_stream
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        for device in (cuda, u.device):
            assert stream_handle(device) == side.cuda_stream != torch.cuda.default_stream(cuda).cuda_stream
        got = lazy_rescale_cuda(u, u, inv, u)
    side.synchronize()
    for a, b in zip(got, lazy_rescale_plain(u.cpu(), u.cpu(), inv.cpu(), u.cpu())):
        assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("path", ["csr f32", "csr f64", "padded v1"])
def test_momentum_inner_step_launches_one_walk_and_no_z_pass(cuda, path):
    """The momentum exit's inner step launches one lazy walk and one
    ``lazy_rescale``, and no z pass: over a run of s steps and k checks the
    walks are s + k, the rescales s, the z passes k + 1 (a check's walk,
    whose z the next step's walk reuses, and the start); the run equals the
    CPU's bit for bit (gen 0.02x, 201 steps; its v1 plan on the padded
    state)."""
    import importlib

    from eig_kl_tpu_torch.ops.spmv_plan import K1_V1
    from eig_kl_tpu_torch.spectral.power import power_partition_fiedler
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    S = importlib.import_module("eig_kl_tpu_torch.ops.spmv")
    dtype = torch.float64 if path.endswith("f64") else torch.float32
    host = _plan_graph("gen_0.02")
    with_plan = path.startswith("padded")
    g_cpu, g = (host.to_device(dv, dtype, with_plan=with_plan) for dv in ("cpu", cuda))
    cfg = SpectralConfig(solver="power", convergence="momentum", max_iterations=201, inter_dtype="bfloat16")
    f64 = dtype == torch.float64
    walk = K1_V1 if with_plan else (S.K1_LAZY_F64 if f64 else S.K1_LAZY)
    rescale, z_pass = (S.K1_RESCALE_F64, S.K1_Z_F64) if f64 else (S.K1_RESCALE, S.K1_Z)
    before = (walk.launches, rescale.launches, z_pass.launches)
    card = power_partition_fiedler(g, cfg, dtype=dtype)
    steps, checks = card[4] - 1, (card[4] - 1) // cfg.check_interval
    # The v1 plan's walk is its SpMV (spmv_v1_f32) and K6's axpy; the solve
    # launches the same SpMV for its first step and its final quotient.
    got = (walk.launches - before[0], rescale.launches - before[1], z_pass.launches - before[2])
    assert got == (steps + checks + 2 * with_plan, steps, checks + 1)
    cpu = power_partition_fiedler(g_cpu, cfg, dtype=dtype)
    assert card[4] == cpu[4] == 201
    np.testing.assert_array_equal(card[3], cpu[3])
    assert np.array_equal(card[2], cpu[2])
