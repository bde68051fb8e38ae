"""The port's kernels on the card against their plain versions.

Every test here needs a CUDA card and skips without one.  The module
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed; run it on the card, without the JAX-side ``conftest.py``, with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

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
    from eig_kl_tpu_torch.ops.spmv import spmv

    g_host_dev = _graphs("gen_0.02", cuda)[1]
    with pytest.raises(TypeError, match="float32"):
        spmv(g_host_dev, torch.zeros(g_host_dev.num_nodes, dtype=torch.float64, device=cuda))


@pytest.mark.parametrize("kind", ["gen_0.02", "hub44"])
def test_k2_equals_plain_bitwise(cuda, kind):
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.kl.megakernel import K2, kl_pass, kl_pass_plain
    from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
    from eig_kl_tpu_torch.ops.spmv import spmv

    _, g = _graphs(kind, cuda)
    sides = torch.as_tensor(random_split(g.num_nodes, 5)).to(cuda)
    s = sides_to_signs(sides, torch.float32)
    a_s = spmv(g, s)
    cut0 = float(cut_size(g, s, a_s))
    n1 = int(sides.sum())
    args = (g, s, a_s, cut0, min(n1, g.num_nodes - n1), 16, 1e-6)
    before = K2.launches
    got = kl_pass(*args)
    assert K2.launches == before + 1
    ref = kl_pass_plain(*args)
    torch.cuda.synchronize()
    assert int(got.scalars[2]) > 50
    for name in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


def test_fused_on_the_card_equals_the_cpu_run(cuda):
    """The card computes the same bits as the CPU path (which the CPU
    tests hold to the JAX package), and goes through both kernels."""
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.kl.megakernel import K2
    from eig_kl_tpu_torch.models.pipelines import fused_partition
    from eig_kl_tpu_torch.ops.spmv import K1

    hg = read_hgr(GEN_002)
    K1.launches = K2.launches = 0
    card = fused_partition(hg)  # the default device is the card
    k1, k2 = K1.launches, K2.launches
    cpu = fused_partition(hg, device="cpu")
    assert card.spectral_iterations == cpu.spectral_iterations == 201
    assert (k1, k2) == (card.spectral_iterations + 3, 1)
    np.testing.assert_array_equal(card.eig.sides, cpu.eig.sides)
    np.testing.assert_array_equal(card.eig.values, cpu.eig.values)
    for name in ("iterations", "initial_cut", "best_cut", "final_cut", "verified_cut"):
        assert getattr(card.kl, name) == getattr(cpu.kl, name), name
    np.testing.assert_array_equal(card.kl.best_sides, cpu.kl.best_sides)
    np.testing.assert_array_equal(card.kl.cut_trajectory, cpu.kl.cut_trajectory)


def _batch_inputs(g, seeds):
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.kl.megakernel import _batch_init
    from eig_kl_tpu_torch.ops.partition import sides_to_signs

    sides = torch.as_tensor(np.stack([random_split(g.num_nodes, s) for s in seeds])).to(g.device)
    s = sides_to_signs(sides, torch.float32)
    a_s, cut0 = _batch_init(g, s)
    return s, a_s, cut0


@pytest.mark.parametrize("kind", ["gen_0.02", "hub44"])
def test_k2_batched_equals_plain_and_single_launches_bitwise(cuda, kind):
    """One launch of 3 starts: a full pass, a zero cap, and a re-entry with
    a best cut below the cut and a termination count carried in."""
    from eig_kl_tpu_torch.kl.megakernel import (
        K2, K2_STARTS, kl_pass_batch, kl_pass_batch_plain, kl_pass_cuda,
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
    got = kl_pass_batch(*args)
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


def test_refresh_interval_on_the_card_equals_the_cpu_run(cuda):
    from eig_kl_tpu_torch.kl.init import random_split
    from eig_kl_tpu_torch.kl.megakernel import K2_STARTS, refine_mega
    from eig_kl_tpu_torch.utils.config import KLConfig

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
