"""The port's KL pass (kernel K2's plain version) and refinement against
the JAX package's engines, on the CPU.

* f32, from the same ``sf0``/``a_s0`` bits: ``kl_pass_plain`` against the
  TPU mega-kernel ``megakernel._run`` in interpret mode, in its flat and
  its hierarchical selection form: logs, iterations and scalars bitwise.
* f64: against ``np_engine.refine_np`` and the XLA engine.  On graphs
  whose weights are exact binary fractions every sum is exact, and the
  three give the same swap sequence and iteration count, with the cut
  trajectory to 1e-9 relative (the port's cut is Kahan-compensated,
  theirs is not).  On a real circuit (gen 0.02x, weights 1/3, 1/5, 1/7)
  equal D values are computed with different roundings in each engine,
  and the JAX package's own two engines part at the first such tie (197
  against 195 swaps from the f64 spectral split); there the port is held
  to their best cut within 2 %.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_hypergraph

GEN_002 = os.path.join(
    os.path.dirname(__file__), "..", "benchmarks", "data", "gen_0.02_42.hgr"
)


def dyadic_hypergraph(rng, num_nodes, num_nets):
    """Random hypergraph whose KL weights 1/(k-1) are exact binary
    fractions (k in {2, 3, 5}), so every sum is exact and ties break the
    same way in every summation order."""
    from eig_kl_tpu.io.hgr import Hypergraph

    sizes = rng.choice([2, 3, 5], size=num_nets, p=[0.6, 0.25, 0.15])
    pins = np.concatenate([rng.choice(num_nodes, size=k, replace=False) for k in sizes])
    offs = np.zeros(num_nets + 1, dtype=np.int64)
    np.cumsum(sizes, out=offs[1:])
    return Hypergraph(num_nodes, num_nets, pins.astype(np.int32), offs)


def _port_graph(g_host, dtype):
    from eig_kl_tpu_torch.graph.csr import Graph

    return Graph.from_arrays(g_host.indptr, g_host.indices, g_host.data).to_device("cpu", dtype)


def _pass_inputs(g, sides, dtype):
    from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
    from eig_kl_tpu_torch.ops.spmv import spmv_plain

    s = sides_to_signs(torch.as_tensor(sides), dtype)
    a_s = spmv_plain(g, s)
    return s, a_s, float(cut_size(g, s, a_s))


def _jax_mega_pass(g_host, sf0, as0, cut0, cap, terminate_limit, gain_eps):
    """One pass of the TPU mega-kernel in interpret mode, from the given
    f32 state; returns (logs, scalars) as flat numpy arrays."""
    from eig_kl_tpu.kl import megakernel as M

    mg = M.MegaGraph(g_host)
    n, P = mg.num_nodes, mg.padded_nodes
    sf_p = np.zeros(P, np.float32)
    as_p = np.zeros(P, np.float32)
    sf_p[:n], as_p[:n] = sf0, as0
    out = M._run(
        mg.meta_indices, mg.meta_weights,
        jnp.asarray(sf_p.reshape(P // 128, 128)), jnp.asarray(as_p.reshape(P // 128, 128)),
        jnp.asarray([[cut0, cut0]], jnp.float32), jnp.asarray([[cap, 0]], jnp.int32),
        num_nodes=n, max_iters=cap, terminate_limit=terminate_limit,
        gain_eps=gain_eps, interpret=True,
    )
    sf, lc, lg, la, lb, sc = (np.asarray(a) for a in out)
    return sf.reshape(-1)[:n], lc.reshape(-1), lg.reshape(-1), la.reshape(-1), lb.reshape(-1), sc[:, 0]


@pytest.mark.parametrize("hierarchical", [False, True])
@pytest.mark.parametrize("graph", ["random", "dyadic"])
def test_kl_pass_plain_f32_equals_tpu_kernel_bitwise(graph, hierarchical, monkeypatch):
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.kl import megakernel as M
    from eig_kl_tpu_torch.kl.megakernel import kl_pass_plain

    if hierarchical:  # the row-max cache form the TPU kernel takes above 131,072 nodes
        monkeypatch.setattr(M, "HIER_THRESHOLD", 0)
    M._run.clear_cache()  # the form is fixed when _run is traced
    rng = np.random.default_rng(21)
    if graph == "random":
        hg = random_hypergraph(rng, num_nodes=260, num_nets=330)
    else:
        hg = dyadic_hypergraph(rng, num_nodes=200, num_nets=300)
    g_host = clique_expand(hg, "kl", use_native=False)
    g = _port_graph(g_host, torch.float32)
    sides = (rng.random(g.num_nodes) < 0.5).astype(np.int8)
    s, a_s, cut0 = _pass_inputs(g, sides, torch.float32)
    n1 = int(sides.sum())
    cap = min(n1, g.num_nodes - n1)
    tl, eps = 12, 1e-6
    ref = _jax_mega_pass(g_host, s.numpy(), a_s.numpy(), cut0, cap, tl, eps)
    M._run.clear_cache()
    got = kl_pass_plain(g, s, a_s, cut0, cap, tl, eps)
    it = int(ref[5][2])
    assert it > 10
    np.testing.assert_array_equal(got.scalars.numpy(), ref[5])
    np.testing.assert_array_equal(got.sf.numpy(), ref[0])
    for mine, theirs in zip((got.log_cut, got.log_gain, got.log_a, got.log_b), ref[1:5]):
        np.testing.assert_array_equal(mine.numpy()[: it + 1], theirs[: it + 1])


def _jax_xla_logs(g_host, sides, dtype, config):
    """The XLA engine's swap log (log_a, log_b), cut trajectory and count."""
    from eig_kl_tpu.kl.engine import _kl_loop

    n1 = int(sides.sum())
    out = _kl_loop(
        g_host.to_device(dtype=dtype), jnp.asarray(sides, jnp.int8),
        max_iters=min(n1, g_host.num_nodes - n1), gain_eps=config.gain_eps,
        terminate_limit=config.terminate_limit(g_host.num_nodes), refresh_interval=0,
    )
    it = int(out.iterations)
    return (np.asarray(out.log_a)[1: it + 1], np.asarray(out.log_b)[1: it + 1],
            np.asarray(out.log_cut)[: it + 1], it)


def _gen002_f64_split():
    """The f64 power split of gen 0.02x (sign exit), from the JAX package."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.io.hgr import read_hgr
    from eig_kl_tpu.spectral.power import power_partition_fiedler
    from eig_kl_tpu.utils.config import SpectralConfig

    g_host = clique_expand(read_hgr(GEN_002, use_native=False), "kl", use_native=False)
    cfg = SpectralConfig(solver="power", convergence="sign")
    sides = power_partition_fiedler(g_host.to_device(dtype="float64"), cfg, dtype=jnp.float64)[3]
    return g_host, np.asarray(sides, np.int8)


def _f64_pass(g_host, sides, gain_eps):
    from eig_kl_tpu_torch.kl.megakernel import kl_pass_plain
    from eig_kl_tpu_torch.utils.config import KLConfig

    g = _port_graph(g_host, torch.float64)
    s, a_s, cut0 = _pass_inputs(g, sides, torch.float64)
    n1 = int(sides.sum())
    cap = min(n1, g.num_nodes - n1)
    limit = KLConfig().terminate_limit(g.num_nodes)
    return kl_pass_plain(g, s, a_s, cut0, cap, limit, gain_eps)


@pytest.mark.parametrize("gain_eps", [0.0, 1e-6])
@pytest.mark.parametrize("size", [(96, 200), (400, 700)])
def test_kl_pass_f64_matches_numpy_and_xla_engines(size, gain_eps):
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.kl.np_engine import refine_np
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig

    rng = np.random.default_rng(33)
    g_host = clique_expand(dyadic_hypergraph(rng, *size), "kl", use_native=False)
    sides = (rng.random(size[0]) < 0.5).astype(np.int8)
    got = _f64_pass(g_host, sides, gain_eps)
    it = int(got.scalars[2])
    log_a, log_b = got.log_a.numpy()[1: it + 1], got.log_b.numpy()[1: it + 1]
    log_cut = got.log_cut.numpy()[: it + 1]

    xa, xb, xcut, xit = _jax_xla_logs(g_host, sides, jnp.float64, JaxKLConfig(gain_eps=gain_eps))
    assert it == xit > 10
    np.testing.assert_array_equal(log_a, xa)
    np.testing.assert_array_equal(log_b, xb)
    np.testing.assert_allclose(log_cut, xcut, rtol=1e-9)

    ref = refine_np(g_host, sides, JaxKLConfig(gain_eps=gain_eps), dtype=np.float64)
    assert ref.iterations == it
    np.testing.assert_allclose(log_cut, ref.cut_trajectory, rtol=1e-9)
    final = sides.copy()
    final[log_a], final[log_b] = 1, 0
    np.testing.assert_array_equal(final, ref.sides)


def test_kl_pass_f64_quality_on_gen002_matches_jax_engines():
    from eig_kl_tpu.kl.np_engine import refine_np
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig

    g_host, sides = _gen002_f64_split()
    got = _f64_pass(g_host, sides, 1e-6)
    best = float(got.scalars[1])
    xcut = _jax_xla_logs(g_host, sides, jnp.float64, JaxKLConfig(gain_eps=1e-6))[2]
    np_best = refine_np(g_host, sides, JaxKLConfig(gain_eps=1e-6), dtype=np.float64).best_cut
    assert float(got.log_cut[0]) == pytest.approx(float(xcut[0]), rel=1e-12)
    for ref in (float(xcut.min()), np_best):
        assert best <= 1.02 * ref


def test_refine_mega_matches_jax_refine_mega_f32():
    """The whole refinement (initial A@s and cut, one pass, replay and
    recount) against the JAX package's mega-kernel path in interpret mode."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.kl.megakernel import MegaGraph, refine_mega as jax_refine
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl.megakernel import refine_mega
    from eig_kl_tpu_torch.utils.config import KLConfig

    rng = np.random.default_rng(4)
    g_host = clique_expand(dyadic_hypergraph(rng, 180, 300), "kl", use_native=False)
    sides = (rng.random(180) < 0.5).astype(np.int8)
    ref = jax_refine(MegaGraph(g_host), sides, JaxKLConfig(gain_eps=1e-6), interpret=True)
    got = refine_mega(_port_graph(g_host, torch.float32), sides, KLConfig(gain_eps=1e-6))
    assert got.iterations == ref.iterations > 10
    for name in ("initial_cut", "final_cut", "best_cut", "verified_cut"):
        assert getattr(got, name) == getattr(ref, name), name
    np.testing.assert_array_equal(got.sides, ref.sides)
    np.testing.assert_array_equal(got.best_sides, ref.best_sides)
    np.testing.assert_array_equal(got.cut_trajectory, ref.cut_trajectory)
    np.testing.assert_array_equal(got.gain_trajectory, ref.gain_trajectory)


@pytest.mark.parametrize("max_iterations", [None, 7])
def test_refine_mega_honours_the_cap_and_replays_the_first_best(max_iterations):
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.kl.megakernel import refine_mega
    from eig_kl_tpu_torch.kl.result import best_iteration, replay_swaps
    from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
    from eig_kl_tpu_torch.utils.config import KLConfig

    hg = read_hgr(GEN_002)
    g = clique_expand(hg, "kl").to_device("cpu", torch.float64)
    sides = (np.random.default_rng(2).random(hg.num_nodes) < 0.5).astype(np.int8)
    cfg = KLConfig(max_iterations=max_iterations)
    r = refine_mega(g, sides, cfg)
    if max_iterations is not None:
        assert r.iterations == max_iterations
    k = best_iteration(r.cut_trajectory, r.iterations)
    assert r.cut_trajectory[k] == r.best_cut == r.cut_trajectory.min()
    assert (r.cut_trajectory[:k] > r.best_cut).all()  # the first minimum
    best_cut = float(cut_size(g, sides_to_signs(torch.as_tensor(r.best_sides), torch.float64)))
    assert best_cut == pytest.approx(r.best_cut, rel=1e-9)
    assert r.verified_cut == pytest.approx(r.final_cut, rel=1e-9)
    assert (r.sides.sum(), r.best_sides.sum()) == (sides.sum(), sides.sum())
    assert replay_swaps(sides, np.zeros(1, np.int32), np.zeros(1, np.int32), 0).tolist() == sides.tolist()


def test_kl_kernel_wrapper_refuses_cpu_tensors():
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.kl.megakernel import K2, kl_pass, kl_pass_cuda

    g = clique_expand(read_hgr(GEN_002), "kl").to_device("cpu")
    s = torch.ones(g.num_nodes)
    with pytest.raises(ValueError, match="CUDA"):
        kl_pass_cuda(g, s, s, 0.0, 1, 5, 0.0)
    before = K2.launches
    kl_pass(g, s, s, 0.0, 1, 5, 0.0)  # all on side 0: no swap, plain version
    assert K2.launches == before
