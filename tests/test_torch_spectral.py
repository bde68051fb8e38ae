"""The port's power solve and spectral partition against the JAX
package's ``_power_core`` on gen 0.02x, on the CPU.

f64: the same iteration count, the same median split, lambda within
1e-10.  The ``gkl2`` exit runs all 1,000 steps on this graph, by when
3,694 of the 4,038 values lie within 1e-15 of the median and their side
is decided by the last bit; the ``sign`` exit's split has as many ties
(ROADMAP.md C4).  So the split is compared on the nodes that stand clear
of the median (more than 1e-12 max|v| from it).

f32 (``sign`` exit): the port adds every sum in XLA's CPU order, so it
reaches the JAX iterate bit for bit; the test holds it to the band of
iterations within one check and a split Hamming distance of at most 1 %
of n, and to the bits.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401  (autouse: PyTorch on one thread)

GEN_002 = os.path.join(
    os.path.dirname(__file__), "..", "benchmarks", "data", "gen_0.02_42.hgr"
)


@pytest.fixture(scope="module")
def gen002_graphs():
    """{dtype name: (JAX DeviceGraph, port DeviceGraph)} of gen 0.02x,
    KL weights, the same arrays in both packages."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.io.hgr import read_hgr
    from eig_kl_tpu_torch.graph.csr import device_graph_from_jax

    g_host = clique_expand(read_hgr(GEN_002, use_native=False), "kl", use_native=False)
    out = {}
    for dtype in ("float32", "float64"):
        g_jax = g_host.to_device(dtype=dtype)
        out[dtype] = g_jax, device_graph_from_jax(
            np.asarray(g_jax.ell_indices), np.asarray(g_jax.ell_weights),
            np.asarray(g_jax.degrees), np.asarray(g_jax.total_weight), "cpu",
        )
    return out


def _both(graphs, dtype, convergence, **over):
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.spectral.power import _power_core

    g_jax, g = graphs[dtype]
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=1000, seed=42)
    kw.update(over)
    lam_j, v_j, it_j = jax_core(g_jax, dtype=dtype, convergence=convergence, **kw)
    lam_t, v_t, it_t = _power_core(g, dtype=getattr(torch, dtype), convergence=convergence, **kw)
    return (float(lam_j), np.asarray(v_j), int(it_j)), (float(lam_t), v_t.numpy(), it_t)


def _upper_split(v):
    med = np.sort(v)[len(v) // 2]
    return med > v


@pytest.mark.parametrize("convergence", ["gkl2", "sign"])
def test_power_f64_matches_jax(gen002_graphs, convergence):
    (lam_j, v_j, it_j), (lam_t, v_t, it_t) = _both(gen002_graphs, "float64", convergence)
    assert it_t == it_j
    assert lam_t == pytest.approx(lam_j, abs=1e-10)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-9, atol=1e-12)
    split_t, split_j = _upper_split(v_t), _upper_split(v_j)
    med = np.sort(v_j)[len(v_j) // 2]
    clear = np.abs(v_j - med) > 1e-12 * np.abs(v_j).max()
    assert clear.sum() >= 300
    np.testing.assert_array_equal(split_t[clear], split_j[clear])


def test_power_f32_sign_matches_jax(gen002_graphs):
    (lam_j, v_j, it_j), (lam_t, v_t, it_t) = _both(gen002_graphs, "float32", "sign")
    n = len(v_j)
    assert abs(it_t - it_j) <= 25
    split_t, split_j = _upper_split(v_t), _upper_split(v_j)
    hamming = int((split_t != split_j).sum())
    assert min(hamming, n - hamming) <= 0.01 * n
    assert lam_t == pytest.approx(lam_j, rel=1e-5)
    # The fixed summation order makes the iterate identical.
    assert it_t == it_j
    np.testing.assert_array_equal(v_t, v_j)


@pytest.mark.parametrize("steps", [1, 7, 60])
def test_power_f32_steps_are_bit_identical(gen002_graphs, steps):
    """Each step of the f32 iteration reproduces the JAX step's bits."""
    (_, v_j, it_j), (_, v_t, it_t) = _both(
        gen002_graphs, "float32", "gkl2", max_iters=steps
    )
    assert it_t == it_j == steps
    np.testing.assert_array_equal(v_t, v_j)


def test_unknown_convergence_is_refused(gen002_graphs):
    from eig_kl_tpu_torch.spectral.power import _power_core

    with pytest.raises(ValueError, match="unknown power convergence"):
        _power_core(
            gen002_graphs["float32"][1], shift=2.0, tolerance=1e-6, min_iters=100,
            max_iters=1000, seed=42, dtype=torch.float32, convergence="chebyshev",
        )


def test_power_partition_momentum_matches_jax(gen002_graphs):
    """``power_partition_fiedler`` with ``convergence="momentum"`` at f32
    against the JAX package's, capped at 201 steps: the same vector, median
    and sides bit for bit."""
    from eig_kl_tpu.spectral.power import power_partition_fiedler as jax_ppf
    from eig_kl_tpu.utils.config import SpectralConfig as JaxConfig
    from eig_kl_tpu_torch.spectral.power import power_partition_fiedler
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    g_jax, g = gen002_graphs["float32"]
    cfg = dict(solver="power", convergence="momentum", max_iterations=201)
    _, med_j, v_j, sides_j = jax_ppf(g_jax, JaxConfig(**cfg), dtype=jnp.float32)
    _, med_t, v_t, sides_t, iters = power_partition_fiedler(g, SpectralConfig(**cfg))
    assert iters == 201
    np.testing.assert_array_equal(v_t.view(np.int32), np.asarray(v_j).view(np.int32))
    assert med_t == med_j
    np.testing.assert_array_equal(sides_t, sides_j)


def test_eig_partition_matches_jax_f64():
    """The power-solver spectral phase end to end: the port's
    ``eig_partition`` against the JAX package's, both in f64 with the
    sign exit, the sides off the ties (see the module note)."""
    from eig_kl_tpu.io.hgr import read_hgr as jax_read
    from eig_kl_tpu.spectral.partition import eig_partition as jax_eig
    from eig_kl_tpu.utils.config import SpectralConfig as JaxConfig
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.spectral.partition import eig_partition
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    cfg = dict(solver="power", convergence="sign")
    ref = jax_eig(jax_read(GEN_002, use_native=False), JaxConfig(**cfg), dtype=jnp.float64)
    got, iters = eig_partition(
        read_hgr(GEN_002), SpectralConfig(**cfg), dtype=torch.float64, device="cpu"
    )
    assert iters > 100
    assert got.eigenvalue == pytest.approx(ref.eigenvalue, abs=1e-10)
    assert got.median == pytest.approx(ref.median, abs=1e-12)
    clear = np.abs(ref.values - ref.median) > 1e-12 * np.abs(ref.values).max()
    assert clear.sum() >= 300
    np.testing.assert_array_equal(got.sides[clear], ref.sides[clear])
    np.testing.assert_allclose(got.values, ref.values, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("solver", ["lanczos", "lobpcg"])
def test_eig_partition_other_solvers_match_jax_f64(solver):
    """``eig_partition`` with Lanczos or LOBPCG in f64 on the largest
    component of gen 0.02x: lambda_2 within 1e-10, the split (up to the
    mirror a negated vector gives) and the balance."""
    from eig_kl_tpu.spectral.partition import eig_partition as jax_eig
    from eig_kl_tpu.utils.config import SpectralConfig as JaxConfig
    from eig_kl_tpu_torch.spectral.partition import eig_partition
    from eig_kl_tpu_torch.utils.config import SpectralConfig
    from test_torch_lanczos import circuit

    hg, jhg = circuit("lcc")
    ref = jax_eig(jhg, JaxConfig(solver=solver), dtype=jnp.float64)
    got, iters = eig_partition(hg, SpectralConfig(solver=solver), dtype=torch.float64, device="cpu")
    assert iters >= 1
    assert got.eigenvalue == pytest.approx(ref.eigenvalue, abs=1e-10)
    assert got.eigenvalue == pytest.approx(0.0973479036, abs=1e-9)
    sign = 1 if got.values @ ref.values >= 0 else -1
    np.testing.assert_allclose(sign * got.values, ref.values, atol=1e-7)
    clear = np.abs(ref.values - ref.median) > 1e-9
    sides = got.sides if sign > 0 else 1 - got.sides
    np.testing.assert_array_equal(sides[clear], ref.sides[clear])
    assert got.balance() == ref.balance() == (1847, 1847)


def test_unknown_solver_is_refused():
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.spectral.partition import eig_partition
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    with pytest.raises(ValueError, match="unknown spectral solver"):
        eig_partition(read_hgr(GEN_002), SpectralConfig(solver="arpack"), device="cpu")


def test_auto_solver_resolves_like_jax():
    from eig_kl_tpu.utils.config import SpectralConfig as JaxConfig
    from eig_kl_tpu.utils.config import resolve_solver as jax_resolve
    from eig_kl_tpu_torch.utils.config import SpectralConfig, resolve_solver

    for n in (10, 256, 257, 4038):
        assert resolve_solver(SpectralConfig(solver="auto"), n).solver == (
            jax_resolve(JaxConfig(solver="auto"), n).solver
        )


@pytest.mark.parametrize("convention", ["average", "upper"])
def test_median_split_matches_jax(convention):
    from eig_kl_tpu.spectral.partition import median_split as jax_split
    from eig_kl_tpu_torch.spectral.partition import median_split

    v = np.round(np.random.default_rng(9).standard_normal(500), 2)
    med_j, sides_j = jax_split(jnp.asarray(v), convention)
    med_t, sides_t = median_split(torch.as_tensor(v), convention)
    assert float(med_t) == float(med_j)
    np.testing.assert_array_equal(sides_t.numpy(), np.asarray(sides_j))
