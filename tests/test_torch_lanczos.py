"""The port's Lanczos, LOBPCG, host refinement and momentum exit against
the JAX package's, on the CPU, on connected graphs: the largest connected
component of gen 0.02x (3,694 nodes, ELL width 32) and of a random
hypergraph with a 40-pin net (ELL width 56, XLA's window order).

Contracts (the generator's circuits are disconnected, where lambda_2 = 0
has the multiplicity of the components and a "Fiedler vector" is an
arbitrary null vector, so every solve here runs on a component):

* the start vectors (``threefry.normal``) and the three K1 epilogues'
  plain versions equal JAX's bit for bit; XLA's CPU fusion contracts
  ``deg * x - A x`` and ``w + dsinv * A(dsinv w)`` into fused
  multiply-adds, and so do they;
* f64 Lanczos and LOBPCG: lambda_2 within 1e-10, the vector equal up to
  sign (|cos| >= 1 - 1e-6), restarts within one;
* f32 with the host f64 refinement: lambda_2 within 1e-6 relative, the
  sides equal except for nodes within 1e-9 of the median.  f32 is not
  bitwise: XLA's CPU dot and PyTorch's matmul add in other orders;
* the momentum exit at f32: the JAX package's iterate bit for bit on gen
  0.02x.  On its component the two part at the second check: there XLA
  fuses the lazy walk's row sums into the Rayleigh quotient's dot and adds
  them in an order the port does not reproduce, so the component is held
  to the sign exit's band (iterations within one check, a split Hamming
  distance of at most 1 % of n).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph
import torch
from torch_one_thread import default_threads, one_thread  # noqa: F401  (autouse: PyTorch on one thread)

REPO = os.path.join(os.path.dirname(__file__), "..")
GEN_002 = os.path.join(REPO, "benchmarks", "data", "gen_0.02_42.hgr")


def largest_component(hg):
    """The largest connected component of a hypergraph: its nodes renumbered
    in order, the nets whose pins all lie in it."""
    from eig_kl_tpu_torch.io.hgr import Hypergraph

    sizes = np.diff(hg.net_offsets)
    first = np.repeat(hg.pins[hg.net_offsets[:-1]], sizes)
    n = hg.num_nodes
    adj = sp.coo_matrix((np.ones(len(first)), (first, hg.pins)), shape=(n, n))
    _, label = csgraph.connected_components(adj, directed=False)
    keep = label == np.argmax(np.bincount(label))
    new_id = np.cumsum(keep) - 1
    nets = np.add.reduceat(keep[hg.pins].astype(np.int64), hg.net_offsets[:-1]) == sizes
    pins = new_id[hg.pins[np.repeat(nets, sizes)]].astype(np.int32)
    offsets = np.zeros(int(nets.sum()) + 1, np.int64)
    np.cumsum(sizes[nets], out=offsets[1:])
    return Hypergraph(int(keep.sum()), int(nets.sum()), pins, offsets, name="lcc.hgr")


def _hub():
    from eig_kl_tpu_torch.io.hgr import Hypergraph

    rng = np.random.default_rng(5)
    n = 1200
    sizes = rng.choice([2, 3, 4, 6], size=1500, p=[0.6, 0.2, 0.15, 0.05])
    nets = [rng.choice(n, k, replace=False) for k in sizes] + [rng.choice(n, 40, replace=False)]
    offsets = np.zeros(len(nets) + 1, np.int64)
    np.cumsum([len(a) for a in nets], out=offsets[1:])
    return Hypergraph(n, len(nets), np.concatenate(nets).astype(np.int32), offsets)


_CIRCUITS = {}


def circuit(kind):
    """(port Hypergraph, JAX Hypergraph) of one connected test circuit."""
    if kind not in _CIRCUITS:
        from eig_kl_tpu.io.hgr import Hypergraph as JaxHypergraph
        from eig_kl_tpu_torch.io.hgr import read_hgr

        hg = largest_component(read_hgr(GEN_002) if kind == "lcc" else _hub())
        jhg = JaxHypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets, name=hg.name)
        _CIRCUITS[kind] = hg, jhg
    return _CIRCUITS[kind]


def graphs(kind, weighting, dtype):
    """(JAX DeviceGraph, port DeviceGraph) of the same arrays."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu_torch.graph.csr import device_graph_from_jax

    g_jax = clique_expand(circuit(kind)[1], weighting, use_native=False).to_device(dtype=dtype)
    return g_jax, device_graph_from_jax(
        np.asarray(g_jax.ell_indices), np.asarray(g_jax.ell_weights),
        np.asarray(g_jax.degrees), np.asarray(g_jax.total_weight), "cpu",
    )


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))


def test_component_helper():
    hg, _ = circuit("lcc")
    assert (hg.num_nodes, hg.num_nets, len(hg.pins)) == (3694, 4194, 10445)
    assert graphs("lcc", "eig", "float32")[1].row_width == 32
    assert graphs("hub", "eig", "float32")[1].row_width == 56


# ------------------------------------------------------------ start vectors


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(4038,), (4038, 4)])
def test_normal_equals_jax_random_normal(dtype, shape):
    from eig_kl_tpu_torch.utils.threefry import normal

    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(42), shape, dtype))
    got = normal(42, shape, dtype)
    assert got.dtype == np.dtype(dtype) and got.shape == shape
    np.testing.assert_array_equal(_bits(got), _bits(ref))


# ---------------------------------------------------- K1's epilogues, plain


@pytest.mark.parametrize("kind", ["lcc", "hub"])
def test_plain_epilogues_equal_xla(kind):
    """``laplacian_plain``, ``spmm_plain`` and ``lazy_walk_plain`` against
    the JAX package's expressions under ``jax.jit``, bit for bit: XLA's CPU
    fusion contracts each epilogue's product into its add."""
    from eig_kl_tpu.ops.partition import spmv as jax_spmv
    from eig_kl_tpu_torch.ops.spmv import laplacian_plain, lazy_walk_plain, spmm_plain

    g_jax, g = graphs(kind, "eig", "float32")
    n = g.num_nodes
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n).astype(np.float32)
    X = rng.standard_normal((n, 16)).astype(np.float32)
    deg = np.asarray(g_jax.degrees)
    dsinv = (1.0 / np.sqrt(np.where(deg > 0, deg, 1.0))).astype(np.float32)

    lap = jax.jit(lambda g, x: g.degrees * x - jax_spmv(g, x))
    np.testing.assert_array_equal(_bits(laplacian_plain(g, torch.as_tensor(x))), _bits(lap(g_jax, x)))

    def vmapped(g, X):
        return jax.vmap(lambda c: jax_spmv(g, c), in_axes=1, out_axes=1)(X)

    blocked = jax.jit(lambda g, X: g.degrees[:, None] * X - vmapped(g, X))
    for k in (1, 4, 8, 12, 16):
        Xk = np.ascontiguousarray(X[:, :k])
        np.testing.assert_array_equal(
            _bits(spmm_plain(g, torch.as_tensor(Xk), laplacian=True)), _bits(blocked(g_jax, Xk))
        )
        np.testing.assert_array_equal(
            _bits(spmm_plain(g, torch.as_tensor(Xk))), _bits(jax.jit(vmapped)(g_jax, Xk))
        )

    walk = jax.jit(lambda g, w, d: 0.5 * (w + d * jax_spmv(g, d * w)))
    got = lazy_walk_plain(g, torch.as_tensor(x), torch.as_tensor(dsinv))
    np.testing.assert_array_equal(_bits(got), _bits(walk(g_jax, x, dsinv)))


def test_epilogues_dispatch_to_the_plain_versions_on_the_cpu():
    """On the CPU the dispatchers run the plain versions and launch
    nothing; the card's wrappers refuse a CPU tensor."""
    import importlib

    S = importlib.import_module("eig_kl_tpu_torch.ops.spmv")
    _, g = graphs("lcc", "eig", "float32")
    x = torch.randn(g.num_nodes, generator=torch.Generator().manual_seed(0))
    before = (S.K1_LAPLACIAN.launches, S.K1_SPMM.launches, S.K1_LAZY.launches)
    assert torch.equal(S.laplacian(g, x), S.laplacian_plain(g, x))
    X = torch.stack([x, -x, 2 * x], dim=1)
    assert torch.equal(S.spmm(g, X, laplacian=True), S.spmm_plain(g, X, laplacian=True))
    d = x.abs() + 1
    assert torch.equal(S.lazy_walk(g, x, d), S.lazy_walk_plain(g, x, d))
    for call in (lambda: S.laplacian_cuda(g, x), lambda: S.spmm_cuda(g, X),
                 lambda: S.lazy_walk_cuda(g, x, d)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert (S.K1_LAPLACIAN.launches, S.K1_SPMM.launches, S.K1_LAZY.launches) == before


# ------------------------------------------------------------------ solvers


@pytest.mark.parametrize("kind", ["lcc", "hub"])
def test_lanczos_f64_equals_jax(kind):
    from eig_kl_tpu.spectral.lanczos import lanczos_fiedler as jax_lanczos
    from eig_kl_tpu.utils.config import SpectralConfig as JaxConfig
    from eig_kl_tpu_torch.spectral.lanczos import lanczos_fiedler
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    g_jax, g = graphs(kind, "eig", "float64")
    ref = jax_lanczos(g_jax, JaxConfig(), dtype=jnp.float64)
    lam_ref, vec_ref = float(ref.eigenvalue), np.asarray(ref.vector)
    got = lanczos_fiedler(g, SpectralConfig(), dtype=torch.float64)
    assert got.converged and ref.converged
    assert abs(got.restarts - ref.restarts) <= 1
    assert float(got.eigenvalue) == pytest.approx(lam_ref, abs=1e-10)
    assert _cos(got.vector.numpy(), vec_ref) >= 1 - 1e-6
    assert float(got.residual) < 1e-6


@pytest.mark.parametrize("kind", ["lcc", "hub"])
def test_lobpcg_f64_equals_jax(kind):
    from eig_kl_tpu.spectral.lobpcg_solver import lobpcg_fiedler as jax_lobpcg
    from eig_kl_tpu.utils.config import SpectralConfig as JaxConfig
    from eig_kl_tpu_torch.spectral.lobpcg_solver import lobpcg_fiedler
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    g_jax, g = graphs(kind, "eig", "float64")
    ref = jax_lobpcg(g_jax, JaxConfig(solver="lobpcg"), dtype=jnp.float64)
    lam_ref, vec_ref, it_ref = float(ref.eigenvalue), np.asarray(ref.vector), int(ref.iterations)
    got = lobpcg_fiedler(g, SpectralConfig(solver="lobpcg"), dtype=torch.float64)
    assert abs(got.iterations - it_ref) <= 1 and got.iterations < 1000
    assert float(got.eigenvalue) == pytest.approx(lam_ref, abs=1e-10)
    assert _cos(got.vector.numpy(), vec_ref) >= 1 - 1e-6


def _sides_agree(got, ref):
    """The sides equal (or mirrored, with the vector's sign) except for
    nodes within 1e-9 of the median."""
    clear = np.abs(ref.values - ref.median) > 1e-9
    sides = got.sides if got.values @ ref.values >= 0 else 1 - got.sides
    np.testing.assert_array_equal(sides[clear], ref.sides[clear])


@pytest.mark.parametrize("solver", ["lanczos", "lobpcg"])
def test_eig_partition_f32_with_the_host_refine_equals_jax(solver):
    """f32 on the device plus the f64 host refinement (on by default for
    f32), against the JAX package's same run: lambda_2 within 1e-6
    relative, the vector up to sign, the split."""
    from eig_kl_tpu.spectral.partition import eig_partition as jax_eig
    from eig_kl_tpu.utils.config import SpectralConfig as JaxConfig
    from eig_kl_tpu_torch.spectral.partition import eig_partition_solve
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    hg, jhg = circuit("lcc")
    ref = jax_eig(jhg, JaxConfig(solver=solver), dtype=jnp.float32)
    # The f32 solve's BLAS products on the CPU (Lanczos's V @ w, LOBPCG's
    # Q.T @ AQ) round by the thread count; the refinement's residual bound
    # holds for their order at PyTorch's default count.
    with default_threads():
        got, solve = eig_partition_solve(hg, SpectralConfig(solver=solver), dtype=torch.float32, device="cpu")
    assert solve.solver == solver and solve.refined is not None
    lam, resid, steps = solve.refined
    assert got.eigenvalue == lam and resid <= 1e-6 and steps <= 25
    assert got.eigenvalue == pytest.approx(ref.eigenvalue, rel=1e-6)
    assert solve.eigenvalue == pytest.approx(ref.eigenvalue, rel=1e-4)
    assert _cos(got.values, ref.values) >= 1 - 1e-6
    _sides_agree(got, ref)
    assert sorted(got.balance()) == sorted(ref.balance())


def test_refine_fiedler_host_equals_jax():
    """The host polish from the same noisy seed: the same f64 steps, so the
    same Ritz pair to the last bits."""
    from eig_kl_tpu.graph.expand import clique_expand as jax_expand
    from eig_kl_tpu.spectral.refine import refine_fiedler_host as jax_refine
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.spectral.refine import refine_fiedler_host

    hg, jhg = circuit("lcc")
    v0 = np.random.default_rng(3).standard_normal(hg.num_nodes)
    ref = jax_refine(jax_expand(jhg, "eig", use_native=False), v0, steps=25, tol=1e-12)
    got = refine_fiedler_host(clique_expand(hg, "eig"), v0, steps=25, tol=1e-12)
    assert got.steps == ref.steps == 25
    assert got.eigenvalue == pytest.approx(ref.eigenvalue, rel=1e-12)
    assert got.residual == pytest.approx(ref.residual, rel=1e-6)
    np.testing.assert_allclose(got.vector, ref.vector, rtol=0, atol=1e-10)


# ------------------------------------------------------------- momentum


def _momentum(hg_kind, max_iters):
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.graph.csr import device_graph_from_jax
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.spectral.power import _power_core

    if hg_kind == "gen_0.02":
        hg = read_hgr(GEN_002)
    else:
        hg = circuit(hg_kind)[0]
    from eig_kl_tpu.io.hgr import Hypergraph as JaxHypergraph

    g_jax = clique_expand(
        JaxHypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets), "kl", use_native=False
    ).to_device(dtype="float32")
    g = device_graph_from_jax(
        np.asarray(g_jax.ell_indices), np.asarray(g_jax.ell_weights),
        np.asarray(g_jax.degrees), np.asarray(g_jax.total_weight), "cpu",
    )
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=max_iters, seed=42,
              convergence="momentum")
    lam_j, v_j, it_j = jax_core(g_jax, dtype="float32", **kw)
    lam_t, v_t, it_t = _power_core(g, dtype=torch.float32, **kw)
    return (np.asarray(v_j), int(it_j)), (v_t.numpy(), it_t)


def test_momentum_f32_equals_jax_bitwise_on_gen002():
    """Every step's bits over 301 steps (12 checks with their beta
    updates): gen 0.02x is disconnected, so the exit runs to the cap."""
    (v_j, it_j), (v_t, it_t) = _momentum("gen_0.02", 301)
    assert it_t == it_j == 301
    np.testing.assert_array_equal(_bits(v_t), _bits(v_j))


def test_momentum_f32_on_the_component_within_the_band():
    """The whole run on the component (3,694 nodes) to its exit, bit for
    bit: the Rayleigh quotient's dot adds as XLA's loop with the lazy walk
    fused in (one chain of fused multiply-adds, ``fused_dot`` "chain"), and
    beta is ``mu * mu`` times XLA's folded constant (ROADMAP.md C9)."""
    (v_j, it_j), (v_t, it_t) = _momentum("lcc", 1000)
    assert it_t == it_j == 176
    np.testing.assert_array_equal(_bits(v_t), _bits(v_j))


def test_momentum_first_check_is_bitwise_on_the_component():
    """Before beta first moves, the component's run is the JAX one's bit
    for bit too: the lazy walk, the deflation and the norms match."""
    (v_j, it_j), (v_t, it_t) = _momentum("lcc", 26)
    assert it_t == it_j == 26
    np.testing.assert_array_equal(_bits(v_t), _bits(v_j))
