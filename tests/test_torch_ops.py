"""The port's SpMV (kernel K1's plain version), cut algebra and median
against the JAX package, on the CPU.

``spmv_plain`` adds each row in XLA's CPU order for the JAX package's
f32 ELL SpMV, so at f32 the two agree bit for bit; at f64 they agree to
1e-12 (no exact f64 fused multiply-add in PyTorch).  The v1 Pallas SpMV
(interpret mode) sums in its own order and is held at rtol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401  (autouse: PyTorch on one thread)

from tests.conftest import random_hypergraph

GEN_002 = os.path.join(
    os.path.dirname(__file__), "..", "benchmarks", "data", "gen_0.02_42.hgr"
)


def _hub_hypergraph(rng, num_nodes, hub):
    """Circuit-like nets plus one ``hub``-pin net, which widens the ELL."""
    from eig_kl_tpu.io.hgr import Hypergraph

    sizes = rng.choice([2, 3, 4, 5, 6, 8], size=num_nodes, p=[.84, .02, .06, .02, .04, .02])
    nets = [rng.choice(num_nodes, k, replace=False) for k in sizes]
    nets.append(rng.choice(num_nodes, hub, replace=False))
    offs = np.zeros(len(nets) + 1, np.int64)
    np.cumsum([len(a) for a in nets], out=offs[1:])
    return Hypergraph(num_nodes, len(nets), np.concatenate(nets).astype(np.int32), offs)


def _graphs(kind, dtype):
    """(JAX host Graph, JAX DeviceGraph, port DeviceGraph) of one kind."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.io.hgr import read_hgr
    from eig_kl_tpu_torch.graph.csr import device_graph_from_jax

    rng = np.random.default_rng(7)
    if kind == "random":
        hg = random_hypergraph(rng, num_nodes=200, num_nets=300)
    elif kind == "gen_0.02":
        hg = read_hgr(GEN_002, use_native=False)
    else:  # "hub<k>"
        hg = _hub_hypergraph(rng, 1500, int(kind[3:]))
    g_host = clique_expand(hg, "kl", use_native=False)
    g_jax = g_host.to_device(dtype=dtype)
    g = device_graph_from_jax(
        np.asarray(g_jax.ell_indices), np.asarray(g_jax.ell_weights),
        np.asarray(g_jax.degrees), np.asarray(g_jax.total_weight), "cpu",
    )
    return g_host, g_jax, g


GRAPH_KINDS = ["random", "gen_0.02", "hub44", "hub130"]


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_spmv_plain_f32_equals_jax_bitwise(kind):
    from eig_kl_tpu.ops.partition import spmv as jax_spmv
    from eig_kl_tpu_torch.ops.spmv import spmv_plain

    _, g_jax, g = _graphs(kind, "float32")
    rng = np.random.default_rng(1)
    jit_spmv = jax.jit(jax_spmv)
    for _ in range(3):
        x = rng.standard_normal(g.num_nodes).astype(np.float32)
        ref = np.asarray(jit_spmv(g_jax, jnp.asarray(x)))
        got = spmv_plain(g, torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_spmv_plain_f64_matches_jax(kind):
    from eig_kl_tpu.ops.partition import spmv as jax_spmv
    from eig_kl_tpu_torch.ops.spmv import spmv_plain

    _, g_jax, g = _graphs(kind, "float64")
    x = np.random.default_rng(2).standard_normal(g.num_nodes)
    ref = np.asarray(jax.jit(jax_spmv)(g_jax, jnp.asarray(x, jnp.float64)))
    got = spmv_plain(g, torch.as_tensor(x)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_spmv_plain_matches_pallas_v1_interpret():
    """gen 0.02x has 22,416 nnz, so the JAX package plans it for v1."""
    from eig_kl_tpu.ops.spmv_pallas import SpmvPlan, spmv_pallas
    from eig_kl_tpu_torch.ops.spmv import spmv_plain

    g_host, _, g = _graphs("gen_0.02", "float32")
    assert g_host.nnz <= 32_768
    plan = SpmvPlan.from_graph(g_host)
    x = np.random.default_rng(3).standard_normal(g.num_nodes).astype(np.float32)
    ref = np.asarray(spmv_pallas(plan, jnp.asarray(x), interpret=True))
    got = spmv_plain(g, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_spmv_dispatch_on_cpu_runs_the_plain_version():
    from eig_kl_tpu_torch.ops.spmv import K1, spmv, spmv_plain

    _, _, g = _graphs("random", "float32")
    x = torch.linspace(-1, 1, g.num_nodes)
    before = K1.launches
    assert torch.equal(spmv(g, x), spmv_plain(g, x))
    assert K1.launches == before


def test_spmv_kernel_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on the card or raises; it never
    computes on the CPU itself."""
    from eig_kl_tpu_torch.ops.spmv import spmv_csr

    _, _, g = _graphs("random", "float32")
    with pytest.raises(ValueError, match="CUDA"):
        spmv_csr(g, torch.zeros(g.num_nodes))


def test_fma_f32_is_correctly_rounded():
    """The fused multiply-add emulation equals an exact rational result
    rounded once (checked with Python's exact fractions)."""
    from fractions import Fraction

    from eig_kl_tpu_torch.ops.spmv import fma_f32

    rng = np.random.default_rng(4)
    a, b, c = (rng.standard_normal(400).astype(np.float32) * s for s in (1.0, 1e-3, 1e2))
    got = fma_f32(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact), int(np.float32(v).view(np.uint32)) & 1))
        assert got[i] == best


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cut_algebra_matches_jax(dtype):
    from eig_kl_tpu.ops import partition as JP
    from eig_kl_tpu_torch.ops import partition as TP

    _, g_jax, g = _graphs("random", dtype)
    sides = (np.random.default_rng(5).random(g.num_nodes) < 0.5).astype(np.int8)
    rel = 1e-12 if dtype == "float64" else 1e-5
    tol = dict(rtol=rel, atol=rel)
    s_j = JP.sides_to_signs(jnp.asarray(sides), jnp.dtype(dtype))
    s_t = TP.sides_to_signs(torch.as_tensor(sides), getattr(torch, dtype))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(TP.signs_to_sides(s_t).numpy(), sides)
    np.testing.assert_allclose(TP.gains(g, s_t).numpy(), np.asarray(JP.gains(g_jax, s_j)), **tol)
    np.testing.assert_allclose(
        TP.external_costs(g, s_t).numpy(), np.asarray(JP.external_costs(g_jax, s_j)), **tol
    )
    assert float(TP.cut_size(g, s_t)) == pytest.approx(float(JP.cut_size(g_jax, s_j)), rel=rel)
    d = TP.gains(g, s_t)
    for u, v in [(0, 1), (3, 17), (10, 11), (5, 5)]:
        assert float(TP.edge_weight(g, u, v)) == float(JP.edge_weight(g_jax, u, v))
        assert float(TP.swap_gain(g, d, u, v)) == pytest.approx(
            float(JP.swap_gain(g_jax, jnp.asarray(d.numpy()), u, v)), rel=rel, abs=rel
        )


def test_cut_size_equals_brute_force():
    from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs

    g_host, _, g = _graphs("random", "float64")
    sides = (np.random.default_rng(6).random(g.num_nodes) < 0.5).astype(np.int8)
    rows = np.repeat(np.arange(g_host.num_nodes), np.diff(g_host.indptr))
    crossing = sides[rows] != sides[g_host.indices]
    brute = g_host.data[crossing].sum() / 2
    got = float(cut_size(g, sides_to_signs(torch.as_tensor(sides), torch.float64)))
    assert got == pytest.approx(brute, rel=1e-12)


def _median_cases():
    rng = np.random.default_rng(8)
    return [
        np.array([0.0, 1.5, 1.5, -2.0, 0.0, 1.5, -2.0, 3.0]),  # ties, even n
        np.array([0.0, -0.0, 0.0, -0.0, 1.0]),  # signed zeros, odd n
        np.array([-0.0, 0.0, -0.0, 0.0, -1.0, 2.0]),
        rng.standard_normal(1001),  # odd n
        np.round(rng.standard_normal(1000), 1),  # many ties
        np.concatenate([np.zeros(300), -np.zeros(300), rng.standard_normal(401)]),
        np.array([7.0]),
    ]


@pytest.mark.parametrize("case", range(len(_median_cases())))
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_upper_median_matches_jax(case, dtype):
    """Bitwise, except that -0.0 and +0.0 stand in for each other: they
    compare equal in ``median > v``, the median's only use."""
    from eig_kl_tpu.ops.select import upper_median as jax_median
    from eig_kl_tpu_torch.ops.select import upper_median

    v = _median_cases()[case].astype(dtype)
    ref = np.asarray(jax_median(jnp.asarray(v)))
    got = upper_median(torch.as_tensor(v)).numpy()
    assert got.dtype == ref.dtype
    if ref == 0:
        assert got == 0
    else:
        assert got.tobytes() == ref.tobytes()
    np.testing.assert_array_equal(got > v, ref > v)
