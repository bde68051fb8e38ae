"""The port's f64 paths on the CPU against the JAX package's at x64.

* ``fma_dot`` in f64 returns f64 and equals ``jax.jit(jnp.vdot)`` bit for
  bit: XLA's CPU vector dot rounds its first 8 products before adding
  them, then fuses every later product into its add, in index order.
* The f64 momentum exit on gen 0.02x meets the f64 exits' tolerance
  against the JAX package (``tests/test_torch_spectral.py``): the same
  iterations, lambda within 1e-10, the vector within rtol 1e-9 and atol
  1e-12, and the same split of the nodes clear of the median.
* The CLI's precision rule, K2's cache size by dtype, the f64 multi-start
  and multi-pass against the JAX package's f64 engine, the f32-only
  refusals of the sharded pass and the v3 route, and the shared selection
  header's place in the kernels' build hashes.
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401  (autouse: PyTorch on one thread)

from tests.test_torch_kl import _port_graph, dyadic_hypergraph
from tests.test_torch_kl_batch import assert_results_equal

GEN_002 = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "data", "gen_0.02_42.hgr")


def _bits(t) -> np.ndarray:
    return np.asarray(t).view(np.int64)


# 4,038 is gen 0.02x's node count; 1,933 and 2,710 are random sizes at
# which a pure fused chain misses XLA's dot by an ulp.
@pytest.mark.parametrize("n", [4038, 1933, 2710])
def test_fma_dot_f64_equals_jnp_vdot(n):
    from eig_kl_tpu_torch.ops.reduce import fma_dot

    rng = np.random.default_rng(n)
    for _ in range(3):
        x = rng.standard_normal(n) * rng.uniform(0.1, 10.0, n)
        y = rng.standard_normal(n)
        got = fma_dot(torch.as_tensor(x), torch.as_tensor(y))
        assert got.dtype == torch.float64
        assert _bits(got) == _bits(jax.jit(jnp.vdot)(x, y))


def test_fma_dot_f64_on_short_and_non_finite_vectors():
    """At most 8 values: every product rounded before its add.  A NaN or an
    infinity propagates as in the unfused chain."""
    from eig_kl_tpu_torch.ops.reduce import fma_dot

    rng = np.random.default_rng(3)
    for n in (1, 5, 8):
        x, y = rng.standard_normal(n), rng.standard_normal(n)
        acc = 0.0
        for a, b in zip(x.tolist(), y.tolist()):
            acc = acc + a * b
        assert float(fma_dot(torch.as_tensor(x), torch.as_tensor(y))) == acc
    x = np.ones(20)
    x[12] = np.inf
    assert float(fma_dot(torch.as_tensor(x), torch.as_tensor(np.ones(20)))) == np.inf
    with pytest.raises(TypeError, match="f64"):
        fma_dot(torch.ones(3), torch.ones(3, dtype=torch.float64))


def test_momentum_f64_matches_jax():
    """The momentum exit at f64 on gen 0.02x (KL weights), 301 steps."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.io.hgr import read_hgr
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.graph.csr import device_graph_from_jax
    from eig_kl_tpu_torch.spectral.power import _power_core

    g_jax = clique_expand(read_hgr(GEN_002, use_native=False), "kl", use_native=False).to_device(
        dtype="float64"
    )
    g = device_graph_from_jax(
        np.asarray(g_jax.ell_indices), np.asarray(g_jax.ell_weights),
        np.asarray(g_jax.degrees), np.asarray(g_jax.total_weight), "cpu",
    )
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=301, seed=42, convergence="momentum")
    lam_j, v_j, it_j = jax_core(g_jax, dtype="float64", **kw)
    lam_t, v_t, it_t = _power_core(g, dtype=torch.float64, **kw)
    v_j, v_t = np.asarray(v_j), v_t.numpy()
    assert v_t.dtype == np.float64 and lam_t.dtype == torch.float64
    assert it_t == int(it_j)
    assert float(lam_t) == pytest.approx(float(lam_j), abs=1e-10)
    np.testing.assert_allclose(v_t, v_j, rtol=1e-9, atol=1e-12)
    # By step 301, 3,694 of the 4,038 values lie within 1e-13 of the median
    # and their side is decided by the last bit (as at the gkl2 exit,
    # tests/test_torch_spectral.py): the split is compared on the nodes that
    # stand clear of it.
    med_t, med_j = np.sort(v_t)[len(v_t) // 2], np.sort(v_j)[len(v_j) // 2]
    clear = np.abs(v_j - med_j) > 1e-12 * np.abs(v_j).max()
    assert clear.sum() >= 300
    np.testing.assert_array_equal((med_t > v_t)[clear], (med_j > v_j)[clear])


def test_device_graph_from_jax_keeps_f64_weights():
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu_torch.graph.csr import device_graph_from_jax

    rng = np.random.default_rng(5)
    g_host = clique_expand(dyadic_hypergraph(rng, 60, 90), "kl", use_native=False)
    g_host = dataclasses.replace(g_host, data=g_host.data * (1.0 + 2.0**-40))  # not an f32 value
    g_jax = g_host.to_device(dtype="float64")
    g = device_graph_from_jax(
        np.asarray(g_jax.ell_indices), np.asarray(g_jax.ell_weights),
        np.asarray(g_jax.degrees), np.asarray(g_jax.total_weight), "cpu",
    )
    assert g.dtype == torch.float64 and g.degrees.dtype == torch.float64
    np.testing.assert_array_equal(g.data.numpy(), g_host.data)
    np.testing.assert_array_equal(g.indptr.numpy(), g_host.indptr)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("flags, dtype", [([], torch.float64), (["--f64"], torch.float64),
                                           (["--f32"], torch.float32)])
def test_eig_precision_rule(device, flags, dtype):
    """f64 unless --f32, on the card as on the CPU: the JAX package's rule
    off the TPU (eig_kl_tpu/cli/main.py:204-212)."""
    from eig_kl_tpu_torch.cli.main import build_parser, eig_dtype

    args = build_parser().parse_args(["eig", "c.hgr", "--device", device, *flags])
    assert eig_dtype(args) == dtype


def test_f64_on_the_card_is_ported_and_sharded_is_not(tmp_path, monkeypatch, capsys):
    """f64 parses for the card; ``kl --sharded``, refused with ROADMAP.md
    A8b's name until the engines across ranks were ported, now runs in f64
    too (one rank, on the CPU), its cut recounted within the f64 drift."""
    from eig_kl_tpu_torch.cli.main import build_parser, main

    for cmd in (["kl", "c.hgr", "--f64"], ["fused", "c.hgr", "-EIG", "--f64"]):
        args = build_parser().parse_args([*cmd, "--device", "cuda"])
        assert args.f64 and args.device == "cuda"
    monkeypatch.chdir(tmp_path)
    assert main(["kl", GEN_002, "--f64", "--sharded", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    final = float(out.split("Final cut size")[1].split(":")[1].split()[0])
    verified = float(out.split("Verified cut size")[1].split(":")[1].split()[0])
    assert final == verified and "Warning" not in out


@pytest.mark.parametrize(
    "num_nodes, dtype, selection, words",
    [
        (201_920, torch.float32, "shared", 2 * 1578 + 50 + 98),  # gen 1.0x
        (201_920, torch.float64, "shared", 4 * 1578 + 50 + 98),
        (10_240, torch.float64, "shared", 4 * 80 + 3 + 80 + 1),  # rounded up to even
        (2_000_000, torch.float32, "shared", 2 * 15_625 + 489 + 98),
        (2_000_000, torch.float64, "global", 4 * 15_625 + 489 + 98 + 1),
        (4_038, torch.float64, "flat", None),
    ],
)
def test_k2_cache_by_dtype(num_nodes, dtype, selection, words):
    """K2's cache holds 8-byte maxima in f64, so it leaves shared memory at
    about half f32's node count."""
    from eig_kl_tpu_torch.kl.megakernel import K2_SHARED_CACHE_BYTES, ROW, k2_cache_words, k2_selection

    assert k2_selection(num_nodes, 48, dtype) == selection
    if words is not None:
        got, cap = k2_cache_words(-(-num_nodes // ROW) * ROW, 48, dtype)
        assert (got, cap) == (words, min(-(-num_nodes // ROW), 98))
        assert (4 * got <= K2_SHARED_CACHE_BYTES) == (selection == "shared")


@pytest.fixture(scope="module")
def dyadic64():
    from eig_kl_tpu.graph.expand import clique_expand

    rng = np.random.default_rng(23)
    g_host = clique_expand(dyadic_hypergraph(rng, 200, 330), "kl", use_native=False)
    sides = (rng.random(200) < 0.5).astype(np.int8)
    return g_host, _port_graph(g_host, torch.float64), sides


@pytest.mark.parametrize("passes", [1, 0])
def test_f64_multi_start_equals_jax_multi_start_refine(dyadic64, passes):
    """Three starts (the split and two jitters) at f64, one pass or passes
    until converged: the port's one engine against the JAX package's f64
    XLA engine vmapped over the starts (eig_kl_tpu/parallel/multi_start.py:44)."""
    from eig_kl_tpu.parallel.multi_start import multi_start_refine as jax_multi
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl.init import perturb_split
    from eig_kl_tpu_torch.parallel import multi_start_refine_mega
    from eig_kl_tpu_torch.utils.config import KLConfig

    g_host, g, sides = dyadic64
    cfg = dict(gain_eps=1e-6, passes=passes)
    init = np.stack([sides] + [perturb_split(sides, 1 + i, 0.1) for i in range(2)])
    ref, ref_cuts = jax_multi(g_host.to_device(dtype="float64"), 3, config=JaxKLConfig(**cfg), init_sides=init)
    got, cuts = multi_start_refine_mega(g, 3, config=KLConfig(**cfg), init_sides=init)
    np.testing.assert_array_equal(cuts, ref_cuts)
    assert_results_equal(got, ref)


def test_f64_multipass_and_kicks_equal_jax(dyadic64):
    """One start at f64, passes until converged, then two kicks: against
    the JAX package's multi-pass and iterated local search around its f64
    XLA engine (eig_kl_tpu/kl/engine.py:206)."""
    from eig_kl_tpu.kl import multipass as jax_mp
    from eig_kl_tpu.kl.engine import refine as jax_refine
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl import multipass as mp
    from eig_kl_tpu_torch.kl.megakernel import refine_mega
    from eig_kl_tpu_torch.utils.config import KLConfig

    g_host, g, sides = dyadic64
    g_jax = g_host.to_device(dtype="float64")
    cfg = dict(gain_eps=1e-6, passes=0)
    jax_fn = lambda s: jax_refine(g_jax, s, JaxKLConfig(**cfg))  # noqa: E731
    fn = lambda s: refine_mega(g, s, KLConfig(**cfg))  # noqa: E731
    got = mp.refine_multipass(fn, sides, KLConfig(**cfg))
    assert_results_equal(got, jax_mp.refine_multipass(jax_fn, sides, JaxKLConfig(**cfg)))
    assert got.best_cut < refine_mega(g, sides, KLConfig(gain_eps=1e-6)).best_cut  # > 1 pass helped
    kw = dict(kicks=2, kick_frac=0.15, seed=4)
    assert_results_equal(
        mp.refine_ils(fn, sides, KLConfig(**cfg), **kw),
        jax_mp.refine_ils(jax_fn, sides, JaxKLConfig(**cfg), **kw),
    )


def test_sharded_pass_and_v3_route_refuse_f64_with_the_jax_reason(dyadic64):
    from eig_kl_tpu_torch.ops.spmv_v3 import build_plan_v3_for_graph, spmv_v3, spmv_v3_padded
    from eig_kl_tpu_torch.parallel.smega import smega_pass

    g_host, g, sides = dyadic64
    s = torch.as_tensor(1.0 - 2.0 * sides.astype(np.float64))
    sf0 = torch.zeros(256, dtype=torch.float64)
    sf0[:200] = s
    with pytest.raises(TypeError, match=r"smega kernel is \(eig_kl_tpu/parallel/smega.py:107\)"):
        smega_pass(g, 2, sf0, sf0, 0.0, 10, 100, 100, 11, 16, 1e-6)
    from eig_kl_tpu_torch.graph.csr import Graph

    plan = build_plan_v3_for_graph(Graph.from_arrays(g_host.indptr, g_host.indices, g_host.data), "cpu")
    for fn, x in ((spmv_v3, s), (spmv_v3_padded, torch.zeros(plan.padded_nodes, dtype=torch.float64))):
        with pytest.raises(TypeError, match="builds a v3 plan only on the TPU"):
            fn(plan, x)


def test_kl_common_header_is_in_both_kernels_build_hash(tmp_path, monkeypatch):
    """K2 and K5 include one copy of the selection helpers: a change to
    csrc/kl_common.cuh changes both libraries' names (so neither is
    loaded from a stale build), and no other kernel's."""
    from eig_kl_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_compiler_identity", lambda compiler: compiler)
    names = ("kl_pass", "smega", "spmv_csr", "fma_dot")
    before = {name: _build.library_path(name) for name in names}
    header = csrc / "kl_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// changed\n")
    after = {name: _build.library_path(name) for name in names}
    assert after["kl_pass"] != before["kl_pass"] and after["smega"] != before["smega"]
    assert after["spmv_csr"] == before["spmv_csr"] and after["fma_dot"] == before["fma_dot"]
    assert {h.name for h in _build.included_headers(csrc / "smega.cu")} == {"kl_common.cuh", "fp.cuh"}
