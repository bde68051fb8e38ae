"""The lazy walks that gather ``z = dsinv * w`` (``ops/spmv.py:lazy_walk``,
``ops/spmv_plan.py:plan_lazy_walk``), the momentum step's rescale that
writes z with its two carries (``lazy_rescale``) and the standalone z pass
(``lazy_z``), on the CPU through their plain versions, which take the
arguments the card's kernels take:

* every walk given z equals the walk given only w, bit for bit: K1's ELL
  walk (f32, f64, and its scaled epilogue), the v2 order's walk with f32
  products, bf16 products and bf16 weights, the v1 plan's walk; on graphs
  of ELL width 8, 16, 24-32 and above 32;
* ``lazy_rescale`` is ``(w * inv, u * inv, dsinv * (u * inv))`` on the flat
  vector and on the padded ``(P/128, 128)`` state, +0 in z's padding;
* the momentum exit through the loop that rescales with z equals the JAX
  package's momentum run bit for bit, with one rescale per step and one z
  pass per check (and one at the start).

Each case runs on a few hundred nodes on one thread, in a second or two.
"""

import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401  (autouse: PyTorch on one thread)

from conftest import random_hypergraph
from test_torch_plan_order import _one_thread

#: (nodes, nets, largest net) of a random circuit per ELL width bucket.
WIDTHS = {8: (300, 150, 2), 16: (300, 200, 3), 24: (300, 300, 4), 32: (300, 350, 5), 56: (300, 420, 6)}


def _hypergraph(width):
    from eig_kl_tpu_torch.io.hgr import Hypergraph

    hg = random_hypergraph(np.random.default_rng(7), *WIDTHS[width])
    return Hypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets)


def _graph(width, dtype=torch.float32):
    from eig_kl_tpu_torch.graph.expand import clique_expand

    g = clique_expand(_hypergraph(width), "kl", use_native=False).to_device("cpu", dtype)
    assert g.row_width == width
    return g


def _vectors(g, seed=0):
    """w (with -0 entries) and dsinv = 1 / sqrt(safe degrees), in g's dtype."""
    rng = np.random.default_rng(seed)
    w = torch.as_tensor(rng.random(g.num_nodes) - 0.5).to(g.dtype)
    w[::17] = -0.0
    d = torch.sqrt(torch.where(g.degrees > 0, g.degrees, 1.0).double()).reciprocal().to(g.dtype)
    return w, d


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _padded(layout, v):
    out = torch.zeros(layout.padded_nodes, dtype=v.dtype)
    out[: layout.num_nodes] = v
    return out.view(-1, 128)


FORMS = ("ell f32", "ell f64", "ell scaled f32", "ell scaled f64", "v2 f32", "v2 bf16i", "v2 bf16w", "v1")


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("form", FORMS)
def test_walk_given_z_equals_walk_given_w(form, width):
    """The walk that gathers a given ``z = dsinv * w`` is the walk of ``w``
    alone, bit for bit, in every form; a z of another shape or dtype is
    refused."""
    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.ops.spmv import lazy_walk, lazy_z
    from eig_kl_tpu_torch.ops.spmv_plan import plan_lazy_walk

    dtype = torch.float64 if form.endswith("f64") else torch.float32
    with _one_thread():
        g = _graph(width, dtype)
        w, d = _vectors(g)
        if form.startswith("ell"):
            scaled = None
            if "scaled" in form:
                u = w * 3.0
                c = torch.tensor(1.0 / 3.0, dtype=dtype)
                w = u * c
                scaled = (u, c)
            z = lazy_z(w, d)
            assert torch.equal(_bits(z), _bits(d * w))

            def walk(**kw):
                return lazy_walk(g, w, d, scaled, **kw)
            bad = torch.zeros(g.num_nodes + 1, dtype=dtype)
        else:
            kernel = "v1" if form == "v1" else "v2"
            geometry = {} if kernel == "v1" else dict(rblock=512, bf16_weights=True)
            layout = CsrPlan.for_graph(g, kernel=kernel, **geometry).layout
            w, d = _padded(layout, w), _padded(layout, d)
            z = lazy_z(w, d)
            assert torch.equal(_bits(z), _bits(d * w))
            bf16 = form in ("v2 bf16i", "v2 bf16w")
            form_kw = dict(bf16_weights=form == "v2 bf16w")

            def walk(**kw):
                return plan_lazy_walk(layout, w, d, bf16, **form_kw, **kw)
            bad = z.reshape(-1)
        got, want = walk(z=z), walk()
        assert torch.equal(_bits(got), _bits(want))
        assert bool(torch.isfinite(got).all())
        for wrong in (bad, z.to(torch.float64 if dtype == torch.float32 else torch.float32)):
            with pytest.raises(ValueError, match="z"):
                walk(z=wrong)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lazy_rescale_plain(padded, dtype):
    """``lazy_rescale`` returns ``(w * inv, u * inv, dsinv * (u * inv))``,
    each product rounded once; on the padded state dsinv is +0 in the
    padding, and so is z; the z pass is ``dsinv * w``."""
    from eig_kl_tpu_torch.ops.spmv import lazy_rescale, lazy_rescale_plain, lazy_z

    rng = np.random.default_rng(11)
    n, P = 700, 768
    u, w = (torch.as_tensor(rng.random(n) - 0.5).to(dtype) for _ in range(2))
    d = torch.as_tensor(rng.random(n) + 0.1).to(dtype)
    u[::13] = -0.0
    if padded:
        u, w, d = (torch.cat([v, torch.zeros(P - n, dtype=dtype)]).view(-1, 128) for v in (u, w, d))
        u.view(-1)[n::7] = -2.5  # the padding's values do not reach z
    inv = torch.tensor(1.0 / 3.7, dtype=dtype)
    wp_new, w_new, z = lazy_rescale(u, w, inv, d)
    for got, want in ((wp_new, w * inv), (w_new, u * inv), (z, d * (u * inv))):
        assert got.shape == u.shape and got.dtype == dtype
        assert torch.equal(_bits(got), _bits(want))
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(lazy_rescale_plain(u, w, inv, d), (wp_new, w_new, z)))
    assert torch.equal(_bits(lazy_z(w_new, d)), _bits(z))
    if padded:
        assert bool((z.view(-1)[n:] == 0).all())


def test_z_and_rescale_dispatch_on_the_cpu():
    """On the CPU the dispatchers run the plain versions and launch
    nothing; the card's wrappers refuse a CPU tensor."""
    import importlib

    S = importlib.import_module("eig_kl_tpu_torch.ops.spmv")
    v = torch.linspace(-1.0, 1.0, 64)
    inv = torch.tensor(0.5)
    before = (S.K1_RESCALE.launches, S.K1_Z.launches, S.K1_LAZY.launches)
    assert torch.equal(S.lazy_z(v, v.abs()), S.lazy_z_plain(v, v.abs()))
    S.lazy_rescale(v, v, inv, v.abs())
    for call in (lambda: S.lazy_z_cuda(v, v.abs()), lambda: S.lazy_rescale_cuda(v, v, inv, v.abs())):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert (S.K1_RESCALE.launches, S.K1_Z.launches, S.K1_LAZY.launches) == before


@pytest.mark.parametrize("width", [24, 56])
def test_momentum_through_the_rescale_equals_jax(width, monkeypatch):
    """The momentum exit on a small circuit's KL graph, three checks: the
    port's loop (a walk that gathers the z its step's rescale wrote, the z
    pass at each check) gives the JAX package's iterate bit for bit, with
    one rescale per step and one z pass per check and at the start."""
    from eig_kl_tpu.graph.expand import clique_expand as jax_expand
    from eig_kl_tpu.io.hgr import Hypergraph as JaxHypergraph
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.graph.csr import device_graph_from_jax
    from eig_kl_tpu_torch.spectral import power as port_power

    hg = _hypergraph(width)
    g_jax = jax_expand(JaxHypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets), "kl",
                       use_native=False).to_device(dtype="float32")
    g = device_graph_from_jax(np.asarray(g_jax.ell_indices), np.asarray(g_jax.ell_weights),
                              np.asarray(g_jax.degrees), np.asarray(g_jax.total_weight), "cpu")
    assert g.row_width == width
    calls = {"lazy_rescale": 0, "lazy_z": 0}
    for name in calls:
        def counted(*a, _fn=getattr(port_power, name), _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(port_power, name, counted)
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=10, max_iters=76, seed=42, convergence="momentum")
    with _one_thread():
        _, v_t, it_t = port_power._power_core(g, dtype=torch.float32, **kw)
    _, v_j, it_j = jax_core(g_jax, dtype="float32", **kw)
    assert it_t == int(it_j)
    checks = (it_t - 1) // 25
    assert calls == {"lazy_rescale": it_t - 1, "lazy_z": checks + 1}
    np.testing.assert_array_equal(_bits(v_t).numpy(), np.asarray(v_j, np.float32).view(np.int32))
