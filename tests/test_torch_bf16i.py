"""The CSR plan path and its bf16-intermediate SpMV (the JAX package's
default on its accelerator: the v2 kernels with ``inter_dtype="bfloat16"``,
ROADMAP.md A10) on the CPU, against the JAX package: the rounded products
bit for bit against ``ml_dtypes``, the padded matvec bit for bit against
the v2 and v1 kernels in interpret mode, the plan rule, and the
bf16-intermediate power solve against the JAX run recorded by
``tools/lcc_reference.py --inter bf16``.
"""

import contextlib
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conftest import random_hypergraph

REPO = pathlib.Path(__file__).resolve().parent.parent
GEN_002 = str(REPO / "benchmarks" / "data" / "gen_0.02_42.hgr")
FIXTURE = REPO / "tools" / "gen002_lcc_bf16i.npz"


@contextlib.contextmanager
def _one_thread():
    """PyTorch's CPU indexing runs far slower on many threads of a busy
    host; the plain versions' results do not depend on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _host(kind):
    """A port host graph: gen 0.02x (22,416 entries, the JAX rule's v1), or
    a random circuit of 40,000-odd entries (v2) with rows wider than 32."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import Hypergraph, read_hgr

    if kind == "gen_0.02":
        return clique_expand(read_hgr(GEN_002, use_native=False), "kl", use_native=False)
    hg = random_hypergraph(np.random.default_rng(21), num_nodes=2000, num_nets=2600, max_net=7)
    return clique_expand(Hypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets), "kl", use_native=False)


def _jax_plan(g, kind):
    """The JAX package's plan of a port host graph: ``build_plan_v2`` or
    ``build_plan`` (v1)."""
    from eig_kl_tpu.ops import spmv_pallas as SP

    rows = np.repeat(np.arange(g.num_nodes, dtype=np.int64), np.diff(g.indptr))
    build = SP.build_plan_v2 if kind == "v2" else SP.build_plan
    return build(g.num_nodes, rows, g.indices.astype(np.int64), g.data.astype(np.float32))


def _tail_rows(plan) -> np.ndarray:
    """The rows of a v2 plan's overflow tail entries, one per entry."""
    from eig_kl_tpu.ops.spmv_pallas import CooTail

    if plan.tail is None:
        return np.zeros(0, np.int64)
    if isinstance(plan.tail, CooTail):
        return np.asarray(plan.tail.rows, np.int64)
    t = plan.tail
    rows = np.asarray(t.rw8, np.int64)[:, None, None] * 128 + np.asarray(t.row_local, np.int64)
    return rows[np.asarray(t.weights) != 0]


def _state(n, P, seed):
    x = np.zeros(P, np.float32)
    x[:n] = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return x.reshape(P // 128, 128)


def test_products_round_to_bf16_as_ml_dtypes_does():
    """Every product the plain version rounds: f32 ``x[col] * w`` (gen
    0.02x, a seeded x) and edge values (+-0, subnormals, the largest
    finite values, infinities) to bf16, round to nearest even, bit for bit
    ``ml_dtypes.bfloat16``'s.  Through the whole plain version too: on a
    matching (every row of degree 1) each row's sum is its one rounded
    product."""
    from eig_kl_tpu_torch.graph.csr import CsrPlan, Graph
    from eig_kl_tpu_torch.ops.spmv_plan import bf16_round, spmv_v2_plain

    g = _host("gen_0.02")
    x = np.random.default_rng(2).standard_normal(g.num_nodes).astype(np.float32)
    prods = np.float32(x[g.indices] * g.data.astype(np.float32))
    edge = np.array([0.0, -0.0, 1e-45, -1e-45, 1.1754942e-38, 9.2e-41, 3.4028235e38, -3.4028235e38,
                     np.inf, -np.inf, 1.00390625, 1.01171875, 3.3961776e38], np.float32)
    for p in (prods, edge):
        want = p.astype(ml_dtypes.bfloat16).astype(np.float32)
        assert (_bits(bf16_round(torch.as_tensor(p))) == _bits(want)).all()
    rng = np.random.default_rng(3)
    n = 1000
    perm = rng.permutation(n)
    u, v = perm[: n // 2], perm[n // 2 :]
    w = rng.uniform(0.01, 1.0, n // 2).astype(np.float32).astype(np.float64)
    key = np.minimum(u, v), np.maximum(u, v)
    gm = Graph.from_upper_coo(n, key[0], key[1], w).to_device("cpu")
    layout = CsrPlan.for_graph(gm, kernel="v2").layout
    assert layout.tail is None
    x2d = _state(n, 1024, 4)
    got = spmv_v2_plain(layout, torch.as_tensor(x2d), bf16=True).numpy().reshape(-1)
    rows = np.repeat(np.arange(n), np.diff(gm.indptr.numpy()))
    want = np.zeros(1024, np.float32)
    want[rows] = (x2d.reshape(-1)[gm.indices.numpy()] * gm.data.numpy()).astype(ml_dtypes.bfloat16).astype(np.float32)
    assert (_bits(got) == _bits(want)).all()


@pytest.mark.parametrize("kind, plan_kind", [("random", "v2"), ("gen_0.02", "v1")])
def test_row_sums_against_the_jax_kernels_in_interpret_mode(kind, plan_kind):
    """The port's padded matvec for the plan the JAX rule picks (v2 above
    32,768 entries: bf16 products; v1 at or below: ``inter_dtype`` ignored,
    f32) against ``spmv_pallas_2d(plan, x2d, interpret=True,
    inter_dtype=jnp.bfloat16)`` of the JAX package's plan, bit for bit: the
    port adds each row in that kernel's order (``ops/spmv_plan.py``), its
    overflow tail in f32 as the JAX package does.  Padding rows are +0 in
    both; on the v2 plan the rounding is there (the f32 sums differ, on rows
    whose entries the plan's buckets keep: this plan keeps 4,096 of 48,628
    entries and spills the rest)."""
    from eig_kl_tpu.ops import spmv_pallas as SP
    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.ops.spmv_plan import plan_spmv

    g = _host(kind)
    gd = g.to_device("cpu", with_plan=True)
    plan = gd.plan
    assert plan.kernel == plan_kind and plan.runs_bf16("bfloat16") == (plan_kind == "v2")
    assert CsrPlan.kernel_for(g.nnz) == plan_kind
    jplan = _jax_plan(g, plan_kind)
    assert jplan.padded_nodes == plan.padded_nodes
    x2d = _state(g.num_nodes, plan.padded_nodes, 5)
    spmv = jax.jit(lambda x, inter: SP.spmv_pallas_2d(jplan, x, interpret=True, inter_dtype=inter),
                   static_argnums=1)
    ref = np.asarray(spmv(jnp.asarray(x2d), jnp.bfloat16)).reshape(-1)
    if plan_kind == "v1":
        assert (_bits(ref) == _bits(np.asarray(spmv(jnp.asarray(x2d), jnp.float32)).reshape(-1))).all()
    else:
        assert _tail_rows(jplan).size > 0  # this plan spills: its tail is added in f32
    with _one_thread():
        got = plan_spmv(plan.layout, torch.as_tensor(x2d), plan.runs_bf16("bfloat16")).numpy().reshape(-1)
        f32 = plan_spmv(plan.layout, torch.as_tensor(x2d)).numpy().reshape(-1)
    n = g.num_nodes
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert (_bits(got[n:]) == 0).all()
    if plan_kind == "v2":  # rounded products on the rows the buckets keep entries of, f32 tail entries
        kept, parted = np.diff(plan.layout.ptr.numpy()) > 0, f32[:n] != got[:n]
        assert (parted <= kept).all() and parted.sum() > kept.sum() // 2


def test_lazy_walk_padded_is_the_matvec_of_the_scaled_state():
    """The padded lazy walk's plain version: ``0.5 * fma(dsinv, A_bf16
    (dsinv * w), w)`` on every row of the state, the product ``dsinv * w``
    rounded once before the matvec, padding rows +0."""
    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.ops.spmv import fma_f32
    from eig_kl_tpu_torch.ops.spmv_plan import plan_lazy_walk, plan_spmv

    g = _host("gen_0.02")
    gd = g.to_device("cpu")
    layout = CsrPlan.for_graph(gd, kernel="v2").layout
    w2d = torch.as_tensor(_state(g.num_nodes, 4096, 6))
    dsinv = torch.zeros(4096)
    dsinv[: g.num_nodes] = 1.0 / torch.sqrt(torch.where(gd.degrees > 0, gd.degrees, 1.0))
    dsinv2d = dsinv.view(32, 128)
    with _one_thread():
        got = plan_lazy_walk(layout, w2d, dsinv2d, True)
        ax = plan_spmv(layout, dsinv2d * w2d, True)
    assert torch.equal(got, 0.5 * fma_f32(dsinv2d, ax, w2d))
    assert (_bits(got.view(-1)[g.num_nodes :]) == 0).all()


def test_power_operator_reads_inter_dtype_only_with_a_csr_plan():
    """``inter_dtype`` changes the f32 step only on a graph with a v2
    :class:`CsrPlan`; without a plan, with a v1 plan, and in f64 (which
    ignores the plan) it is not read, and a bad value is refused only
    where it is read."""
    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.spectral.power import power_operator

    g = _host("gen_0.02")
    base = g.to_device("cpu")
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(g.num_nodes).astype(np.float32))

    def steps(gd, dtype=torch.float32):
        out = []
        for inter in ("float32", "bfloat16"):
            op = power_operator(gd, 2.0, dtype, inter)
            out.append(op.step(op.to_state(x.to(dtype)))[0])
        return out, op

    with _one_thread():
        (a, b), op = steps(base)
        assert not op.padded and torch.equal(a, b)
        v1, v2 = (CsrPlan.for_graph(base, kernel=k) for k in ("v1", "v2"))
        (a, b), op = steps(dataclasses.replace(base, plan=v1))
        assert op.padded and a.shape == (32, 128) and torch.equal(a, b)
        (a, b), op = steps(dataclasses.replace(base, plan=v2))
        assert op.padded and not torch.equal(a, b)
        g64 = g.to_device("cpu", torch.float64)
        (a, b), op = steps(dataclasses.replace(g64, plan=CsrPlan.for_graph(g64, kernel="v2")), torch.float64)
        assert not op.padded and torch.equal(a, b)
    with pytest.raises(ValueError, match="inter_dtype"):
        power_operator(dataclasses.replace(base, plan=v2), 2.0, torch.float32, "float16")
    power_operator(base, 2.0, torch.float32, "float16")


def test_the_plan_rule_and_the_pipelines_attach_no_plan_by_default():
    """``to_device(with_plan=True)`` attaches the plan the JAX package's
    rule picks (P = n rounded up to 1,024; v1 at or below 32,768 entries);
    the pipelines attach none on any device; a CSR plan's matvecs outside
    the power solve take the plan's order in f32 (as the JAX package's
    ``spmv`` takes ``spmv_pallas``), and its padded f32 matvec the same
    sums, +0 past n; the bf16 rule reads the plan's ``g1``."""
    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.models.pipelines import attaches_plan
    from eig_kl_tpu_torch.ops.spmv import spmv, spmv_plain
    from eig_kl_tpu_torch.ops.spmv_plan import V1Layout, V2Layout, build_v1_layout, spmv_v1_plain

    g = _host("gen_0.02")
    gd = g.to_device("cpu", with_plan=True)
    assert isinstance(gd.plan.layout, V1Layout) and gd.plan.kernel == "v1" and gd.plan.padded_nodes == 4096
    assert g.to_device("cpu").plan is None and gd.plan_layout is gd.plan.layout
    assert CsrPlan.kernel_for(1_107_844) == "v2" and CsrPlan.kernel_for(32_769) == "v2"
    assert CsrPlan.kernel_for(32_768) == "v1"
    assert build_v1_layout(1025, np.zeros(1, np.int64), np.ones(1, np.int64), np.ones(1), "cpu").padded_nodes == 2048
    assert not attaches_plan(torch.device("cpu")) and not attaches_plan(torch.device("cuda"))
    v2 = CsrPlan.for_graph(gd, kernel="v2")
    assert isinstance(v2.layout, V2Layout) and v2.layout.g1 % 2048 == 0 and v2.runs_bf16("bfloat16")
    odd = CsrPlan(dataclasses.replace(v2.layout, g1=v2.layout.g1 + 512))
    assert not odd.runs_bf16("bfloat16") and not CsrPlan(gd.plan.layout).runs_bf16("bfloat16")
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(g.num_nodes).astype(np.float32))
    with _one_thread():
        y = spmv_v1_plain(gd.plan.layout, x)
        assert torch.equal(spmv(gd, x), y)
        assert not torch.equal(spmv_plain(gd, x), y)
        # The padded f32 matvec is the same sums, +0 past n.
        x2d = torch.zeros(4096)
        x2d[: g.num_nodes] = x
        y2d = spmv_v1_plain(gd.plan.layout, x2d.view(32, 128)).view(-1)
    assert torch.equal(y2d[: g.num_nodes], y) and (_bits(y2d[g.num_nodes :]) == 0).all()


def test_bf16i_solve_against_the_jax_run():
    """The port's plain bf16-intermediate power solve (momentum exit, seed
    42, 300 steps at most) on gen 0.02x's largest component (3,694 nodes, a
    v2 plan forced on it, whose overflow tail holds 7,501 of its 22,380
    entries) against the JAX package's run with its v2 kernels in
    interpret mode (``tools/gen002_lcc_bf16i.npz``, from
    ``tools/lcc_reference.py --inter bf16``): bit for bit, now that every
    SpMV takes the v2 kernels' order (``ops/spmv_plan.py``): the
    iterations, the eigenvalue and every value of the iterate.  The f32 run
    on the same padded state exits far earlier, at its sign check."""
    from test_torch_lanczos import largest_component

    from eig_kl_tpu_torch.graph.csr import CsrPlan
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.spectral.power import _power_core

    ref = np.load(FIXTURE)
    hg = largest_component(read_hgr(GEN_002, use_native=False))
    g = clique_expand(hg, "kl", use_native=False)
    base = g.to_device("cpu")
    gd = dataclasses.replace(base, plan=CsrPlan.for_graph(base, kernel="v2"))
    runs = {}
    with _one_thread():
        for inter in ("bfloat16", "float32"):
            runs[inter] = _power_core(gd, shift=2.0, tolerance=1e-6, min_iters=100, max_iters=300, seed=42,
                                      dtype=torch.float32, convergence="momentum", inter_dtype=inter)
    lam, v, iters = runs["bfloat16"]
    assert iters == int(ref["iterations"]) and abs(runs["float32"][2] - iters) > 25
    assert _bits(float(lam)) == _bits(ref["eigenvalue"])
    np.testing.assert_array_equal(_bits(v.numpy()), _bits(ref["values"]))
