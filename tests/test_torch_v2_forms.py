"""The v2 TPU SpMV's other forms (``eig_kl_tpu_torch/ops/spmv_plan.py``)
against the JAX package on the CPU: the bf16 weights that
``EIG_KL_TPU_BF16_W=1`` makes a plan keep, and the opt-in reduce kernels
that ``EIG_KL_TPU_REDUCE_IMPL`` picks ("mxuv", "mxu2", "vpu").  Each test
sets the environment as a user would and calls the port's entry points,
which read it where the JAX package does.  The JAX runs trace afresh under
each setting (a new ``jax.jit`` per run), since the JAX package reads the
knobs at trace time.  The plain versions run on one thread.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_one_thread import one_thread  # noqa: F401  (autouse: PyTorch on one thread)

from test_torch_plan_order import _bits, _coo, _host, _jax_slots, _one_thread

KNOBS = ("EIG_KL_TPU_REDUCE_IMPL", "EIG_KL_TPU_BF16_W", "EIG_KL_TPU_REDUCE_DOT", "EIG_KL_TPU_REDUCE_ROWWISE")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)


@functools.lru_cache(maxsize=None)
def _plans(rblock, bf16_weights):
    """The JAX package's v2 plan of the 6,000-node graph (78,752 entries, a
    v1 tail) at a pinned row block and the port's layout, both built with
    ``EIG_KL_TPU_BF16_W`` set to 1 or unset."""
    from eig_kl_tpu.ops.spmv_pallas import build_plan_v2
    from eig_kl_tpu_torch.ops.spmv_plan import build_v2_layout

    mp = pytest.MonkeyPatch()
    try:
        if bf16_weights:
            mp.setenv("EIG_KL_TPU_BF16_W", "1")
        g = _host("6000")
        coo = _coo(g)
        return build_plan_v2(g.num_nodes, *coo, use_native=False, rblock=rblock), \
            build_v2_layout(g.num_nodes, *coo, "cpu", rblock=rblock)
    finally:
        mp.undo()


def _state(plan, seed=3):
    n, P = _host("6000").num_nodes, plan.padded_nodes
    x = np.zeros(P, np.float32)
    x[:n] = np.random.default_rng(seed).standard_normal(n)
    return x.reshape(-1, 128)


@pytest.mark.parametrize("rblock", [512, 4096])
def test_layout_keeps_the_jax_plans_bf16_weights(rblock):
    """Under ``EIG_KL_TPU_BF16_W=1`` the port's layout keeps
    ``weights_bf16``, the kept entries' weights in bf16 (2 bytes each),
    equal bit for bit to the JAX plan's at every kept slot; the tail keeps
    f32 weights, and without the knob neither plan keeps any.  The slots
    that the opt-in reduces read (``V2Layout.slots``) are the JAX plan's, in
    their 512-slot pass-2 sub-chunks."""
    from eig_kl_tpu_torch.ops.spmv_plan import V1Layout

    plan, lay = _plans(rblock, True)
    assert lay.weights_bf16 is not None and lay.weights_bf16.dtype == torch.bfloat16
    assert lay.weights_bf16.shape == lay.weights.shape and isinstance(lay.tail, V1Layout)
    assert lay.tail.weights.dtype == torch.float32
    slot, rows, cols, _ = _jax_slots(plan)
    o = np.lexsort((cols, rows))  # the JAX plan's kept entries in CSR order
    ptr = lay.ptr.numpy().astype(np.int64)
    np.testing.assert_array_equal(rows[o], np.repeat(np.arange(lay.num_nodes), np.diff(ptr)))
    np.testing.assert_array_equal(cols[o], lay.cols.numpy())
    ref = np.asarray(plan.weights_bf16).reshape(-1)[slot].view(np.int16)
    np.testing.assert_array_equal(lay.weights_bf16.view(torch.int16).numpy(), ref[o])
    # A pass-1 slot (column block, row block, rank) lies in the row block's
    # pass-2 slots at column block * Q + rank.
    lin = slot // plan.g1 * plan.quantum + slot % plan.quantum
    np.testing.assert_array_equal(lay.slots.numpy(), lin[o] % 512)
    plain, lay_plain = _plans(rblock, False)
    assert plain.weights_bf16 is None and lay_plain.weights_bf16 is None


#: The JAX runs compile one interpret-mode program per reduce, row block and
#: product form (5-12 s each), so each reduce takes each row block and each
#: form once, not every pair: "mxu" takes f32 and bf16 products at 512 and
#: 4,096 in tests/test_torch_plan_order.py.
FORMS = [
    ("mxu", 512, ("bf16w",)),
    ("mxuv", 512, ("f32",)),
    ("mxuv", 4096, ("bf16i",)),
    ("mxu2", 512, ("f32", "bf16i", "bf16w")),
    ("mxu2", 2048, ("f32",)),
    ("mxu2", 4096, ("bf16w",)),
    ("vpu", 512, ("f32", "bf16w")),
    ("vpu", 2048, ("bf16i",)),
    ("vpu", 4096, ("f32",)),
]


@pytest.mark.parametrize("reduce, rblock, forms", FORMS, ids=[f"{r}-{b}-{'+'.join(f)}" for r, b, f in FORMS])
def test_spmv_v2_plain_equals_spmv_pallas_2d(monkeypatch, reduce, rblock, forms):
    """``plan_spmv`` (the plain version on the CPU) under
    ``EIG_KL_TPU_REDUCE_IMPL`` equals ``spmv_pallas_2d(..., interpret=True)``
    with ``==`` on the 6,000-node graph, with f32 products, bf16 products
    ("bf16i") or bf16 products of bf16 weights ("bf16w", a plan built under
    ``EIG_KL_TPU_BF16_W=1``).  "mxuv" is "mxu"'s order; "mxu2" parts from
    it at row blocks 512 and 2,048 (4 and 2 interleaved partials) and equals
    it at 4,096; "vpu" (32-slot blocks) parts at every row block: there the
    port's default order parts from the JAX run."""
    from eig_kl_tpu.ops import spmv_pallas as SP
    from eig_kl_tpu_torch.ops.spmv_plan import plan_spmv, reduce_impl_from_env, spmv_v2_plain

    monkeypatch.setenv("EIG_KL_TPU_REDUCE_IMPL", reduce)
    plan, lay = _plans(rblock, False)
    plan_w, lay_w = _plans(rblock, True)
    x2d = _state(plan)
    args = {"f32": (plan, jnp.float32), "bf16i": (plan, jnp.bfloat16), "bf16w": (plan_w, jnp.bfloat16)}
    refs = jax.jit(lambda a: [SP.spmv_pallas_2d(args[f][0], a, interpret=True, inter_dtype=args[f][1])
                              for f in forms])(jnp.asarray(x2d))
    form = reduce_impl_from_env()
    assert form == reduce
    x = torch.as_tensor(x2d)
    with _one_thread():
        for f, ref in zip(forms, refs):
            got = plan_spmv(lay_w if f == "bf16w" else lay, x, f != "f32", form, bf16_weights=f == "bf16w")
            np.testing.assert_array_equal(_bits(got), _bits(ref))
            default = spmv_v2_plain(lay_w if f == "bf16w" else lay, x, f != "f32", bf16_weights=f == "bf16w")
            parts = int((_bits(default) != _bits(ref)).sum())
            if f == "f32":
                assert (parts > 0) == (reduce == "vpu" or (reduce == "mxu2" and rblock < 4096)), parts
            if f == "bf16w":
                assert (_bits(got) != _bits(plan_spmv(lay, x, True, form))).any()  # the bf16 weights move rows


def test_reduce_dot_and_rowwise_change_no_bit(monkeypatch):
    """``EIG_KL_TPU_REDUCE_DOT=bf16`` (bf16 operands for the default dot
    with bf16 products) and ``EIG_KL_TPU_REDUCE_ROWWISE=0`` (one (H, 128)
    update of y where the row block's default is H row updates) change no
    bit of ``spmv_pallas_2d``: its run equals the port's default order, so
    the port reads neither."""
    from eig_kl_tpu.ops import spmv_pallas as SP
    from eig_kl_tpu_torch.ops.spmv_plan import spmv_v2_plain

    assert SP._reduce_rowwise(512)
    monkeypatch.setenv("EIG_KL_TPU_REDUCE_DOT", "bf16")
    monkeypatch.setenv("EIG_KL_TPU_REDUCE_ROWWISE", "0")
    plan, lay = _plans(512, False)
    x2d = _state(plan, seed=5)
    ref = jax.jit(lambda a: SP.spmv_pallas_2d(plan, a, interpret=True, inter_dtype=jnp.bfloat16))(jnp.asarray(x2d))
    with _one_thread():
        got = spmv_v2_plain(lay, torch.as_tensor(x2d), True)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_mega_engine_and_spmv_ignore_the_knobs(monkeypatch):
    """Under ``EIG_KL_TPU_REDUCE_IMPL=vpu`` and ``EIG_KL_TPU_BF16_W=1`` the
    JAX package's ``spmv_pallas`` (the mega engine's ``A @ s`` and recount,
    ``ops/partition.py:spmv`` on a planned graph) passes neither the reduce
    nor the bf16 weights to its kernels; so the port's ``mega_spmv`` and
    ``spmv`` on a graph with a ``CsrPlan`` keep the default order and the
    f32 weights, though the layout keeps bf16 weights: bit for bit the
    default order (which equals ``spmv_pallas``,
    tests/test_torch_plan_order.py)."""
    import dataclasses

    from eig_kl_tpu_torch.graph.csr import CsrPlan, Graph
    from eig_kl_tpu_torch.kl.megakernel import mega_spmv
    from eig_kl_tpu_torch.ops.spmv import spmv
    from eig_kl_tpu_torch.ops.spmv_plan import V2Layout, spmv_v2_plain

    monkeypatch.setenv("EIG_KL_TPU_REDUCE_IMPL", "vpu")
    monkeypatch.setenv("EIG_KL_TPU_BF16_W", "1")
    h = _host("6000")
    g = Graph.from_arrays(h.indptr, h.indices, h.data).to_device("cpu")
    lay = g.plan_layout
    assert isinstance(lay, V2Layout) and lay.weights_bf16 is not None
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(h.num_nodes).astype(np.float32))
    gp = dataclasses.replace(g, plan=CsrPlan(lay))
    with _one_thread():
        want = spmv_v2_plain(lay, x)
        assert (_bits(want) != _bits(spmv_v2_plain(lay, x, reduce="vpu"))).any()
        for got in (mega_spmv(g)(x), spmv(gp, x)):
            np.testing.assert_array_equal(_bits(got), _bits(want))


def test_forms_and_their_entry_points():
    """The entry point each form launches: "mxuv" and "mxu2" from 2,176
    rows per block (``B`` >= 64) take the default's (the same order, the
    same function); "mxu2" below takes its own with 4 partials up to 512
    rows per block and 2 from 640 to 2,048; "vpu" its own; bf16 weights
    their ``_bf16w`` form and only with bf16 products.  Unknown reduce
    names and bf16 weights a layout does not keep are refused."""
    from eig_kl_tpu_torch.ops.spmv_plan import (
        K1_LAZY_V2, K1_V2, K1_V2_BF16I, K1_V2_FORMS, mxu2_lanes, v2_kernel, v2_order,
    )

    assert [mxu2_lanes(128 * h) for h in (1, 2, 3, 4, 5, 8, 16, 17, 32, 128)] == [4, 4, 4, 4, 2, 2, 2, 1, 1, 1]
    _, lay = _plans(4096, True)
    _, small = _plans(512, False)
    assert v2_order(lay, "mxu2") == v2_order(lay, "mxuv") == v2_order(lay, "mxu") == ("mxu", 0)
    assert v2_order(small, "mxu2") == ("mxu2", 4) and v2_order(small, "vpu") == ("vpu", 0)
    assert v2_kernel(lay, reduce="mxu2") is K1_V2 and v2_kernel(lay, True, "mxuv") is K1_V2_BF16I
    assert v2_kernel(lay, reduce="mxu2", lazy=True) is K1_LAZY_V2
    assert v2_kernel(small, True, "mxu2").symbol == "spmv_v2_mxu2_bf16i_f32"
    assert v2_kernel(lay, True, "vpu", True, lazy=True).symbol == "lazy_walk_v2_vpu_bf16w_f32"
    assert v2_kernel(lay, True, bf16_weights=True).symbol == "spmv_v2_bf16w_f32"
    assert len({k.symbol for k in K1_V2_FORMS.values()}) == 18
    with pytest.raises(ValueError, match="reduce"):
        v2_order(lay, "dense")
    with pytest.raises(ValueError, match="bf16 products"):
        v2_kernel(lay, False, bf16_weights=True)
    with pytest.raises(ValueError, match="keeps no bf16 weights"):
        v2_kernel(small, True, bf16_weights=True)
