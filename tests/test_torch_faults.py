"""The port against the JAX package where XLA's CPU code adds in orders
that depend on the shape (ROADMAP.md C5, C6, C9), on the CPU, bit for bit
unless a test says otherwise:

* rows wider than 32 (C9): the momentum check's lazy walk, in which XLA
  recomputes the deflated iterate inside the epilogue's fusion and fuses
  that product, and the Rayleigh quotients' dots, whose loop then takes
  element-wise operands; the momentum exit to its exit on such a graph;
* XLA's 2-D order above 1,024 rows (C6): the second round's ``(32, 4)``
  windows, which LLVM vectorizes over rows where the round has no lead
  pad;
* fused dots of 1 to 159 values (C5, C9) for three fused producers, each
  with its own lengths of scalar, unrolled and vector loops, and the
  vector loop's epilogue ties;
* the f64 momentum exit's beta (C9), folded as in the f32 program;
* the mega paths' cut from 4,096 nodes (C5, settled): the tree order, within
  a rounding bound of the JAX mega engine's sequential dot, the drift gate
  of 1e-5 held.

The graphs are small: ``tests/conftest.py:random_hypergraph`` with one
wide net added where rows wider than 32 are wanted; the plain versions run
on one thread.
"""

import contextlib
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_hypergraph


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.int32 if a.dtype == np.float32 else np.int64)


def _with_wide_net(num_nodes, wide, seed):
    """The largest component of a random hypergraph with one net of
    ``wide`` pins added: its pins' rows hold ``wide - 1`` entries or more."""
    from eig_kl_tpu_torch.io.hgr import Hypergraph
    from test_torch_lanczos import largest_component

    rng = np.random.default_rng(seed)
    hg = random_hypergraph(rng, num_nodes, num_nodes, 3)
    pins = np.concatenate([hg.pins, rng.choice(num_nodes, wide, replace=False).astype(np.int32)])
    offsets = np.append(hg.net_offsets, len(pins))
    return largest_component(Hypergraph(num_nodes, hg.num_nets + 1, pins, offsets))


def _graphs(hg, dtype="float32"):
    """(JAX DeviceGraph, port DeviceGraph) of the same KL-weighted arrays."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.io.hgr import Hypergraph as JaxHypergraph
    from eig_kl_tpu_torch.graph.csr import device_graph_from_jax

    jhg = JaxHypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets)
    g_jax = clique_expand(jhg, "kl", use_native=False).to_device(dtype=dtype)
    return g_jax, device_graph_from_jax(
        np.asarray(g_jax.ell_indices), np.asarray(g_jax.ell_weights),
        np.asarray(g_jax.degrees), np.asarray(g_jax.total_weight), "cpu",
    )


# ------------------------------------------------ C9: rows wider than 32


@pytest.mark.parametrize("wide, width", [(30, 40), (34, 48), (40, 56)])
def test_momentum_check_walk_above_32_columns_equals_xla(wide, width):
    """The check's ``jnp.vdot(w, opm_sym(w))`` with ``w`` the deflated unit
    iterate made in the same program (``eig_kl_tpu/spectral/power.py:
    356-358``): its walk is ``0.5 * fma(u, c, dsinv * Ax)`` (``lazy_walk``'s
    scaled form), its dot the "lanes" loop below 4,096 values."""
    from eig_kl_tpu.ops.partition import spmv as jax_spmv
    from eig_kl_tpu_torch.ops.reduce import axpy, fma_dot, tree_norm
    from eig_kl_tpu_torch.ops.spmv import lazy_walk_plain
    from eig_kl_tpu_torch.spectral.power import _reciprocal, power_operator

    g_jax, g = _graphs(_with_wide_net(700, wide, seed=wide))
    assert g.row_width == width
    n = g.num_nodes
    deg = np.asarray(g_jax.degrees)
    d = (1.0 / np.sqrt(np.where(deg > 0, deg, 1.0))).astype(np.float32)
    q0 = np.sqrt(np.where(deg > 0, deg, 1.0)).astype(np.float32)
    q0 = (q0 / np.float32(np.linalg.norm(q0.astype(np.float64)))).astype(np.float32)
    w = np.random.default_rng(width).standard_normal(n).astype(np.float32)

    def unit(w, q0):
        u = w - jnp.vdot(q0, w) * q0
        nv = jnp.linalg.norm(u)
        return u, jnp.where(nv > 0, 1.0 / jnp.where(nv > 0, nv, 1.0), 1.0)

    @jax.jit
    def check(g, w, d, q0):  # the walk alone, or the quotient alone, as in the program
        u, c = unit(w, q0)
        wv = u * c
        walk = 0.5 * (wv + d * jax_spmv(g, d * wv))
        return walk, jnp.vdot(wv, walk)

    walk_ref = check(g_jax, w, d, q0)[0]
    mu_ref = jax.jit(lambda g, w, d, q0: check(g, w, d, q0)[1])(g_jax, w, d, q0)
    with _one_thread():
        T = torch.as_tensor
        u = axpy(-fma_dot(T(q0), T(w)), T(q0), T(w))
        c = _reciprocal(tree_norm(u))
        wv = u * c
        walk = lazy_walk_plain(g, wv, T(d), scaled=(u, c))
        mu = power_operator(g, 2.0, torch.float32).rayleigh(wv, u, c, T(d))
        np.testing.assert_array_equal(_bits(walk), _bits(walk_ref))
        assert _bits(mu) == _bits(mu_ref)


def _connected_with_wide_net(num_nodes, wide, seed):
    """A connected hypergraph of exactly ``num_nodes`` nodes (a path of
    2-pin nets through them all, random 3-pin nets, one net of ``wide``
    pins)."""
    from eig_kl_tpu_torch.io.hgr import Hypergraph

    rng = np.random.default_rng(seed)
    hg = random_hypergraph(rng, num_nodes, num_nodes // 2, 3)
    path = np.arange(num_nodes, dtype=np.int32)
    wide_pins = rng.choice(num_nodes, wide, replace=False).astype(np.int32)
    pins = np.concatenate([hg.pins, np.stack([path[:-1], path[1:]], 1).reshape(-1), wide_pins])
    offsets = np.concatenate([hg.net_offsets, len(hg.pins) + 2 * np.arange(1, num_nodes), [len(pins)]])
    return Hypergraph(num_nodes, hg.num_nets + num_nodes, pins, offsets.astype(hg.net_offsets.dtype))


_WIDE_GRAPHS = {f"width {w}": functools.partial(_with_wide_net, 700, wide, wide) for wide, w in [(30, 40), (34, 48),
                                                                                                (40, 56)]}
#: Lengths at each edge of the "laplacian" form: the first a graph wider
#: than 32 can have, the unrolled epilogue of 6 or 7 (4 lanes), the last
#: unrolled and the first vector loop, its ties (4 lanes), a remainder of 7;
#: 195-223 unrolled where the degrees are an operand.
_WIDE_GRAPHS.update({f"{n} nodes": functools.partial(_connected_with_wide_net, n, 34, n)
                     for n in (34, 39, 55, 70, 135, 191, 192, 195, 221, 223, 224, 252, 263)})


@pytest.mark.parametrize("graph", _WIDE_GRAPHS)
def test_final_rayleigh_quotient_above_32_columns_equals_xla(graph):
    """The f32 CSR solve's final ``jnp.vdot(v, norm_lap(v))``
    (``eig_kl_tpu/spectral/power.py:413``) on a graph wider than 32: the
    Laplacian's row sums are a fusion of their own and the rest of it is
    fused into the dot's vectorized loop, whose order is the "laplacian"
    form (``ops/reduce.py:LANES_FORMS``: unrolled up to 223 values, 4
    lanes at a tie), on four seeded iterates.  As in the solve's program,
    the safe degrees come into the quotient's loop made (the steps read
    them too): with their select in the loop it unrolls only to 191."""
    from eig_kl_tpu.ops.partition import spmv as jax_spmv
    from eig_kl_tpu_torch.spectral.power import power_operator

    g_jax, g = _graphs(_WIDE_GRAPHS[graph]())
    assert g.row_width > 32

    @jax.jit
    def rayleigh(g, v, safe_deg):
        return jnp.vdot(v, 2.0 * v - 2.0 * jax_spmv(g, v) / safe_deg)

    deg = np.asarray(g_jax.degrees)
    safe_deg = np.where(deg > 0, deg, 1.0).astype(np.float32)
    op = power_operator(g, 2.0, torch.float32)
    rng = np.random.default_rng(g.num_nodes)
    for _ in range(4):
        v = rng.standard_normal(g.num_nodes, dtype=np.float32)
        with _one_thread():
            got = op.dot(torch.as_tensor(v), op.norm_lap(torch.as_tensor(v)))
        assert _bits(got) == _bits(rayleigh(g_jax, v, safe_deg))


@pytest.mark.parametrize("n, wide, width, convergence", [
    (195, 34, 48, "momentum"), (200, 34, 48, "sign"), (223, 34, 48, "sign"), (200, 60, 72, "momentum"),
])
def test_final_quotient_at_192_to_223_values_equals_jax(n, wide, width, convergence):
    """The sign and momentum exits on connected graphs of 192-223 nodes
    wider than 32, to their exit: every iterate bit, the iteration count
    and the eigenvalue.  At ELL width 48 (two row windows) the final
    quotient takes the "laplacian" form unrolled to 223 values (its loop
    reads the safe degrees made before it; with a vector loop from 192 the
    eigenvalue parted while every iterate bit held); at width 72 (three
    windows) both quotients take "windows3", unrolled to 191 with no 8-lane
    tie (with the check's "walk" the momentum iterate parted from step 27;
    ROADMAP.md C9)."""
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.spectral.power import _power_core

    g_jax, g = _graphs(_connected_with_wide_net(n, wide, n))
    assert g.row_width == width
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=400, seed=42, convergence=convergence)
    lam_j, v_j, it_j = jax_core(g_jax, dtype="float32", **kw)
    with _one_thread():
        lam_t, v_t, it_t = _power_core(g, dtype=torch.float32, **kw)
    assert it_t == int(it_j)
    np.testing.assert_array_equal(_bits(v_t.numpy()), _bits(v_j))
    assert _bits(lam_t) == _bits(lam_j)


@pytest.mark.parametrize("n", [34, 46, 60, 150, 222])
def test_small_momentum_above_32_columns_equals_jax_to_its_exit(n):
    """The momentum exit on connected graphs of 34-222 nodes with a 34-pin
    net (ELL width 40), to its exit: the check's quotient takes the "walk"
    form, unrolled from 34 values to 223 with 8 lanes at the epilogue's tie
    (222: 30 values left), over the walk whose epilogue contracts ``dsinv *
    Ax`` ("lanes" kept 34 and 46 a chain and 150 a vector loop, and the
    runs parted at the first check's beta; 60 parted at step 51 with the
    walk's scaled form)."""
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.spectral.power import _power_core

    g_jax, g = _graphs(_connected_with_wide_net(n, 34, n))
    assert g.row_width == 40
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=400, seed=42, convergence="momentum")
    lam_j, v_j, it_j = jax_core(g_jax, dtype="float32", **kw)
    with _one_thread():
        lam_t, v_t, it_t = _power_core(g, dtype=torch.float32, **kw)
    assert it_t == int(it_j)
    np.testing.assert_array_equal(_bits(v_t.numpy()), _bits(v_j))
    assert _bits(lam_t) == _bits(lam_j)


@pytest.mark.parametrize("n, width", [(64, 64), (150, 72)])
def test_momentum_at_widths_64_and_72_equals_jax_to_its_exit(n, width):
    """The momentum exit on connected graphs with a 60-pin net (ELL width
    64, whose row windows of 32 have no lead pad, and 72), to its exit:
    every iterate bit, the iteration count and the eigenvalue (both parted
    with the walk's scaled form in the check's quotient)."""
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.spectral.power import _power_core

    g_jax, g = _graphs(_connected_with_wide_net(n, 60, n))
    assert g.row_width == width
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=400, seed=42, convergence="momentum")
    lam_j, v_j, it_j = jax_core(g_jax, dtype="float32", **kw)
    with _one_thread():
        lam_t, v_t, it_t = _power_core(g, dtype=torch.float32, **kw)
    assert it_t == int(it_j)
    np.testing.assert_array_equal(_bits(v_t.numpy()), _bits(v_j))
    assert _bits(lam_t) == _bits(lam_j)


@pytest.mark.parametrize("n", [92, 127, 191, 219, 223, 224])
def test_momentum_check_quotient_below_4096_values_equals_xla(n):
    """The check's quotient ``jnp.vdot(w, opm_sym(w))`` of the deflated
    unit iterate (``eig_kl_tpu/spectral/power.py:356-358``) in a program of
    its own, on connected graphs of ELL width 40 or 48 whose length leaves
    28-31 values to the unrolled loop's epilogue (92, 127, 191, 223: 8
    lanes at the tie), ends the unrolled loop (219, 223) or starts the
    vector loop (224): below 4,096 values the walk's epilogue is fused into
    the dot's loop and contracts ``dsinv * Ax`` (the lazy walk's own
    epilogue), the dot's order is "walk"; on 8 draws of the iterate."""
    from eig_kl_tpu.ops.partition import spmv as jax_spmv
    from eig_kl_tpu_torch.ops.reduce import axpy, fma_dot, tree_norm
    from eig_kl_tpu_torch.spectral.power import _reciprocal, power_operator

    g_jax, g = _graphs(_connected_with_wide_net(n, 34, n))
    assert g.row_width > 32
    deg = np.asarray(g_jax.degrees)
    d = (1.0 / np.sqrt(np.where(deg > 0, deg, 1.0))).astype(np.float32)
    q0 = np.sqrt(np.where(deg > 0, deg, 1.0)).astype(np.float32)
    q0 = (q0 / np.float32(np.linalg.norm(q0.astype(np.float64)))).astype(np.float32)

    @jax.jit
    def quotient(g, w, d, q0):
        u = w - jnp.vdot(q0, w) * q0
        nv = jnp.linalg.norm(u)
        wv = u * jnp.where(nv > 0, 1.0 / jnp.where(nv > 0, nv, 1.0), 1.0)
        return jnp.vdot(wv, 0.5 * (wv + d * jax_spmv(g, d * wv)))

    op = power_operator(g, 2.0, torch.float32)
    T = torch.as_tensor
    for seed in range(8):
        w = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        with _one_thread():
            u = axpy(-fma_dot(T(q0), T(w)), T(q0), T(w))
            c = _reciprocal(tree_norm(u))
            mu = op.rayleigh(u * c, u, c, T(d))
        assert _bits(mu) == _bits(quotient(g_jax, w, d, q0)), seed


def test_momentum_above_32_columns_equals_jax_to_its_exit():
    """The momentum exit on a component of 4,206 nodes with rows of up to
    48 entries (ELL width 48, as gen 1.0x's component has; from 4,096
    values the dots are XLA's vector dot) to its exit: every iterate bit,
    the iteration count and the eigenvalue."""
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.spectral.power import _power_core

    g_jax, g = _graphs(_with_wide_net(4600, 36, seed=8))
    assert g.row_width == 48 and g.num_nodes >= 4096
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=1000, seed=42, convergence="momentum")
    lam_j, v_j, it_j = jax_core(g_jax, dtype="float32", **kw)
    with _one_thread():
        lam_t, v_t, it_t = _power_core(g, dtype=torch.float32, **kw)
    assert it_t == int(it_j) == 201
    np.testing.assert_array_equal(_bits(v_t.numpy()), _bits(v_j))
    assert _bits(lam_t) == _bits(lam_j)


# --------------------------------------- C6: XLA's 2-D order above 1,024 rows


def _rows_for(k, pad):
    """A row count of 128 columns whose second round has ``k`` windows and
    a total pad of ``pad`` rows (0 or 1: no lead pad)."""
    return 32 * (32 * k - pad)


_NORM_ROWS = [3073, 32_768] + [_rows_for(k, k % 2) - 7 * (k % 3) for k in range(2, 33)]


@functools.lru_cache(maxsize=None)
def _norms():
    """The seeded ``(rows, 128)`` states of :data:`_NORM_ROWS` and their
    ``jnp.linalg.norm``, all from one program (each norm its own fusions,
    as in a program of its own: held below at two row counts)."""
    xs = [np.random.default_rng(rows).standard_normal((rows, 128), dtype=np.float32) for rows in _NORM_ROWS]
    norms = [np.asarray(v) for v in jax.jit(lambda xs: [jnp.linalg.norm(x) for x in xs])(xs)]
    for i in (0, 7):
        assert _bits(jax.jit(jnp.linalg.norm)(xs[i])) == _bits(norms[i])
    return dict(zip(_NORM_ROWS, zip(xs, norms)))


@pytest.mark.parametrize("rows", _NORM_ROWS)
def test_norm_2d_above_1024_rows_equals_xla(rows):
    """``tree_norm_2d`` against ``jnp.linalg.norm`` at 1,025-32,768 rows of
    128, one row count for every k = 2..32 windows of the second round (its
    last block ``(k, 1)``; above 1,024 rows k >= 2), most of them with no
    lead pad, where XLA's loop adds each ``(32, 4)`` window across 8 lanes
    of rows (pad 0) or 4 (pad 1), and both ends."""
    from eig_kl_tpu_torch.ops.reduce import reduce_rounds, tree_norm_2d

    rounds = reduce_rounds((rows, 128))
    assert len(rounds) == 2 and 2 <= rounds[-1].windows[0] <= 32
    x, want = _norms()[rows]
    with _one_thread():
        got = tree_norm_2d(torch.as_tensor(x))
    assert _bits(got) == _bits(want)


# ---------------------------------- C5, C9: fused dots of fewer than 160 values


#: The fused producers of the vectorized orders (``ops/reduce.py:
#: LANES_FORMS``) as the JAX programs write them, from a vector ``a``, the
#: int8 sides ``fs`` of a split and a padded state ``b2d``: the JAX dot of
#: ``n`` values, and the port's operands.  (The other operand's producer
#: matters too: the signs are read against a plain vector, as the verified
#: cut's ``A s``.)
_FORMS = {
    "lanes": (lambda a, fs, b2d, n: jnp.vdot(a * 1.5, b2d.reshape(-1)[:n]),
              lambda a, fs, b, n: (a * np.float32(1.5), b[:n])),
    "slice": (lambda a, fs, b2d, n: jnp.vdot(b2d.reshape(-1)[:n], a), lambda a, fs, b, n: (b[:n], a)),
    "signs": (lambda a, fs, b2d, n: jnp.vdot(1.0 - 2.0 * fs.astype(jnp.float32), a),
              lambda a, fs, b, n: ((1.0 - 2.0 * fs).astype(np.float32), a)),
}


def _inputs(rng, n):
    a = rng.standard_normal(n, dtype=np.float32)
    b = rng.standard_normal(-(-n // 128) * 128 + 128, dtype=np.float32)
    a[::7], b[1:n:5] = -0.0, -0.0
    return a, (rng.random(n) < 0.5).astype(np.int8), b.reshape(-1, 128)


@functools.lru_cache(maxsize=None)
def _short_dots():
    """Seeded inputs of every length 1..159 (-0 among the values) and the
    JAX dots of each producer of :data:`_FORMS`, all from one program:
    each dot is a fusion of its own there, compiled as in a program of its
    own (held below at three lengths of each form), and one compile costs
    far less than 477."""
    rng = np.random.default_rng(159)
    inputs = [_inputs(rng, n) for n in range(1, 160)]

    def every(ins):
        return {form: [dot(a, fs, b2d, a.shape[0]) for a, fs, b2d in ins] for form, (dot, _) in _FORMS.items()}

    dots = {form: [np.asarray(d) for d in ds] for form, ds in jax.jit(every)(inputs).items()}
    for form, (dot, _) in _FORMS.items():
        for n in (7, 57, 150):
            alone = jax.jit(lambda a, fs, b2d: dot(a, fs, b2d, a.shape[0]))(*inputs[n - 1])
            assert _bits(alone) == _bits(dots[form][n - 1]), (form, n)
    return inputs, dots


@pytest.mark.parametrize("n", range(1, 160))
def test_short_fused_dots_equal_xla(n):
    """``fused_dot`` in its vectorized orders against ``jnp.vdot`` of the
    producer each is read from (a scaled vector with a slice of a padded
    state, a bare slice, the signs of a split): one value is the product;
    LLVM leaves the loop a scalar chain up to 49, 59 and 37 values, unrolls
    the vector loop fully and reassociates it up to 128, 128 and 351, and
    the vector loop's epilogue takes 2 or 4 lanes for 6 or 7 values left
    by the unrolled loop (``LANES_FORMS``)."""
    from eig_kl_tpu_torch.ops.reduce import fused_dot

    inputs, dots = _short_dots()
    a, fs, b2d = inputs[n - 1]
    for form, (_, operands) in _FORMS.items():
        x, y = operands(a, fs, b2d.reshape(-1), n)
        got = fused_dot(torch.as_tensor(x), torch.as_tensor(np.ascontiguousarray(y)), form)
        assert _bits(got) == _bits(dots[form][n - 1]), form


@pytest.mark.parametrize("form", ["lanes", "slice", "signs"])
def test_vector_loop_epilogue_ties_equal_xla(form):
    """The vector loop's epilogue where 8 and 4 lanes tie in steps
    (remainders 28 to 31): 8 lanes for a scaled vector and for a bare
    slice, 4 for the signs; and the signs' unrolled loop up to 351 values,
    its vector loop from 352 (one program of the six dots)."""
    from eig_kl_tpu_torch.ops.reduce import fused_dot

    dot, operands = _FORMS[form]
    rng = np.random.default_rng(28)
    inputs = [_inputs(rng, n) for n in (348, 351, 352, 380, 1021, 4063)]
    wants = jax.jit(lambda ins: [dot(a, fs, b2d, a.shape[0]) for a, fs, b2d in ins])(inputs)
    for (a, fs, b2d), want in zip(inputs, wants):
        x, y = operands(a, fs, b2d.reshape(-1), a.size)
        got = fused_dot(torch.as_tensor(x), torch.as_tensor(np.ascontiguousarray(y)), form)
        assert _bits(got) == _bits(want), a.size


# ------------------------------------------------- C9: the f64 beta


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_momentum_beta_equals_xla(dtype):
    """``momentum_beta`` against the JAX expression ``jnp.square(0.995 *
    mu) * 0.25`` on a clipped scalar mu, jitted: XLA folds it into ``mu *
    mu`` times one rounded constant in both types."""
    from eig_kl_tpu_torch.spectral.power import momentum_beta

    beta = jax.jit(lambda m: jnp.square(0.995 * jnp.clip(m, 0.05, 1.0 - 1e-7)) * 0.25)
    mus = np.random.default_rng(3).uniform(0.05, 1.0, 300).astype(dtype)
    got = np.array([momentum_beta(torch.tensor(m)).item() for m in mus], dtype)
    want = np.array([beta(m) for m in mus], dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ------------------------------- rows of ELL width 8 and 16: one chain


@pytest.mark.parametrize("n, wide, width", [(13, 2, 8), (72, 2, 16), (1000, 2, 16), (300, 18, 24), (300, 22, 32)])
def test_row_sums_by_width_equal_xla(n, wide, width):
    """XLA adds a row of ELL width 8 or 16 as one chain of fused
    multiply-adds in position order (LLVM unrolls its loop fully), and rows
    of width 24 and 32 in K1's 8 lanes: the SpMV, the Laplacian, the lazy
    walk, the blocked product (4 columns) and the power step against the
    JAX package's expressions under ``jax.jit``, bit for bit.  With 8 lanes
    at widths 8 and 16 each parted on some rows."""
    from eig_kl_tpu.ops.partition import spmv as jax_spmv
    from eig_kl_tpu_torch.ops.spmv import (
        laplacian_plain, lazy_walk_plain, power_step_plain, spmm_plain, spmv_plain,
    )

    g_jax, g = _graphs(_connected_with_wide_net(n, wide, n))
    assert g.row_width == width
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    deg = np.asarray(g_jax.degrees)
    sd = np.where(deg > 0, deg, 1.0).astype(np.float32)
    d = (1.0 / np.sqrt(sd)).astype(np.float32)
    T = torch.as_tensor
    refs = jax.jit(lambda g, x, X, d, sd: (
        jax_spmv(g, x), g.degrees * x - jax_spmv(g, x), 0.5 * (x + d * jax_spmv(g, d * x)),
        jax.vmap(lambda c: jax_spmv(g, c), in_axes=1, out_axes=1)(X),
        x - 0.5 * (2.0 * x - 2.0 * jax_spmv(g, x) / sd),
    ))(g_jax, x, X, d, sd)
    with _one_thread():
        gots = (spmv_plain(g, T(x)), laplacian_plain(g, T(x)), lazy_walk_plain(g, T(x), T(d)),
                spmm_plain(g, T(X)), power_step_plain(g, T(x), T(sd), 0.5))
    for got, ref in zip(gots, refs):
        np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("n, convergence", [(13, "sign"), (13, "momentum"), (300, "sign"), (300, "momentum")])
def test_power_solve_at_widths_8_and_16_equals_jax(n, convergence):
    """The f32 power solve on connected graphs of ELL width 8 (13 nodes)
    and 16 (300 nodes), sign and momentum exits, against the JAX package's
    ``_power_core``: the iterations, the iterate and the eigenvalue bit for
    bit.  The solve's first step keeps 8 lanes at width 16 (XLA fuses the
    start vector's draw into its loop and does not unroll the rows); the
    loop's steps, the lazy walks and the final quotient take the chain.
    With 8 lanes everywhere all four parted."""
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.spectral.power import _power_core

    g_jax, g = _graphs(_connected_with_wide_net(n, 2, n))
    assert g.row_width <= 16
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=400, seed=42, convergence=convergence)
    lam_j, v_j, it_j = jax_core(g_jax, dtype="float32", **kw)
    with _one_thread():
        lam_t, v_t, it_t = _power_core(g, dtype=torch.float32, **kw)
    assert it_t == int(it_j)
    np.testing.assert_array_equal(_bits(v_t.numpy()), _bits(v_j))
    assert _bits(lam_t) == _bits(lam_j)


@pytest.mark.parametrize("n", [4, 16, 19, 55])
def test_momentum_at_width_8_equals_jax_to_its_exit(n):
    """The momentum exit on connected graphs of ELL width 8 (a path through
    the nodes and random 3-pin nets), to its exit: every iterate bit, the
    iteration count and the final quotient.  XLA fuses the row sums into
    both quotients' loops, which LLVM vectorizes across rows in 4 or 8
    lanes ("rows", read from the x86-64 code at every length to 420 and at
    173 up to 4,095: ``ops/reduce.py:rows_dot_lanes``), and the first step's
    row sums stay a chain at width 8 (its 8 lanes are width 16's).  With the
    "chain" quotients and 8 lanes in the first step all four parted (at 4
    nodes from the second check, at 16 at the first check's final quotient);
    with the "rows" quotients alone 55 still parted, at the first step."""
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.spectral.power import _power_core

    g_jax, g = _graphs(_connected_with_wide_net(n, 2, n))
    assert g.row_width == 8
    kw = dict(shift=2.0, tolerance=1e-6, min_iters=100, max_iters=400, seed=42, convergence="momentum")
    lam_j, v_j, it_j = jax_core(g_jax, dtype="float32", **kw)
    with _one_thread():
        lam_t, v_t, it_t = _power_core(g, dtype=torch.float32, **kw)
    assert it_t == int(it_j)
    np.testing.assert_array_equal(_bits(v_t.numpy()), _bits(v_j))
    assert _bits(lam_t) == _bits(lam_j)


# ----------------------------------- C5 from 4,096 nodes: settled, tree order


def test_mega_cut_from_4096_nodes_keeps_the_tree_order():
    """From 4,096 nodes the mega paths' initial and verified cuts are
    ``cut_size``'s (the fixed tree order) and lie within the rounding bound
    of the JAX mega engine's form ``0.25 * (wsum - jnp.vdot(s, A s))``,
    whose dot XLA adds as one sequential chain there; the drift stays within
    the gate of 1e-5.

    The bound: both forms take the same ``A s`` (the mega engine's, in its
    plan's order: this graph's 66,000-odd entries make a v2 plan) and the
    same ``wsum`` (``jnp.sum``'s order); they differ in the dot's order.
    Any order of n products and n - 1 adds leaves each term with at most n
    roundings, so each dot lies within ``gamma_n * S`` of the exact one,
    ``gamma_n = n u / (1 - n u)``, ``u = 2^-24``, ``S = sum |s_i (A s)_i|``;
    the two within ``2 gamma_n S``, and after ``0.25 * (wsum - dot)`` (the
    subtraction rounded once in each, the quarter exact) the cuts within
    ``0.5 gamma_n S + u (|cut_tree| + |cut_jax|)``."""
    from eig_kl_tpu_torch.kl.megakernel import mega_spmv, refine_mega
    from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
    from eig_kl_tpu_torch.ops.spmv_plan import V2Layout
    from eig_kl_tpu_torch.utils.config import KLConfig

    rng = np.random.default_rng(11)
    g_jax, g = _graphs(random_hypergraph(rng, 4800, 6000, 5))
    n = g.num_nodes
    assert n >= 4096 and isinstance(g.plan_layout, V2Layout)
    sides = (rng.random(n) < 0.5).astype(np.int8)
    with _one_thread():
        r = refine_mega(g, sides, KLConfig(gain_eps=1e-6, max_iterations=300))
        jax_cut = jax.jit(lambda g, s, a_s: 0.25 * (jnp.sum(g.degrees) - jnp.vdot(s, a_s)))
        u = 2.0**-24
        gamma = n * u / (1 - n * u)
        for cut, labels in ((r.initial_cut, sides), (r.verified_cut, r.sides)):
            s = sides_to_signs(torch.as_tensor(labels), torch.float32)
            a_s = mega_spmv(g)(s)
            assert cut == float(cut_size(g, s, a_s))
            terms = float(torch.sum(torch.abs(s.double() * a_s.double())))
            other = float(jax_cut(g_jax, s.numpy(), a_s.numpy()))
            assert abs(cut - other) <= 0.5 * gamma * terms + u * (abs(cut) + abs(other))
    assert r.iterations == 300
    assert abs(r.final_cut - r.verified_cut) / r.final_cut <= 1e-5


# ------------------------- the mega engine's A @ s: the v1 TPU SpMV's order

GEN_002 = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks" / "data" / "gen_0.02_42.hgr")


def _v1_graph(kind):
    """A KL-weighted host graph (JAX package) of at most 32,768 stored
    entries, whose plan is a v1 plan."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.io.hgr import read_hgr

    if kind == "gen_0.02":
        return clique_expand(read_hgr(GEN_002, use_native=False), "kl", use_native=False)
    n, nets, pins, seed = kind
    return clique_expand(random_hypergraph(np.random.default_rng(seed), n, nets, pins), "kl", use_native=False)


@pytest.mark.parametrize(
    "kind", ["gen_0.02", (158, 205, 5, 1000), (2000, 2600, 5, 5), (20000, 7000, 3, 7)],
    ids=["gen_0.02", "158", "2000", "20000_nb8"],
)
def test_spmv_v1_plain_equals_the_v1_kernel(kind):
    """The v1 layout is the JAX plan's chunk by chunk, and ``spmv_v1_plain``
    equals ``spmv_pallas(plan_for_graph(g), x, interpret=True)`` with
    ``==`` (the last graph has 400 chunks, which the kernel takes 8 per
    grid step); the JAX engine's ``A @ s`` parts from K1's ELL order."""
    from eig_kl_tpu.ops.spmv_pallas import SpmvPlan, plan_for_graph, spmv_pallas
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.ops.spmv import spmv_plain
    from eig_kl_tpu_torch.ops.spmv_plan import segment_ends, spmv_v1_plain

    gh = _v1_graph(kind)
    assert gh.nnz <= 32_768
    plan = plan_for_graph(gh)
    assert isinstance(plan, SpmvPlan)
    g = Graph.from_arrays(gh.indptr, gh.indices, gh.data).to_device("cpu")
    lay = g.plan_layout
    C = lay.num_chunks
    assert lay.padded_nodes == plan.padded_nodes and C <= plan.num_chunks < C + 8
    np.testing.assert_array_equal(lay.x_base.numpy(), 128 * np.asarray(plan.cw8[:C]))
    np.testing.assert_array_equal(lay.col_local.numpy(), np.asarray(plan.col_local[:C]).reshape(C, -1))
    np.testing.assert_array_equal(lay.row_local.numpy(), np.asarray(plan.row_local[:C]).reshape(C, -1))
    np.testing.assert_array_equal(_bits(lay.weights), _bits(np.asarray(plan.weights[:C]).reshape(C, -1)))
    # The segment ends are the plan's route_src, and the windows its rw8.
    c_idx, p_idx = np.nonzero(segment_ends(lay).numpy())
    route = np.full((C, 1024), -1, np.int64)
    route[c_idx, lay.row_local.numpy()[c_idx, p_idx]] = p_idx
    np.testing.assert_array_equal(route, np.asarray(plan.route_src[:C]).reshape(C, -1))
    window = np.empty(C, np.int64)
    ptr = lay.win_ptr.numpy()
    window[lay.win_chunks.numpy()] = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    np.testing.assert_array_equal(window, np.asarray(plan.rw8[:C]) // 8)
    rng = np.random.default_rng(3)
    n = gh.num_nodes
    parted = 0
    for x in (rng.standard_normal(n).astype(np.float32), np.where(rng.random(n) < 0.5, -1.0, 1.0).astype(np.float32)):
        ref = np.asarray(spmv_pallas(plan, jnp.asarray(x), interpret=True))
        with _one_thread():
            got = spmv_v1_plain(lay, torch.as_tensor(x))
            parted += int((_bits(spmv_plain(g, torch.as_tensor(x))) != _bits(ref)).sum())
        np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert parted > 0


def _mega_case(n, seed):
    """The graph and split of a random hypergraph with nets of up to 5
    pins (weights 1/2, 1/3, 1/4: not dyadic), the split drawn after it."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu_torch.graph.csr import Graph

    rng = np.random.default_rng(seed)
    gh = clique_expand(random_hypergraph(rng, n, int(1.3 * n), 5), "kl", use_native=False)
    sides = (rng.random(n) < 0.5).astype(np.int8)
    return gh, Graph.from_arrays(gh.indptr, gh.indices, gh.data).to_device("cpu"), sides


def _assert_same_run(got, ref):
    assert got.iterations == ref.iterations
    for name in ("initial_cut", "final_cut", "best_cut", "verified_cut"):
        assert getattr(got, name) == getattr(ref, name), name
    np.testing.assert_array_equal(got.sides, ref.sides)
    np.testing.assert_array_equal(got.best_sides, ref.best_sides)
    np.testing.assert_array_equal(_bits(got.cut_trajectory), _bits(ref.cut_trajectory))
    np.testing.assert_array_equal(_bits(got.gain_trajectory), _bits(ref.gain_trajectory))


@pytest.mark.parametrize("n, seed", [(158, 1000), (158, 1001), (300, 1000), (300, 1001)])
def test_refine_mega_batch_equals_jax_on_non_dyadic_graphs(n, seed):
    """The port's ``refine_mega_batch`` against the JAX package's in
    interpret mode, bit for bit: the starting ``A @ s`` and the recount in
    the v1 kernel's order, the verified cut's dot in its program's order
    ("recount").  With K1's ELL order the two took other swaps from the
    first (300 nodes) or the eleventh (158) swap on."""
    from eig_kl_tpu.kl.megakernel import MegaGraph, refine_mega_batch as jax_batch
    from eig_kl_tpu.utils.config import KLConfig as JaxKL
    from eig_kl_tpu_torch.kl.megakernel import refine_mega_batch
    from eig_kl_tpu_torch.utils.config import KLConfig

    gh, g, sides = _mega_case(n, seed)
    ref = jax_batch(MegaGraph(gh), sides[None], JaxKL(), interpret=True)[0]
    with _one_thread():
        got = refine_mega_batch(g, sides[None], KLConfig())[0]
    _assert_same_run(got, ref)


@pytest.mark.parametrize("n", [40, 70, 130])
def test_single_start_recount_equals_jax(n):
    """The single-start program (``refine_mega``) at lengths where the
    recount's dot is unrolled (40, 70: two lanes only below 6 values left)
    and a vector loop (130)."""
    from eig_kl_tpu.kl.megakernel import MegaGraph, refine_mega as jax_refine
    from eig_kl_tpu.utils.config import KLConfig as JaxKL
    from eig_kl_tpu_torch.kl.megakernel import refine_mega
    from eig_kl_tpu_torch.utils.config import KLConfig

    gh, g, sides = _mega_case(n, 0)
    ref = jax_refine(MegaGraph(gh), sides, JaxKL(), interpret=True)
    with _one_thread():
        got = refine_mega(g, sides, KLConfig())
    _assert_same_run(got, ref)


def test_fused_refine_mega_equals_jax_on_gen002():
    """The whole gKL2 program on gen 0.02x (22,416 entries, a v1 plan):
    the port's ``fused_refine_mega`` and the JAX package's in interpret
    mode give the same power solve, split, 1,362 swaps and cuts."""
    from eig_kl_tpu.kl.megakernel import MegaGraph, fused_refine_mega as jax_fused
    from eig_kl_tpu.utils.config import KLConfig as JaxKL, SpectralConfig as JaxSpec
    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.kl.megakernel import fused_refine_mega
    from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig

    gh = _v1_graph("gen_0.02")
    jdev = gh.to_device()
    jeig, jkl = jax_fused(MegaGraph(gh, device_graph=jdev), jdev, JaxSpec(solver="power"),
                          JaxKL(gain_eps=1e-6), interpret=True)
    g = Graph.from_arrays(gh.indptr, gh.indices, gh.data).to_device("cpu")
    with _one_thread():
        eig, kl, iters = fused_refine_mega(g, SpectralConfig(solver="power"), KLConfig(gain_eps=1e-6))
    assert iters == 201 and eig.eigenvalue == jeig.eigenvalue
    np.testing.assert_array_equal(eig.sides, jeig.sides)
    _assert_same_run(kl, jkl)
    assert (kl.iterations, kl.best_cut, kl.verified_cut) == (1362, 788.5287475585938, 1003.1761474609375)
