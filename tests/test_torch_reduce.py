"""The port's fixed-order sums (``ops/reduce.py``, kernel K6's plain
versions) and the power step (K1's step entry point's plain version)
against the JAX package on the CPU, bit for bit; K6's round plan and its
layout, emulated as the kernel runs it, against the plain sums.

Every comparison here is bitwise (tolerance 0): the point of the order is
that the port's f32 iterate equals the JAX package's.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

GEN_002 = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "data", "gen_0.02_42.hgr")
SIZES_1D = [1, 31, 32, 33, 1023, 1025, 4038, 201_920] + [
    int(s) for s in np.random.default_rng(5).integers(34, 60_000, 3)
]
_jnp_sum = jax.jit(jnp.sum)
_jnp_norm = jax.jit(jnp.linalg.norm)
_jnp_dot_sum = jax.jit(lambda a, b: jnp.sum(a * b))


def _bits(a) -> np.ndarray:
    """int32 view of f32 values: equal views mean equal values with equal
    zero signs."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _values(rng, shape, zeros=False):
    """Seeded f32 values of magnitude 0.1-10 and both signs; with
    ``zeros``, about a tenth of them +0 and a tenth -0."""
    v = rng.standard_normal(shape) * 10.0 ** rng.uniform(-1.0, 1.0, shape)
    if zeros:
        pick = rng.random(shape)
        v[pick < 0.1] = 0.0
        v[(pick >= 0.1) & (pick < 0.2)] = -0.0
    return v.astype(np.float32)


@pytest.mark.parametrize("size", SIZES_1D)
def test_1d_sums_equal_xla(size):
    """(a) ``tree_sum_plain``, ``tree_norm`` and ``tree_dot`` against XLA's
    ``jnp.sum``, ``jnp.linalg.norm`` and ``jnp.sum(a * b)`` on the CPU."""
    from eig_kl_tpu_torch.ops.reduce import tree_dot, tree_norm, tree_sum_plain

    rng = np.random.default_rng(size)
    v, w = _values(rng, size), _values(rng, size)
    tv, tw = torch.as_tensor(v), torch.as_tensor(w)
    assert _bits(tree_sum_plain(tv)) == _bits(_jnp_sum(v))
    assert _bits(tree_norm(tv)) == _bits(_jnp_norm(v))
    assert _bits(tree_dot(tv, tw)) == _bits(_jnp_dot_sum(v, w))


@pytest.mark.parametrize("shape", [(32,), (5, 7), (7, 5), (2, 32), (32, 32)])
def test_short_products_are_fused_as_xla_fuses_them(shape):
    """Where no round is taken (no axis over 32), XLA adds a product with
    one rounding (a fused multiply-add, in row-major order): ``tree_norm``
    and ``tree_norm_2d`` do so too, and rounding the products first
    differs for some arrays.  (A ``(k, 4)`` array is the vectorized case
    ``tree_sum_2d`` names as unmatched.)"""
    from eig_kl_tpu_torch.ops.reduce import tree_norm, tree_norm_2d, tree_sum_2d_plain, tree_sum_plain

    norm, sum_plain = (tree_norm, tree_sum_plain) if len(shape) == 1 else (tree_norm_2d, tree_sum_2d_plain)
    differ = 0
    for seed in range(10):
        v = _values(np.random.default_rng(seed), shape)
        assert _bits(norm(torch.as_tensor(v))) == _bits(_jnp_norm(v))
        rounded = torch.sqrt(sum_plain(torch.as_tensor(v * v)).double()).float()
        differ += int((_bits(rounded) != _bits(_jnp_norm(v))).any())
    assert differ > 0


@pytest.mark.parametrize(
    "shape, plan",
    [
        # (windows, pads) per round; gen 1.0x's 1-D and 2-D norms first.
        ((201_920,), [((6310,), (0,)), ((198,), (13,)), ((7,), (13,))]),
        ((1584, 128), [((50, 4), (8, 0)), ((2, 1), (7, 0))]),
        ((4038,), [((127,), (13,)), ((4,), (0,))]),
        ((32, 128), [((1, 4), (0, 0))]),
        ((192, 128), [((6, 4), (0, 0))]),
        ((33,), [((2,), (15,))]),
        ((1000,), [((32,), (12,))]),
        ((33, 70), [((2, 3), (15, 13))]),
        ((1, 1000), [((1, 32), (0, 12))]),
        ((64_000, 10), [((2000, 1), (0, 0)), ((63, 1), (8, 0)), ((2, 1), (0, 0))]),
        ((32,), []),
        ((5, 7), []),
    ],
)
def test_reduce_rounds(shape, plan):
    """(b) The rounds of the fixed order, as the host hands them to K6."""
    from eig_kl_tpu_torch.ops.reduce import reduce_rounds

    rounds = reduce_rounds(shape)
    assert [(r.windows, r.pads) for r in rounds] == plan
    for k, r in enumerate(rounds):
        assert r.shape == (shape if k == 0 else rounds[k - 1].windows)
        for size, m, w, pad in zip(r.shape, r.windows, r.window, r.pads):
            assert (m, w, pad) == ((1, size, 0) if size <= 32 else (math.ceil(size / 32), 32, (32 * m - size) // 2))
    assert max(rounds[-1].windows if rounds else shape) <= 32


def test_k6_plan_at_gen_1x():
    """K6's host plan: the rounds as (rows, cols, windows, extents, pads)
    ints, a vector taken as one row; the scratch holds rounds 1 and 2."""
    from eig_kl_tpu_torch.ops.reduce import k6_plan

    words, scratch, second = k6_plan((201_920,))
    assert list(words) == [3, 7, 1, 201_920, 1, 6310, 1, 32, 0, 0, 1, 6310, 1, 198, 1, 32, 0, 13,
                           1, 198, 1, 7, 1, 32, 0, 13, 1, 7]
    assert (scratch, second) == (6310 + 198, 6310)
    words, scratch, second = k6_plan((1584, 128))
    assert list(words) == [2, 2, 1584, 128, 50, 4, 32, 32, 8, 0, 50, 4, 2, 1, 32, 4, 7, 0, 1, 1]
    assert (scratch, second) == (200 + 2, 200)
    assert list(k6_plan((7,))[0]) == [0, 7, 1, 7] and k6_plan((7,))[1:] == (0, 0)
    # The last block's lanes (XLA's vectorized loop): (128, 128) ends in a
    # (4, 4) block over 4 lanes; in f64 it adds in order.
    assert list(k6_plan((128, 128))[0])[-2:] == [4, 4]
    assert list(k6_plan((128, 128), torch.float64)[0])[-2:] == [1, 4]


# K6's layout, as csrc/tree_sum.cu runs it.
_SMS, _MAX_WARPS, _V = 132, 8, 4  # the card's SMs; f32: 8 warps a block at most, 4 values per 16 bytes


def _chain(values):
    """Values added in order from +0 along the last axis, each add rounded
    (f32)."""
    acc = np.zeros(values.shape[:-1], np.float32)
    for e in range(values.shape[-1]):
        acc = acc + values[..., e]
    return acc


def _fold(load, n, lead_a, m_b, lead_b, written):
    """``fold_round``: sum j of round B (lead_b) from round A's windows
    32 j - lead_b + t, t < 32, over A's input of n values (lead_a).  The
    load for window t lands in row t of the warp's tile, value ``lane`` at
    chunk (lane / 4) ^ (t & 7); lane L adds row L, reading chunk q at
    q ^ (L & 7); then the 32 lane sums are added in order.  Returns the
    m_b sums."""
    j = np.arange(m_b)[:, None, None]
    k = np.arange(32)[None, :, None]
    lane = np.arange(32)[None, None, :]
    i = (32 * j - lead_b + k) * 32 + lane - lead_a
    vals = np.where((i >= 0) & (i < n), load(np.clip(i, 0, max(n - 1, 0))), 0.0).astype(np.float32)
    row, col = np.arange(32)[:, None], np.arange(32)[None, :]
    tile = np.empty((m_b, 32 * 32), np.float32)
    tile[:, (row * 32 + ((col // _V) ^ (row & 7)) * _V + col % _V).reshape(-1)] = vals.reshape(m_b, -1)
    lane_sums = _chain(tile[:, row * 32 + ((col // _V) ^ (row & 7)) * _V + col % _V])
    np.add.at(written, np.arange(m_b), 1)
    return _chain(lane_sums)


def _tile_round(load, r, dst, written):
    """``tile_round``: a warp per 2-D window; value e of a window is row
    row0 + e / wb, column col0 + e % wb; lane 0 adds e = 0, 1, ... in
    order, or for a (32, 4) window with no lead pad across lanes of rows
    (``window_lanes``: lane j from +0, the others from -0, adds rows j,
    j + lanes, ... below ``in_lanes``, the lanes fold in halves, then the
    window's other real rows in order)."""
    from eig_kl_tpu_torch.ops.reduce import window_lanes

    rows, cols, win_rows, win_cols, wa, wb, la, lb = r
    w = np.arange(win_rows * win_cols)
    e = np.arange(wa * wb)[None, :]
    a = ((w // win_cols) * wa - la)[:, None] + e // wb
    b = ((w % win_cols) * wb - lb)[:, None] + e % wb
    ok = (a >= 0) & (a < rows) & (b >= 0) & (b < cols)
    tiles = np.where(ok, load(np.where(ok, a * cols + b, 0)), 0.0).astype(np.float32)
    by_lanes = window_lanes((rows, cols)) if (wa, wb, la) == (32, 4, 0) else None
    if by_lanes is None:
        dst[w] = _chain(tiles)
    else:
        lanes, in_lanes = by_lanes
        acc = np.full((w.size, lanes), -0.0, np.float32)
        acc[:, 0] = 0.0
        block = tiles.reshape(w.size, 32, 4)
        for i in range(0, in_lanes, lanes):
            for c in range(4):
                acc = acc + block[:, i : i + lanes, c]
        while acc.shape[1] > 1:
            acc = acc[:, : acc.shape[1] // 2] + acc[:, acc.shape[1] // 2 :]
        total = acc[:, 0]
        for t in range(w.size):
            for x in block[t, in_lanes : min(32, rows - 32 * t)].reshape(-1):
                total[t] = np.float32(total[t] + x)
        dst[w] = total
    np.add.at(written, w, 1)


def _k6_emulated(v, w, mode, root, plan=None):
    """K6 on the host from ``k6_plan``'s ints (or ``plan``), stage by stage
    as ``tree_sum_kernel`` runs them: the grid folds rounds 1 and 2 of a
    vector (round 1 into the final chain where it is the only round) or
    runs a 2-D round 1, on blocks of 1 to 8 warps; the last block folds two
    vector rounds at a time (the last into the final chain), runs a 2-D
    round alone (the last one into shared memory), and chains what is left;
    every sum written exactly once, into the scratch's two parts in turns."""
    from eig_kl_tpu_torch.ops.reduce import k6_plan
    from eig_kl_tpu_torch.ops.spmv import fma_f32

    words, scratch_len, second = plan or k6_plan(v.shape)
    words = list(words)
    k, final_count = words[:2]
    rounds = [words[2 + 8 * r : 10 + 8 * r] for r in range(k)]
    lanes, cols = words[2 + 8 * k : 4 + 8 * k]
    flat_v, flat_w = v.reshape(-1), w.reshape(-1)

    def source(i):
        if mode == "sum":
            return flat_v[i]
        return np.float32(flat_v[i] * (flat_v[i] if mode == "square" else flat_w[i]))

    def vector(r):
        return r[0] == 1 or r[1] == 1

    def fold(load, ra, rb, written):
        return _fold(load, ra[0] * ra[1], ra[6] + ra[7], rb[2] * rb[3] if rb else 1, rb[6] + rb[7] if rb else 0,
                     written)

    def finish(acc):
        return np.float32(np.sqrt(np.float64(acc))) if root else np.float32(acc)

    if k == 0:  # one warp: the chain over the input, products fused
        acc = torch.zeros((), dtype=torch.float32)
        b = flat_v if mode == "square" else flat_w
        for i in range(final_count):
            a = torch.tensor(flat_v[i])
            acc = acc + a if mode == "sum" else fma_f32(a, torch.tensor(b[i]), acc)
        return finish(acc.numpy())
    scratch = np.full(scratch_len, np.nan, np.float32)
    if vector(rounds[0]) and k == 1:
        return finish(fold(source, rounds[0], None, np.zeros(1, np.int64))[0])
    work = rounds[1][2] * rounds[1][3] if vector(rounds[0]) else rounds[0][2] * rounds[0][3]
    warps = max(1, min(_MAX_WARPS, work // _SMS if vector(rounds[0]) else -(-work // _SMS)))
    assert -(-work // warps) * warps >= work  # every sum has its warp
    written = np.zeros(work, np.int64)
    if vector(rounds[0]):
        scratch[:work] = fold(source, rounds[0], rounds[1], written)
        nxt = 2
    else:
        _tile_round(source, rounds[0], scratch[:work], written)
        nxt = 1
    assert (written == 1).all()
    src, dst = 0, second
    while nxt < k:
        ra, load = rounds[nxt], lambda i, s=scratch[src:].copy(): s[i]
        if vector(ra) and nxt + 1 == k:
            return finish(fold(load, ra, None, np.zeros(1, np.int64))[0])
        m = ra[2] * ra[3] if not vector(ra) else rounds[nxt + 1][2] * rounds[nxt + 1][3]
        if nxt + 1 == k:  # a 2-D last round: its sums stay in shared memory
            left = np.full(m, np.nan, np.float32)
            written = np.zeros(m, np.int64)
            _tile_round(load, ra, left, written)
            assert (written == 1).all()
            return finish(_last_block(left[:final_count], lanes, cols))
        out = scratch[dst : dst + m]
        assert out.size == m, "the scratch is too short"
        written = np.zeros(m, np.int64)
        if vector(ra):
            out[:] = fold(load, ra, rounds[nxt + 1], written)
            nxt += 2
        else:
            _tile_round(load, ra, out, written)
            nxt += 1
        assert (written == 1).all()
        src, dst = dst, src
    return finish(_last_block(scratch[src : src + final_count], lanes, cols))


def _last_block(values, lanes, cols):
    """``final_lanes`` (lanes > 1): lane j from +0 (the others from -0)
    adds the rows j, j + lanes, ... of the (k, cols) block in order, the
    lanes fold in halves, the rows past the last whole group add in order;
    else the chain."""
    if lanes <= 1:
        return _chain(values)
    block = values.reshape(-1, cols)
    whole = block.shape[0] // lanes * lanes
    acc = np.array([0.0] + [-0.0] * (lanes - 1), np.float32)
    for i in range(0, whole, lanes):
        for c in range(cols):
            acc = acc + block[i : i + lanes, c]
    while acc.size > 1:
        acc = acc[: acc.size // 2] + acc[acc.size // 2 :]
    total = acc[0]
    for x in block[whole:].reshape(-1):
        total = np.float32(total + x)
    return total


@pytest.mark.parametrize(
    "shape",
    [(1,), (31,), (32,), (33,), (1025,), (4038,), (201_920,), (100_003,),
     (32, 128), (192, 128), (1584, 128), (33, 70), (1, 1000), (1000, 1), (5, 7), (64_000, 10),
     (128, 128), (1000, 128), (600, 128), (2048, 128), (2000, 128)],
)
@pytest.mark.parametrize("mode", ["sum", "square", "product"])
def test_k6_layout_emulated_equals_the_plain_sums(shape, mode):
    """(c) K6's window assignment and rounds, emulated, against the plain
    sums: ``tree_sum_plain``/``tree_sum_2d_plain`` and the norm and dot
    built on them, with +0 and -0 among the inputs."""
    from eig_kl_tpu_torch.ops.reduce import (
        _products_plain, tree_dot, tree_norm, tree_norm_2d, tree_sum_2d_plain, tree_sum_plain,
    )

    rng = np.random.default_rng(sum(shape))
    v, w = _values(rng, shape, zeros=True), _values(rng, shape, zeros=True)
    tv, tw = torch.as_tensor(v), torch.as_tensor(w)
    if mode == "sum":
        want = (tree_sum_plain if len(shape) == 1 else tree_sum_2d_plain)(tv)
    elif mode == "square":
        want = (tree_norm if len(shape) == 1 else tree_norm_2d)(tv)
    elif len(shape) == 1:
        want = tree_dot(tv, tw)
    else:
        want = _products_plain(tv, tw, tree_sum_2d_plain)
    got = _k6_emulated(v, w, mode, root=mode == "square")
    assert _bits(got) == _bits(want)


@pytest.mark.parametrize("shape, word", [((4038,), 9), ((4038,), 17), ((1584, 128), 9), ((1584, 128), 16)])
def test_k6_layout_emulation_sees_a_wrong_pad(shape, word):
    """The emulation is not blind: a plan with a lead pad off by one (round
    1's or round 2's) changes the sum."""
    from eig_kl_tpu_torch.ops.reduce import k6_plan

    v = _values(np.random.default_rng(1), shape)
    words, scratch, second = k6_plan(shape)
    bad = list(words)
    bad[word] += 1
    right = _k6_emulated(v, v, "sum", root=False)
    wrong = _k6_emulated(v, v, "sum", root=False, plan=(bad, scratch, second))
    assert _bits(right) != _bits(wrong)


def test_f64_cpu_root_is_correctly_rounded():
    """The CPU's f64 root (``sqrt_rn``, of a vector and of 0-d values, and
    ``tree_norm`` of one value) equals ``math.sqrt`` bit for bit on 100,000
    seeded values, on which PyTorch's ``sqrt`` misses (ROADMAP.md C11)."""
    from eig_kl_tpu_torch.ops.reduce import sqrt_rn, tree_norm

    rng = np.random.default_rng(11)
    s = rng.random(100_000) * 10.0 ** rng.uniform(-3.0, 3.0, 100_000)
    want = np.array([math.sqrt(x) for x in s])
    squares = np.array([math.sqrt(x * x) for x in s])
    assert (torch.sqrt(torch.as_tensor(s)).numpy() != want).any()
    assert (torch.sqrt(torch.as_tensor(s * s)).numpy() != squares).any()
    np.testing.assert_array_equal(sqrt_rn(torch.as_tensor(s)).numpy().view(np.int64), want.view(np.int64))
    one = [float(sqrt_rn(torch.tensor(x, dtype=torch.float64))) for x in s[:5000]]
    np.testing.assert_array_equal(np.array(one).view(np.int64), want[:5000].view(np.int64))
    norms = np.array([float(tree_norm(torch.tensor([x], dtype=torch.float64))) for x in s])
    np.testing.assert_array_equal(norms.view(np.int64), squares.view(np.int64))


def test_sum_2d_of_one_row_is_the_1d_sum():
    from eig_kl_tpu_torch.ops.reduce import tree_sum_2d_plain, tree_sum_plain

    v = torch.as_tensor(_values(np.random.default_rng(2), 201_920))
    assert _bits(tree_sum_2d_plain(v.view(1, -1))) == _bits(tree_sum_plain(v))
    assert _bits(tree_sum_2d_plain(v.view(-1, 1))) == _bits(tree_sum_plain(v))


@pytest.fixture(scope="module")
def gen002_f32():
    """(JAX DeviceGraph, port DeviceGraph) of gen 0.02x at f32."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.io.hgr import read_hgr
    from eig_kl_tpu_torch.graph.csr import device_graph_from_jax

    g_host = clique_expand(read_hgr(GEN_002, use_native=False), "kl", use_native=False)
    g_jax = g_host.to_device(dtype="float32")
    return g_jax, device_graph_from_jax(
        np.asarray(g_jax.ell_indices), np.asarray(g_jax.ell_weights),
        np.asarray(g_jax.degrees), np.asarray(g_jax.total_weight), "cpu",
    )


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("shift", [2.0, 3.0])
def test_power_steps_equal_the_jax_steps(gen002_f32, shift, steps):
    """(d) The port's power steps (``power_step_plain``, the tree-ordered
    norm and ``normalize_plain``) against the JAX package's ``x - inv_shift
    * norm_lap(x)`` steps in its ``_power_core``, bit for bit.  At shift
    3.0 the step's last product is not exact, and XLA's fused multiply-add
    decides the bits."""
    from eig_kl_tpu.spectral.power import _power_core as jax_core
    from eig_kl_tpu_torch.spectral.power import _power_core

    g_jax, g = gen002_f32
    kw = dict(shift=shift, tolerance=1e-6, min_iters=100, max_iters=steps, seed=42, convergence="gkl2")
    lam_j, v_j, it_j = jax_core(g_jax, dtype="float32", **kw)
    lam_t, v_t, it_t = _power_core(g, dtype=torch.float32, **kw)
    assert it_t == it_j == steps
    np.testing.assert_array_equal(_bits(v_t), _bits(v_j))


def test_power_step_plain_at_shift_2_is_the_separately_rounded_sequence(gen002_f32):
    """At shift 2.0 the fused last operation changes no bit: the product
    by 0.5 is exact."""
    from eig_kl_tpu_torch.ops.spmv import power_step_plain, spmv_plain

    g = gen002_f32[1]
    x = torch.as_tensor(_values(np.random.default_rng(4), g.num_nodes))
    deg = torch.where(g.degrees > 0, g.degrees, 1.0)
    separate = x - 0.5 * (2.0 * x - 2.0 * spmv_plain(g, x) / deg)
    np.testing.assert_array_equal(_bits(power_step_plain(g, x, deg, 0.5)), _bits(separate))


def test_cpu_tensors_take_the_plain_versions():
    """(e) On CPU tensors the dispatch runs the plain versions and launches
    nothing; the kernels' wrappers refuse CPU tensors and count no launch."""
    from eig_kl_tpu_torch.ops import reduce as R
    from eig_kl_tpu_torch.ops.spmv import K1_STEP

    v = torch.as_tensor(_values(np.random.default_rng(3), 4038))
    counts = (R.K6.launches, R.K6_SCALE.launches, K1_STEP.launches)
    assert _bits(R.tree_sum(v)) == _bits(R.tree_sum_plain(v))
    assert _bits(R.tree_sum_2d(v.view(2, -1))) == _bits(R.tree_sum_2d_plain(v.view(2, -1)))
    nrm = R.tree_norm(v)
    np.testing.assert_array_equal(_bits(R.normalize(v, nrm)), _bits(R.normalize_plain(v, nrm)))
    with pytest.raises(ValueError, match="CUDA"):
        R.tree_sum_cuda(v)
    with pytest.raises(ValueError, match="CUDA"):
        R.tree_sum_cuda(v, v, root=True)
    with pytest.raises(ValueError, match="CUDA"):
        R.normalize_cuda(v, nrm)
    assert (R.K6.launches, R.K6_SCALE.launches, K1_STEP.launches) == counts
    # K4's batch: one plain chain per pair on the CPU, refused by the kernel.
    w = v.flip(0).contiguous()
    dots = R.fma_dot_batch((v, w, v), (w, w, v))
    assert dots.shape == (3,) and dots.dtype == torch.float32
    assert _bits(dots).tolist() == [int(_bits(R.fma_dot_plain(a, b))) for a, b in ((v, w), (w, w), (v, v))]
    k4 = R.K4.launches
    with pytest.raises(ValueError, match="CUDA"):
        R.fma_dot_batch_cuda((v, w), (w, w))
    assert R.K4.launches == k4


@pytest.mark.parametrize(
    "case, error, match",
    [("five pairs", ValueError, "1 to 4 pairs"), ("two lengths", ValueError, "one length"),
     ("strided", ValueError, "contiguous"), ("two dtypes", TypeError, "f32 or f64")],
)
def test_fma_dot_batch_on_the_cpu_refuses_what_k4_refuses(case, error, match):
    """The CPU's plain chains take the inputs the card's K4 takes, no more
    (tests/test_torch_cuda.py:test_k4_batch_refuses_what_it_cannot_run)."""
    from eig_kl_tpu_torch.ops import reduce as R

    x = torch.arange(20, dtype=torch.float32)
    xs = {"five pairs": [x] * 5, "two lengths": [x, x[:10]], "strided": [x, torch.arange(40.0).view(20, 2)[:, 0]],
          "two dtypes": [x, x.double()]}[case]
    with pytest.raises(error, match=match):
        R.fma_dot_batch(xs, xs)


def test_power_step_cuda_refuses_cpu_tensors(gen002_f32):
    from eig_kl_tpu_torch.ops.spmv import K1_STEP, power_step_cuda

    g = gen002_f32[1]
    x = torch.zeros(g.num_nodes)
    before = K1_STEP.launches
    with pytest.raises(ValueError, match="CUDA"):
        power_step_cuda(g, x, x, 0.5)
    assert K1_STEP.launches == before


def test_normalize_plain_keeps_a_zero_norm():
    from eig_kl_tpu_torch.ops.reduce import normalize_plain

    y = torch.tensor([1.0, -2.0, 0.0])
    assert torch.equal(normalize_plain(y, torch.tensor(0.0)), y)
    assert torch.equal(normalize_plain(y, torch.tensor(2.0)), torch.tensor([0.5, -1.0, 0.0]))


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    """A kernel's library name changes with the headers of ``csrc/`` it
    includes, directly or through another header, and not with a system
    header or a header it does not include."""
    from eig_kl_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  # include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "c.cuh").write_text("// c\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build, "_compiler_identity", lambda compiler: "nvcc 0")
    assert _build.included_headers(tmp_path / "k.cu") == [tmp_path / "a.cuh", tmp_path / "b.cuh"]
    first = _build.library_path("k")
    (tmp_path / "c.cuh").write_text("// c, changed\n")
    assert _build.library_path("k") == first
    (tmp_path / "b.cuh").write_text("// b, changed\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// a, changed\n')
    assert _build.library_path("k") not in (first, second)


# ------------------------------------------- dots with a producer fused in


@pytest.mark.parametrize("n", [160, 1000, 1031, 3694, 4038, 4095, 4096, 6000])
def test_fused_dot_lanes_equals_xla(n):
    """``fused_dot(x, y, "lanes")`` against ``jnp.vdot`` of an element-wise
    producer and a slice of a padded state, as the JAX package's mega cut
    and padded momentum dots take them (ROADMAP.md C5, C9): XLA fuses them
    into one loop below 4,096 values, which LLVM vectorizes (32 lanes, an
    8- or 4-lane epilogue, scalar steps); from 4,096 values up the dot is
    XLA's vector dot (``fma_dot``).  Bit for bit, remainders 0, 7, 8, 15,
    22, 31 and 30 among them."""
    from eig_kl_tpu_torch.ops.reduce import fused_dot

    P = -(-n // 128) * 128 + 128
    dot = jax.jit(lambda a, b2d: jnp.vdot(a * 1.5, b2d.reshape(-1)[:n]))
    rng = np.random.default_rng(n)
    for _ in range(3):
        a = _values(rng, n, zeros=True)
        b = _values(rng, P, zeros=True)
        want = dot(jnp.asarray(a), jnp.asarray(b.reshape(-1, 128)))
        got = fused_dot(torch.as_tensor(a) * 1.5, torch.as_tensor(b[:n]), "lanes")
        assert _bits(got) == _bits(want)


def test_fused_dot_orders_and_where_they_apply():
    """The "chain" order is one fused chain from +0 (``fma_dot_plain`` with
    no rounded products); from 4,096 f32 values up, and in f64, both orders
    are ``fma_dot``; the epilogue widths are those of the x86-64 code
    (remainder 6 and 7: 4 lanes, 12 and 20: 4, 8, 16, 24, 28, 31: 8); an
    unknown order is refused; K4's fused entry point refuses CPU tensors."""
    from eig_kl_tpu_torch.ops import reduce as R

    rng = np.random.default_rng(9)
    x, y = (torch.as_tensor(_values(rng, 16)) for _ in range(2))
    assert _bits(R.fused_dot(x, y, "chain")) == _bits(R.fma_dot_plain(x, y, unfused=0))
    assert _bits(R.fused_dot(x, y, "chain")) != _bits(R.fma_dot(x, y))  # 8 products rounded there
    x, y = (torch.as_tensor(_values(rng, 3000)) for _ in range(2))
    assert _bits(R.fused_dot(x, y, "chain")) == _bits(R.fma_dot_plain(x, y, unfused=0))
    big = torch.as_tensor(_values(rng, 4096))
    for order in R.FUSED_ORDERS:
        assert _bits(R.fused_dot(big, big.flip(0).contiguous(), order)) == _bits(R.fma_dot(big, big.flip(0).contiguous()))
        assert R.fused_dot(x.double(), y.double(), order) == R.fma_dot(x.double(), y.double())
    assert [R.dot_epilogue_width(r) for r in (0, 3, 4, 6, 7, 8, 12, 16, 20, 24, 28, 31)] == [0, 0, 4, 4, 4, 8, 4, 8, 4, 8, 8, 8]
    with pytest.raises(ValueError, match="order"):
        R.fused_dot(x, y, "tree")
    k4 = R.K4_FUSED.launches
    with pytest.raises(ValueError, match="CUDA"):
        R.fused_dot_batch_cuda((x,), (y,), "lanes")
    assert R.K4_FUSED.launches == k4
