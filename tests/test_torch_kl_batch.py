"""The port's batched KL pass (the batched K2's plain version), the batched
refinement and the kernel re-entry of ``refresh_interval`` against the JAX
package's, on the CPU.

* From the same ``sf0``/``a_s0`` bits, ``kl_pass_batch_plain`` against the
  TPU mega-kernel's batched form ``megakernel._run_batched`` in interpret
  mode, flat and hierarchical: scalars, final ``sf`` and the logs up to
  each start's ``iterations`` bitwise (tolerance 0).  The TPU kernel leaves
  stale staging content past ``iterations``; the port's logs are zero
  there, so every comparison stops at the iteration count.
* ``refine_mega_batch`` and ``refine_mega(refresh_interval=k)`` against the
  JAX functions of the same names in interpret mode on graphs whose weights
  are exact binary fractions: every sum is exact, so every ``KLResult``
  field is equal (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_hypergraph
from tests.test_torch_kl import _pass_inputs, _port_graph, dyadic_hypergraph

RESULT_SCALARS = ("initial_cut", "final_cut", "best_cut", "verified_cut", "iterations")
RESULT_ARRAYS = ("sides", "best_sides", "cut_trajectory", "gain_trajectory")


def assert_results_equal(got, ref):
    """Every KLResult field equal, tolerance 0."""
    for name in RESULT_SCALARS:
        assert getattr(got, name) == getattr(ref, name), name
    for name in RESULT_ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name), err_msg=name)


def _jax_mega_batch_pass(g_host, sf0, as0, cut0, best0, cap, term0, terminate_limit, gain_eps):
    """One launch of the TPU mega-kernel's batched form in interpret mode
    from the given f32 state; (sf, four logs) as [S, flat] arrays and the
    scalars as [S, 8]."""
    from eig_kl_tpu.kl import megakernel as M

    mg = M.MegaGraph(g_host)
    n = mg.num_nodes
    P = M._round_up(mg.padded_nodes, 1024)  # the batched form's 8-row stripes
    S = len(cap)
    sf_p = np.zeros((S, P), np.float32)
    as_p = np.zeros((S, P), np.float32)
    sf_p[:, :n], as_p[:, :n] = sf0, as0
    out = M._run_batched(
        mg.meta_indices, mg.meta_weights,
        jnp.asarray(sf_p.reshape(S, P // 128, 128)), jnp.asarray(as_p.reshape(S, P // 128, 128)),
        jnp.asarray(np.stack([cut0, best0]), jnp.float32),
        jnp.asarray(np.stack([cap, term0]), jnp.int32),
        num_nodes=n, max_iters=int(max(cap)), terminate_limit=terminate_limit,
        gain_eps=gain_eps, interpret=True,
    )
    sf, lc, lg, la, lb, sc = (np.asarray(a) for a in out)
    flat = [a.reshape(S, -1) for a in (sf, lc, lg, la, lb)]
    return flat[0][:, :n], flat[1], flat[2], flat[3], flat[4], sc.T


@pytest.mark.parametrize("hierarchical", [False, True])
def test_kl_pass_batch_plain_equals_tpu_batched_kernel_bitwise(hierarchical, monkeypatch):
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.kl import megakernel as M
    from eig_kl_tpu_torch.kl.megakernel import kl_pass_batch_plain

    if hierarchical:  # the row-max cache form the TPU kernel takes above 131,072 nodes
        monkeypatch.setattr(M, "HIER_THRESHOLD", 0)
    M._run_batched.clear_cache()  # the form is fixed when _run_batched is traced
    rng = np.random.default_rng(21)
    g_host = clique_expand(random_hypergraph(rng, num_nodes=260, num_nets=330), "kl", use_native=False)
    g = _port_graph(g_host, torch.float32)
    n, S = g.num_nodes, 3
    sides = (rng.random((S, n)) < 0.5).astype(np.int8)
    inputs = [_pass_inputs(g, sides[k], torch.float32) for k in range(S)]
    sf0 = torch.stack([i[0] for i in inputs])
    as0 = torch.stack([i[1] for i in inputs])
    cut0 = np.array([i[2] for i in inputs], np.float32)
    # Start 0 runs to its end; start 1 has a zero cap; start 2 enters with a
    # best cut below its cut and a termination count carried in.
    best0 = cut0.copy()
    best0[2] = cut0[2] - np.float32(7.5)
    cap = np.array([min(sides[0].sum(), n - sides[0].sum()), 0, 40], np.int32)
    term0 = np.array([0, 0, 5], np.int32)
    tl, eps = 12, 1e-6
    ref = _jax_mega_batch_pass(g_host, sf0.numpy(), as0.numpy(), cut0, best0, cap, term0, tl, eps)
    M._run_batched.clear_cache()
    got = kl_pass_batch_plain(
        g, sf0, as0, torch.as_tensor(cut0), torch.as_tensor(best0),
        torch.as_tensor(cap), torch.as_tensor(term0), int(cap.max()) + 1, tl, eps,
    )
    its = ref[5][:, 2].astype(int)
    assert its[0] > 10 and its[1] == 0 and 0 < its[2] <= 40
    assert ref[5][2, 1] <= best0[2] < cut0[2]  # best starts at min(cut0, best0)
    np.testing.assert_array_equal(got.scalars.numpy(), ref[5])
    np.testing.assert_array_equal(got.sf.numpy(), ref[0])
    logs = (got.log_cut, got.log_gain, got.log_a, got.log_b)
    for k in range(S):
        for mine, theirs in zip(logs, ref[1:5]):
            np.testing.assert_array_equal(mine[k].numpy()[: its[k] + 1], theirs[k][: its[k] + 1])
        assert not logs[0][k, its[k] + 1 :].any()  # zero past the run


def test_kl_pass_batch_start_equals_single_pass():
    """A batch is S independent passes: start k equals ``kl_pass_plain``
    from the same state, and a zero cap runs no swap but writes scalars."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu_torch.kl.megakernel import kl_pass_batch, kl_pass_plain

    rng = np.random.default_rng(5)
    g = _port_graph(clique_expand(random_hypergraph(rng, 150, 200), "kl", use_native=False), torch.float32)
    sides = (rng.random((2, 150)) < 0.5).astype(np.int8)
    inputs = [_pass_inputs(g, s, torch.float32) for s in sides]
    cut0 = torch.tensor([i[2] for i in inputs])
    cap = torch.tensor([60, 0], dtype=torch.int32)
    got = kl_pass_batch(
        g, torch.stack([i[0] for i in inputs]), torch.stack([i[1] for i in inputs]),
        cut0, cut0, cap, torch.zeros(2, dtype=torch.int32), 61, 12, 0.0,
    )
    one = kl_pass_plain(g, inputs[0][0], inputs[0][1], inputs[0][2], 60, 12, 0.0)
    for name in ("sf", "log_cut", "log_gain", "log_a", "log_b", "scalars"):
        assert torch.equal(getattr(got.start(0), name), getattr(one, name)), name
    idle = got.start(1).scalars
    assert idle[2] == 0 and idle[0] == idle[1] == idle[6] == cut0[1]
    assert torch.equal(got.sf[1], inputs[1][0])


def test_kl_pass_batch_kernel_wrapper_refuses_cpu_tensors():
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu_torch.kl.megakernel import K2, K2_STARTS, kl_pass_batch, kl_pass_batch_cuda

    rng = np.random.default_rng(5)
    g = _port_graph(clique_expand(random_hypergraph(rng, 40, 60), "kl", use_native=False), torch.float32)
    s = torch.ones(2, 40)
    f, i = torch.zeros(2), torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kl_pass_batch_cuda(g, s, s, f, f, i, i, 2, 5, 0.0)
    before = K2.launches, sum(K2_STARTS.values())
    kl_pass_batch(g, s, s, f, f, i, i, 2, 5, 0.0)  # all on side 0: no swap, plain version
    assert (K2.launches, sum(K2_STARTS.values())) == before


@pytest.mark.parametrize(
    "num_nodes, row_width, selection, words",
    [
        (4038, 48, "flat", None),  # gen 0.02x
        (9_999, 48, "flat", None),
        (10_000, 48, "shared", 2 * 79 + 3 + 79),  # the list no longer than the rows
        (201_920, 48, "shared", 2 * 1578 + 50 + 98),  # gen 1.0x
        (3_230_720, 48, "shared", 2 * 25_240 + 789 + 98),  # gen 16x
        (4_000_000, 48, "global", 2 * 31_250 + 977 + 98),
        (20_000, 1300, "shared", 2 * 157 + 5 + 157),
    ],
)
def test_k2_selection_and_cache_layout(num_nodes, row_width, selection, words):
    """K2's flat scan below the measured crossover, the row-max cache in
    shared memory up to the 227 KB opt-in, in global memory above; the
    cache's words per start: both sides' maxima per 128-node row, a dirty
    bit per row, a list of the rows one swap can touch."""
    from eig_kl_tpu_torch.kl.megakernel import K2_SHARED_CACHE_BYTES, ROW, k2_cache_words, k2_selection

    assert k2_selection(num_nodes, row_width) == selection
    if words is not None:
        got, cap = k2_cache_words(-(-num_nodes // ROW) * ROW, row_width)
        assert got == words and cap <= 2 * row_width + 2
        assert (4 * got <= K2_SHARED_CACHE_BYTES) == (selection == "shared")


def _dyadic(seed, num_nodes, num_nets):
    from eig_kl_tpu.graph.expand import clique_expand

    rng = np.random.default_rng(seed)
    g_host = clique_expand(dyadic_hypergraph(rng, num_nodes, num_nets), "kl", use_native=False)
    return rng, g_host


@pytest.mark.parametrize("max_iterations", [None, 25])
def test_refine_mega_batch_matches_jax_and_single_start(max_iterations):
    from eig_kl_tpu.kl.megakernel import MegaGraph, refine_mega_batch as jax_batch
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl.megakernel import refine_mega, refine_mega_batch
    from eig_kl_tpu_torch.utils.config import KLConfig

    rng, g_host = _dyadic(8, 220, 360)
    # Unequal splits: every start has its own natural cap.
    sides = np.stack([(rng.random(220) < p).astype(np.int8) for p in (0.5, 0.3, 0.6)])
    cfg = dict(gain_eps=1e-6, max_iterations=max_iterations)
    ref = jax_batch(MegaGraph(g_host), sides, JaxKLConfig(**cfg), interpret=True)
    g = _port_graph(g_host, torch.float32)
    got = refine_mega_batch(g, sides, KLConfig(**cfg))
    assert len(got) == len(ref) == 3
    assert got[0].iterations > 10
    for k in range(3):
        assert_results_equal(got[k], ref[k])
        assert_results_equal(got[k], refine_mega(g, sides[k], KLConfig(**cfg)))


@pytest.mark.parametrize("interval", [7, 1000])
def test_refine_mega_refresh_interval_matches_jax(interval):
    """Kernel re-entry with one start: chunks of ``interval`` swaps, the
    best cut and the termination count carried across (``interval`` 1000
    is one chunk: the re-entry path with nothing to splice)."""
    from eig_kl_tpu.kl.megakernel import MegaGraph, refine_mega as jax_refine
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl.megakernel import refine_mega
    from eig_kl_tpu_torch.utils.config import KLConfig

    rng, g_host = _dyadic(9, 200, 320)
    sides = (rng.random(200) < 0.5).astype(np.int8)
    cfg = dict(gain_eps=1e-6, refresh_interval=interval)
    ref = jax_refine(MegaGraph(g_host), sides, JaxKLConfig(**cfg), interpret=True)
    g = _port_graph(g_host, torch.float32)
    got = refine_mega(g, sides, KLConfig(**cfg))
    assert got.iterations == ref.iterations > 2 * 7
    assert_results_equal(got, ref)
    # Exact arithmetic: the refreshes change nothing, so the chunked pass
    # equals the unchunked one.
    assert_results_equal(got, refine_mega(g, sides, KLConfig(gain_eps=1e-6)))


def test_refine_mega_batch_refresh_matches_jax():
    """Batched re-entry: starts stop at different chunks and ride along
    with a zero cap; one start is capped by ``max_iterations``."""
    from eig_kl_tpu.kl.megakernel import MegaGraph, refine_mega_batch as jax_batch
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl.megakernel import refine_mega, refine_mega_batch
    from eig_kl_tpu_torch.utils.config import KLConfig

    rng, g_host = _dyadic(10, 200, 320)
    sides = np.stack([(rng.random(200) < p).astype(np.int8) for p in (0.5, 0.08, 0.45)])
    cfg = dict(gain_eps=1e-6, refresh_interval=9, max_iterations=50)
    ref = jax_batch(MegaGraph(g_host), sides, JaxKLConfig(**cfg), interpret=True)
    g = _port_graph(g_host, torch.float32)
    got = refine_mega_batch(g, sides, KLConfig(**cfg))
    assert sorted(r.iterations for r in got)[0] <= 16 < got[0].iterations
    for k in range(3):
        assert_results_equal(got[k], ref[k])
        assert_results_equal(got[k], refine_mega(g, sides[k], KLConfig(**cfg)))


def test_refine_mega_batch_checks_its_input():
    from eig_kl_tpu_torch.kl.megakernel import refine_mega_batch

    _, g_host = _dyadic(3, 50, 80)
    with pytest.raises(ValueError, match=r"\(S, 50\)"):
        refine_mega_batch(_port_graph(g_host, torch.float32), np.zeros((2, 49), np.int8))
