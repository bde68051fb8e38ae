"""The port's multi-start, multi-pass and kicked refinement against the
JAX package's, on the CPU: the host-side pieces (``perturb_split``, the
kick seeds, the pass rules), the multi-pass and iterated-local-search loops
with a stub backend and with the real engine, and the slice as a whole
through ``fused_partition``, ``kl_partition`` and the CLI.

Tolerances.  The host-side pieces and everything on graphs with exact
binary-fraction weights: 0.  On gen 0.02x (weights 1/3, 1/5, 1/7) the JAX
package's CPU path is its XLA engine, whose f32 cut is a plain running sum
where the port's is Kahan-compensated: partitions, swap counts and pass
counts are equal (tolerance 0), cut values agree to 1e-5 relative.
"""

import dataclasses
import os
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kl import _port_graph, dyadic_hypergraph
from tests.test_torch_kl_batch import assert_results_equal

REPO = pathlib.Path(__file__).resolve().parent.parent
GEN_002 = str(REPO / "benchmarks" / "data" / "gen_0.02_42.hgr")
CUT_RTOL = 1e-5


# ------------------------------------------------------- host-side pieces


@pytest.mark.parametrize("frac", [0.0, 0.01, 0.05, 0.5, 1.0])
@pytest.mark.parametrize("seed", [0, 1, 12345])
def test_perturb_split_equals_jax(seed, frac):
    from eig_kl_tpu.kl.init import perturb_split as jax_perturb
    from eig_kl_tpu_torch.kl.init import perturb_split

    sides = (np.random.default_rng(7).random(301) < 0.4).astype(np.int8)
    got = perturb_split(sides, seed, frac)
    np.testing.assert_array_equal(got, jax_perturb(sides, seed, frac))
    assert got.sum() == sides.sum() and got.dtype == np.int8
    if frac == 0.0:
        np.testing.assert_array_equal(got, sides)
    # A Generator is drawn from in place, in the same order.
    np.testing.assert_array_equal(
        perturb_split(sides, np.random.default_rng(seed), frac),
        jax_perturb(sides, np.random.default_rng(seed), frac),
    )


@pytest.mark.parametrize("frac", [-0.1, 1.5])
def test_perturb_split_rejects_fractions_out_of_range(frac):
    from eig_kl_tpu_torch.kl.init import perturb_split

    with pytest.raises(ValueError, match=r"frac must be in \[0, 1\]"):
        perturb_split(np.zeros(8, np.int8), 0, frac)


def test_perturb_split_on_a_one_sided_split_is_a_copy():
    from eig_kl_tpu_torch.kl.init import perturb_split

    sides = np.zeros(10, np.int8)
    out = perturb_split(sides, 3, 0.5)
    np.testing.assert_array_equal(out, sides)
    assert out is not sides


@pytest.mark.parametrize("seed", [0, 1, 42, -1, 2**31 + 5])
def test_kick_seed_equals_jax(seed):
    from eig_kl_tpu.kl.multipass import _kick_seed as jax_kick_seed
    from eig_kl_tpu_torch.kl.multipass import _kick_seed

    got = [_kick_seed(seed, k) for k in range(6)]
    assert got == [jax_kick_seed(seed, k) for k in range(6)]
    assert len(set(got)) == 6
    assert not set(got) & {seed + 1 + i for i in range(64)}  # never a jitter seed


@pytest.mark.parametrize("passes", [0, 1, 3, 40, -1])
def test_resolved_passes_equals_jax(passes):
    from eig_kl_tpu.kl import multipass as jax_mp
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl import multipass as mp
    from eig_kl_tpu_torch.utils.config import KLConfig

    assert (mp.AUTO_PASS_CAP, mp._IMPROVE_EPS) == (jax_mp.AUTO_PASS_CAP, jax_mp._IMPROVE_EPS)
    if passes < 0:
        with pytest.raises(ValueError, match="passes must be >= 0"):
            mp.resolved_passes(KLConfig(passes=passes))
        return
    assert mp.resolved_passes(KLConfig(passes=passes)) == jax_mp.resolved_passes(
        JaxKLConfig(passes=passes)
    )


# ------------------------------------- the loops, with a stub backend


class StubBackend:
    """A refinement backend with scripted best cuts: call ``i`` returns a
    result whose best cut is ``cuts[i]`` and whose partitions encode ``i``,
    and records the sides it was given."""

    def __init__(self, result_type, cuts):
        self.result_type, self.cuts, self.calls = result_type, list(cuts), []

    def one(self, sides):
        i = len(self.calls)
        self.calls.append(np.array(sides))
        c = float(self.cuts[i])
        n = len(sides)
        return self.result_type(
            sides=np.full(n, i % 2, np.int8),
            best_sides=np.roll(np.asarray(sides, np.int8), i + 1),
            initial_cut=c + 10.0, final_cut=c + 1.0, best_cut=c, verified_cut=c + 1.0,
            iterations=i + 2,
            cut_trajectory=np.arange(i + 3, dtype=np.float32) + c,
            gain_trajectory=np.arange(i + 3, dtype=np.float32) - i,
        )

    def batch(self, batch):
        return [self.one(s) for s in batch]


def _stubs(cuts):
    from eig_kl_tpu.kl.result import KLResult as JaxResult
    from eig_kl_tpu_torch.kl.result import KLResult

    return StubBackend(KLResult, cuts), StubBackend(JaxResult, cuts)


def _assert_same_calls(mine, theirs):
    assert len(mine.calls) == len(theirs.calls)
    for a, b in zip(mine.calls, theirs.calls):
        np.testing.assert_array_equal(a, b)


SIDES = (np.arange(24) % 3 == 0).astype(np.int8)


@pytest.mark.parametrize(
    "passes, cuts, calls",
    [
        (1, [9, 8, 7], 1),  # one pass: the backend's result as it is
        (0, [9, 8, 8, 1], 3),  # stops at the first pass that does not improve
        (0, [9, 9 - 1e-10, 1], 2),  # an improvement below 1e-9 does not count
        (3, [9, 8, 7, 6], 3),  # stops at the pass limit
        (0, [9 - k for k in range(20)], 16),  # the cap of "until converged"
    ],
)
def test_refine_multipass_equals_jax_with_a_stub_backend(passes, cuts, calls):
    from eig_kl_tpu.kl.multipass import refine_multipass as jax_multipass
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl.multipass import refine_multipass
    from eig_kl_tpu_torch.utils.config import KLConfig

    mine, theirs = _stubs(cuts)
    got = refine_multipass(mine.one, SIDES, KLConfig(passes=passes))
    ref = jax_multipass(theirs.one, SIDES, JaxKLConfig(passes=passes))
    assert len(mine.calls) == calls
    _assert_same_calls(mine, theirs)
    assert_results_equal(got, ref)


@pytest.mark.parametrize("incumbent", [False, True])
@pytest.mark.parametrize(
    "cuts",
    [
        [9, 9, 7, 7, 8, 8],  # the first kick wins, the second loses
        [9, 9, 9.5, 9.5, 9.2, 9.2],  # no kick wins: the first descent stays
        [9, 8, 8, 5, 4, 4, 6, 6],  # descents of several passes
    ],
)
def test_refine_ils_equals_jax_with_a_stub_backend(cuts, incumbent):
    from eig_kl_tpu.kl.multipass import refine_ils as jax_ils
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl.multipass import refine_ils
    from eig_kl_tpu_torch.utils.config import KLConfig

    mine, theirs = _stubs(cuts)
    kw = dict(kicks=2, kick_frac=0.2, seed=11)
    inc_m = inc_t = None
    if incumbent:  # a converged descent to kick from: no leading re-descent
        inc_m, inc_t = mine.one(SIDES), theirs.one(SIDES)
    got = refine_ils(mine.one, SIDES, KLConfig(passes=0), incumbent=inc_m, **kw)
    ref = jax_ils(theirs.one, SIDES, JaxKLConfig(passes=0), incumbent=inc_t, **kw)
    _assert_same_calls(mine, theirs)
    assert_results_equal(got, ref)
    assert got.initial_cut == cuts[0] + 10.0  # the first descent's, whoever wins


@pytest.mark.parametrize(
    "passes, cuts, rounds",
    [
        (1, [9, 8, 7], 1),
        (0, [9, 8, 7, 8, 8, 6, 8, 8, 6], 3),  # start 2 improves in round 2, none in round 3
        (2, [9, 8, 7, 1, 1, 1, 0, 0, 0], 2),
    ],
)
def test_refine_multipass_batch_equals_jax_with_a_stub_backend(passes, cuts, rounds):
    from eig_kl_tpu.kl.multipass import refine_multipass_batch as jax_batch
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl.multipass import refine_multipass_batch
    from eig_kl_tpu_torch.utils.config import KLConfig

    mine, theirs = _stubs(cuts)
    init = np.stack([SIDES, 1 - SIDES, np.roll(SIDES, 1)])
    got = refine_multipass_batch(mine.batch, init, KLConfig(passes=passes))
    ref = jax_batch(theirs.batch, init, JaxKLConfig(passes=passes))
    assert len(mine.calls) == 3 * rounds
    _assert_same_calls(mine, theirs)
    for g, r in zip(got, ref):
        assert_results_equal(g, r)


# --------------------------------------- the loops, with the real engine


@pytest.fixture(scope="module")
def dyadic():
    """A 240-node graph with exact binary-fraction weights: the JAX
    package's host graph and mega-kernel graph, the port's f32 device
    graph, and a split."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.kl.megakernel import MegaGraph

    rng = np.random.default_rng(17)
    g_host = clique_expand(dyadic_hypergraph(rng, 240, 400), "kl", use_native=False)
    sides = (rng.random(240) < 0.5).astype(np.int8)
    return g_host, MegaGraph(g_host), _port_graph(g_host, torch.float32), sides


def test_refine_multipass_and_ils_equal_jax_on_the_real_engine(dyadic):
    from eig_kl_tpu.kl import multipass as jax_mp
    from eig_kl_tpu.kl.megakernel import refine_mega as jax_refine
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl import multipass as mp
    from eig_kl_tpu_torch.kl.megakernel import refine_mega
    from eig_kl_tpu_torch.utils.config import KLConfig

    _, mg, g, sides = dyadic
    cfg = dict(gain_eps=1e-6, passes=0)
    jax_fn = lambda s: jax_refine(mg, s, JaxKLConfig(**cfg), interpret=True)  # noqa: E731
    fn = lambda s: refine_mega(g, s, KLConfig(**cfg))  # noqa: E731
    ref = jax_mp.refine_multipass(jax_fn, sides, JaxKLConfig(**cfg))
    got = mp.refine_multipass(fn, sides, KLConfig(**cfg))
    assert got.iterations > refine_mega(g, sides, KLConfig(gain_eps=1e-6)).iterations  # > 1 pass
    assert_results_equal(got, ref)
    kw = dict(kicks=2, kick_frac=0.15, seed=4)
    assert_results_equal(
        mp.refine_ils(fn, sides, KLConfig(**cfg), **kw),
        jax_mp.refine_ils(jax_fn, sides, JaxKLConfig(**cfg), **kw),
    )


def test_multi_start_refine_mega_equals_jax(dyadic):
    from eig_kl_tpu.parallel.multi_start import multi_start_refine_mega as jax_multi
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.kl.init import perturb_split
    from eig_kl_tpu_torch.parallel import multi_start_refine_mega
    from eig_kl_tpu_torch.utils.config import KLConfig

    g_host, _, g, sides = dyadic
    cfg = dict(gain_eps=1e-6, passes=0)
    init = np.stack([sides] + [perturb_split(sides, 1 + i, 0.1) for i in range(2)])
    ref, ref_cuts = jax_multi(g_host, 3, config=JaxKLConfig(**cfg), init_sides=init)
    got, cuts = multi_start_refine_mega(g, 3, config=KLConfig(**cfg), init_sides=init)
    np.testing.assert_array_equal(cuts, ref_cuts)
    assert_results_equal(got, ref)
    # Two launches of two and one starts give what one launch of three gives.
    split, split_cuts = multi_start_refine_mega(
        g, 3, config=KLConfig(**cfg), init_sides=init, launch_chunk=2
    )
    np.testing.assert_array_equal(split_cuts, cuts)
    assert_results_equal(split, got)
    # Random splits from base_seed, one pass.
    ref1, ref1_cuts = jax_multi(g_host, 2, config=JaxKLConfig(gain_eps=1e-6), base_seed=5)
    got1, cuts1 = multi_start_refine_mega(g, 2, config=KLConfig(gain_eps=1e-6), base_seed=5)
    np.testing.assert_array_equal(cuts1, ref1_cuts)
    assert_results_equal(got1, ref1)
    with pytest.raises(ValueError, match="expected 4"):
        multi_start_refine_mega(g, 4, init_sides=init)


# ------------------------------------------------- the slice as a whole


def _hypergraphs():
    from eig_kl_tpu.io.hgr import read_hgr as jax_read
    from eig_kl_tpu_torch.io.hgr import read_hgr

    return jax_read(GEN_002, use_native=False), read_hgr(GEN_002)


def _assert_runs_agree(got, ref):
    """Partitions and counts equal; cut values to CUT_RTOL (module docstring)."""
    assert got.iterations == ref.iterations
    np.testing.assert_array_equal(got.sides, ref.sides)
    np.testing.assert_array_equal(got.best_sides, ref.best_sides)
    for name in ("initial_cut", "final_cut", "best_cut", "verified_cut"):
        assert getattr(got, name) == pytest.approx(getattr(ref, name), rel=CUT_RTOL), name
    np.testing.assert_allclose(got.cut_trajectory, ref.cut_trajectory, rtol=CUT_RTOL)


@pytest.fixture(scope="module")
def gen002_multi():
    """(JAX run, port run) of the fused pipeline on gen 0.02x at f32 with 3
    starts, passes until converged and one kick."""
    from eig_kl_tpu.models.pipelines import fused_partition as jax_fused
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.models.pipelines import fused_partition
    from eig_kl_tpu_torch.utils.config import KLConfig

    jax_hg, hg = _hypergraphs()
    cfg = dict(gain_eps=1e-6, passes=0, kicks=1)
    ref = jax_fused(jax_hg, starts=3, perturb=0.05, kl_config=JaxKLConfig(**cfg), dtype=jnp.float32)
    got = fused_partition(hg, starts=3, perturb=0.05, kl_config=KLConfig(**cfg), device="cpu")
    return ref, got


def test_fused_multi_start_matches_jax_on_gen002(gen002_multi):
    ref, got = gen002_multi
    np.testing.assert_array_equal(got.eig.sides, ref.eig.sides)
    assert got.spectral_iterations == 201
    _assert_runs_agree(got.kl, ref.kl)
    assert got.kl.iterations > 357  # more than the one pass of the one-start run
    assert got.kl.best_cut < 794.98  # and a smaller cut
    assert abs(got.kl.final_cut - got.kl.verified_cut) <= 1e-5 * got.kl.final_cut
    assert {"init", "spectral.total", "kl.refine", "kl.pass", "kl.finalize"} <= set(got.timings)


def test_fused_multi_start_per_start_cuts_match_jax(gen002_multi):
    """The per-start best cuts, which the JAX pipeline computes and drops:
    taken from its ``_multi_start_dispatch`` on the same spectral split."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.models.pipelines import _multi_start_dispatch as jax_dispatch
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig

    ref, got = gen002_multi
    g_host = clique_expand(_hypergraphs()[0], "kl", use_native=False)
    _, ref_cuts = jax_dispatch(
        g_host, g_host.to_device(dtype=jnp.float32), ref.eig.sides,
        JaxKLConfig(gain_eps=1e-6, passes=0), jnp.float32,
        starts=3, perturb=0.05, seed=0, perturb_base=True,
    )
    assert len(got.start_cuts) == 3
    np.testing.assert_allclose(got.start_cuts, ref_cuts, rtol=CUT_RTOL)
    assert got.kl.best_cut <= min(got.start_cuts)  # the kick starts from the winner


def test_fused_start_zero_is_the_one_start_run():
    """Start 0 is the unperturbed split, so one pass of a multi-start run
    holds the one-start fused run: its cut bounds the winner's."""
    from eig_kl_tpu_torch.models.pipelines import fused_partition

    hg = _hypergraphs()[1]
    one = fused_partition(hg, device="cpu")
    multi = fused_partition(hg, starts=2, device="cpu")
    assert multi.start_cuts[0] == one.kl.best_cut
    assert multi.kl.best_cut == min(multi.start_cuts)
    assert one.start_cuts is None


def test_fused_random_init_multi_start_matches_jax():
    from eig_kl_tpu.models.pipelines import fused_partition as jax_fused
    from eig_kl_tpu_torch.models.pipelines import fused_partition

    jax_hg, hg = _hypergraphs()
    ref = jax_fused(jax_hg, use_eig=False, starts=2, seed=3, dtype=jnp.float32)
    got = fused_partition(hg, use_eig=False, starts=2, seed=3, device="cpu")
    assert got.eig is None and got.spectral_iterations is None
    _assert_runs_agree(got.kl, ref.kl)


@pytest.mark.parametrize("kicks", [0, 1])
def test_kl_partition_multipass_matches_jax(kicks):
    from eig_kl_tpu.models.pipelines import kl_partition as jax_kl
    from eig_kl_tpu.utils.config import KLConfig as JaxKLConfig
    from eig_kl_tpu_torch.models.pipelines import kl_partition
    from eig_kl_tpu_torch.utils.config import KLConfig

    jax_hg, hg = _hypergraphs()
    cfg = dict(passes=3, kicks=kicks)
    ref = jax_kl(jax_hg, seed=3, kl_config=JaxKLConfig(**cfg), dtype=jnp.float32)
    got = kl_partition(hg, seed=3, kl_config=KLConfig(**cfg), device="cpu")
    one = kl_partition(hg, seed=3, device="cpu")
    assert got.kl.best_cut < one.kl.best_cut
    if kicks == 0:  # with kicks the swaps reported are the winning descent's own
        assert got.kl.iterations > one.kl.iterations
    _assert_runs_agree(got.kl, ref.kl)


def test_kl_partition_refresh_interval_runs_and_keeps_the_oracle():
    """f64 on a real circuit: the refreshed pass stays a valid KL pass (the
    recount equals the running cut, the best cut is on the trajectory).  A
    refreshed ``A @ s`` rounds differently from the updated one, so ties
    break differently and the pass takes another path than the unrefreshed
    one: only the size of the improvement is compared."""
    from eig_kl_tpu_torch.models.pipelines import kl_partition
    from eig_kl_tpu_torch.utils.config import KLConfig

    hg = _hypergraphs()[1]
    run = kl_partition(
        hg, seed=1, dtype=torch.float64, device="cpu", kl_config=KLConfig(refresh_interval=100)
    )
    kl = run.kl
    assert kl.iterations == len(kl.cut_trajectory) - 1 > 200
    assert kl.verified_cut == pytest.approx(kl.final_cut, rel=1e-12)
    assert kl.best_cut == kl.cut_trajectory.min()
    assert kl.best_cut < 0.4 * kl.initial_cut


# ------------------------------------------------------------------ CLI


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _cli(argv):
    from eig_kl_tpu_torch.cli.main import main

    return main(argv)


def _best(out):
    return float(re.search(r"Best cut size achieved\s*:\s*([\d.]+)", out).group(1))


def test_cli_fused_starts_passes_kicks(workdir, capsys, gen002_multi):
    argv = ["fused", GEN_002, "-EIG", "--device", "cpu", "--starts", "3", "--passes", "0", "--kicks", "1"]
    assert _cli(argv) == 0
    out = capsys.readouterr().out
    cuts = re.search(r"Multi-start best cuts: \[([^\]]*)\] \.\.\.", out).group(1).split(",")
    assert [float(c) for c in cuts] == sorted(round(c, 2) for c in gen002_multi[1].start_cuts)
    assert _best(out) == pytest.approx(gen002_multi[1].kl.best_cut, abs=0.01)
    for block in ("Final Results", "Verified cut size", "Power iterations: 201", "[kl.refine]"):
        assert block in out
    assert os.path.exists("results/gen_0.02_42.hgr_KL_CutSize_EIG_output.txt")


@pytest.mark.parametrize(
    "flags",
    [["--passes", "3"], ["--kicks", "1", "--kick-frac", "0.2"], ["--passes", "0", "--kicks", "1"]],
)
def test_cli_kl_passes_and_kicks_match_the_jax_cli(workdir, capsys, monkeypatch, flags):
    from eig_kl_tpu.cli.main import main as jax_cli

    # The JAX CLI's XLA engine, not its NumPy engine, which the port's f32
    # swaps are not held to.
    monkeypatch.setenv("EIG_KL_TPU_CPU_ENGINE", "xla")
    assert jax_cli(["kl", GEN_002, "--platform", "cpu", "--seed", "2", *flags]) == 0
    ref = _best(capsys.readouterr().out)
    assert _cli(["kl", GEN_002, "--device", "cpu", "--seed", "2", *flags]) == 0
    out = capsys.readouterr().out
    assert _best(out) == pytest.approx(ref, rel=1e-4)


def test_cli_kl_starts_from_the_eig_file(workdir, capsys):
    """``kl -EIG --starts N``: start 0 is the EIG file's split, the others
    jitter it; without -EIG the starts are random splits."""
    from eig_kl_tpu_torch.io.eigfile import eig_out_path
    from eig_kl_tpu_torch.kl.init import split_from_eig
    from eig_kl_tpu_torch.models.pipelines import kl_partition

    assert _cli(["eig", GEN_002, "--solver", "power", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert _cli(["kl", GEN_002, "-EIG", "--device", "cpu", "--starts", "2", "--gain-eps", "1e-6"]) == 0
    out = capsys.readouterr().out
    cuts = [float(c) for c in re.search(r"Multi-start best cuts: \[([^\]]*)\]", out).group(1).split(",")]
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.utils.config import KLConfig

    one = kl_partition(
        read_hgr(GEN_002), init=split_from_eig(eig_out_path(GEN_002)),
        kl_config=KLConfig(gain_eps=1e-6), device="cpu",
    )
    assert round(one.kl.best_cut, 2) in cuts and _best(out) == pytest.approx(min(cuts), abs=0.01)
    assert _cli(["kl", GEN_002, "--device", "cpu", "--starts", "2", "--seed", "3"]) == 0
    assert "Multi-start best cuts:" in capsys.readouterr().out


def test_cli_kl_starts_without_an_eig_file_fails_cleanly(workdir, capsys):
    assert _cli(["kl", GEN_002, "-EIG", "--device", "cpu", "--starts", "2"]) == 1
    assert "Error: file not found" in capsys.readouterr().err


def test_config_docstring_no_longer_says_not_ported():
    from eig_kl_tpu_torch.utils.config import KLConfig

    fields = {f.name for f in dataclasses.fields(KLConfig)}
    assert {"refresh_interval", "passes", "kicks", "kick_frac"} <= fields
    assert "not yet ported" not in KLConfig.__doc__.lower()
