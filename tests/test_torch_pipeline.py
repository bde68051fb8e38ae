"""The port end to end on the CPU: the fused, KL and spectral pipelines
against the JAX package's, the CLI, the default device, and the rule
that the port imports neither JAX nor the JAX package.
"""

import ast
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
GEN_002 = str(REPO / "benchmarks" / "data" / "gen_0.02_42.hgr")


@pytest.fixture(scope="module")
def gen002_fused():
    """(JAX run, port run) of the fused pipeline on gen 0.02x at f32."""
    from eig_kl_tpu.io.hgr import read_hgr as jax_read
    from eig_kl_tpu.models.pipelines import fused_partition as jax_fused
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.models.pipelines import fused_partition

    ref = jax_fused(jax_read(GEN_002, use_native=False), dtype=jnp.float32)
    got = fused_partition(read_hgr(GEN_002), dtype=torch.float32, device="cpu")
    return ref, got


def test_fused_f32_matches_jax_on_gen002(gen002_fused):
    ref, got = gen002_fused
    kl, rkl = got.kl, ref.kl
    assert kl.initial_cut == pytest.approx(rkl.initial_cut, rel=1e-4)
    assert abs(kl.best_cut - rkl.best_cut) <= 0.02 * rkl.best_cut
    assert abs(kl.final_cut - kl.verified_cut) <= 1e-5 * kl.final_cut
    # The figures the JAX package gives here (201 power iterations,
    # initial cut 1,041.85, best cut 794.98 after 357 swaps).
    assert got.spectral_iterations == 201
    assert rkl.initial_cut == pytest.approx(1041.85, abs=0.01)
    assert rkl.best_cut == pytest.approx(794.98, abs=0.01)


def test_fused_f32_reproduces_the_jax_split_and_swaps(gen002_fused):
    """Every sum of the power solve runs in XLA's CPU order, so the port
    lands on the JAX package's split and swap sequence exactly."""
    ref, got = gen002_fused
    np.testing.assert_array_equal(got.eig.sides, ref.eig.sides)
    np.testing.assert_array_equal(got.eig.values.astype(np.float32), ref.eig.values.astype(np.float32))
    assert got.eig.median == ref.eig.median
    assert got.kl.iterations == ref.kl.iterations == 357
    np.testing.assert_array_equal(got.kl.sides, ref.kl.sides)
    np.testing.assert_array_equal(got.kl.best_sides, ref.kl.best_sides)
    np.testing.assert_allclose(got.kl.cut_trajectory, ref.kl.cut_trajectory, rtol=1e-5)


def _dyadic_hypergraph(seed, num_nodes, num_nets):
    from eig_kl_tpu.io.hgr import Hypergraph

    rng = np.random.default_rng(seed)
    sizes = rng.choice([2, 3, 5], size=num_nets, p=[0.6, 0.25, 0.15])
    pins = np.concatenate([rng.choice(num_nodes, k, replace=False) for k in sizes])
    offs = np.zeros(num_nets + 1, np.int64)
    np.cumsum(sizes, out=offs[1:])
    return Hypergraph(num_nodes, num_nets, pins.astype(np.int32), offs, name="dyadic.hgr")


def test_fused_f64_matches_jax():
    """f64, on a graph with exact binary-fraction weights, with the sign
    exit: the same split, the same swaps, the same cuts.  (The f64 default
    exit "gkl2" runs all 1,000 steps here, until most nodes tie with the
    median to the last bit and the split is decided by rounding.)"""
    from eig_kl_tpu.models.pipelines import fused_partition as jax_fused
    from eig_kl_tpu.utils.config import KLConfig as JaxKL
    from eig_kl_tpu.utils.config import SpectralConfig as JaxSpec
    from eig_kl_tpu_torch.io.hgr import Hypergraph
    from eig_kl_tpu_torch.models.pipelines import fused_partition
    from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig

    ref_hg = _dyadic_hypergraph(3, 600, 900)
    hg = Hypergraph(ref_hg.num_nodes, ref_hg.num_nets, ref_hg.pins, ref_hg.net_offsets)
    ref = jax_fused(
        ref_hg, dtype=jnp.float64, kl_config=JaxKL(gain_eps=1e-6),
        spectral_config=JaxSpec(solver="power", convergence="sign"),
    )
    got = fused_partition(
        hg, dtype=torch.float64, device="cpu", kl_config=KLConfig(gain_eps=1e-6),
        spectral_config=SpectralConfig(solver="power", convergence="sign"),
    )
    np.testing.assert_array_equal(got.eig.sides, ref.eig.sides)
    assert got.kl.iterations == ref.kl.iterations > 10
    np.testing.assert_array_equal(got.kl.sides, ref.kl.sides)
    np.testing.assert_array_equal(got.kl.best_sides, ref.kl.best_sides)
    for name in ("initial_cut", "best_cut", "final_cut", "verified_cut"):
        assert getattr(got.kl, name) == pytest.approx(getattr(ref.kl, name), rel=1e-9), name


def test_kl_partition_matches_jax_random_init():
    from eig_kl_tpu.io.hgr import read_hgr as jax_read
    from eig_kl_tpu.models.pipelines import kl_partition as jax_kl
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.models.pipelines import kl_partition

    ref = jax_kl(jax_read(GEN_002, use_native=False), seed=3, dtype=jnp.float32)
    got = kl_partition(read_hgr(GEN_002), seed=3, dtype=torch.float32, device="cpu")
    assert got.kl.iterations == ref.kl.iterations > 100
    np.testing.assert_array_equal(got.kl.sides, ref.kl.sides)
    np.testing.assert_array_equal(got.kl.best_sides, ref.kl.best_sides)
    assert got.kl.best_cut == pytest.approx(ref.kl.best_cut, rel=1e-4)
    assert got.nnz == ref.nnz


def test_spectral_partition_matches_jax_f64():
    from eig_kl_tpu.io.hgr import read_hgr as jax_read
    from eig_kl_tpu.models.pipelines import spectral_partition as jax_spectral
    from eig_kl_tpu.utils.config import SpectralConfig as JaxSpec
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.models.pipelines import spectral_partition
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    cfg = dict(solver="power", convergence="sign")
    ref = jax_spectral(jax_read(GEN_002, use_native=False), JaxSpec(**cfg), dtype=jnp.float64)
    got = spectral_partition(read_hgr(GEN_002), SpectralConfig(**cfg), device="cpu")
    assert got.eig.eigenvalue == pytest.approx(ref.eig.eigenvalue, abs=1e-10)
    # Every side but those of the nodes whose value is the median itself
    # (4 of the 4,038): their side is decided by the rounding (ROADMAP.md C4).
    off = ref.eig.values != ref.eig.median
    assert off.sum() >= 0.99 * len(off)
    np.testing.assert_array_equal(got.eig.sides[off], ref.eig.sides[off])


@pytest.mark.parametrize("entry", ["fused", "kl", "spectral"])
def test_default_device_is_the_card(entry, monkeypatch):
    """With no device argument and no card, an entry point raises; it
    does not fall back to the CPU."""
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.models import pipelines

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"fused": pipelines.fused_partition, "kl": pipelines.kl_partition,
          "spectral": pipelines.spectral_partition}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(read_hgr(GEN_002))


@pytest.mark.parametrize("solver", ["lanczos", "lobpcg"])
def test_spectral_partition_other_solvers_match_jax(solver):
    """``spectral_partition`` with Lanczos or LOBPCG (f64 on the CPU) on the
    largest component of gen 0.02x, against the JAX package's."""
    from eig_kl_tpu.models.pipelines import spectral_partition as jax_spectral
    from eig_kl_tpu.utils.config import SpectralConfig as JaxSpec
    from eig_kl_tpu_torch.models.pipelines import spectral_partition
    from eig_kl_tpu_torch.utils.config import SpectralConfig
    from test_torch_lanczos import circuit

    hg, jhg = circuit("lcc")
    ref = jax_spectral(jhg, JaxSpec(solver=solver), dtype=jnp.float64)
    got = spectral_partition(hg, SpectralConfig(solver=solver), device="cpu")
    assert got.eig.eigenvalue == pytest.approx(ref.eig.eigenvalue, abs=1e-10)
    assert got.spectral_iterations is None and got.spectral_solve.solver == solver
    assert got.spectral_solve.refined is None  # f64: no host refinement


@pytest.mark.parametrize("solver", ["lanczos", "lobpcg"])
def test_fused_partition_other_solvers_match_jax(solver):
    """``fused_partition`` at f32 with Lanczos or LOBPCG (and the host
    refinement): the spectral split of the "eig" graph, then KL on the KL
    graph.  The f32 vectors differ in their last bits and may be negated,
    so the split is compared up to the mirror and the cuts within 2 %."""
    from eig_kl_tpu.models.pipelines import fused_partition as jax_fused
    from eig_kl_tpu.utils.config import SpectralConfig as JaxSpec
    from eig_kl_tpu_torch.models.pipelines import fused_partition
    from eig_kl_tpu_torch.utils.config import SpectralConfig
    from test_torch_lanczos import circuit

    hg, jhg = circuit("lcc")
    ref = jax_fused(jhg, spectral_config=JaxSpec(solver=solver), dtype=jnp.float32)
    got = fused_partition(hg, spectral_config=SpectralConfig(solver=solver), device="cpu")
    assert got.eig.eigenvalue == pytest.approx(ref.eig.eigenvalue, rel=1e-6)
    sign = 1 if got.eig.values @ ref.eig.values >= 0 else -1
    clear = np.abs(ref.eig.values - ref.eig.median) > 1e-9
    sides = got.eig.sides if sign > 0 else 1 - got.eig.sides
    np.testing.assert_array_equal(sides[clear], ref.eig.sides[clear])
    assert got.kl.initial_cut == pytest.approx(ref.kl.initial_cut, rel=1e-4)
    assert abs(got.kl.best_cut - ref.kl.best_cut) <= 0.02 * ref.kl.best_cut
    assert abs(got.kl.final_cut - got.kl.verified_cut) <= 1e-5 * got.kl.final_cut
    assert got.spectral_solve.solver == solver and got.spectral_iterations is None


# ---------------------------------------------------------------- CLI


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _port_cli(argv):
    from eig_kl_tpu_torch.cli.main import main

    return main(argv)


def _trajectory(path):
    rows = [line.rstrip("\n").split("\t") for line in open(path)]
    assert all(len(r) == 3 for r in rows)
    return np.array([[float(v) for v in r] for r in rows])


def test_cli_fused_writes_the_jax_cli_files(workdir, capsys):
    from eig_kl_tpu.cli.main import main as jax_cli

    assert jax_cli(["fused", GEN_002, "-EIG", "--platform", "cpu"]) == 0
    out_file = "results/gen_0.02_42.hgr_KL_CutSize_EIG_output.txt"
    ref = _trajectory(out_file)
    os.remove(out_file)
    capsys.readouterr()
    assert _port_cli(["fused", GEN_002, "-EIG", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = _trajectory(out_file)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[:, 0], np.arange(len(got)))
    np.testing.assert_allclose(got[:, 1:], ref[:, 1:], rtol=1e-5, atol=1e-4)
    for block in ("Matrix Statistics", "Final Results", "Verified cut size", "Power iterations: 201"):
        assert block in out
    best = float(re.search(r"Best cut size achieved\s*:\s*([\d.]+)", out).group(1))
    assert best == pytest.approx(794.98, abs=0.01)


def test_cli_generate_eig_and_kl(workdir, capsys):
    from eig_kl_tpu.io.eigfile import read_eig_file as jax_read_eig

    assert _port_cli(["generate", "0.002", "-o", "c.hgr", "--seed", "4"]) == 0
    assert _port_cli(["eig", "c.hgr", "--solver", "power", "--device", "cpu"]) == 0
    eig = jax_read_eig("pre_saved_EIG/c.hgr_out.txt")  # the JAX reader takes the file
    assert eig.num_nodes == 403 and 0 < int(eig.sides.sum()) <= 403 // 2
    assert _port_cli(["kl", "c.hgr", "-EIG", "--device", "cpu", "--table"]) == 0
    out = capsys.readouterr().out
    assert "KL Iterations" in out and "Verified cut size" in out
    assert os.path.exists("results/c.hgr_KL_CutSize_EIG_output.txt")
    assert _port_cli(["info"]) == 0


def test_cli_missing_file(workdir, capsys):
    assert _port_cli(["fused", "nope.hgr", "-EIG", "--device", "cpu"]) == 1
    assert "Error: file not found: nope.hgr" in capsys.readouterr().err


def _connected_circuit(path, num_nodes=200, num_nets=260):
    """A connected random circuit of at most 256 nodes, written to ``path``
    ("auto" resolves to Lanczos there)."""
    from conftest import random_hypergraph
    from eig_kl_tpu_torch.io.hgr import Hypergraph, write_hgr
    from test_torch_lanczos import largest_component

    hg = random_hypergraph(np.random.default_rng(8), num_nodes, num_nets, 5)
    hg = largest_component(Hypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets))
    write_hgr(path, hg)
    return hg


def test_cli_eig_runs_lanczos_by_default(workdir, capsys):
    """``eig`` with no ``--solver`` runs Lanczos (f64 on the CPU), and its
    EIG file matches the JAX CLI's: lambda_2 within 1e-10, the split up to
    the mirror."""
    from eig_kl_tpu.cli.main import main as jax_cli
    from eig_kl_tpu.io.eigfile import read_eig_file
    from eig_kl_tpu_torch.io.hgr import write_hgr
    from test_torch_lanczos import circuit

    write_hgr("lcc.hgr", circuit("lcc")[0])
    assert jax_cli(["eig", "lcc.hgr", "--platform", "cpu"]) == 0
    ref = read_eig_file("pre_saved_EIG/lcc.hgr_out.txt")
    os.remove("pre_saved_EIG/lcc.hgr_out.txt")
    capsys.readouterr()
    assert _port_cli(["eig", "lcc.hgr", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = read_eig_file("pre_saved_EIG/lcc.hgr_out.txt")
    assert got.eigenvalue == pytest.approx(ref.eigenvalue, abs=1e-10)
    assert f"lambda_2 = {got.eigenvalue:.12g}" in out and "balance  = 1847 / 1847" in out
    mirrored = got.values @ ref.values < 0
    clear = np.abs(ref.values - ref.median) > 1e-9
    sides = 1 - got.sides if mirrored else got.sides
    np.testing.assert_array_equal(sides[clear], ref.sides[clear])


def test_cli_fused_auto_solver_on_a_tiny_circuit_runs_lanczos(workdir, capsys):
    """``fused -EIG`` on a circuit of at most 256 nodes: "auto" resolves to
    Lanczos (f32 plus the host refinement), as in the JAX CLI, whose
    trajectory file it matches in length and best cut."""
    from eig_kl_tpu.cli.main import main as jax_cli

    hg = _connected_circuit("t.hgr")
    assert hg.num_nodes <= 256
    assert jax_cli(["fused", "t.hgr", "-EIG", "--platform", "cpu"]) == 0
    out_file = "results/t.hgr_KL_CutSize_EIG_output.txt"
    ref = _trajectory(out_file)
    os.remove(out_file)
    capsys.readouterr()
    assert _port_cli(["fused", "t.hgr", "-EIG", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = _trajectory(out_file)
    assert "Lanczos restarts:" in out and "Power iterations" not in out
    assert got[0, 1] == pytest.approx(ref[0, 1], rel=1e-4)  # the spectral split's cut
    assert got[:, 1].min() == pytest.approx(ref[:, 1].min(), rel=0.02)


def test_cli_kl_sharded_is_not_ported(workdir, capsys):
    """``kl --sharded`` was refused with ROADMAP.md A8b's name until the
    engines across ranks were ported; it now runs at one rank and refuses
    nothing (tests/test_torch_sharded.py holds its result to ``kl``'s)."""
    assert _port_cli(["kl", GEN_002, "--sharded", "--device", "cpu"]) == 0
    out = capsys.readouterr()
    assert "Final Results" in out.out and "not yet ported" not in out.err + out.out


def test_cli_default_device_needs_a_card(workdir, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _port_cli(["fused", GEN_002, "-EIG"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# ------------------------------------------------------- no JAX in the port


def _port_files():
    files = sorted((REPO / "eig_kl_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    return files


def test_port_source_imports_no_jax():
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "eig_kl_tpu"), f"{path}: imports {name}"


def test_port_modules_import_without_jax():
    mods = [
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in _port_files()
        if p.name != "chip_smoke.py"
    ]
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'eig_kl_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.replace('.__init__', ''))\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_never_loads_the_jax_native_library():
    """The port parses, expands and routes with its own host library,
    never the JAX package's ``native/libeigkl.so``."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'eig_kl_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from eig_kl_tpu_torch.io.hgr import read_hgr\n"
        "from eig_kl_tpu_torch.graph.expand import clique_expand\n"
        "from eig_kl_tpu_torch.ops.spmv_v3 import build_plan_v3_for_graph\n"
        f"g = clique_expand(read_hgr({GEN_002!r}, use_native=True), 'kl', use_native=True)\n"
        "build_plan_v3_for_graph(g, 'cpu')\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'eigkl_native-' in maps, 'the port did not load its own library'\n"
        "assert 'libeigkl' not in maps, 'the port loaded native/libeigkl.so'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
        env=env, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
