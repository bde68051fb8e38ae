"""The port's engines across ranks (``eig_kl_tpu_torch.parallel``: the mesh,
``sharded_refine``, ``sharded_refine_oc``, ``sharded_power_fiedler``,
``multi_start_refine_mega_sharded``, ``smega_refine`` on a mesh) against the
JAX package on its 8 virtual CPU devices, and ``kl --sharded`` against the
unsharded ``kl``.

The port's ranks are processes: one gloo group of 2 ranks and one of 4,
each started once for the module, each rank on one thread, running every
case of its world and writing its results for the tests to read.  Each
group has a 60 s timeout and the processes a deadline (300 s), after
which they are killed, so a hang fails the tests instead of stalling the run.

Tolerances: the KL engines equal the JAX engines bit for bit (swap logs,
cut and gain trajectories, sides, best sides, initial, final, best and
verified cuts): the JAX ``psum`` over the CPU's virtual devices adds in
device order, which :meth:`Mesh.sum` repeats.  The bf16 case is held to
the JAX test's own drift bound and to real node ids.  The power
iteration equals the JAX one bit for bit too: its iterations, lambda and
vector.  ``smega_refine`` across 2 ranks (the plain version of K5R, its two
rounds per swap two gathers over the group) equals the JAX ``smega_refine``
on ``make_mesh(2)`` in interpret mode bit for bit, every field; that run
takes 10-100 s, so ``tools/smega_ranks_reference.py`` records it in
``tools/smega_ranks_reference.npz`` with a digest of its inputs, which the
test checks, and the test also holds the port's swaps to the JAX XLA
engine's, run here.
"""

import datetime
import hashlib
import os
import pickle
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np
import pytest
import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
GEN_002 = os.path.join(REPO, "benchmarks", "data", "gen_0.02_42.hgr")
SMEGA_REFERENCE = os.path.join(REPO, "tools", "smega_ranks_reference.npz")
#: smega across ranks: (case, graph of _jax_graphs, max_iterations), as
#: tools/smega_ranks_reference.py runs the JAX package.
SMEGA_CASES = (("dyadic", "dyadic", None), ("dyadic cap 7", "dyadic", 7), ("overflow", "overflow", None))
#: gen 0.02x's pass across ranks stops here (of about 960 swaps): two
#: gathers over gloo a swap take milliseconds on a busy host.
SMEGA_GEN002_CAP = 300
DEADLINE_S = 300
WORLDS = (2, 4)
RESULT_FIELDS = ("initial_cut", "final_cut", "best_cut", "verified_cut", "iterations")
ARRAY_FIELDS = ("sides", "best_sides", "cut_trajectory", "gain_trajectory")


# ---------------------------------------------------------------- the ranks


def _graph(arrays):
    from eig_kl_tpu_torch.graph.csr import Graph

    return Graph.from_arrays(*arrays)


def _kl(r):
    return {f: getattr(r, f) for f in RESULT_FIELDS + ARRAY_FIELDS}


def _refine_case(name, engine, S, dtype=torch.float64, dp=1, **config):
    def run(inp, world):
        from eig_kl_tpu_torch.parallel.mesh import make_mesh
        from eig_kl_tpu_torch.parallel.sharded_kl import sharded_refine
        from eig_kl_tpu_torch.parallel.sharded_kl2 import sharded_refine_oc
        from eig_kl_tpu_torch.utils.config import KLConfig

        g = _graph(inp[name]["graph"])
        fn = sharded_refine_oc if engine == "oc" else sharded_refine
        mesh = make_mesh(S * dp, dp=dp, device="cpu")
        return _kl(fn(g, inp[name]["sides"], mesh, KLConfig(**config), dtype=dtype))

    return run


def _power_case(name, S):
    def run(inp, world):
        from eig_kl_tpu_torch.parallel import sharded_power
        from eig_kl_tpu_torch.parallel.mesh import make_mesh
        from eig_kl_tpu_torch.utils.config import SpectralConfig

        cfg = SpectralConfig(solver="power", convergence="gkl2", max_iterations=inp[name]["max_iterations"])
        lam, v = sharded_power.sharded_power_fiedler(_graph(inp[name]["graph"]), make_mesh(S, device="cpu"), cfg)
        return {"lam": float(lam), "v": v.numpy(), "iterations": sharded_power.last_iterations}

    return run


def _mesh_case(inp, world):
    from eig_kl_tpu_torch.parallel.mesh import make_mesh

    out = {"shapes": [make_mesh(world, dp=2, device="cpu").shape, make_mesh(device="cpu").shape],
           "member_of_one": make_mesh(1, device="cpu").member, "errors": []}
    for args in ((world + 1,), (world, 3)):
        try:
            make_mesh(*args, device="cpu")
        except ValueError as e:
            out["errors"].append(str(e))
    return out


def _multi_case(inp, world):
    """The dp-sharded multi-start at dp = 2 beside the one-card run, one
    pass and passes until converged; its refusals and its refresh
    fallback; smega_refine across ranks."""
    from eig_kl_tpu_torch.parallel import make_mesh, multi_start_refine_mega, smega_refine
    from eig_kl_tpu_torch.parallel.multi_start import multi_start_refine_mega_sharded
    from eig_kl_tpu_torch.utils.config import KLConfig

    host = _graph(inp["dyadic"]["graph"])
    g = host.to_device("cpu", torch.float32)
    mesh = make_mesh(2, dp=2, device="cpu")
    out = {}
    for tag, cfg in (("one", KLConfig()), ("passes", KLConfig(passes=3))):
        best_s, cuts_s = multi_start_refine_mega_sharded(g, 4, mesh=mesh, config=cfg, base_seed=5)
        best_1, cuts_1 = multi_start_refine_mega(g, 4, config=cfg, base_seed=5, spmv_order="plan")
        out[tag] = {"sharded": (_kl(best_s), cuts_s), "one_card": (_kl(best_1), cuts_1)}
    try:
        multi_start_refine_mega_sharded(g, 3, mesh=mesh)
    except ValueError as e:
        out["indivisible"] = str(e)
    cfg = KLConfig(refresh_interval=5)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        best_r, cuts_r = multi_start_refine_mega_sharded(g, 4, mesh=mesh, config=cfg, base_seed=5)
    out["refresh"] = ([str(w.message) for w in caught], cuts_r,
                      multi_start_refine_mega(g, 4, config=cfg, base_seed=5, spmv_order="plan")[1])
    out["smega"] = _kl(smega_refine(host, inp["dyadic"]["sides"], make_mesh(2, device="cpu")))
    out["smega_one_rank"] = _kl(smega_refine(host, inp["dyadic"]["sides"], mesh))
    return out


def _smega_case(name, cap):
    def run(inp, world):
        from eig_kl_tpu_torch.parallel import make_mesh, smega_refine
        from eig_kl_tpu_torch.utils.config import KLConfig

        g = _graph(inp[name]["graph"])
        return _kl(smega_refine(g, inp[name]["sides"], make_mesh(2, device="cpu"), KLConfig(max_iterations=cap),
                                align=128))

    return run


def _smega_refusal_case(inp, world):
    """A plan built for 4 shards, given with a mesh of 2 ranks."""
    from eig_kl_tpu_torch.parallel import SmegaPlan, make_mesh, smega_refine

    g = _graph(inp["dyadic"]["graph"])
    try:
        smega_refine(g, inp["dyadic"]["sides"], make_mesh(2, device="cpu"), plan=SmegaPlan(g, 4))
    except ValueError as e:
        return str(e)
    return None


CASES = {
    2: {
        "mesh": _mesh_case,
        **{f"dyadic {e} S=1": _refine_case("dyadic", e, 1, dp=2) for e in ("oc", "bc")},
        **{f"dyadic {e} S=2": _refine_case("dyadic", e, 2) for e in ("oc", "bc")},
        "overflow oc S=2": _refine_case("overflow", "oc", 2),
        **{f"power {m} S=2": _power_case(f"power {m}", 2) for m in (64, 61)},
        "multi": _multi_case,
        **{f"smega {case}": _smega_case(name, cap) for case, name, cap in SMEGA_CASES},
        "smega gen002": _smega_case("gen002", SMEGA_GEN002_CAP),
        "smega refusal": _smega_refusal_case,
    },
    4: {
        "mesh": _mesh_case,
        **{f"dyadic {e} S=4": _refine_case("dyadic", e, 4) for e in ("oc", "bc")},
        "dyadic oc S=2 dp=2": _refine_case("dyadic", "oc", 2, dp=2),
        "bf16 oc S=4": _refine_case("bf16", "oc", 4, torch.bfloat16, max_iterations=40),
        **{f"gen002 {e} S=4": _refine_case("gen002", e, 4, torch.float32) for e in ("oc", "bc")},
        **{f"power {m} S=4": _power_case(f"power {m}", 4) for m in (64, 61)},
    },
}


def _rank_main(rank: int, world: int, tmp: str) -> None:
    """One rank: join the world's gloo group, run its cases, write the
    results (an exception is recorded as the case's result)."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, f"store{world}"), world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60),
    )
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = {}
    for name, case in CASES[world].items():
        t0 = time.perf_counter()
        try:
            out[name] = case(inp, world)
        except Exception:  # noqa: BLE001 -- the test reports it
            out[name] = ("error", traceback.format_exc())
        out[f"{name} seconds"] = time.perf_counter() - t0
    with open(os.path.join(tmp, f"w{world}_r{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


class _Ranks:
    """The groups' processes, started together; each world's results are
    read (and its processes joined, or killed at the deadline) on first use."""

    def __init__(self, tmp: str):
        self.tmp = tmp
        self.t0 = time.monotonic()
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        code = "import sys; sys.path.insert(0, {!r}); from test_torch_sharded import _rank_main; _rank_main({}, {}, {!r})"
        self.procs = {
            w: [subprocess.Popen([sys.executable, "-c", code.format(os.path.dirname(__file__), r, w, tmp)],
                                 env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for r in range(w)]
            for w in WORLDS
        }
        self.results: dict[int, list] = {}

    def world(self, w: int) -> list[dict]:
        if w not in self.results:
            logs = []
            for p in self.procs[w]:
                try:
                    logs.append(p.communicate(timeout=max(DEADLINE_S - (time.monotonic() - self.t0), 1))[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    logs.append(p.communicate()[0])
            paths = [os.path.join(self.tmp, f"w{w}_r{r}.pkl") for r in range(w)]
            if not all(os.path.exists(p) for p in paths):
                self.results[w] = AssertionError(b"\n".join(logs).decode(errors="replace")[-4000:])
            else:
                self.results[w] = [pickle.load(open(p, "rb")) for p in paths]
        if isinstance(self.results[w], AssertionError):
            raise self.results[w]
        return self.results[w]

    def case(self, w: int, name: str) -> list:
        out = [r[name] for r in self.world(w)]
        for o in out:
            if isinstance(o, tuple) and o and o[0] == "error":
                raise AssertionError(o[1])
        return out

    def close(self):
        for procs in self.procs.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.communicate()


# ------------------------------------------------------------ the JAX side


def _jax_graphs():
    """The cases' graphs and splits, built by the JAX package: the 61-node
    dyadic problem of tests/test_sharded.py:20-25, its overflow graph
    (:82), its bf16 graph (:123), gen 0.02x with a random split, and the
    sharded power's 64- and 61-node graphs."""
    from eig_kl_tpu.graph.expand import clique_expand
    from eig_kl_tpu.io.hgr import Hypergraph, read_hgr
    from eig_kl_tpu.kl.init import random_split

    from tests.conftest import random_hypergraph
    from tests.test_kl import dyadic_hypergraph

    out = {}
    g = clique_expand(dyadic_hypergraph(np.random.default_rng(21), num_nodes=61, num_nets=140), "kl")
    out["dyadic"] = (g, random_split(g.num_nodes, seed=9))
    hg = random_hypergraph(np.random.default_rng(0), num_nodes=64, num_nets=60, max_net=4)
    pins = np.concatenate([hg.pins, np.arange(41, dtype=np.int32)])
    offs = np.concatenate([hg.net_offsets, [hg.net_offsets[-1] + 41]]).astype(np.int64)
    hg = Hypergraph(num_nodes=64, num_nets=hg.num_nets + 1, pins=pins, net_offsets=offs)
    g = clique_expand(hg, "kl", use_native=False)
    out["overflow"] = (g, random_split(64, 3))
    hg = random_hypergraph(np.random.default_rng(9), num_nodes=320, num_nets=600, max_net=4)
    out["bf16"] = (clique_expand(hg, "kl", use_native=False), random_split(320, 1))
    g = clique_expand(read_hgr(GEN_002, use_native=False), "kl", use_native=False)
    out["gen002"] = (g, random_split(g.num_nodes, 5))
    for m, iters in ((64, 150), (61, 300)):
        hg = random_hypergraph(np.random.default_rng(0), num_nodes=m, num_nets=128, max_net=5)
        out[f"power {m}"] = (clique_expand(hg, "kl"), iters)
    return out


def inputs_digest(g, sides) -> str:
    """The first 16 hex digits of the SHA-256 of a graph's CSR arrays and a
    split (tools/smega_ranks_reference.py records it beside each run)."""
    h = hashlib.sha256()
    for a in (g.indptr, g.indices, g.data, sides):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


@pytest.fixture(scope="module")
def jax_graphs():
    return _jax_graphs()


@pytest.fixture(scope="module")
def ranks(jax_graphs, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ranks"))
    inp = {}
    for name, (g, extra) in jax_graphs.items():
        arrays = (g.indptr, g.indices, g.data)
        key = "max_iterations" if name.startswith("power") else "sides"
        inp[name] = {"graph": arrays, key: extra}
    with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    r = _Ranks(tmp)
    yield r
    r.close()


def _jax_mesh(S, dp=1):
    from eig_kl_tpu.parallel.mesh import make_mesh

    return make_mesh(S * dp, dp=dp)


def _jax_refine(engine, g, sides, S, dtype, **config):
    import jax.numpy as jnp

    from eig_kl_tpu.parallel.sharded_kl import sharded_refine
    from eig_kl_tpu.parallel.sharded_kl2 import sharded_refine_oc
    from eig_kl_tpu.utils.config import KLConfig

    fn = sharded_refine_oc if engine == "oc" else sharded_refine
    return fn(g, sides, _jax_mesh(S), KLConfig(**config), dtype=getattr(jnp, dtype))


def _assert_same_kl(got: dict, ref) -> None:
    for f in RESULT_FIELDS:
        assert got[f] == getattr(ref, f), f
    for f in ARRAY_FIELDS:
        np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)), err_msg=f)


# ------------------------------------------------------------------- tests


@pytest.mark.parametrize(
    "world, case, S",
    [(2, f"dyadic {e} S=1", 1) for e in ("oc", "bc")]
    + [(2, f"dyadic {e} S=2", 2) for e in ("oc", "bc")]
    + [(4, f"dyadic {e} S=4", 4) for e in ("oc", "bc")]
    + [(4, "dyadic oc S=2 dp=2", 2)],
)
def test_sharded_engines_equal_jax_on_the_dyadic_problem(jax_graphs, ranks, world, case, S):
    """Every rank's result equals the JAX engine's on make_mesh(S) in f64,
    bit for bit; on a (2, 2) mesh each "dp" row runs the pass whole."""
    g, sides = jax_graphs["dyadic"]
    ref = _jax_refine(case.split()[1], g, sides, S, "float64")
    for got in ranks.case(world, case):
        _assert_same_kl(got, ref)


def test_overflow_columns_equal_jax(jax_graphs, ranks):
    """A 41-pin net: columns of more than 16 entries on a rank go to the
    overflow lists; the pass still equals the JAX engine's at S = 2."""
    from eig_kl_tpu.parallel import sharded_kl2 as jax_kl2

    from eig_kl_tpu_torch.graph.csr import Graph
    from eig_kl_tpu_torch.parallel import sharded_kl2

    g, sides = jax_graphs["overflow"]
    want = jax_kl2._transpose_partition(g, 64, 2, np.float64)
    assert want[-1] == sharded_kl2._CMAX_DENSE
    assert (want[3] >= 0).sum() > 0, "the graph must overflow"
    for p in range(2):
        got = sharded_kl2._transpose_partition(Graph.from_arrays(g.indptr, g.indices, g.data), 64, 2,
                                               torch.float64, p)
        assert got[-1] == want[-1]
        for a, b in zip(got[:-1], want[:-1]):
            np.testing.assert_array_equal(np.asarray(a), b[p])
    ref = _jax_refine("oc", g, sides, 2, "float64")
    for res in ranks.case(2, "overflow oc S=2"):
        _assert_same_kl(res, ref)


def test_bf16_index_packing(jax_graphs, ranks):
    """bf16 state at S = 4 on 320 nodes: the swap log holds real node ids
    (a bf16 value cast would collapse ids above 256), the balance holds,
    and the drift stays within the JAX test's bound
    (tests/test_sharded.py:123-144)."""
    g, sides = jax_graphs["bf16"]
    ref = _jax_refine("oc", g, sides, 4, "bfloat16", max_iterations=40)
    for got in ranks.case(4, "bf16 oc S=4"):
        assert got["iterations"] > 0
        assert int(got["sides"].sum()) == int(sides.sum())
        assert abs(got["final_cut"] - got["verified_cut"]) <= max(4.0, 0.05 * abs(got["final_cut"]))
        moved = np.flatnonzero(got["sides"] != sides)
        assert moved.size == 2 * got["iterations"] and (moved >= 256).any()
        assert got["iterations"] == ref.iterations


@pytest.mark.parametrize("engine", ["oc", "bc"])
def test_gen002_f32_at_four_ranks_equals_jax(jax_graphs, ranks, engine):
    """gen 0.02x (4,038 nodes, ELL width 32) from a random split, f32, S = 4:
    swaps, gains, cut trajectory and cuts equal the JAX engine's bit for
    bit."""
    g, sides = jax_graphs["gen002"]
    ref = _jax_refine(engine, g, sides, 4, "float32")
    assert ref.iterations > 100
    for got in ranks.case(4, f"gen002 {engine} S=4"):
        _assert_same_kl(got, ref)


@pytest.mark.parametrize("world, m", [(2, 64), (2, 61), (4, 64), (4, 61)])
def test_sharded_power_equals_jax(jax_graphs, ranks, world, m):
    """The sharded power iteration (f32) at S ranks against the JAX one on
    make_mesh(S): the same iterations, lambda and vector, bit for bit (n
    divisible by S and not)."""
    import jax.numpy as jnp

    from eig_kl_tpu.parallel import sharded_power
    from eig_kl_tpu.utils.config import SpectralConfig

    g, iters = jax_graphs[f"power {m}"]
    cfg = SpectralConfig(solver="power", convergence="gkl2", max_iterations=iters)
    lam, v = sharded_power.sharded_power_fiedler(g, _jax_mesh(world), cfg, dtype=jnp.float32)
    v = np.asarray(v)
    for got in ranks.case(world, f"power {m} S={world}"):
        assert got["iterations"] == sharded_power.last_iterations
        assert got["v"].shape == (m,)
        assert got["lam"] == float(lam)
        np.testing.assert_array_equal(got["v"], v)


def test_multi_start_sharded_equals_one_card_and_jax(jax_graphs, ranks):
    """4 starts at dp = 2: per start equal to the one-card
    multi_start_refine_mega(spmv_order="plan") bit for bit, one pass and
    passes until converged, on both ranks; the one-pass cuts equal the JAX
    dp-sharded run's (interpret mode, make_mesh(2, dp=2))."""
    from eig_kl_tpu.parallel.multi_start import multi_start_refine_mega_sharded

    g, _ = jax_graphs["dyadic"]
    _best, jax_cuts = multi_start_refine_mega_sharded(g, 4, mesh=_jax_mesh(1, dp=2), base_seed=5)
    for out in ranks.case(2, "multi"):
        for tag in ("one", "passes"):
            (best_s, cuts_s), (best_1, cuts_1) = out[tag]["sharded"], out[tag]["one_card"]
            np.testing.assert_array_equal(cuts_s, cuts_1)
            for f in RESULT_FIELDS:
                assert best_s[f] == best_1[f], (tag, f)
            for f in ARRAY_FIELDS:
                np.testing.assert_array_equal(best_s[f], best_1[f])
        np.testing.assert_array_equal(out["one"]["sharded"][1], np.asarray(jax_cuts, np.float32))


def test_multi_start_sharded_refusals_and_refresh(ranks):
    """The JAX function's ValueError for starts not divisible by dp, its
    warning and one-card run with refresh_interval > 0, and smega_refine on
    a mesh of 2 ranks, no longer refused: equal to its one-rank run (on the
    (2, 1) mesh's row) bit for bit."""
    for out in ranks.case(2, "multi"):
        assert out["indivisible"] == "num_starts=3 must be divisible by dp=2"
        msgs, cuts, one_card = out["refresh"]
        assert any("refresh_interval > 0" in m for m in msgs)
        np.testing.assert_array_equal(cuts, one_card)
        assert out["smega_one_rank"]["iterations"] > 0
        for f in RESULT_FIELDS:
            assert out["smega"][f] == out["smega_one_rank"][f], f
        for f in ARRAY_FIELDS:
            np.testing.assert_array_equal(out["smega"][f], out["smega_one_rank"][f], err_msg=f)


@pytest.mark.parametrize("case, name, cap", SMEGA_CASES)
def test_smega_across_ranks_equals_jax_smega(jax_graphs, ranks, case, name, cap):
    """smega_refine across 2 ranks (gloo, the plain version) against the JAX
    smega_refine on make_mesh(2) (interpret, align=128), recorded by
    tools/smega_ranks_reference.py for these very inputs: every field bit
    for bit on both ranks, whole and capped; the swaps also equal the JAX
    XLA engine's, run here."""
    import jax.numpy as jnp

    from eig_kl_tpu.kl.engine import refine
    from eig_kl_tpu.utils.config import KLConfig

    g, sides = jax_graphs[name]
    ref = np.load(SMEGA_REFERENCE)
    assert str(ref[f"{case}/inputs"]) == inputs_digest(g, sides), "the recorded run had other inputs"
    xla = refine(g.to_device(dtype=jnp.float32), sides, KLConfig(max_iterations=cap))
    assert 0 < xla.iterations == int(ref[f"{case}/iterations"]) <= (cap or xla.iterations)
    np.testing.assert_array_equal(np.asarray(xla.sides), ref[f"{case}/sides"])
    np.testing.assert_array_equal(np.asarray(xla.gain_trajectory), ref[f"{case}/gain_trajectory"])
    for got in ranks.case(2, f"smega {case}"):
        for f in RESULT_FIELDS:
            assert got[f] == ref[f"{case}/{f}"].item(), f
        for f in ARRAY_FIELDS:
            np.testing.assert_array_equal(got[f], ref[f"{case}/{f}"], err_msg=f)


def test_smega_across_ranks_gen002_equals_one_process(jax_graphs, ranks):
    """gen 0.02x from a random split, the first 300 swaps: smega_refine
    across 2 ranks equals the port's one-process pass at 2 shards,
    smega_refine(g, sides, 2), bit for bit (no JAX interpret run at this
    size)."""
    from eig_kl_tpu_torch.parallel import smega_refine
    from eig_kl_tpu_torch.utils.config import KLConfig

    g, sides = jax_graphs["gen002"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = _kl(smega_refine(_graph((g.indptr, g.indices, g.data)), sides, 2,
                               KLConfig(max_iterations=SMEGA_GEN002_CAP), device="cpu"))
    finally:
        torch.set_num_threads(threads)
    assert one["iterations"] == SMEGA_GEN002_CAP
    for got in ranks.case(2, "smega gen002"):
        for f in RESULT_FIELDS:
            assert got[f] == one[f], f
        for f in ARRAY_FIELDS:
            np.testing.assert_array_equal(got[f], one[f], err_msg=f)


def test_smega_plan_for_other_shards_refused_on_every_rank(ranks):
    """A plan built for 4 shards given with a mesh of 2 ranks: every rank
    raises the same ValueError, before any collective."""
    assert ranks.case(2, "smega refusal") == ["plan built for 4 shards, not 2"] * 2


@pytest.mark.parametrize("world", WORLDS)
def test_make_mesh_shapes_and_errors_as_jax(ranks, world):
    """make_mesh's shapes as the JAX ones (tests/test_sharded.py:28-33),
    membership of a smaller mesh, and JAX's ValueErrors."""
    for r, out in enumerate(ranks.case(world, "mesh")):
        assert out["shapes"] == [{"dp": 2, "mp": world // 2}, {"dp": 1, "mp": world}]
        assert out["member_of_one"] == (r == 0)
        assert out["errors"] == [f"requested {world + 1} devices, have {world}",
                                 f"n_devices={world} not divisible by dp=3"]


def _result_lines(text: str) -> list[str]:
    keep = ("Total iterations", "Initial cut size", "Best cut size", "Final cut size", "Overall improvement")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


def _verified_cut(text: str) -> float:
    (line,) = [ln for ln in text.splitlines() if ln.startswith("Verified cut size")]
    return float(line.split(":")[1])


@pytest.mark.parametrize("extra", [["--passes", "0"], ["--kicks", "1"], ["--shuffled-ties"]])
def test_cli_kl_sharded_equals_kl(tmp_path, monkeypatch, capsys, extra):
    """``kl --sharded --device cpu`` at one rank (a plain process): its
    result lines equal the unsharded ``kl`` from the same random split,
    with passes until converged, with a kick, and in the reference's
    shuffled order.  The verified cut is recounted in the JAX sharded
    engine's order, not K2's, so its last printed digit may differ."""
    from eig_kl_tpu_torch.cli.main import main

    monkeypatch.chdir(tmp_path)
    args = ["kl", GEN_002, "--device", "cpu", "--seed", "3", *extra]
    assert main(args + ["--sharded"]) == 0
    sharded = capsys.readouterr().out
    assert main(args) == 0
    plain = capsys.readouterr().out
    assert len(_result_lines(sharded)) == 5
    assert _result_lines(sharded) == _result_lines(plain)
    assert abs(_verified_cut(sharded) - _verified_cut(plain)) <= 0.01
    assert (tmp_path / "results" / "gen_0.02_42.hgr_KL_CutSize_output.txt").exists()
    import torch.distributed as dist

    assert not dist.is_initialized()
