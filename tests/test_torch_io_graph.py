"""The port's host layer against the JAX package: the threefry start
vector, the ``.hgr`` parser, the generator, the clique expansion and the
device graph built from a JAX ``DeviceGraph``.

Everything runs on the CPU (``device="cpu"``).  Inputs are made with
numpy from a seed and handed to both packages.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_hypergraph

GEN_002 = os.path.join(
    os.path.dirname(__file__), "..", "benchmarks", "data", "gen_0.02_42.hgr"
)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", [1, 1000, 4038, 100_003])
@pytest.mark.parametrize("seed", [0, 42])
def test_threefry_uniform_matches_jax_bitwise(n, seed, dtype):
    from eig_kl_tpu_torch.utils.threefry import uniform

    ref = np.asarray(
        jax.random.uniform(jax.random.PRNGKey(seed), (n,), dtype=jnp.dtype(dtype))
    )
    got = uniform(seed, n, dtype)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_threefry_rejects_other_dtypes():
    from eig_kl_tpu_torch.utils.threefry import uniform

    with pytest.raises(TypeError):
        uniform(0, 4, np.float16)


def test_hgr_parse_matches_jax_parser():
    from eig_kl_tpu.io.hgr import read_hgr as jax_read
    from eig_kl_tpu_torch.io.hgr import read_hgr

    ref = jax_read(GEN_002, use_native=False)
    got = read_hgr(GEN_002)
    assert (got.num_nodes, got.num_nets, got.name) == (ref.num_nodes, ref.num_nets, ref.name)
    np.testing.assert_array_equal(got.pins, ref.pins)
    np.testing.assert_array_equal(got.net_offsets, ref.net_offsets)
    assert got.pins.dtype == ref.pins.dtype


def test_hgr_write_round_trip(tmp_path, rng):
    from eig_kl_tpu_torch.io.hgr import Hypergraph, read_hgr, write_hgr

    ref = random_hypergraph(rng, num_nodes=50, num_nets=70)
    hg = Hypergraph(ref.num_nodes, ref.num_nets, ref.pins, ref.net_offsets)
    path = tmp_path / "c.hgr"
    write_hgr(path, hg)
    back = read_hgr(path)
    np.testing.assert_array_equal(back.pins, hg.pins)
    np.testing.assert_array_equal(back.net_offsets, hg.net_offsets)


def test_hgr_rejects_out_of_range_pins(tmp_path):
    from eig_kl_tpu_torch.io.hgr import read_hgr

    path = tmp_path / "bad.hgr"
    path.write_text("1 3\n1 4\n")
    with pytest.raises(ValueError, match="out of range"):
        read_hgr(path)


def test_generator_matches_jax_generator():
    from eig_kl_tpu.models.generator import CircuitGenerator as JaxGen
    from eig_kl_tpu_torch.models.generator import CircuitGenerator

    ref = JaxGen(0.02, 42).generate()
    got = CircuitGenerator(0.02, 42).generate()
    assert (got.num_nodes, got.num_nets) == (ref.num_nodes, ref.num_nets) == (4038, 4212)
    np.testing.assert_array_equal(got.pins, ref.pins)
    np.testing.assert_array_equal(got.net_offsets, ref.net_offsets)


def test_generator_write_equals_committed_file(tmp_path):
    """The committed gen 0.02x seed-42 circuit is what the port writes."""
    from eig_kl_tpu_torch.models.generator import CircuitGenerator

    out = tmp_path / "g.hgr"
    CircuitGenerator(0.02, 42).write(str(out))
    with open(GEN_002) as f:
        assert out.read_text() == f.read()


@pytest.mark.parametrize("weighting", ["kl", "eig"])
@pytest.mark.parametrize("source", ["random", "gen_0.02"])
def test_clique_expand_matches_jax(weighting, source, rng):
    from eig_kl_tpu.graph.expand import clique_expand as jax_expand
    from eig_kl_tpu.io.hgr import read_hgr as jax_read
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import Hypergraph

    if source == "random":
        ref_hg = random_hypergraph(rng, num_nodes=120, num_nets=200, max_net=8)
    else:
        ref_hg = jax_read(GEN_002, use_native=False)
    hg = Hypergraph(ref_hg.num_nodes, ref_hg.num_nets, ref_hg.pins, ref_hg.net_offsets)
    ref = jax_expand(ref_hg, weighting, use_native=False)
    got = clique_expand(hg, weighting)
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    assert got.data.dtype == np.float64
    np.testing.assert_array_equal(got.data, ref.data)
    np.testing.assert_array_equal(got.weighted_degrees, ref.weighted_degrees)
    assert got.total_weight == ref.total_weight


def test_clique_expand_rejects_unknown_weighting(rng):
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import Hypergraph

    ref = random_hypergraph(rng, num_nodes=10, num_nets=5)
    hg = Hypergraph(ref.num_nodes, ref.num_nets, ref.pins, ref.net_offsets)
    with pytest.raises(ValueError):
        clique_expand(hg, "star")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_device_graph_from_jax_equals_to_device(dtype, rng):
    """Dropping the ELL pads of a JAX DeviceGraph gives exactly the CSR
    the port uploads from the same host graph."""
    from eig_kl_tpu.graph.expand import clique_expand as jax_expand
    from eig_kl_tpu_torch.graph.csr import Graph, device_graph_from_jax

    ref_hg = random_hypergraph(rng, num_nodes=90, num_nets=150, max_net=7)
    g_jax = jax_expand(ref_hg, "kl", use_native=False)
    dg = g_jax.to_device(dtype=dtype)
    from_jax = device_graph_from_jax(
        np.asarray(dg.ell_indices), np.asarray(dg.ell_weights),
        np.asarray(dg.degrees), np.asarray(dg.total_weight), "cpu",
    )
    tdtype = getattr(torch, dtype)
    mine = Graph.from_arrays(g_jax.indptr, g_jax.indices, g_jax.data).to_device("cpu", tdtype)
    assert from_jax.row_width == mine.row_width == dg.ell_indices.shape[1]
    for name in ("indptr", "indices", "data", "degrees", "total_weight"):
        a, b = getattr(from_jax, name), getattr(mine, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name


def test_graph_from_arrays_keeps_the_arrays(rng):
    from eig_kl_tpu.graph.expand import clique_expand as jax_expand
    from eig_kl_tpu_torch.graph.csr import Graph

    g_jax = jax_expand(random_hypergraph(rng), "kl", use_native=False)
    g = Graph.from_arrays(g_jax.indptr, g_jax.indices, g_jax.data)
    assert g.num_nodes == g_jax.num_nodes and g.nnz == g_jax.nnz
    assert g.max_degree == g_jax.max_degree
    np.testing.assert_array_equal(g.data, g_jax.data)
