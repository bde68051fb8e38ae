"""The port's host library (``csrc/eigkl_native.cpp`` through
``io/native_io.py``) against the port's NumPy routes and the JAX
package's native ones: the ``.hgr`` parser, the clique expansion, the
parse errors, ``use_native`` and a failed build.
"""

import pathlib

import numpy as np
import pytest

from conftest import random_hypergraph
from torch_one_thread import one_thread  # noqa: F401  (autouse: PyTorch on one thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
GEN_002 = str(REPO / "benchmarks" / "data" / "gen_0.02_42.hgr")


def _same_bits(a: np.ndarray, b: np.ndarray) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _port_hypergraph(seed: int, repeated_pins: bool):
    """A random hypergraph; with ``repeated_pins`` some nets name one node
    twice (the self pairs are dropped, the duplicate pairs add up)."""
    from eig_kl_tpu_torch.io.hgr import Hypergraph

    rng = np.random.default_rng(seed)
    hg = random_hypergraph(rng, num_nodes=300, num_nets=500, max_net=8)
    pins = hg.pins.copy()
    if repeated_pins:
        offs = hg.net_offsets
        for i in range(0, hg.num_nets, 7):
            pins[offs[i + 1] - 1] = pins[offs[i]]
    return Hypergraph(hg.num_nodes, hg.num_nets, pins, hg.net_offsets)


def _to_jax(hg):
    from eig_kl_tpu.io.hgr import Hypergraph

    return Hypergraph(hg.num_nodes, hg.num_nets, hg.pins, hg.net_offsets)


@pytest.fixture()
def gen002_written(tmp_path):
    """gen 0.02x and a random hypergraph with repeated pins, as files."""
    from eig_kl_tpu_torch.io.hgr import write_hgr

    path = tmp_path / "rep.hgr"
    write_hgr(path, _port_hypergraph(5, repeated_pins=True))
    return [GEN_002, str(path)]


def test_parse_matches_numpy_and_the_jax_parser(gen002_written):
    from eig_kl_tpu.io import native_io as jax_native
    from eig_kl_tpu_torch.io import native_io
    from eig_kl_tpu_torch.io.hgr import read_hgr

    for path in gen002_written:
        got = read_hgr(path, use_native=True)
        ref = read_hgr(path, use_native=False)
        jax = jax_native.read_hgr_native(path)
        for other in (ref, jax):
            assert (got.num_nets, got.num_nodes) == (other.num_nets, other.num_nodes)
            _same_bits(got.pins, other.pins)
            _same_bits(got.net_offsets, other.net_offsets)
        assert got.name == ref.name == pathlib.Path(path).name
        _same_bits(native_io.read_hgr_native(path).pins, got.pins)


@pytest.mark.parametrize("weighting", ["eig", "kl"])
@pytest.mark.parametrize("source", ["random", "repeated pins", "gen_0.02"])
def test_expansion_matches_numpy_bitwise(weighting, source):
    """Pairs that several nets share add their weights in the NumPy
    route's order, so the two routes agree to the last bit."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import read_hgr

    if source == "gen_0.02":
        hg = read_hgr(GEN_002, use_native=False)
    else:
        hg = _port_hypergraph(6, repeated_pins=source == "repeated pins")
    got = clique_expand(hg, weighting, use_native=True)
    ref = clique_expand(hg, weighting, use_native=False)
    assert got.num_nodes == ref.num_nodes
    for name in ("indptr", "indices", "data"):
        _same_bits(getattr(got, name), getattr(ref, name))


@pytest.mark.parametrize("weighting", ["eig", "kl"])
def test_expansion_matches_the_jax_builder(weighting):
    """Against the JAX package's native builder: gen 0.02x bit for bit;
    on a random hypergraph the structure exactly and the weights to an
    ulp (that builder adds a pair's weights smallest first, and a pair of
    three or more weights may round otherwise)."""
    from eig_kl_tpu.graph.expand import clique_expand as jax_expand
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io.hgr import read_hgr

    gen = read_hgr(GEN_002, use_native=False)
    got = clique_expand(gen, weighting, use_native=True)
    ref = jax_expand(_to_jax(gen), weighting, use_native=True)
    for name in ("indptr", "indices", "data"):
        _same_bits(getattr(got, name), getattr(ref, name))
    rnd = _port_hypergraph(7, repeated_pins=True)
    got = clique_expand(rnd, weighting, use_native=True)
    ref = jax_expand(_to_jax(rnd), weighting, use_native=True)
    _same_bits(got.indptr, ref.indptr)
    _same_bits(got.indices, ref.indices)
    np.testing.assert_array_max_ulp(got.data, ref.data, maxulp=1)


def test_parse_errors_raise_as_in_jax(tmp_path):
    from eig_kl_tpu_torch.io import native_io
    from eig_kl_tpu_torch.io.hgr import read_hgr

    missing = str(tmp_path / "missing.hgr")
    with pytest.raises(OSError):
        native_io.read_hgr_native(missing)
    bad = tmp_path / "bad.hgr"
    bad.write_text("2 3\n1 99\n2 3\n")  # pin 99 out of range
    with pytest.raises(OSError):
        native_io.read_hgr_native(str(bad))
    with pytest.raises(OSError):
        read_hgr(bad, use_native=True)
    # None falls back to NumPy, which names the fault.
    with pytest.raises(ValueError, match="out of range"):
        read_hgr(bad)
    with pytest.raises(FileNotFoundError):
        read_hgr(missing)


def test_default_route_is_native_and_a_failed_build_raises(tmp_path, monkeypatch):
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io import native_io
    from eig_kl_tpu_torch.io.hgr import read_hgr
    from eig_kl_tpu_torch.ops import _build

    assert native_io.available()
    calls = []
    real = native_io.clique_expand_native
    monkeypatch.setattr(native_io, "clique_expand_native", lambda *a, **k: calls.append(1) or real(*a, **k))
    hg = read_hgr(GEN_002)
    clique_expand(hg, "kl")
    assert calls == [1]
    monkeypatch.undo()

    # A library that does not build: available() says so, None falls back
    # to NumPy, True raises with the compiler's verdict.
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_load_error", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_cxx", lambda: "false")
    assert not native_io.available()
    assert read_hgr(GEN_002).num_nodes == hg.num_nodes
    with pytest.raises(ImportError, match="cannot build the host library"):
        read_hgr(GEN_002, use_native=True)
    with pytest.raises(ImportError):
        clique_expand(hg, "kl", use_native=True)


def test_a_native_failure_on_a_readable_input_raises(monkeypatch):
    """With ``use_native=None`` and a library that builds, a failure of the
    native route is not hidden behind the NumPy route."""
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.io import native_io
    from eig_kl_tpu_torch.io.hgr import read_hgr

    def fail(*args, **kwargs):
        raise OSError("native route failed")

    hg = read_hgr(GEN_002, use_native=False)
    monkeypatch.setattr(native_io, "read_hgr_native", fail)
    monkeypatch.setattr(native_io, "clique_expand_native", fail)
    with pytest.raises(OSError, match="native route failed"):
        read_hgr(GEN_002)
    with pytest.raises(OSError, match="native route failed"):
        clique_expand(hg, "kl")
    assert read_hgr(GEN_002, use_native=False).num_nodes == hg.num_nodes
    assert clique_expand(hg, "kl", use_native=False).num_nodes == hg.num_nodes


def test_library_name_hashes_the_compiler_and_the_platform(monkeypatch):
    """A library built by another compiler or on another platform is not
    the one loaded here."""
    from eig_kl_tpu_torch.ops import _build

    base = _build.library_path("eigkl_native")
    with monkeypatch.context() as m:
        m.setattr(_build.platform, "platform", lambda: "another-platform")
        assert _build.library_path("eigkl_native") != base
    with monkeypatch.context() as m:
        m.setattr(_build, "_compiler_identity", lambda compiler: "another compiler")
        assert _build.library_path("eigkl_native") != base
    assert _build.library_path("eigkl_native") == base
