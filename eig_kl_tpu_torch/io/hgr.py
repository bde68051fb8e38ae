"""`.hgr` hypergraph file format reader/writer (the port's copy of
``eig_kl_tpu/io/hgr.py``: a NumPy parser, and the native C++ tokenizer of
:mod:`eig_kl_tpu_torch.io.native_io`, which gives the same arrays).

Format (reference README.md:170-187; parsed at cEIG.cpp:178-182,94-101,
cKL.cpp:92-132, gKL.cu:581-649):

* line 1: ``<num_nets> <num_nodes>``
* lines 2..nets+1: whitespace-separated **1-indexed** node ids, one net
  per line.

Internally everything is 0-indexed.  A hypergraph is stored in the flat
"pin list + net offsets" form (the CSR of the net->node incidence).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from eig_kl_tpu_torch.io import native_io


@dataclasses.dataclass(frozen=True)
class Hypergraph:
    """A hypergraph as flat pin arrays.

    Attributes:
      num_nodes: declared node count (header field 2).
      num_nets: declared net count (header field 1).
      pins: int32[num_pins] -- concatenated 0-indexed node ids of every
        net, in file order.
      net_offsets: int64[num_nets + 1] -- net ``i`` spans
        ``pins[net_offsets[i]:net_offsets[i+1]]``.
      name: basename of the source file (used for output-file naming,
        mirroring cKL.cpp:437-444).
    """

    num_nodes: int
    num_nets: int
    pins: np.ndarray
    net_offsets: np.ndarray
    name: str = "hypergraph"

    @property
    def num_pins(self) -> int:
        return int(self.pins.shape[0])

    @property
    def net_sizes(self) -> np.ndarray:
        return np.diff(self.net_offsets)

    @property
    def max_net_size(self) -> int:
        sizes = self.net_sizes
        return int(sizes.max()) if sizes.size else 0


def _parse_tokens(text: str) -> Hypergraph:
    """Pure-NumPy parse of full `.hgr` text."""
    nl = text.find("\n")
    if nl < 0:
        raise ValueError("empty .hgr file")
    header = text[:nl].split()
    if len(header) < 2:
        raise ValueError(f"bad .hgr header: {header!r}")
    num_nets, num_nodes = int(header[0]), int(header[1])

    lines = text[nl + 1 :].splitlines()
    if len(lines) < num_nets:
        raise ValueError(
            f".hgr declares {num_nets} nets but has only {len(lines)} lines"
        )
    counts = np.empty(num_nets, dtype=np.int64)
    all_tokens: list[str] = []
    for i in range(num_nets):
        toks = lines[i].split()
        counts[i] = len(toks)
        all_tokens.extend(toks)
    pins = np.asarray(all_tokens, dtype=np.int64)
    if pins.size and (pins.min() < 1 or pins.max() > num_nodes):
        raise ValueError(
            f"pin ids out of range [1, {num_nodes}]: "
            f"min={pins.min()}, max={pins.max()}"
        )
    net_offsets = np.zeros(num_nets + 1, dtype=np.int64)
    np.cumsum(counts, out=net_offsets[1:])
    return Hypergraph(
        num_nodes=num_nodes,
        num_nets=num_nets,
        pins=(pins - 1).astype(np.int32),  # 0-based, as in cEIG.cpp:99
        net_offsets=net_offsets,
    )


def read_hgr(path: str | os.PathLike, *, use_native: bool | None = None) -> Hypergraph:
    """Read a `.hgr` file.

    Args:
      path: path to the file.
      use_native: force (True) or forbid (False) the native C++ parser;
        None = use it if the host library builds, else NumPy.  With None,
        a file the native parser refuses is read again by the NumPy
        parser, which names the fault as the JAX package's does; if that
        parser reads it, the native failure raises.
    """
    path = os.fspath(path)
    if use_native is False or (use_native is None and not native_io.available()):
        with open(path, "r") as f:
            hg = _parse_tokens(f.read())
    else:
        try:
            hg = native_io.read_hgr_native(path)
        except OSError as err:
            if use_native:
                raise
            with open(path, "r") as f:
                _parse_tokens(f.read())
            raise err
    return dataclasses.replace(hg, name=os.path.basename(path))


def write_hgr(path: str | os.PathLike, hg: Hypergraph) -> None:
    """Write a hypergraph in `.hgr` format (1-indexed, like the reference
    generator, circuit_generator.py:66-68)."""
    path = os.fspath(path)
    out = [f"{hg.num_nets} {hg.num_nodes}\n"]
    offs = hg.net_offsets
    pins1 = hg.pins + 1
    for i in range(hg.num_nets):
        out.append(" ".join(map(str, pins1[offs[i] : offs[i + 1]])) + "\n")
    with open(path, "w") as f:
        f.writelines(out)
