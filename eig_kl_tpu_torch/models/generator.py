"""Synthetic circuit generator.

Capability-parity port of the reference's ``circuit_generator.py``
(FastCircuitGenerator, circuit_generator.py:7-87), vectorized:

* reference scale = 201,920 nodes / 210,613 nets x multiplier (:43-44)
* net-size distribution {2: 84%, 3: 2%, 4: 6%, 5: 2%, 6: 4%, 8: 2%}
  (:12-19)
* per net: uniform node sample without replacement, sorted (:32-39)

Sampling is vectorized with rejection: duplicate-containing nets (rare,
~k^2/2n probability) are redrawn in bulk.
"""

from __future__ import annotations

import numpy as np

from eig_kl_tpu_torch.io.hgr import Hypergraph, write_hgr

# (size, probability weight) -- circuit_generator.py:12-19.
NET_SIZE_DISTRIBUTION = ((2, 84), (3, 2), (4, 6), (5, 2), (6, 4), (8, 2))
REFERENCE_NODES = 201920   # circuit_generator.py:43
REFERENCE_NETS = 210613    # circuit_generator.py:44


class CircuitGenerator:
    """Generate random hypergraphs at a multiple of the reference scale."""

    def __init__(self, size_multiplier: float = 1.0, seed: int | None = None):
        self.size_multiplier = size_multiplier
        self.num_nodes = int(REFERENCE_NODES * size_multiplier)
        self.num_nets = int(REFERENCE_NETS * size_multiplier)
        self.rng = np.random.default_rng(seed)

    def _net_sizes(self) -> np.ndarray:
        sizes = np.array([s for s, _ in NET_SIZE_DISTRIBUTION])
        probs = np.array([p for _, p in NET_SIZE_DISTRIBUTION], dtype=np.float64)
        probs /= probs.sum()
        k = self.rng.choice(sizes, size=self.num_nets, p=probs)
        return np.minimum(k, self.num_nodes)

    def _sample_nets(self, k: int, count: int) -> np.ndarray:
        """(count, k) matrix of distinct sorted 0-based node ids."""
        out = self.rng.integers(0, self.num_nodes, size=(count, k), dtype=np.int64)
        out.sort(axis=1)
        bad = (np.diff(out, axis=1) == 0).any(axis=1)
        while bad.any():
            redraw = self.rng.integers(
                0, self.num_nodes, size=(int(bad.sum()), k), dtype=np.int64
            )
            redraw.sort(axis=1)
            out[bad] = redraw
            bad[bad] = (np.diff(redraw, axis=1) == 0).any(axis=1)
        return out

    def generate(self) -> Hypergraph:
        sizes = self._net_sizes()
        offs = np.zeros(self.num_nets + 1, dtype=np.int64)
        np.cumsum(sizes, out=offs[1:])
        pins = np.empty(int(offs[-1]), dtype=np.int32)
        for k in np.unique(sizes):
            sel = np.nonzero(sizes == k)[0]
            mat = self._sample_nets(int(k), sel.size)
            pos = offs[sel][:, None] + np.arange(int(k))[None, :]
            pins[pos] = mat
        return Hypergraph(
            num_nodes=self.num_nodes,
            num_nets=self.num_nets,
            pins=pins,
            net_offsets=offs,
            name=f"generated_{self.size_multiplier}x",
        )

    def write(self, path: str) -> Hypergraph:
        hg = self.generate()
        write_hgr(path, hg)
        return hg


def generate_circuit(
    size_multiplier: float, seed: int | None = None
) -> Hypergraph:
    return CircuitGenerator(size_multiplier, seed).generate()
