"""The EIG-result file protocol (`pre_saved_EIG/<base>_out.txt`).

This file decouples the spectral phase from KL refinement and doubles as
the framework's checkpoint/resume mechanism, exactly as in the
reference (written cEIG.cpp:211-220 and gKL2.cu:229-255; read
cKL.cpp:155-174 and gKL.cu:276-301):

* line 1: eigenvalue (lambda_2, the Fiedler value), 12 significant digits
* line 2: median of the Fiedler vector, 12 significant digits
* lines 3..n+2: ``<node>\\t<side>\\t<value>`` where
  ``side = (median > value)`` (cEIG.cpp:218).

We keep byte-level compatibility so that our KL can consume the golden
``pre_saved_EIG`` fixtures and the reference KL could consume our EIG
output.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def _fmt12(x: float) -> str:
    """Format like C++ ``setprecision(12)`` (12 significant digits)."""
    return f"{x:.12g}"


@dataclasses.dataclass(frozen=True)
class EigResult:
    """Spectral-phase output.

    Attributes:
      eigenvalue: lambda_2 of the clique-expansion Laplacian.
      median: median of the Fiedler vector.
      sides: int8[n] -- 0/1 partition side per node, side = median > value.
      values: float64[n] -- Fiedler vector entries.
    """

    eigenvalue: float
    median: float
    sides: np.ndarray
    values: np.ndarray

    @property
    def num_nodes(self) -> int:
        return int(self.sides.shape[0])

    def balance(self) -> tuple[int, int]:
        right = int(self.sides.sum())
        return self.num_nodes - right, right


def write_eig_file(path: str | os.PathLike, result: EigResult) -> None:
    """Write the reference-compatible EIG output file (cEIG.cpp:213-220)."""
    lines = [_fmt12(result.eigenvalue) + "\n", _fmt12(result.median) + "\n"]
    for i in range(result.num_nodes):
        lines.append(
            f"{i}\t{int(result.sides[i])}\t{_fmt12(float(result.values[i]))}\n"
        )
    with open(os.fspath(path), "w") as f:
        f.writelines(lines)


def read_eig_file(path: str | os.PathLike) -> EigResult:
    """Read an EIG output file (cKL.cpp:155-174 skips the 2 header lines
    and reads ``node side value`` triples; node ids may be unordered)."""
    with open(os.fspath(path), "r") as f:
        eigenvalue = float(f.readline())
        median = float(f.readline())
        rows = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if rows.size == 0:
        raise ValueError(f"EIG file {path} has no node rows")
    nodes = rows[:, 0].astype(np.int64)
    n = int(nodes.max()) + 1
    sides = np.zeros(n, dtype=np.int8)
    values = np.zeros(n, dtype=np.float64)
    sides[nodes] = rows[:, 1].astype(np.int8)
    values[nodes] = rows[:, 2]
    return EigResult(eigenvalue=eigenvalue, median=median, sides=sides, values=values)


def eig_out_path(input_path: str | os.PathLike, out_dir: str = "pre_saved_EIG") -> str:
    """Canonical EIG output path for an input circuit, mirroring
    ``pre_saved_EIG/<basename>_out.txt`` (cEIG.cpp:164, cKL.cpp:442)."""
    base = os.path.basename(os.fspath(input_path))
    return os.path.join(out_dir, base + "_out.txt")
