"""eig_kl_tpu_torch -- the PyTorch/CUDA port of eig_kl_tpu.

The same EIG+KL hypergraph bipartitioner (spectral initialization from
the Fiedler vector of the clique-expanded graph, then Kernighan-Lin
swap refinement), running on an NVIDIA H100 through hand-written CUDA
kernels: ``csrc/spmv_csr.cu`` (the SpMV), ``csrc/kl_pass.cu`` (one
whole KL pass of each of S starts in one launch) and ``csrc/smega.cu``
(one pass with its nodes sharded over the blocks of a thread-block
cluster), among others in ``csrc/``.  Module paths and public names mirror
``eig_kl_tpu``; the package imports neither JAX nor ``eig_kl_tpu``.
Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``, where each kernel's plain PyTorch version runs.
"""

__version__ = "0.1.0"

from eig_kl_tpu_torch.io.hgr import Hypergraph, read_hgr, write_hgr
from eig_kl_tpu_torch.io.eigfile import EigResult, read_eig_file, write_eig_file
from eig_kl_tpu_torch.graph.expand import clique_expand
from eig_kl_tpu_torch.graph.csr import Graph, DeviceGraph

__all__ = [
    "Hypergraph",
    "read_hgr",
    "write_hgr",
    "EigResult",
    "read_eig_file",
    "write_eig_file",
    "clique_expand",
    "Graph",
    "DeviceGraph",
    "__version__",
]
