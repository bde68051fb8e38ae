from eig_kl_tpu_torch.io.hgr import Hypergraph, read_hgr, write_hgr
from eig_kl_tpu_torch.io.eigfile import EigResult, read_eig_file, write_eig_file

__all__ = [
    "Hypergraph",
    "read_hgr",
    "write_hgr",
    "EigResult",
    "read_eig_file",
    "write_eig_file",
]
