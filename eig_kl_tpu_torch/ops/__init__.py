from eig_kl_tpu_torch.ops.partition import (
    cut_size,
    edge_weight,
    external_costs,
    gains,
    sides_to_signs,
    signs_to_sides,
)
from eig_kl_tpu_torch.ops.spmv import spmv

__all__ = [
    "spmv",
    "gains",
    "cut_size",
    "external_costs",
    "edge_weight",
    "sides_to_signs",
    "signs_to_sides",
]
