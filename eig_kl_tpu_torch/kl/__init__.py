"""KL refinement: one pass per launch of kernel K2 (kl/megakernel.py)."""

from eig_kl_tpu_torch.kl.init import random_split, sides_balance, split_from_eig
from eig_kl_tpu_torch.kl.result import KLResult

__all__ = ["KLResult", "random_split", "split_from_eig", "sides_balance"]
