"""KL refinement: one pass of one or several starts per launch of kernel
K2 (kl/megakernel.py); passes and kicks around it (kl/multipass.py)."""

from eig_kl_tpu_torch.kl.init import perturb_split, random_split, sides_balance, split_from_eig
from eig_kl_tpu_torch.kl.result import KLResult

__all__ = ["KLResult", "perturb_split", "random_split", "split_from_eig", "sides_balance"]
