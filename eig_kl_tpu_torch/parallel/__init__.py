"""Running several refinements side by side (the port of
``eig_kl_tpu/parallel``).  On one card the starts of a multi-start run
are the blocks of one K2 launch; spreading work over several cards is
ROADMAP.md A8."""

from eig_kl_tpu_torch.parallel.multi_start import multi_start_refine_mega

__all__ = ["multi_start_refine_mega"]
