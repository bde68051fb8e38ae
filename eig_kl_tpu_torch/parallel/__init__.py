"""Running refinements side by side (the port of ``eig_kl_tpu/parallel``).

On one card the starts of a multi-start run are the blocks of one K2
launch (:mod:`eig_kl_tpu_torch.parallel.multi_start`), and the node-sharded
pass runs its shards as the blocks of one thread-block cluster, kernel K5
(:mod:`eig_kl_tpu_torch.parallel.smega`).  Spreading work over several
cards (the mesh, ``sharded_power``, ``sharded_kl``, ``sharded_kl2``, the
JAX CLI's ``kl --sharded``, and K5 across cards) is ROADMAP.md A8b."""

from eig_kl_tpu_torch.parallel.multi_start import multi_start_refine_mega
from eig_kl_tpu_torch.parallel.smega import SmegaPlan, smega_refine

__all__ = ["multi_start_refine_mega", "SmegaPlan", "smega_refine"]
