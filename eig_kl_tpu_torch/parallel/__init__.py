"""Running refinements side by side (the port of ``eig_kl_tpu/parallel``).

On one card the starts of a multi-start run are the blocks of one K2
launch (:mod:`eig_kl_tpu_torch.parallel.multi_start`), and the node-sharded
pass runs its shards as the blocks of one thread-block cluster, kernel K5
(:mod:`eig_kl_tpu_torch.parallel.smega`).

Across ranks of a ``torch.distributed`` group (one process per card, or
per CPU rank over gloo) a :class:`~eig_kl_tpu_torch.parallel.mesh.Mesh`
lays the ranks out as the JAX ``(dp, mp)`` mesh: the node-sharded engines
(:func:`sharded_refine`, the owner-computes
:func:`~eig_kl_tpu_torch.parallel.sharded_kl2.sharded_refine_oc` of the
CLI's ``kl --sharded``) and the power iteration
(:func:`sharded_power_fiedler`) split the nodes over ``"mp"``;
:func:`multi_start_refine_mega_sharded` splits the starts over ``"dp"``.
The JAX ``multi_start_refine`` (a ``vmap`` of the XLA engine) has no
counterpart: the port's one engine plays that part.  ``smega_refine`` on a
mesh runs one shard per rank of ``"mp"``: kernel K5R, its two rounds per
swap stores into the peers' memory through CUDA IPC (the ranks of one
host: a card each, or several on one card), and on the CPU its plain
version over the group.
"""

from eig_kl_tpu_torch.parallel.mesh import make_mesh, node_sharding
from eig_kl_tpu_torch.parallel.multi_start import (
    multi_start_refine_mega,
    multi_start_refine_mega_sharded,
)
from eig_kl_tpu_torch.parallel.sharded_kl import sharded_refine
from eig_kl_tpu_torch.parallel.sharded_power import sharded_power_fiedler
from eig_kl_tpu_torch.parallel.smega import SmegaPlan, smega_refine

__all__ = [
    "make_mesh",
    "node_sharding",
    "sharded_refine",
    "sharded_power_fiedler",
    "multi_start_refine_mega",
    "multi_start_refine_mega_sharded",
    "SmegaPlan",
    "smega_refine",
]
