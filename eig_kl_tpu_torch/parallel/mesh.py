"""The mesh of ranks and its collectives (the port of
``eig_kl_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``(dp, mp)`` mesh: ``"mp"``
splits the nodes (the sharded engines), ``"dp"`` splits the starts of a
multi-start run.  Here a device is a rank of the default
``torch.distributed`` process group, one process per rank, each on its
own card (rank r on ``cuda:LOCAL_RANK``) or on the CPU.  Rank ``r`` of
the first ``dp * mp`` ranks sits at row ``r // mp``, column ``r % mp``,
as ``np.asarray(jax.devices()).reshape(dp, mp)`` places device ``r``.

The JAX ``node_sharding(mesh)`` (a ``NamedSharding`` that splits the
leading node axis over ``"mp"``) is a rank's row range here:
:func:`node_sharding` gives rank ``r`` the nodes ``[r * n_l, (r + 1) *
n_l)`` of ``n_pad = mp * n_l``.  What JAX replicates, every rank holds
whole.

The group's collectives carry tensors of the group's backend: NCCL
takes them on the card, gloo on the host.  :meth:`Mesh.all_gather` and
:meth:`Mesh.sum` move a tensor to where the backend takes it and back,
so gloo also serves two ranks that share one card (NCCL refuses that).
:meth:`Mesh.sum` adds the ranks' values in rank order on every rank:
the order of the JAX ``psum`` over the CPU's virtual devices (measured:
a left fold in device order at 2, 4 and 8 devices), whatever order the
backend's own all-reduce takes.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from eig_kl_tpu_torch.utils.device import resolve_device

#: Every group the port makes waits at most this long for a peer, so a
#: rank that dies or hangs fails its peers instead of stalling them.
GROUP_TIMEOUT = datetime.timedelta(seconds=60)

_created_default = False
_meshes: dict[tuple, "Mesh"] = {}


def world_size() -> int:
    """The ranks of the default group, or of the ``torchrun`` launch
    (``WORLD_SIZE``) before the group exists; 1 without either."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    """This process's rank (``RANK`` before the group exists; 0 without)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def init_default_group(device: torch.device) -> None:
    """Make the default group if none exists: from ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) where it is set, else a group of one rank in this
    process.  NCCL for a CUDA device, gloo for the CPU."""
    global _created_default
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), timeout=GROUP_TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, timeout=GROUP_TIMEOUT)
    _created_default = True


def release_default_group() -> None:
    """Destroy the default group if :func:`init_default_group` made it
    (a caller's own group is left alone), and forget the meshes on it."""
    global _created_default
    if _created_default and dist.is_initialized():
        dist.destroy_process_group()
    _created_default = False
    _meshes.clear()


def rank_device(device: str | torch.device | None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (modulo the cards present,
    so that ranks may share a card over gloo) or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank()))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


class Mesh:
    """A ``(dp, mp)`` grid of the first ``dp * mp`` ranks of the default
    group: the counterpart of ``jax.sharding.Mesh``.

    Attributes:
      shape: ``{"dp": dp, "mp": mp}`` (keyed by ``axis_names``), as the
        JAX mesh's ``shape``.
      axis_names: the two axes' names, the split of the starts first.
      device: this rank's device.
      member: whether this rank is one of the mesh's; the engines refuse
        a rank outside it.
      coords: this rank's index along each axis.
    """

    def __init__(self, n_devices: int, dp: int, axis_names, device: torch.device):
        self.axis_names = tuple(axis_names)
        dp_name, mp_name = self.axis_names
        mp = n_devices // dp
        self.shape = {dp_name: dp, mp_name: mp}
        self.device = device
        me = dist.get_rank()
        self.member = me < n_devices
        self.coords = {dp_name: me // mp, mp_name: me % mp} if self.member else {}
        grid = np.arange(n_devices).reshape(dp, mp)
        self._groups: dict[str, object] = {}
        # Every rank makes every group, in one order (new_group is collective).
        for name, lines in ((mp_name, grid), (dp_name, grid.T)):
            for line in lines:
                ranks = [int(r) for r in line]
                if len(ranks) == 1:
                    continue
                group = (dist.group.WORLD if len(ranks) == dist.get_world_size()
                         else dist.new_group(ranks, timeout=GROUP_TIMEOUT))
                if me in ranks:
                    self._groups[name] = group

    def _check_member(self) -> None:
        if not self.member:
            raise ValueError(f"rank {dist.get_rank()} is not in the {self.shape} mesh")

    def _comm_device(self, group) -> torch.device:
        return self.device if dist.get_backend(group) == "nccl" else torch.device("cpu")

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` of every rank along ``axis``, stacked in rank order on a
        new leading axis, on ``t``'s device (``jax.lax.all_gather``)."""
        self._check_member()
        if self.shape[axis] == 1:
            return t[None]
        group = self._groups[axis]
        x = t.contiguous().to(self._comm_device(group))
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts).to(t.device)

    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of ``t`` over the ranks along ``axis``, added in rank
        order on every rank (``jax.lax.psum`` as the JAX CPU backend adds)."""
        parts = self.all_gather(t, axis)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def all_gather_object(self, obj, axis: str) -> list:
        """The picklable ``obj`` of every rank along ``axis``, in rank order."""
        self._check_member()
        if self.shape[axis] == 1:
            return [obj]
        out = [None] * self.shape[axis]
        dist.all_gather_object(out, obj, group=self._groups[axis])
        return out


def make_mesh(
    n_devices: int | None = None,
    dp: int = 1,
    axis_names=("dp", "mp"),
    *,
    device: str | torch.device | None = None,
) -> Mesh:
    """A ``(dp, mp)`` mesh over the first ``n_devices`` ranks of the
    default group (all of them by default), made first if none exists
    (:func:`init_default_group`).  ``device`` (default the card) is where
    this rank computes.  Every rank of the group calls it with the same
    arguments; meshes are kept per arguments and made once."""
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_default_group(dev)
    have = dist.get_world_size()
    if n_devices is None:
        n_devices = have
    if n_devices > have:
        raise ValueError(f"requested {n_devices} devices, have {have}")
    if n_devices % dp != 0:
        raise ValueError(f"n_devices={n_devices} not divisible by dp={dp}")
    key = (n_devices, dp, tuple(axis_names), dev, id(dist.group.WORLD))
    if key not in _meshes:
        _meshes[key] = Mesh(n_devices, dp, axis_names, dev)
    return _meshes[key]


def node_sharding(mesh: Mesh, n_pad: int, axis: str = "mp") -> range:
    """This rank's nodes of the ``n_pad`` padded nodes split over
    ``axis``: ``[r * n_l, (r + 1) * n_l)`` with ``n_l = n_pad / size``
    (the JAX ``node_sharding``'s shard)."""
    mesh._check_member()
    n_l = n_pad // mesh.shape[axis]
    r0 = mesh.coords[axis] * n_l
    return range(r0, r0 + n_l)
