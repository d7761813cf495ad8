"""One rank's place in the collective backend (counterpart of
``consensusml_tpu/comm/mesh.py``).

The reference binds a topology to a device mesh (``WorkerMesh``, one
device a worker, inside one ``shard_map``). Here a worker is a process:
its :class:`WorkerMesh` holds the topology, its rank and the world size
in the ``torch.distributed`` process group, its device, and the
transport the gossip bytes ride (:mod:`.transport`). The process group
is made by the caller (:func:`consensusml_tpu_torch.comm.launch.launch`
does it for every rank it spawns).

Exchanges that stay in flight while the rank does other work (overlap
gossip's correction, under the local steps) ride a second transport,
:meth:`WorkerMesh.inflight_transport`, over a process group of their own
on the same ranks: the turn-taking barrier and the metrics' all-reduces
on the mesh's group then neither wait for those requests nor order
against them. It counts into the mesh transport's statistics.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from consensusml_tpu_torch.comm.transport import Transport, check_nccl_world, make_transport
from consensusml_tpu_torch.topology import Topology

__all__ = ["WorkerMesh", "rank_device"]


def rank_device(rank: int, device: str | torch.device | None = None) -> torch.device:
    """Rank ``rank``'s device: the CPU when asked (``device="cpu"``), else
    card ``rank % torch.cuda.device_count()`` (ranks share cards round
    robin). Without a GPU that raises unless the CPU was asked for."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda", rank % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """A topology bound to one rank of a process group."""

    topology: Topology
    rank: int
    world_size: int
    group: Any  # the torch.distributed process group (None: the default group)
    device: torch.device
    transport: Transport
    dist_backend: str = "gloo"
    _inflight: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def create(cls, topology: Topology, dist_backend: str = "gloo", device: str | torch.device | None = None,
               group=None) -> "WorkerMesh":
        """This process's mesh in ``group`` (default: the default process
        group, which must be initialised), on :func:`rank_device`, over the
        ``dist_backend`` transport. The world size must be the
        topology's."""
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        if world != topology.world_size:
            raise ValueError(
                f"the topology has {topology.world_size} workers but the process group has {world} ranks"
            )
        dev = rank_device(rank, device)
        if dist_backend == "nccl":
            if dev.type != "cuda":
                raise ValueError("--dist-backend nccl runs on CUDA devices only; use --dist-backend gloo on the CPU")
            check_nccl_world(world, torch.cuda.device_count())
        return cls(topology=topology, rank=rank, world_size=world, group=group, device=dev,
                   transport=make_transport(dist_backend, group, rank, dev), dist_backend=dist_backend)

    def inflight_transport(self) -> Transport:
        """The transport of exchanges left in flight (module docstring),
        its process group made at the first call: every rank must make
        that call at the same point of its program, as it makes every
        collective call."""
        if "transport" not in self._inflight:
            ranks = None if self.group is None else dist.get_process_group_ranks(self.group)
            group = dist.new_group(ranks=ranks, backend=self.dist_backend)
            side = make_transport(self.dist_backend, group, self.rank, self.device)
            side.stats = self.transport.stats
            self._inflight["transport"] = side
        return self._inflight["transport"]

    @property
    def shares_device(self) -> bool:
        """Whether other ranks run on this rank's card (more ranks than
        cards): their kernels are then time-sliced on it."""
        return self.device.type == "cuda" and self.world_size > torch.cuda.device_count()

    def barrier(self) -> None:
        """Every rank reaches this point before any leaves it."""
        dist.barrier(group=self.group)
