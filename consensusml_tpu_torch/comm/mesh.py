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

Model axes (``model_axes``, the reference's hybrid gossip-DP x tensor
parallelism, ``consensusml_tpu/comm/mesh.py:73-130``) make a worker
``prod(sizes)`` ranks: the world is laid out row-major over
``(*topology.mesh_shape, *model axis sizes)``, so rank ``r`` is worker
``r // per_worker`` at model index ``r % per_worker``. The mesh's
``rank``, ``world_size``, ``group`` and ``transport`` are then those of
its gossip group, the ranks of the same model index on every worker,
whose group ranks are the worker indices (the gossip runs on it as it
runs on a world of workers); ``model`` is the :class:`~consensusml_tpu_
torch.parallel.axis.Axis` of the worker's own ranks, over which its
model's collectives run. Every rank makes every group, in one order.
"""

from __future__ import annotations

import dataclasses
import math
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
    model_axes: tuple[tuple[str, int], ...] = ()
    model: Any = None  # the worker's model-parallel Axis (None without model axes)
    world_rank: int = 0  # this rank in the whole world (the rank itself without model axes)
    _inflight: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @classmethod
    def create(cls, topology: Topology, dist_backend: str = "gloo", device: str | torch.device | None = None,
               group=None, model_axes=()) -> "WorkerMesh":
        """This process's mesh in ``group`` (default: the default process
        group, which must be initialised), on :func:`rank_device`, over the
        ``dist_backend`` transport. The world size must be the topology's
        times the ranks a worker (``model_axes``: ``(name, size)`` pairs;
        the module docstring)."""
        model_axes = tuple((str(n), int(s)) for n, s in model_axes)
        if overlap := {n for n, _ in model_axes} & set(topology.axis_names):
            raise ValueError(f"model axes {sorted(overlap)} collide with worker axes")
        per_worker = math.prod(s for _, s in model_axes)
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        if world != topology.world_size * per_worker:
            each = f" x {per_worker} ranks a worker" if per_worker > 1 else ""
            raise ValueError(
                f"the topology has {topology.world_size} workers{each} but the process group has {world} ranks"
            )
        dev = rank_device(rank, device)
        if dist_backend == "nccl":
            if dev.type != "cuda":
                raise ValueError("--dist-backend nccl runs on CUDA devices only; use --dist-backend gloo on the CPU")
            check_nccl_world(world, torch.cuda.device_count())
        if per_worker == 1:
            return cls(topology=topology, rank=rank, world_size=world, group=group, device=dev,
                       transport=make_transport(dist_backend, group, rank, dev), dist_backend=dist_backend,
                       world_rank=rank)
        if group is not None:
            raise ValueError("model axes lay out the default process group; pass group=None")
        if len(model_axes) > 1:
            raise NotImplementedError("the port's model parallelism runs one model axis")
        from consensusml_tpu_torch.parallel.axis import make_axes

        workers = topology.world_size
        # the gossip groups (one a model index), then the model groups (one a worker)
        gossip = make_axes("workers", [[w * per_worker + m for w in range(workers)] for m in range(per_worker)],
                           rank, dev, dist_backend)
        model = make_axes(model_axes[0][0], [[w * per_worker + m for m in range(per_worker)]
                                             for w in range(workers)], rank, dev, dist_backend)
        return cls(topology=topology, rank=gossip.index, world_size=workers, group=gossip.transport.group,
                   device=dev, transport=gossip.transport, dist_backend=dist_backend, model_axes=model_axes,
                   model=model, world_rank=rank)

    @property
    def per_worker(self) -> int:
        """Ranks a worker: the product of the model axes' sizes."""
        return math.prod(s for _, s in self.model_axes)

    def inflight_transport(self) -> Transport:
        """The transport of exchanges left in flight (module docstring),
        its process group made at the first call: every rank must make
        that call at the same point of its program, as it makes every
        collective call. Not under model axes (the groups would differ
        between ranks)."""
        if self.model is not None:
            raise NotImplementedError("exchanges in flight (overlap gossip) do not run under model axes")
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
        return self.device.type == "cuda" and self.world_size * self.per_worker > torch.cuda.device_count()

    def barrier(self) -> None:
        """Every rank of the mesh's group reaches this point before any
        leaves it."""
        dist.barrier(group=self.group)

    def world_barrier(self) -> None:
        """Every rank of the world (every model index of every worker)."""
        dist.barrier()
