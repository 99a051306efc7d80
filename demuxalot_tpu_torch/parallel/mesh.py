"""Shard devices and the process group of barcode-sharded execution.

The counterpart of ``demuxalot_tpu/parallel/mesh.py``. The workload is
data-parallel over barcodes: call tables and logits are split by barcode
range, genotype tables are replicated, and the EM M-step partials are
summed once per iteration. A :class:`Mesh` is the ordered list of this
process's shard devices plus, when several processes take part, the
``torch.distributed`` process group that joins them. Shards are numbered
over all processes in rank order: rank r holds the shards after those of
ranks 0..r-1.

A device may hold several shards (the same card, or the CPU, named more
than once): that is how the CPU tests and a one-card machine run several
shards. The collectives here move small host-side values; with the
``nccl`` backend they go through the mesh's first card (``gloo`` also
reduces CUDA tensors, but gathers only CPU ones).
"""
from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DEFAULT_TIMEOUT = datetime.timedelta(minutes=5)


@dataclass(frozen=True)
class Mesh:
    """This process's shard devices, in shard order, and the group joining the processes."""

    devices: tuple  # torch.device per local shard
    shards_per_rank: tuple  # local shard count of every rank, in rank order
    group: Optional[dist.ProcessGroup] = None  # None: one process, no collectives

    @property
    def n_shards(self) -> int:
        return sum(self.shards_per_rank)

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self.group is not None else 0

    def comm_device(self) -> torch.device:
        """Where the collectives' tensors live: the first card for nccl, else the CPU."""
        if self.group is not None and dist.get_backend(self.group) == "nccl":
            return self.devices[0]
        return torch.device("cpu")

    def key(self) -> tuple:
        """Identity of the mesh for caches of per-shard layouts."""
        return (tuple(str(d) for d in self.devices), self.shards_per_rank, self.rank,
                id(self.group) if self.group is not None else None)


def make_mesh(devices: Optional[Sequence] = None, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """Mesh over ``devices`` (default: every visible CUDA card; raises without one).

    When ``torch.distributed`` is initialized the mesh spans every process
    of ``group`` (default: the world); each process passes its own devices.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() shards over the CUDA cards, but torch.cuda.is_available() is False; "
                               "pass devices=[torch.device('cpu'), ...] to shard on the CPU")
        devices = [torch.device("cuda", index) for index in range(torch.cuda.device_count())]
    devices = tuple(resolve_device(device) for device in devices)
    if not devices:
        raise ValueError("a mesh needs at least one shard device")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(devices, (len(devices),))
    if dist.get_backend(group) == "nccl":
        if devices[0].type != "cuda":
            raise ValueError("an nccl process group needs CUDA shard devices")
        torch.cuda.set_device(devices[0])
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    mesh = Mesh(devices, (0,) * world, group)
    counts = torch.zeros(world, dtype=torch.int64, device=mesh.comm_device())
    counts[rank] = len(devices)
    dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=group)
    return Mesh(devices, tuple(counts.tolist()), group)


def init_distributed(backend: Optional[str] = None, timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                     **kwargs) -> None:
    """Join the processes of a multi-process run (wraps ``init_process_group``).

    Call once per process before :func:`make_mesh`, with ``init_method``
    (e.g. ``"tcp://localhost:29500"``), ``world_size`` and ``rank``. The
    default backend is ``nccl`` where a CUDA card is visible and ``gloo``
    otherwise; a collective that waits longer than ``timeout`` raises.
    """
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend=backend, timeout=timeout, **kwargs)


def local_shard_ids(mesh: Mesh) -> list:
    """Positions along the mesh owned by this process."""
    first = sum(mesh.shards_per_rank[: mesh.rank])
    return list(range(first, first + len(mesh.devices)))


def allreduce_max_dims(values, mesh: Mesh) -> list:
    """Elementwise maximum of ``values`` over the mesh's processes (ints).

    One process returns them unchanged.
    """
    values = [int(v) for v in values]
    if mesh.group is None:
        return values
    tensor = torch.tensor(values, dtype=torch.int64, device=mesh.comm_device())
    dist.all_reduce(tensor, op=dist.ReduceOp.MAX, group=mesh.group)
    return tensor.tolist()


def to_host(blocks: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The per-shard ``blocks`` of every process, concatenated in shard order, on the CPU.

    ``blocks`` are this process's shards' results, one per local shard and
    all of one shape and dtype; every process must call this with the same
    shapes. Across processes the blocks travel as raw bytes through one
    ``all_gather``, so any dtype comes back bit for bit.
    """
    local = torch.cat([block.detach().cpu() for block in blocks])
    if mesh.group is None:
        return local
    row_shape, dtype = tuple(blocks[0].shape[1:]), blocks[0].dtype
    rows = blocks[0].shape[0]
    payload = local.reshape(local.shape[0], -1).contiguous().view(torch.uint8)
    most = max(mesh.shards_per_rank)
    padded = payload.new_zeros((most * rows, payload.shape[1]))
    padded[: payload.shape[0]] = payload
    padded = padded.to(mesh.comm_device())
    gathered = [torch.empty_like(padded) for _ in mesh.shards_per_rank]
    dist.all_gather(gathered, padded, group=mesh.group)
    parts = [part[: count * rows].cpu() for part, count in zip(gathered, mesh.shards_per_rank)]
    return torch.cat(parts).view(dtype).reshape((mesh.n_shards * rows, *row_shape))
