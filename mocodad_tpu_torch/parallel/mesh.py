"""The data-parallel mesh: which ranks, which device each drives, over
which process group.

Counterpart of `mocodad_tpu/parallel/mesh.py`.  The JAX mesh is a 1-D
'data' axis over devices, batches sharded along it and the state
replicated, with XLA inserting the gradient psum.  Here a rank is one
process driving one device: `make_mesh` says which rank this process is,
its device and the process group its collectives go over; `shard_batch`
keeps the rank's rows of a global host batch; `replicate` broadcasts a
module's parameters and buffers from rank 0 (what `replicated_sharding`
states for JAX).

The backend follows from where the ranks are placed: NCCL when each rank
has a GPU of its own, gloo on the CPU or when ranks share a card.  It is
never a fallback: an NCCL failure raises.

Not ported: `shard_grouped_batch` (several train steps per dispatch are
single-process, in the JAX package as here, so a grouped batch is never
sharded) and `batch_sharding` (a JAX placement object; `shard_batch`
places).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from mocodad_tpu_torch.device import (check_device_count, rank_device,
                                      resolve_device)
from mocodad_tpu_torch.parallel.distributed import broadcast_, local_rows


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a data-parallel run: `world` ranks, this
    one `rank`, driving `device`; `group` (None for a process alone)
    carries its collectives over `backend`."""
    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    backend: Optional[str] = None


def backend_for(devices: Sequence[torch.device]) -> str:
    """'nccl' when every rank has a GPU of its own, else 'gloo'."""
    cuda = all(d.type == 'cuda' for d in devices)
    return 'nccl' if cuda and len(set(devices)) == len(devices) else 'gloo'


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None, device=None) -> Mesh:
    """The mesh of this process.

    `devices` names each rank's device, in rank order, and may name one
    card more than once.  Without it, each rank drives the device of kind
    `device` (default CUDA, raising without it; 'cpu' for CPU ranks) at
    its index on its host (`device.rank_device`), and `n_devices` GPUs per
    host must be visible (`requested N devices, have M` otherwise).
    `n_devices` defaults to the size of the process group this process is in, or 1
    outside one.  A mesh of more than one rank needs that many processes
    in the group (`distributed.launch`, torchrun or the MOCODAD_*
    variables); a mesh of one process outside a group is that process and
    its device, with no collectives."""
    kind = resolve_device(device if devices is None else
                          torch.device(devices[0]).type).type
    in_group = dist.is_initialized()
    world = dist.get_world_size() if in_group else 1
    rank = dist.get_rank() if in_group else 0
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        if n_devices is not None and n_devices != n:
            raise ValueError(f'n_devices={n_devices} but {n} devices named')
    else:
        n = world if n_devices is None else int(n_devices)
        check_device_count(int(os.environ.get('LOCAL_WORLD_SIZE', n)), kind)
    if n != world:
        raise ValueError(
            f'a mesh of {n} ranks needs {n} processes, and this one is '
            f'{"in a group of " + str(world) if in_group else "alone"}: '
            f'start the ranks with --n-devices {n}, torchrun or the '
            f'MOCODAD_* variables (mocodad_tpu_torch/parallel/distributed.py)')
    if not in_group:
        return Mesh(world=1, rank=0, device=(
            resolve_device(device) if devices is None else devices[0]))
    if devices is None:
        dev = rank_device(kind, rank)
        backend = 'nccl' if kind == 'cuda' else 'gloo'
    else:
        dev, backend = devices[rank], backend_for(devices)
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
    group = (dist.new_group(backend='nccl') if backend == 'nccl'
             else dist.group.WORLD)
    return Mesh(world=world, rank=rank, device=dev, group=group,
                backend=backend)


def shard_batch(batch: dict, mesh: Optional[Mesh]) -> dict:
    """The rank's contiguous rows of every array of a global host batch
    (the same seeded batch on every rank), as the JAX package's
    multi-process `shard_batch`; the batch itself on a mesh of one rank.
    Raises when the rows do not split evenly, in the JAX package's
    words."""
    if mesh is None or mesh.world == 1:
        return batch
    rows = next(iter(batch.values())).shape[0]
    if rows % mesh.world:
        raise ValueError(
            f'batch rows ({rows}) must be divisible by the mesh '
            f"'data' axis ({mesh.world} devices) — set batch_size to a "
            f'multiple of the device count (loaders pad every batch to '
            f'batch_size, so configuring that suffices)')
    return {key: local_rows(v, mesh) for key, v in batch.items()}


def replicate(net: nn.Module, mesh: Optional[Mesh]) -> None:
    """Give every rank rank 0's parameters and buffers."""
    broadcast_(itertools.chain(net.parameters(), net.buffers()), mesh)
