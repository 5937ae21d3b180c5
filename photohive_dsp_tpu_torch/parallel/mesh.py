"""Process groups (counterpart of ``photohive_dsp_tpu/parallel/mesh.py``).

The JAX package scales along two named axes of a device mesh:

  * ``data``    — independent images (the throughput axis);
  * ``spatial`` — row-tiles of a single large image (the image-size axis).

Here each axis is a set of ``torch.distributed`` process groups with one
process per rank: NCCL for the ranks' CUDA tensors, gloo for CPU tensors.
Rank r sits at data index r // spatial and spatial index r % spatial, as
the JAX package lays its devices out (``devices.reshape(data, spatial)``).
Nothing tells a program of a cluster, so each rank is given its rank, the
world size and a rendezvous that all ranks share: a file
(``file:///path``, a path no earlier group used) or a local TCP address
(``tcp://127.0.0.1:PORT``).
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"

# A collective that waits longer than this raises instead of hanging.
DEFAULT_TIMEOUT_S = 300.0


def initialize_distributed(rendezvous: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda",
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join this process to the world of ``num_processes`` ranks as rank
    ``process_id``.  ``device`` is where this rank computes: a CUDA device
    (made the current device, card ``process_id`` modulo the count when no
    index is given; NCCL carries its CUDA tensors and gloo its CPU ones) or
    the CPU (gloo alone).

    Unlike the JAX package's, which does nothing for a single process, this
    also makes a one-rank world when ``num_processes`` is 1 or None (with
    no rendezvous needed then): the port's collectives always run on a
    process group."""
    single = num_processes is None or num_processes <= 1
    rank, world = (0, 1) if single else (process_id, num_processes)
    if rank is None or not 0 <= rank < world:
        raise ValueError(f"process_id {process_id} outside [0, {world})")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    kw = dict(backend="cpu:gloo,cuda:nccl" if dev.type == "cuda" else "gloo",
              rank=rank, world_size=world,
              timeout=datetime.timedelta(seconds=timeout_s))
    if rendezvous is None:
        if not single:
            raise ValueError(f"{world} processes need a rendezvous")
        kw["store"] = dist.HashStore()
    else:
        kw["init_method"] = rendezvous
    dist.init_process_group(**kw)


def init_spatial_group(rank: int, world_size: int, rendezvous: str,
                       device="cuda",
                       timeout_s: float = DEFAULT_TIMEOUT_S):
    """Join this process to the ranks of the spatial axis
    (``initialize_distributed``) and return their group, the whole world:
    the process group ``spatial.build_spatial_report`` takes."""
    initialize_distributed(rendezvous, world_size, rank, device, timeout_s)
    return dist.group.WORLD


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in a (data, spatial) grid of all ranks, the
    counterpart of a JAX ``Mesh`` with the axes (``data``, ``spatial``).

    ``spatial_group`` holds the ranks that share this rank's data index
    (the rows of its images), ``data_group`` those that share its spatial
    index (in data-index order).  ``flat`` is the same ranks as one data
    axis (``sharding.flat_data_mesh``), made with the mesh when
    ``spatial`` > 1."""

    data: int
    spatial: int
    data_index: int
    spatial_index: int
    data_group: dist.ProcessGroup
    spatial_group: dist.ProcessGroup
    flat: Optional["Mesh"] = None

    @property
    def size(self) -> int:
        return self.data * self.spatial


def _grid(data: int, spatial: int, timeout: datetime.timedelta) -> Mesh:
    """Every rank makes every subgroup, in one order, its own or not:
    ``new_group`` is collective over the world and deadlocks otherwise."""
    rank = dist.get_rank()
    spatial_group, _ = dist.new_subgroups_by_enumeration(
        [[d * spatial + s for s in range(spatial)] for d in range(data)],
        timeout=timeout)
    data_group, _ = dist.new_subgroups_by_enumeration(
        [[d * spatial + s for d in range(data)] for s in range(spatial)],
        timeout=timeout)
    return Mesh(data, spatial, rank // spatial, rank % spatial, data_group,
                spatial_group)


def make_mesh(data: Optional[int] = None, spatial: int = 1,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """A (data, spatial) mesh over all ranks of the world
    (``initialize_distributed``).  Collective: every rank calls it, with
    the same sizes, in the same order as its other group-making calls.
    Raises as the JAX package does when data * spatial is not the number
    of ranks.  The subgroups' collectives give up after ``timeout_s``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs initialize_distributed first")
    n = dist.get_world_size()
    if data is None:
        if n % spatial != 0:
            raise ValueError(f"{n} ranks not divisible by spatial={spatial}")
        data = n // spatial
    if data * spatial != n:
        raise ValueError(f"data*spatial={data * spatial} != {n} ranks")
    timeout = datetime.timedelta(seconds=timeout_s)
    mesh = _grid(data, spatial, timeout)
    if spatial > 1:
        mesh = dataclasses.replace(mesh, flat=_grid(n, 1, timeout))
    return mesh
