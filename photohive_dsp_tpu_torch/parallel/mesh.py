"""Process groups (counterpart of ``photohive_dsp_tpu/parallel/mesh.py``).

The JAX package names the axes of a device mesh; here the row-sharded
report's ``spatial`` axis is a ``torch.distributed`` process group with one
process per rank: NCCL when the ranks compute on CUDA devices, gloo when
they compute on the CPU.  Nothing tells a program of a cluster, so each rank
is given its rank, the world size and a rendezvous that all ranks share: a
file (``file:///path``, a path no earlier group used) or a local TCP
address (``tcp://127.0.0.1:PORT``).
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

def init_spatial_group(rank: int, world_size: int, rendezvous: str,
                       device="cuda", timeout_s: float = 300.0):
    """Join this process to the ranks of the spatial axis and return their
    group.  ``device`` is where this rank computes: a CUDA device (NCCL;
    made the current device, card ``rank`` modulo the count when no index
    is given) or the CPU (gloo).  A collective that waits longer than
    ``timeout_s`` raises instead of hanging."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo", init_method=rendezvous,
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD
