"""Data-parallel batch execution: images split over the ranks of the
``data`` axis (counterpart of ``photohive_dsp_tpu/parallel/sharding.py``).

Each image's report is independent, so the batch axis partitions with no
collective in the body: each rank runs ``full_report_batched`` on its
slice of the batch, kernels included.  The one collective is the gather of
the outputs over the data axis, which the JAX package gets implicitly from
its global array: here one ``all_gather`` of the packed ``ReportData``, so
every rank returns all the batch's reports (the convention of
``spatial.build_spatial_report``: every rank is handed the whole input and
returns the whole output).  A JAX ``Mesh`` of devices is a ``mesh.Mesh`` of
process groups, one process per rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import ReportConfig
from ..models.pipeline import (ReportData, cached_tables, full_report_batched,
                               resolve_device)
from ..models.staging import device_batch
from ..utils.profiling import span
from .mesh import Mesh


def gather_reports(local: ReportData, group) -> ReportData:
    """Each rank's (b_l, ...) reports -> the (n * b_l, ...) reports of all
    ``n`` ranks of ``group`` in group-rank order, on every rank: one
    ``all_gather`` of the fields packed as 32-bit words (every field is
    float32 or int32, so the packing moves bits, not values)."""
    b = local[0].shape[0]
    if any(x.element_size() != 4 for x in local):
        raise TypeError("gather_reports packs 32-bit fields only")
    words = torch.cat([x.contiguous().view(torch.int32).reshape(b, -1)
                       for x in local], dim=1)
    parts = [torch.empty_like(words)
             for _ in range(dist.get_world_size(group))]
    with span("photohive.collective.all_gather"):
        dist.all_gather(parts, words, group=group)
    words = torch.cat(parts)
    fields, at = [], 0
    for x in local:
        n = x[0].numel()
        fields.append(words[:, at:at + n].contiguous().view(x.dtype)
                      .reshape((-1,) + tuple(x.shape[1:])))
        at += n
    return ReportData(*fields)


def _local_slice(mesh: Mesh, b: int) -> slice:
    """The batch rows of this rank's data index; raises unless the data
    axis divides the batch (pad at the caller; models/batch.py does)."""
    if b % mesh.data:
        raise ValueError(f"batch {b} must divide by data={mesh.data}")
    per = b // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def data_parallel_report(height: int, width: int, cfg: ReportConfig,
                         mesh: Mesh, device="cuda"):
    """The batch report with the batch split over ``mesh``'s data axis
    (replicated over its spatial axis, as the JAX package's
    ``P(DATA_AXIS)`` is).  Returns (fn, tables); fn(batch (B, 3, H, W)
    float32 in [0, 1] or (B, H, W, 3) uint8, boxes (B, 10, 4), valid
    (B, 10), tables) -> ReportData (B, ...) on ``device``, the same on
    every rank; uint8 travels as it is and is made planar there.  Every rank
    is handed the whole batch (host arrays, or tensors on any device) and
    moves only its slice to ``device`` (``staging.device_batch``).  B must
    be a multiple of the data axis.  The palette variant is read at each
    call, as ``full_report_batched`` reads it."""
    cfg.validate()
    dev = resolve_device(device)
    tables = cached_tables(height, width, cfg, dev)

    def fn(batch, boxes, valid, tables) -> ReportData:
        batch = torch.as_tensor(batch)
        rows = _local_slice(mesh, batch.shape[0])
        local = full_report_batched(device_batch(batch[rows], dev),
                                    torch.as_tensor(boxes)[rows].cpu(),
                                    torch.as_tensor(valid)[rows].cpu(),
                                    tables, cfg)
        return gather_reports(local, mesh.data_group)

    return fn, tables


# The JAX package's uint8 entry point: the batch's dtype picks the layout.
data_parallel_report_u8 = data_parallel_report


def flat_data_mesh(mesh: Mesh) -> Mesh:
    """All of ``mesh``'s ranks as one pure ``data`` axis.

    Small images don't use the spatial axis; folding it into ``data``
    means a dp x sp mesh still data-parallelizes small batches over every
    rank instead of replicating the work ``spatial``-fold.  The groups
    were made with the mesh (``make_mesh``), so this is no collective."""
    return mesh.flat or mesh
