"""Serving artifacts: the batched report program, exported and reloaded
(counterpart of ``photohive_dsp_tpu/serving.py``).

``export_report`` captures ``models/pipeline.full_report_batched`` for one
(height, width, config) with ``torch.export``: an ATen graph in which every
kernel is one registered operator (``torch.ops.photohive.*``,
ops/library.py) and the palette tier and the sharpness route are
``torch.cond`` nodes, with the shape- and config-static tables (the octree
and polar tables, the FFT plan's twiddles) embedded as constants.
``load_report`` rehydrates it.  A serving process runs the graph that was
validated, whatever the Python around the kernels becomes.

    blob = export_report(1080, 1920, cfg, batch_size=16)      # bytes
    Path("report_1080p.pt2").write_bytes(blob)
    ...
    fn = load_report(blob)          # (u8 BHW3, boxes, valid) -> ReportData
    data = fn(u8_batch, boxes, valid)

Calling convention: (B, H, W, 3) uint8 frames on the artifact's device,
(B, 10, 4) int32 crop boxes [top, bottom, left, right) and (B, 10) bool
validity on the host, as CPU tensors.  The JAX artifact takes all three on
the device; here the boxes stay on the host, as ``full_report_batched``
takes them, so the sharpness route's predicates read no device memory and
the only device read of a call is the palette tier's one scalar.

The device takes the place of JAX's ``use_pallas``: an artifact exported
for ``cuda`` runs the CUDA kernels, one exported for ``cpu`` their plain
versions.  The palette variant (``PHOTOHIVE_PALETTE_KERNEL``) is the one
read at export time.  Unlike JAX's StableHLO, the artifact is not
self-contained: it holds the graph and the tables, and finds its operators
by name, so it loads in a process that has imported
``photohive_dsp_tpu_torch`` (which this module does).

A mesh artifact (``export_report(mesh=...)``) is the per-rank program of
the data-parallel layer (``parallel/sharding.py``): each rank of the mesh
loads it, runs its slice of the batch and gathers the rest, under the same
conventions (frames on the device, boxes on the host, operators by name).

Determinism: the kernels' sums are exact fixed point or added in a fixed
order, so an artifact gives the same outputs for the same inputs, and the
live ``full_report_batched`` on the same device gives them too.
"""

from __future__ import annotations

import io
from typing import Callable, Union

import torch
import torch.utils._pytree as pytree

from .config import MAX_CROP_BOXES, ReportConfig
from .models.pipeline import (ReportData, ReportTables, full_report_batched,
                              resolve_device)
from .ops.fft_plan import FftPlan, fft_kernel_eligible
from .parallel.sharding import flat_data_mesh, gather_reports

_SERIALIZED_NAME = "photohive_dsp_tpu_torch.ReportData"
# The extra file in which an artifact records its rank count.
_RANKS = "photohive_ranks"


def _register_serialization() -> None:
    """ReportData is a NamedTuple: ``torch.export.save`` needs a name for
    its output tree, registered once per process."""
    if ReportData not in pytree.SUPPORTED_SERIALIZED_TYPES:
        pytree._register_namedtuple(ReportData,
                                    serialized_type_name=_SERIALIZED_NAME)


class _ReportProgram(torch.nn.Module):
    """(B, H, W, 3) uint8, boxes, valid -> ReportData, for one table set:
    the frames made planar as ``BatchRunner.run_u8`` makes them, so the
    artifact's reports are its reports."""

    def __init__(self, tables: ReportTables, cfg: ReportConfig):
        super().__init__()
        self.tables = tables
        self.cfg = cfg

    def forward(self, u8: torch.Tensor, boxes: torch.Tensor,
                valid: torch.Tensor) -> ReportData:
        return full_report_batched(u8.permute(0, 3, 1, 2).contiguous(),
                                   boxes, valid, self.tables, self.cfg)


def export_report(height: int, width: int, cfg: ReportConfig | None = None,
                  *, batch_size: Union[int, str] = 16, device="cuda",
                  mesh=None) -> bytes:
    """Serialize the batched uint8 report program for one (H, W, config).

    ``batch_size`` is an int (the artifact takes exactly that batch) or
    ``"dynamic"``: a symbolic batch of 1 or more, so one artifact serves
    any batch size.  ``device`` is where the artifact runs: ``cuda`` (the
    kernels) or ``cpu`` (their plain versions); ``cuda`` without CUDA
    raises.  Returns the bytes ``torch.export.save`` writes.

    ``mesh`` (parallel.mesh.make_mesh) exports the data-parallel program:
    the per-rank program, the pinned artifact at batch ``batch_size`` /
    (data * spatial), all of the mesh's ranks as one data axis
    (``sharding.flat_data_mesh``), collective-free as the JAX package's
    is.  The artifact records that rank count, and ``load_report(mesh=)``
    runs it on every rank of a mesh of as many ranks.  ``batch_size`` must
    be a multiple of the rank count, and a dynamic batch is refused, as
    the JAX package refuses them.  Exporting reads only the mesh's sizes,
    so one process can export for all."""
    cfg = cfg or ReportConfig()
    cfg.validate()
    ranks = 1
    if mesh is not None:
        if batch_size == "dynamic":
            raise ValueError("dynamic batch is not supported with a mesh "
                             "(per-shard shapes must be static)")
        ranks = mesh.size
        if int(batch_size) % ranks:
            raise ValueError(f"batch_size {int(batch_size)} must divide the "
                             f"mesh's {ranks} devices")
        batch_size = int(batch_size) // ranks
    dev = resolve_device(device)
    _register_serialization()
    tables = ReportTables.build(height, width, cfg, dev)
    if fft_kernel_eligible(height, width):
        # Built before tracing, so that the graph embeds the plan's tables.
        FftPlan.for_shape(height, width, dev)
    dynamic = batch_size == "dynamic"
    b = 2 if dynamic else int(batch_size)
    example = (torch.zeros((b, height, width, 3), dtype=torch.uint8,
                           device=dev),
               torch.zeros((b, MAX_CROP_BOXES, 4), dtype=torch.int32),
               torch.zeros((b, MAX_CROP_BOXES), dtype=torch.bool))
    shapes = None
    if dynamic:
        batch = torch.export.Dim("b", min=1)
        shapes = ({0: batch}, {0: batch}, {0: batch})
    program = torch.export.export(_ReportProgram(tables, cfg), example,
                                  dynamic_shapes=shapes)
    program.example_inputs = None    # the zeros it was traced on stay here
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={_RANKS: str(ranks)})
    return buf.getvalue()


def load_report(blob: Union[bytes, bytearray], *,
                mesh=None) -> Callable[..., ReportData]:
    """Rehydrate an ``export_report`` artifact into a callable.

    The callable takes (u8 (B, H, W, 3) on the artifact's device, boxes
    (B, 10, 4) int32 and valid (B, 10) bool on the host) with the exported
    shape and batch, and returns a ReportData (leading batch dimension) on
    the artifact's device.

    With a ``mesh`` of as many ranks as the artifact was exported for
    (another count raises), every rank calls the callable with the whole
    batch: it runs the artifact on its slice and gathers every rank's
    reports (``sharding.gather_reports``), so each rank returns the whole
    batch's, the same on every rank."""
    _register_serialization()
    extra = {_RANKS: ""}
    program = torch.export.load(io.BytesIO(bytes(blob)),
                                extra_files=extra).module()
    if mesh is None:
        return program
    ranks = int(extra[_RANKS] or 1)
    if ranks != mesh.size:
        raise ValueError(f"artifact exported for {ranks} ranks, loaded on a "
                         f"mesh of {mesh.size}")
    flat = flat_data_mesh(mesh)

    def sharded_call(u8, boxes, valid) -> ReportData:
        per = u8.shape[0] // ranks
        rows = slice(flat.data_index * per, (flat.data_index + 1) * per)
        return gather_reports(program(u8[rows], boxes[rows], valid[rows]),
                              flat.data_group)

    return sharded_call
