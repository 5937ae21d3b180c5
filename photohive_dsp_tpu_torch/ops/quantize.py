"""HSV-grid colour quantization ("octree") -> fixed-shape colour palette
(counterpart of ``photohive_dsp_tpu/ops/quantize.py``).

reference: src/color_quantization.c.  Same steps as the JAX package, on
tensors with the batch dimension written out:

  1. Cell assignment (:108-161) with the reference's gray-collapse cast,
     and the integer cell histogram — K1,
     ``palette_kernels.cell_counts_s_from_rgb``.
  2. Saliency (:588-595) in float32, ordered by the reference's margin-1
     insertion sort — K2, ``margin_sort.margin_sort``.
  3. Coverage selection (:174-203) and the nearest-parent map with exact
     distance-rank ties (:253-288, :342-479), ``parent_assignment_from_order``.
  4. Per-pixel parent resolution and palette sums in one pass over the
     pixels: K3 (q=1, no populated cell tied) or K4 (first minimum distance
     over at most q candidates, q = 8 or the config's q_full), picked per
     batch from the tie structure by nested graph conditionals
     (``library.branch``, ``torch.cond``), as the JAX package's
     ``lax.switch`` does; on
     flat HSV pixels (the row-sharded report, the ``cwide`` route) K10 at
     q = 8 or q_full, or K14 over each cell's allowed parents,
     ``palette_sums_by_k_auto``.
  5. Palette averages with the hue-rotation offset (:510-576),
     ``palette_finalize_by_k``.

``PHOTOHIVE_PALETTE_KERNEL`` picks the route (``palette_kernel_variant``),
which the caller reads once per batch and passes down: ``bf16`` (the
default) and ``candidate`` run ``color_palette_batched_from_rgb`` (the
latter on float32 planes, K11-K13), ``cwide`` runs ``color_palette_batched``
on flat HSV planes with K9 and K14.  All three give the same palette.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import os

import numpy as np
import torch

from ..config import ReportConfig
from ..utils.profiling import span
from .geometry import octree_geometry
from .stats import div_const, fma_f32


class OctreeTables(NamedTuple):
    """Quantizer constants (geometry.OctreeGeometry) on the device."""

    centers: torch.Tensor      # (C, 3) f32 cell centres (h, s, v)
    s_v_f32: torch.Tensor      # (C,) f32 centre s*v as C computes it
    dist_ranks: torch.Tensor   # (C, C) int32 dense rank of exact distances

    @classmethod
    def for_config(cls, cfg: ReportConfig, device="cpu") -> "OctreeTables":
        geom = octree_geometry(cfg)
        return cls.from_numpy(geom.centers, geom.s_v_f32, geom.dist_ranks,
                              device)

    @classmethod
    def from_numpy(cls, centers, s_v_f32, dist_ranks,
                   device="cpu") -> "OctreeTables":
        return cls(
            centers=torch.tensor(np.asarray(centers, np.float32),
                                 device=device),
            s_v_f32=torch.tensor(np.asarray(s_v_f32, np.float32),
                                 device=device),
            dist_ranks=torch.tensor(np.asarray(dist_ranks, np.int32),
                                    device=device))


class PaletteResult(NamedTuple):
    """Fixed-shape palettes, batched: the first n_valid rows of each image
    are real entries, in the reference's valid_parents (saliency) order."""

    hsv: torch.Tensor          # (B, C, 3) f32 average H, S, V per slot
    percentages: torch.Tensor  # (B, C) f32 fraction of image pixels
    n_valid: torch.Tensor      # (B,) int32 number of real entries
    parent_ids: torch.Tensor   # (B, C) int32 cell id per slot (-1 pad)


class ParentAssignment(NamedTuple):
    """Counts-only state of the parent selection, batched."""

    order: torch.Tensor          # (B, C) int64 saliency-sorted cell ids
    n_valid: torch.Tensor        # (B,) int32
    valid_sorted: torch.Tensor   # (B, C) bool over sorted slots
    parent_of_cell: torch.Tensor  # (B, C) int64 unique nearest parent
    cell_tied: torch.Tensor      # (B, C) bool: per-pixel tie-break needed
    allowed: torch.Tensor        # (B, C, C) bool: tied parents per cell,
    #                              in valid (saliency) order


def assign_cells(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor,
                 cfg: ReportConfig) -> torch.Tensor:
    """Per-pixel octree cell id, int32 (reference
    src/color_quantization.c:127-145).  Python constants round to float32
    in these ops, as in the JAX package.  The cell id is XLA's
    ``x * f32(1/L)``, like ``div_const``: inside ``jax.jit``, as
    ``get_report`` runs, the JAX package's divisions by the cell steps
    become multiplies by their float32 reciprocals, and a multiply rounds
    alike on the CPU and the card."""
    vi = torch.clamp(div_const(v - cfg.black_thresh, cfg.cell_Lv), 0,
                     cfg.v_partitions - 1e-6).to(torch.int32)
    si = torch.clamp(div_const(s - cfg.gray_thresh, cfg.cell_Ls), 0,
                     cfg.s_partitions - 1e-6).to(torch.int32)
    hi = torch.clamp(div_const(h, cfg.cell_Lh), 0,
                     cfg.h_partitions - 1e-6).to(torch.int32)
    color_id = (hi * cfg.s_partitions + si) * cfg.v_partitions + vi
    # Gray: the premature int cast in the reference (:136) zeroes the value
    # index, so every gray pixel goes to the first gray cell.
    out = torch.where(v < cfg.black_thresh, cfg.black_id,
                      torch.where(s < cfg.gray_thresh, cfg.gray_start,
                                  color_id))
    return out.to(torch.int32)


def saliency_f32(counts: torch.Tensor, s_v_f32: torch.Tensor,
                 cfg: ReportConfig) -> torch.Tensor:
    """Float32 replica of the C saliency (src/color_quantization.c:588-595):
    (B, C) counts -> (B, C) f32.  The weight is one FMA
    (``stats.fma_f32``), as XLA contracts the JAX package's ``qw + svw *
    s_v`` inside ``jax.jit``: rounded twice, it moves by an ulp on some
    cells, and saliencies a few units apart can then swap in K2's order."""
    weight = fma_f32(cfg.saturation_value_weight, s_v_f32,
                     cfg.quantity_weight)
    return counts.to(torch.float32) * weight * 1000.0


def palette_widths(cfg: ReportConfig) -> Tuple[int, int]:
    """(q_small, q_full): the narrow candidate width, and the config's static
    worst case (no cell has more tie candidates than the largest
    equal-rank group of the distance table), rounded up to 8."""
    q_full = max(8, -(-octree_geometry(cfg).max_tie_candidates // 8) * 8)
    return 8, q_full


def parent_assignment_from_order(counts: torch.Tensor, order: torch.Tensor,
                                 total_pixels: int, cfg: ReportConfig,
                                 tables: OctreeTables) -> ParentAssignment:
    """Coverage selection and the nearest-parent map, given the saliency
    order (reference :174-203, :342-479).  counts, order: (B, C)."""
    b, c = counts.shape
    dev = counts.device
    order = order.long()
    iota = torch.arange(c, device=dev)
    goal = int(float(total_pixels) * cfg.coverage_thresh)  # C int cast
    cum = torch.gather(counts.long(), 1, order).cumsum(dim=1)
    n_valid = (cum >= goal).to(torch.int32).argmax(dim=1) + 1
    valid_sorted = iota[None, :] < n_valid[:, None]          # (B, C)
    pos_in_order = torch.empty_like(order).scatter_(
        1, order, iota.expand(b, c))
    is_valid = pos_in_order < n_valid[:, None]              # per cell id

    # Nearest valid parent per cell from the exact distance ranks:
    # rank_by_k[b, cell, k] = rank[cell, order[b, k]], invalid k masked.
    rank_by_k = tables.dist_ranks[:, order].permute(1, 0, 2)
    valid_k = valid_sorted[:, None, :]
    masked = torch.where(valid_k, rank_by_k, 1 << 30)
    is_min = masked == masked.amin(dim=-1, keepdim=True)
    num_mins = (is_min & valid_k).sum(dim=-1)
    first_min_k = is_min.to(torch.int32).argmax(dim=-1)     # first in order
    unique_parent = torch.gather(order, 1, first_min_k)
    return ParentAssignment(
        order=order, n_valid=n_valid.to(torch.int32),
        valid_sorted=valid_sorted,
        parent_of_cell=torch.where(is_valid, iota, unique_parent),
        cell_tied=~is_valid & (num_mins > 1),
        allowed=is_min & valid_k)


def candidate_slots(assign: ParentAssignment, num_cells: int,
                    q_pad: int) -> torch.Tensor:
    """(B, C, q_pad) int32: each cell's parent-candidate slots in ascending
    valid order, sentinel ``num_cells`` in unused entries.

    A cell's candidates are its row of ``assign.allowed`` (its unique
    parent when untied), so the first minimum distance over them in
    ascending slot order is the reference's tie rule
    (src/color_quantization.c:376-451)."""
    c = num_cells
    iota = torch.arange(c, dtype=torch.int32, device=assign.allowed.device)
    slots = torch.where(assign.allowed, iota, c)
    cand = torch.sort(slots, dim=-1).values[..., :q_pad]
    if q_pad > c:
        cand = torch.cat([cand, cand.new_full(
            cand.shape[:-1] + (q_pad - c,), c)], dim=-1)
    return cand.contiguous()


def palette_finalize_by_k(per_slot: torch.Tensor, assign: ParentAssignment,
                          total_pixels: int, tables: OctreeTables)\
        -> PaletteResult:
    """Palette averages from (B, C, 4) [sum wrapped hue, sum s, sum v,
    count] per valid-order slot (reference :510-576)."""
    offsets = 180.0 - tables.centers[:, 0]
    n_k = per_slot[..., 3]
    n_safe = torch.clamp(n_k, min=1.0)
    h_avg = per_slot[..., 0] / n_safe - offsets[assign.order]
    h_avg = torch.where(h_avg < 0.0, h_avg + 360.0,
                        torch.where(h_avg > 360.0, h_avg - 360.0, h_avg))
    s_avg = per_slot[..., 1] / n_safe
    v_avg = per_slot[..., 2] / n_safe
    pct = div_const(n_k, total_pixels)

    live = assign.valid_sorted
    hsv = torch.where(live[..., None], torch.stack([h_avg, s_avg, v_avg], -1),
                      0.0)
    return PaletteResult(
        hsv=hsv, percentages=torch.where(live, pct, 0.0),
        n_valid=assign.n_valid,
        parent_ids=torch.where(live, assign.order, -1).to(torch.int32))


def palette_tier(counts: torch.Tensor, assign: ParentAssignment,
                 cfg: ReportConfig) -> torch.Tensor:
    """Candidate width the batch needs, 1, q_small or q_full, as a 0-dim
    int64 tensor on the host.  Only cells that hold pixels matter.  The
    width is computed on the device and copied to the host once: the
    batch's one device read, from which the palette's route conditionals
    read their predicates without another."""
    q_small, q_full = palette_widths(cfg)
    ncand = assign.allowed.sum(dim=-1)
    q_needed = torch.where(counts > 0, ncand, 0).amax()
    width = torch.where(q_needed <= 1, 1,
                        torch.where(q_needed <= q_small, q_small, q_full))
    with span("photohive.d2h"):
        return width.cpu()


PALETTE_KERNEL_VARIANTS = ("bf16", "candidate", "cwide")


def palette_kernel_variant() -> str:
    """The palette route ``PHOTOHIVE_PALETTE_KERNEL`` selects, read at each
    call: ``bf16`` (the default), ``candidate`` or ``cwide``.  Any other
    value raises (the JAX package takes it as ``candidate``).

    ``candidate`` is a parity mode with no workload reason: it hands the
    RGB kernels the decoded float32 planes (4x the bytes of uint8) so that
    their float32 instantiations, the counterparts of the TPU's candidate
    kernels K11-K13, have a path; its reports equal ``bf16``'s."""
    variant = os.environ.get("PHOTOHIVE_PALETTE_KERNEL", "bf16")
    if variant not in PALETTE_KERNEL_VARIANTS:
        raise ValueError(f"PHOTOHIVE_PALETTE_KERNEL={variant!r}: expected "
                         f"one of {PALETTE_KERNEL_VARIANTS}")
    return variant


def palette_sums_by_k_auto(h: torch.Tensor, s: torch.Tensor,
                           v: torch.Tensor, assign: ParentAssignment,
                           counts: torch.Tensor, cfg: ReportConfig,
                           tables: OctreeTables,
                           variant: str) -> torch.Tensor:
    """The palette pixel pass on flat HSV pixels, (B, P) x3 -> (B, C, 4)
    int64 accumulator per valid-order slot (palette_kernels.
    palette_sums_from_fixed converts it), by K10 at candidate width q_small
    (8) or, when a populated cell has more tie candidates, the config's
    q_full (the JAX package's function of the same name; like it, no q=1
    tier on this route); under the ``cwide`` variant by K14, which needs
    no width and so no tier read from the device.  Hue < 0 marks pixels
    that add nothing."""
    from . import palette_kernels as pk
    from .library import branch

    if variant == "cwide":
        return pk.palette_sums_by_k_cwide(h, s, v,
                                          *pk.cwide_tables(assign, tables),
                                          cfg)
    q_small, q_full = palette_widths(cfg)

    def sums(q):
        def run(h, s, v, *assign):
            cand, centers_by_k = pk.palette_candidate_table(
                ParentAssignment(*assign), tables, cfg.num_cells, q)
            return pk.palette_sums_by_k(h, s, v, cand, centers_by_k, cfg)
        return run

    return branch(palette_tier(counts, assign, cfg) <= q_small,
                  sums(q_small), sums(q_full), (h, s, v, *assign))


def color_palette_batched_from_rgb(down: torch.Tensor, cfg: ReportConfig,
                                   tables: OctreeTables):
    """(B, 3, H, W) float32 in [0, 1] or uint8 -> (PaletteResult, (B,) f32
    sums of the saturation channel).  HSV lives only inside the kernels;
    K1 also returns mean saturation's numerator.  The ``bf16`` route hands
    it uint8 frames (K1, K3, K4), the ``candidate`` route the decoded
    float32 planes (K11, K12, K13)."""
    from . import palette_kernels as pk
    from .library import branch
    from .margin_sort import margin_sort

    _, _, hh, ww = down.shape
    total_pixels = hh * ww
    c = cfg.num_cells
    counts, s_sum = pk.cell_counts_s_from_rgb(down, cfg)
    sal = saliency_f32(counts, tables.s_v_f32, cfg)
    order = margin_sort(sal)
    assign = parent_assignment_from_order(counts, order, total_pixels, cfg,
                                          tables)
    q_small, q_full = palette_widths(cfg)

    def q1(down, *assign):
        slot, offset = pk.palette_offset_table(ParentAssignment(*assign),
                                               tables, c)
        return pk.palette_sums_by_k_rgb_q1(down, slot, offset, cfg)

    def tie_broken(q):
        def run(down, *assign):
            cand, centers_by_k = pk.palette_candidate_table(
                ParentAssignment(*assign), tables, c, q)
            return pk.palette_sums_by_k_rgb(down, cand, centers_by_k, cfg)
        return run

    # The JAX package's lax.switch over the tiers, as two nested
    # conditionals on the one width read from the device.
    width = palette_tier(counts, assign, cfg)
    sums = branch(width == 1, q1, lambda *ops: branch(
        width <= q_small, tie_broken(q_small), tie_broken(q_full), ops),
        (down, *assign))
    return palette_finalize_by_k(sums, assign, total_pixels, tables), s_sum


def color_palette_batched(h: torch.Tensor, s: torch.Tensor, v: torch.Tensor,
                          cfg: ReportConfig, tables: OctreeTables,
                          variant: str) -> PaletteResult:
    """The flat-HSV palette (the JAX package's single-device flat route):
    (B, H, W) float32 HSV planes -> PaletteResult.  K9, saliency, K2, the
    parent assignment, the pixel pass (``palette_sums_by_k_auto``: K14
    under ``cwide``, else K10) and the finish."""
    from . import palette_kernels as pk
    from .margin_sort import margin_sort

    b = h.shape[0]
    total_pixels = int(np.prod(h.shape[1:]))
    hf, sf, vf = (x.reshape(b, -1).contiguous() for x in (h, s, v))
    counts, _ = pk.counts_s_from_fixed(pk.cell_counts_from_hsv(hf, sf, vf,
                                                               cfg))
    order = margin_sort(saliency_f32(counts, tables.s_v_f32, cfg))
    assign = parent_assignment_from_order(counts, order, total_pixels, cfg,
                                          tables)
    acc = palette_sums_by_k_auto(hf, sf, vf, assign, counts, cfg, tables,
                                 variant)
    return palette_finalize_by_k(pk.palette_sums_from_fixed(acc), assign,
                                 total_pixels, tables)
