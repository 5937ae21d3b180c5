"""The PhotoHive report, plain: the stages of the C library
(Joseph-93/PhotoHive_DSP, ``src/interface.c:20-94``) written out in NumPy
and plain PyTorch, one image at a time.

It follows the configuration's stated precision, float32, where the
report's decisions are made per pixel: the decode x/255, HSV, the cell of
each pixel (a division by a constant cell step taken as a multiply by its
float32 reciprocal, as compiled float32 code does), the float32 saliency
and its truncating margin sort, and the float32 tie-break distance, whose
two multiply-adds round once each (``fma_f32``).  Everything that adds up
pixels (statistics, palette sums, sharpness, the FFT and its bins) runs in
float64.  ``Reference(cfg, device, dtype=torch.bfloat16)`` computes every
per-pixel and per-image quantity in bfloat16 instead: the control, which
the comparison in ``portbench.check`` must refuse.

Nothing here is taken from the program: the tables (cell centres,
distances, polar bins) are worked out again from the configuration.
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MAX_SV = 0.999999           # src/image_processing.c:8-9
REFERENCE_PI = 3.14159265   # src/blur_profile.c:10
NUM_VECTORS = 10            # src/blur_profile.c:328
CHUNK_PX = 1 << 22          # tie-break pixels per step, bounds temporaries


def f32_round(x: Fraction) -> np.float32:
    """``x`` rounded once to float32, to nearest, ties to even."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        err = abs(Fraction(float(c)) - x)
        even = int(np.array(c, np.float32).view(np.uint32)) & 1 == 0
        if best is None or err < best[0] or (err == best[0] and even):
            best = (err, c)
    return np.float32(best[1])


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor)\
        -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding.  The product of two float32
    values is exact in float64; the float64 sum's own error (TwoSum) decides
    the one case where rounding it again to float32 would go wrong, a sum
    that lands on a float32 midpoint."""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.float()
    rd = r.double()
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(rd < s, inf, -inf))
    tie = ((rd + other.double()) * 0.5 == s) & (err != 0)
    pick = torch.where(err > 0, torch.maximum(r, other),
                       torch.minimum(r, other))
    return torch.where(tie, pick, r)


class Octree:
    """The HSV grid of ``src/color_quantization.c``: centres (:57-98), the
    float32 centre s*v (:588-595) and the cell-to-cell distance (:253-288),
    in float64 as the C code computes them."""

    def __init__(self, cfg: dict):
        hp, sp, vp = cfg["h_partitions"], cfg["s_partitions"], \
            cfg["v_partitions"]
        self.hp, self.sp, self.vp = hp, sp, vp
        self.black, self.gray = cfg["black_thresh"], cfg["gray_thresh"]
        self.num_cells = hp * sp * vp + vp + 1
        self.gray_start = self.num_cells - (vp + 1)
        self.black_id = self.num_cells - 1
        self.lh = float(360 // hp)
        self.ls = (1.0 - self.gray) / sp
        self.lv = (1.0 - self.black) / vp
        centers = np.zeros((self.num_cells, 3))
        s_offs = self.ls / 2 + self.gray
        v_offs = self.lv / 2 + self.black
        for h in range(hp):
            for s in range(sp):
                for v in range(vp):
                    centers[h * sp * vp + s * vp + v] = (
                        h * self.lh + self.lh / 2, s * self.ls + s_offs,
                        v * self.lv + v_offs)
        l_gray = (1.0 - self.black) / vp
        for j in range(vp):
            centers[hp * sp * vp + j] = (0.0, 0.0, l_gray * j + v_offs)
        self.centers = centers
        s_v = (centers[:, 1] * centers[:, 2]).astype(np.float32)
        svw = np.float32(cfg["saturation_value_weight"])
        qw = np.float32(cfg["quantity_weight"])
        # qw + svw * s_v, one rounding (compiled float32 code fuses it).
        self.weight = np.array([f32_round(Fraction(float(svw))
                                          * Fraction(float(x))
                                          + Fraction(float(qw)))
                                for x in s_v], np.float32)
        ids = np.arange(self.num_cells)
        color = ids < self.gray_start
        gray = (ids >= self.gray_start) & (ids < self.black_id)
        hc, sc, vc = centers[:, 0], centers[:, 1], centers[:, 2]
        hd = np.abs(hc[:, None] - hc[None, :])
        hd = np.where(hd > 180.0, 360.0 - hd, hd) * (1.0 / 360.0)
        sd = sc[:, None] - sc[None, :]
        vd = vc[:, None] - vc[None, :]
        both = color[:, None] & color[None, :]
        mixed = (gray[:, None] & color[None, :]) | (color[:, None]
                                                    & gray[None, :])
        self.dist = np.where(both, hd * hd + sd * sd + vd * vd,
                             np.where(mixed, sd * sd + vd * vd, vd * vd))

    def margin_order(self, sal: np.ndarray) -> List[int]:
        """custom_sort (src/color_quantization.c:598-611,
        src/utilities.c:132-153): insertion sort, swapping while the
        float32 difference truncates below zero."""
        order = list(range(self.num_cells))
        for i in range(1, self.num_cells):
            j = i
            while j > 0:
                diff = np.float32(sal[order[j - 1]]) - np.float32(
                    sal[order[j]])
                if int(diff) < 0:
                    order[j - 1], order[j] = order[j], order[j - 1]
                    j -= 1
                else:
                    break
        return order


@functools.lru_cache(maxsize=8)
def polar_bins(height: int, width: int, angles: int, radii: int)\
        -> np.ndarray:
    """Flat (angle * R + radius) bin per half-spectrum pixel
    (src/blur_profile.c:34-126, :427-458): the truncated PI, the bottom
    mirror written from row height-1-y, integer-division bin size and the
    Newton integer square root."""
    fw = width // 2 + 1
    x = np.arange(fw, dtype=np.float64)[None, :]
    half = height // 2
    bound = half + 1 if height % 2 == 1 else half
    y = np.arange(bound, dtype=np.float64)[:, None]
    top_phi = np.arctan2(y, x)
    top_rsq = x.astype(np.int64) ** 2 + y.astype(np.int64) ** 2
    phi = np.empty((height, fw))
    rsq = np.empty((height, fw), np.int64)
    phi[:bound], rsq[:bound] = -top_phi, top_rsq
    rows = height - 1 - np.arange(bound)
    phi[rows], rsq[rows] = top_phi, top_rsq
    a_bin = ((phi + REFERENCE_PI * 0.5) / REFERENCE_PI * (angles - 1))\
        .astype(np.int64).clip(0, angles - 1)
    size_sq = (fw * fw + (height * height) // 4) // (radii * radii)
    val = (rsq.astype(np.float64) / float(size_sq)).ravel()
    r_bin = np.zeros(val.shape, np.int64)
    idx = np.flatnonzero(val != 0)
    x_n = val[idx]
    while idx.size:                      # src/utilities.c:43-52
        s = 0.5 * (x_n + val[idx] / x_n)
        done = np.abs(s - x_n) < 1.0
        r_bin[idx[done]] = s[done].astype(np.int64)
        idx, x_n = idx[~done], s[~done]
    r_bin = np.where(r_bin == radii, radii - 1, r_bin).clip(0, radii - 1)
    return (a_bin.ravel() * radii + r_bin).astype(np.int64)


def vectors_from_bins(bins: np.ndarray, cfg: dict) -> List[Tuple[int, float]]:
    """vectorize_blur_profile (src/blur_profile.c:324-416), float64, with
    the C code's float32 magnitude and angle."""
    bins = np.asarray(bins, np.float64)
    a, r = bins.shape
    cut = r // cfg["blur_cutoff_ratio_denom"]
    tot = bins[:, :cut].sum(axis=1)
    avg = tot.sum() / a
    smooth = sum(np.roll(tot, j) for j in range(5)) / 5
    thresh = avg * cfg["fft_streak_thresh"]
    maxima = [i for i in range(a)
              if smooth[i] > smooth[i - 1] and smooth[i] > smooth[(i + 1) % a]
              and smooth[i] > thresh][:NUM_VECTORS]
    out = [(0, 0.0)] * NUM_VECTORS
    for k, i in enumerate(maxima):
        idx = (i + a // 2) % a
        cur = bins[idx]
        if cur[:cut].sum() > avg:
            continue
        below = np.flatnonzero(cur < cfg["magnitude_thresh"])
        radius = int(below[0]) if below.size else r
        mag = np.float32(radius) / np.float32(r)
        angle = int(np.float32(180) * (np.float32(idx) / np.float32(a))
                    - np.float32(90))
        out[k] = (angle, float(mag))
    return out


def vectors_fragile(bins: np.ndarray, cfg: dict, margin: float) -> bool:
    """True where one of vectorize_blur_profile's decisions on ``bins``
    lies within ``margin`` (relative) of going the other way: a streak
    threshold, a local maximum, the suppression by the average, or the
    magnitude threshold up to where a vector's radius is read.  There
    bins equal to a small rounding may give other vectors."""
    bins = np.asarray(bins, np.float64)
    a, r = bins.shape
    cut = r // cfg["blur_cutoff_ratio_denom"]
    tot = bins[:, :cut].sum(axis=1)
    avg = tot.sum() / a
    smooth = sum(np.roll(tot, j) for j in range(5)) / 5
    thresh = avg * cfg["fft_streak_thresh"]
    mt = cfg["magnitude_thresh"]

    def close(x, y):
        return abs(x - y) <= margin * max(abs(x), abs(y))

    for i in range(a):
        if close(smooth[i], thresh):
            return True
        if smooth[i] < thresh:
            continue
        if close(smooth[i], smooth[i - 1]) or \
                close(smooth[i], smooth[(i + 1) % a]):
            return True
        cur = bins[(i + a // 2) % a]
        if close(cur[:cut].sum(), avg):
            return True
        for v in cur:
            if close(v, mt):
                return True
            if v < mt:
                break
    return False


class Reference:
    """Reports of (H, W, 3) uint8 frames on ``device``.  ``dtype`` is the
    per-pixel precision: float32 as the configuration states, or bfloat16
    for the control (then every sum runs in bfloat16 too)."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dt = dtype
        self.acc = torch.float64 if dtype == torch.float32 else dtype
        self.octree = Octree(cfg)
        lut = np.arange(256, dtype=np.float32) / np.float32(255)
        self.lut = torch.from_numpy(lut).to(self.device, dtype)

    # ---- per pixel -------------------------------------------------------

    def hsv(self, r, g, b):
        """src/image_processing.c:372-417 in ``self.dt``."""
        mx = torch.maximum(torch.maximum(r, g), b)
        mn = torch.minimum(torch.minimum(r, g), b)
        delta = mx - mn
        one, zero = torch.ones_like(delta), torch.zeros_like(delta)
        safe = torch.where(delta == 0, one, delta)
        h = torch.where(delta == 0, zero, torch.where(
            mx == r, 60.0 * ((g - b) / safe), torch.where(
                mx == g, 60.0 * (2.0 + (b - r) / safe),
                60.0 * (4.0 + (r - g) / safe))))
        h = torch.where(h < 0, h + 360.0, h)
        h = torch.where(h > 360, h - 360.0, h)
        v = torch.where(mx == 1.0, torch.full_like(mx, MAX_SV), mx)
        s = torch.where(mx == 0, zero, torch.where(
            delta == mx, torch.full_like(mx, MAX_SV),
            delta / torch.where(mx == 0, one, mx)))
        return h, s, v

    def cells(self, h, s, v):
        """arm_octree (src/color_quantization.c:127-145), every gray pixel
        in the first gray cell (:136)."""
        o = self.octree

        def index(x, step, top):
            inv = float(np.float32(1.0) / np.float32(step))
            # The int clamp changes nothing in float32; in bfloat16
            # top - 1e-6 rounds to top.
            return torch.clamp(x * inv, 0, top - 1e-6).to(torch.int64)\
                .clamp(max=top - 1)

        color = (index(h, o.lh, o.hp) * o.sp
                 + index(s - o.gray, o.ls, o.sp)) * o.vp \
            + index(v - o.black, o.lv, o.vp)
        return torch.where(v < o.black, o.black_id,
                           torch.where(s < o.gray, o.gray_start, color))

    # ---- the report ------------------------------------------------------

    def report(self, frame, boxes: Sequence[Tuple[int, int, int, int]] = ())\
            -> Dict[str, object]:
        """The report of one (H, W, 3) uint8 frame (numpy or a tensor)."""
        x = torch.as_tensor(frame).to(self.device)
        height, width = int(x.shape[0]), int(x.shape[1])
        rgb = self.lut[x.permute(2, 0, 1).long()]          # (3, H, W)
        r, g, b = rgb[0], rgb[1], rgb[2]
        racc = rgb.to(self.acc)
        mean = racc.mean(dim=(1, 2))
        std = torch.sqrt(torch.square(racc - mean[:, None, None])
                         .mean(dim=(1, 2)))
        stats = torch.cat([mean, std])
        h, s, v = (t.reshape(-1) for t in self.hsv(r, g, b))
        out = dict(rgb_stats=stats.double().cpu().numpy(),
                   average_saturation=float(s.to(self.acc).mean()))
        out.update(self.palette(h, s, v))
        pgm = (0.299 * racc[0] + 0.587 * racc[1] + 0.114 * racc[2])
        out["sharpness"] = np.array([self.sharpness(pgm, bx)
                                     for bx in boxes])
        dc = (stats[0] + stats[1] + stats[2]) / 3.0
        out["blur_bins"] = self.blur_bins(pgm - dc)
        out["blur_vectors"] = vectors_from_bins(out["blur_bins"], self.cfg)
        return out

    def palette(self, h, s, v) -> Dict[str, np.ndarray]:
        """get_color_palette (src/color_quantization.c:652-684)."""
        o, cfg = self.octree, self.cfg
        c = o.num_cells
        total = h.numel()
        cells = self.cells(h, s, v)
        counts = torch.bincount(cells, minlength=c).cpu().numpy()
        if self.dt == torch.float32:
            sal = (counts.astype(np.float32) * o.weight) * np.float32(1000)
        else:
            sal = (torch.from_numpy(counts).to(self.dt)
                   * torch.from_numpy(o.weight).to(self.dt)
                   * 1000.0).float().numpy()
        order = o.margin_order(sal)
        goal = int(float(total) * cfg["coverage_thresh"])
        cum = np.cumsum(counts[order])
        n_valid = int(np.argmax(cum >= goal)) + 1
        valid = order[:n_valid]

        # Parent slot per cell; cells tied between parents
        # (group_irregular_pixels, :342-479) keep their candidate slots.
        slot_of_cell = np.full(c + 1, -1, np.int64)
        slot_of_cell[valid] = np.arange(n_valid)
        tied: Dict[int, np.ndarray] = {}
        for cell in np.flatnonzero(counts):
            if slot_of_cell[cell] >= 0:
                continue
            d = o.dist[cell, valid]
            slots = np.flatnonzero(d == d.min())
            if len(slots) == 1:
                slot_of_cell[cell] = slots[0]
            else:
                tied[int(cell)] = slots
        dev = h.device
        slot = torch.as_tensor(slot_of_cell, device=dev)[cells]
        centers = torch.as_tensor(o.centers[valid], device=dev,
                                  dtype=torch.float32).to(self.dt)
        for cell, slots in tied.items():
            px = torch.nonzero(cells == cell)[:, 0]
            cand = torch.as_tensor(slots, device=dev)
            slot[px] = self.nearest(h[px], s[px], v[px], cand,
                                    centers[cand])

        offset = (180.0 - centers[:, 0])                    # (n_valid,)
        temp = h + offset[slot]
        temp = torch.where(temp > 360.0, temp - 360.0,
                           torch.where(temp < 0.0, temp + 360.0, temp))
        sums = torch.zeros((n_valid, 4), dtype=self.acc, device=dev)
        vals = torch.stack([temp, s, v, torch.ones_like(s)], 1).to(self.acc)
        sums.index_add_(0, slot, vals)
        n = sums[:, 3]
        h_avg = sums[:, 0] / n - offset.to(self.acc)
        h_avg = torch.where(h_avg < 0, h_avg + 360.0,
                            torch.where(h_avg > 360.0, h_avg - 360.0, h_avg))
        hsv = torch.stack([h_avg, sums[:, 1] / n, sums[:, 2] / n], 1)
        return dict(palette_ids=np.array(valid, np.int64),
                    palette_pct=(n / total).double().cpu().numpy(),
                    palette_hsv=hsv.double().cpu().numpy())

    def nearest(self, h, s, v, cand, ctr) -> torch.Tensor:
        """The first nearest of the tied parents ``cand`` (slots in valid
        order, centres ``ctr``) for each pixel (:376-451), by the squared
        distance hd^2 + sd^2 + vd^2, its two multiply-adds fused."""
        out = []
        for j in range(0, h.numel(), CHUNK_PX):
            hp, sp, vp = (t[j:j + CHUNK_PX, None] for t in (h, s, v))
            hd = torch.abs(hp - ctr[None, :, 0])
            hd = torch.where(hd > 180.0, 360.0 - hd, hd) * (1.0 / 360.0)
            sd = sp - ctr[None, :, 1]
            vd = vp - ctr[None, :, 2]
            if self.dt == torch.float32:
                d = fma_f32(vd, vd, fma_f32(sd, sd, hd * hd))
            else:
                d = hd * hd + sd * sd + vd * vd
            out.append(cand[d.argmin(dim=1)])
        return torch.cat(out)

    def sharpness(self, pgm, box) -> float:
        """variance_sharpness (src/filtering.c:151-183): the zero-padded
        3x3 Laplacian of the crop, variance over mean."""
        top, bottom, left, right = box
        crop = pgm[top:bottom, left:right]
        p = F.pad(crop[None, None], (1, 1, 1, 1))[0, 0]
        neigh = (p[:-2, :-2] + p[:-2, 1:-1] + p[:-2, 2:] + p[1:-1, :-2]
                 + p[1:-1, 2:] + p[2:, :-2] + p[2:, 1:-1] + p[2:, 2:])
        resp = 8.0 * crop - neigh
        mean = resp.mean()
        return float(torch.square(resp - mean).mean() / mean)

    def blur_bins(self, luma) -> np.ndarray:
        """|rfft2|^2 of the DC-free luma, the log normalisation
        (src/fft_processing.c:173-213) and the polar bin means."""
        height, width = luma.shape
        if self.acc == torch.float64:
            mag = torch.fft.rfft2(luma).abs().square()
        else:
            mag = torch.fft.rfft2(luma.float()).abs().square().to(self.acc)
        gain = 1.0 / (2.0 * torch.log(torch.sqrt(mag.max()) + 1.0))
        norm = torch.where(mag < 1.0, torch.zeros_like(mag),
                           torch.log(torch.clamp(mag, min=1.0)) * gain)
        a, r = self.cfg["angle_partitions"], self.cfg["radius_partitions"]
        ids = torch.as_tensor(polar_bins(height, width, a, r),
                              device=luma.device)
        sums = torch.zeros(a * r, dtype=self.acc, device=luma.device)
        sums.index_add_(0, ids, norm.reshape(-1))
        counts = torch.bincount(ids, minlength=a * r).to(self.acc)
        means = torch.where(counts > 0, sums / counts.clamp(min=1), 0.0)
        return means.double().cpu().numpy().reshape(a, r)
