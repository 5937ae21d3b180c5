"""The comparison that decides ``correct``: a sample of the reports a run
delivered, held to the plain reference (``portbench/reference``) on the
same frames.

Each number is the worst over the sample and must not exceed its limit in
``limits.json``; PERF.md gives the readings each limit was set from.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .reference.report import vectors_fragile

LIMITS = Path(__file__).resolve().parent / "limits.json"
# A report's vectors count as differing only where no decision of the
# reference's vectorize lies this close (relative) to its threshold: the
# program's bins differ from the reference's by rounding (~1e-6), so there
# either answer is right.
VECTOR_MARGIN = 1e-4
STAT_KEYS = ("Red Brightness", "Green Brightness", "Blue Brightness",
             "Red Contrast", "Green Contrast", "Blue Contrast")


def limits() -> Dict[str, float]:
    return json.loads(LIMITS.read_text())


def from_report(report, text: str, num_boxes: int) -> dict:
    """One delivered single-image report: its JSON string, and the fields
    the JSON leaves out (palette ids and HSV, blur bins) from the Report."""
    d = json.loads(text)
    n = report.color_palette.N
    return dict(
        rgb_stats=np.array([d[k] for k in STAT_KEYS]),
        average_saturation=d["Average Saturation"],
        palette_ids=np.array(report.color_palette.cell_ids[:n]),
        palette_pct=np.array([d[f"Color {i + 1} Percentage"]
                              for i in range(n)]),
        palette_hsv=np.array(report.color_palette.hsv[:n]).reshape(-1, 3),
        sharpness=np.array([d[f"Sharpness {i + 1}:"]
                            for i in range(num_boxes)]),
        blur_bins=np.array(report.blur_profile.bins),
        blur_vectors=[(d[f"Blur Vector {i + 1} Angle"],
                       d[f"Blur Vector {i + 1} Magnitude"])
                      for i in range(10)])


def from_report_data(row, num_boxes: int) -> dict:
    """One image's row of a batch's ReportData (host tensors)."""
    f = {k: np.asarray(v) for k, v in row._asdict().items()}
    n = int(f["palette_n"])
    return dict(
        rgb_stats=f["rgb_stats"].astype(np.float64),
        average_saturation=float(f["average_saturation"]),
        palette_ids=f["palette_ids"][:n].astype(np.int64),
        palette_pct=f["palette_pct"][:n].astype(np.float64),
        palette_hsv=f["palette_hsv"][:n].astype(np.float64),
        sharpness=f["sharpness"][:num_boxes].astype(np.float64),
        blur_bins=f["blur_bins"].astype(np.float64),
        blur_vectors=[(int(a), float(m)) for a, m in
                      zip(f["blur_vector_angles"], f["blur_vector_mags"])])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.size == 0:
        return 0.0
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                        1e-30)))


def gaps(got: dict, want: dict, pixels: int, cfg: dict) -> Dict[str, float]:
    """The numbers of one report against the reference's.  Palette entries
    are matched by cell id: an entry on one side only counts its whole
    share as the gap."""
    out = dict(
        stats_rel=_rel(got["rgb_stats"], want["rgb_stats"]),
        saturation_rel=_rel(got["average_saturation"],
                            want["average_saturation"]),
        palette_ids_differ=float(not np.array_equal(got["palette_ids"],
                                                    want["palette_ids"])),
        blur_bins_rel=float(np.max(np.abs(got["blur_bins"]
                                          - want["blur_bins"]))
                            / max(np.max(np.abs(want["blur_bins"])), 1e-30)),
    )
    if len(want["sharpness"]):
        out["sharpness_rel"] = _rel(got["sharpness"], want["sharpness"])
    pct = dict(zip(got["palette_ids"].tolist(), got["palette_pct"]))
    ref_pct = dict(zip(want["palette_ids"].tolist(), want["palette_pct"]))
    out["palette_pct_px"] = float(max(
        abs(pct.get(i, 0.0) - ref_pct.get(i, 0.0))
        for i in set(pct) | set(ref_pct)) * pixels)
    ref_hsv = dict(zip(want["palette_ids"].tolist(), want["palette_hsv"]))
    common = [(h, ref_hsv[i]) for i, h in zip(got["palette_ids"].tolist(),
                                              got["palette_hsv"])
              if i in ref_hsv]
    if common:
        d = np.abs(np.array([g for g, _ in common])
                   - np.array([w for _, w in common]))
        d[:, 0] = np.minimum(d[:, 0], 360.0 - d[:, 0]) / 360.0
        out["palette_hsv"] = float(d.max())
    differ = any(a != ra or abs(m - rm) > 1e-6 for (a, m), (ra, rm)
                 in zip(got["blur_vectors"], want["blur_vectors"]))
    out["blur_vectors_differ"] = float(
        differ and not vectors_fragile(want["blur_bins"], cfg,
                                       VECTOR_MARGIN))
    return out


def required(has_boxes: bool) -> List[str]:
    """The numbers a cell compares: crop sharpness only where its frames
    have boxes."""
    return [k for k in limits() if has_boxes or k != "sharpness_rel"]


COUNTS = ("palette_ids_differ", "blur_vectors_differ")


def unreadable() -> Dict[str, float]:
    """The numbers of a report that cannot be compared: every one fails."""
    return {name: float("inf") for name in limits()}


def combine(per_item: List[Dict[str, float]]) -> Dict[str, Optional[float]]:
    """Counts add up over the sample; every other number takes its worst."""
    names = list(limits())
    out: Dict[str, Optional[float]] = {}
    for name in names:
        vals = [g[name] for g in per_item if name in g]
        if not vals:
            out[name] = None
        elif name in COUNTS:
            out[name] = float(sum(vals))
        else:
            out[name] = float(max(vals))
    return out


def verdict(numbers: Dict[str, Optional[float]], attempted: int,
            failed: int, sampled: int, names: List[str]) -> bool:
    lim = limits()
    return (attempted > 0 and failed == 0 and sampled > 0
            and all(numbers.get(k) is not None and numbers[k] <= lim[k]
                    for k in names))


def _finite(x: Optional[float]) -> Optional[float]:
    """JSON has no infinity: an unreadable number is written as null."""
    return x if x is None or np.isfinite(x) else None


def check_entry(numbers: Dict[str, Optional[float]], sampled: int,
                names: List[str]) -> dict:
    lim = limits()
    out = {k: {"value": _finite(numbers.get(k)), "limit": lim[k]}
           for k in names}
    out["sampled"] = {"value": sampled, "limit": 1}
    return out
