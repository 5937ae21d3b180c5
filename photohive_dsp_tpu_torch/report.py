"""Host-side Report object, its visualisations and the fixed JSON schema
(counterpart of ``photohive_dsp_tpu/report.py``).

Mirrors the reference's Python Report class (core.py:23-119) and its
to_json schema (core.py:388-436): fixed width — exactly 10 blur vectors,
100 zero-padded palette colors, 10 zero-padded sharpnesses.
"""

from __future__ import annotations

import json
from types import SimpleNamespace
import numpy as np

from .models.pipeline import ReportData
from .utils.profiling import span

MAX_COLOR_ENTRIES = 100
MAX_VECTOR_ENTRIES = 10
MAX_SHARPNESSES = 10


def hsv_to_rgb255(h: float, s: float, v: float):
    """HSV -> integer RGB tuple (reference utils.py:7-27)."""
    c = v * s
    x = c * (1 - abs((h / 60) % 2 - 1))
    m = v - c
    if h < 60:
        r, g, b = c, x, 0
    elif h < 120:
        r, g, b = x, c, 0
    elif h < 180:
        r, g, b = 0, c, x
    elif h < 240:
        r, g, b = 0, x, c
    elif h < 300:
        r, g, b = x, 0, c
    else:
        r, g, b = c, 0, x
    return int((r + m) * 255), int((g + m) * 255), int((b + m) * 255)


class Report:
    """Python-facing report for one image, converted from an unbatched
    ReportData (one image's row of each field, tensors or arrays).

    Field-compatible with the reference Report (core.py:23-119):
      rgb_stats.{Br,Bg,Bb,Cr,Cg,Cb,height,width}, color_palette.{colors,
      quantities,N}, blur_profile.bins, blur_vectors[*].{angle,magnitude},
      average_saturation, sharpnesses.
    """

    def __init__(self, data: ReportData, height: int, width: int,
                 num_boxes: int = 0, config=None):
        with span("photohive.entry.report"):
            self._fill(_to_numpy(data), height, width, num_boxes, config)

    def _fill(self, data: ReportData, height: int, width: int,
              num_boxes: int, config) -> None:
        self.config = config
        stats = data.rgb_stats
        self.rgb_stats = SimpleNamespace(
            Br=float(stats[0]), Bg=float(stats[1]), Bb=float(stats[2]),
            Cr=float(stats[3]), Cg=float(stats[4]), Cb=float(stats[5]),
            height=int(height), width=int(width),
        )
        self.average_saturation = float(data.average_saturation)

        n = int(data.palette_n)
        hsv = data.palette_hsv[:n]
        # The reference converts palette HSV averages to integer RGB tuples
        # (core.py:82-88).
        colors = [hsv_to_rgb255(float(h), float(s), float(v))
                  for h, s, v in hsv]
        self.color_palette = SimpleNamespace(
            N=n,
            colors=colors,
            hsv=[tuple(map(float, row)) for row in hsv],
            quantities=[float(q) for q in data.palette_pct[:n]],
            cell_ids=[int(i) for i in data.palette_ids[:n]],
        )

        bins = np.nan_to_num(data.blur_bins, nan=0.0)
        self.blur_profile = SimpleNamespace(bins=bins.tolist())

        self.blur_vectors = [
            SimpleNamespace(angle=int(a), magnitude=float(m))
            for a, m in zip(data.blur_vector_angles, data.blur_vector_mags)
        ]
        # No crop boxes -> empty list (reference core.py:39-41,
        # src/filtering.c:152-154).
        self.sharpnesses = [float(x) for x in data.sharpness[:num_boxes]]

    # ---- visualization methods (API parity with reference core.py) -------

    def generate_color_palette_image(self):
        """reference core.py:182-216."""
        from .utils import viz

        self.color_palette_image = viz.palette_image(
            self.color_palette.colors, self.color_palette.quantities)
        return self.color_palette_image

    def generate_blur_profile_image(self):
        """reference core.py:219-228 + src/blur_profile.c:140-180."""
        from .utils import viz

        self.blur_profile_image = viz.blur_profile_image(
            np.asarray(self.blur_profile.bins), self.rgb_stats.height,
            self.rgb_stats.width)
        return self.blur_profile_image

    def generate_blur_direction_frequency_response(self):
        """reference core.py:122-179."""
        from .utils import viz

        cfg = self.config
        self.blur_vector_plot = viz.frequency_response_plot(
            self.blur_vectors, np.asarray(self.blur_profile.bins),
            cfg.magnitude_thresh if cfg else 0.3,
            cfg.fft_streak_thresh if cfg else 1.2,
            cfg.blur_cutoff_ratio_denom if cfg else 2)
        return self.blur_vector_plot

    def generate_report_card(self, image=None, bounding_boxes=None):
        """Headless all-in-one dashboard (stand-in for reference
        display_all, core.py:267-385)."""
        from .utils import viz

        return viz.report_card(self, image=image,
                               bounding_boxes=bounding_boxes)

    def display_all(self, image=None, bounding_boxes=None):  # pragma: no cover
        """Show the report card in a window when a display is available."""
        self.generate_report_card(image, bounding_boxes).show()

    def display_color_palette_image(self):  # pragma: no cover
        """Show the palette image (reference core.py:231-237).

        Generates it first if needed (the reference requires a prior
        generate_color_palette_image call and crashes otherwise — quirk
        not reproduced)."""
        if not hasattr(self, "color_palette_image"):
            self.generate_color_palette_image()
        self.color_palette_image.show()

    def display_blur_profile(self):  # pragma: no cover
        """Show the blur-profile visual (reference core.py:240-264)."""
        if not hasattr(self, "blur_profile_image"):
            self.generate_blur_profile_image()
        self.blur_profile_image.show()

    def text_report(self) -> str:
        """Plain-text dump matching the reference's print_full_report layout
        (src/utilities.c:229-256): saturation, RGB stats, palette rows as
        (H, S%, V%) ints + portion, then every (angle, frequency) bin."""
        lines = ["FULL REPORT:",
                 f"Average Saturation: {self.average_saturation:f}",
                 "Brightness of RGB: ({:f},{:f},{:f})".format(
                     self.rgb_stats.Br, self.rgb_stats.Bg, self.rgb_stats.Bb),
                 "Contrast of RGB; ({:f},{:f},{:f})".format(
                     self.rgb_stats.Cr, self.rgb_stats.Cg, self.rgb_stats.Cb),
                 "", "Color Palette Contents:"]
        for i, ((h, s, v), pct) in enumerate(
                zip(self.color_palette.hsv, self.color_palette.quantities)):
            lines.append(
                f"{i + 1}\tHSV: ({int(h):3d},{int(s * 100):3d},"
                f"{int(v * 100):3d}), Portion of image accounted for: "
                f"{pct:f}")
        lines += ["", "Blur Profile:"]
        bins = self.blur_profile.bins
        num_angle, num_radius = len(bins), len(bins[0])
        angle_bin_size = 180 // num_angle
        for i in range(num_angle):
            for j in range(num_radius):
                lines.append(
                    f"angle: {angle_bin_size * i:3d}, frequency: "
                    f"{j / num_radius:.3f}\t\t Bin: {bins[i][j]:f}")
        lines += ["", "", "END OF REPORT."]
        return "\n".join(lines)

    def to_json(self) -> str:
        """Fixed-width flat schema (reference core.py:388-436)."""
        with span("photohive.to_json"):
            return json.dumps(self.to_dict(), indent=4)

    def to_dict(self) -> dict:
        """The 439-key schema as a plain dict (what to_json serializes).
        The corpus JSONL writer embeds this directly, skipping a
        serialize-parse round trip per image."""
        rd = {
            'Height': self.rgb_stats.height,
            'Width': self.rgb_stats.width,
            'Average Saturation': self.average_saturation,
            'Red Brightness': self.rgb_stats.Br,
            'Green Brightness': self.rgb_stats.Bg,
            'Blue Brightness': self.rgb_stats.Bb,
            'Red Contrast': self.rgb_stats.Cr,
            'Green Contrast': self.rgb_stats.Cg,
            'Blue Contrast': self.rgb_stats.Cb,
        }
        for i in range(MAX_VECTOR_ENTRIES):
            rd[f'Blur Vector {i+1} Angle'] = self.blur_vectors[i].angle
            rd[f'Blur Vector {i+1} Magnitude'] = self.blur_vectors[i].magnitude
        for i in range(MAX_COLOR_ENTRIES):
            if i < len(self.color_palette.colors):
                h, s, v = self.color_palette.colors[i]
                pct = self.color_palette.quantities[i]
            else:
                h, s, v, pct = 0, 0, 0, 0
            rd[f'Color {i+1} H'] = h
            rd[f'Color {i+1} S'] = s
            rd[f'Color {i+1} V'] = v
            rd[f'Color {i+1} Percentage'] = pct
        for i in range(MAX_SHARPNESSES):
            rd[f'Sharpness {i+1}:'] = (
                self.sharpnesses[i] if i < len(self.sharpnesses) else 0.0
            )
        return rd


def _to_numpy(data: ReportData) -> ReportData:
    with span("photohive.d2h"):
        return ReportData(*(x.detach().cpu().numpy() if hasattr(x, "detach")
                            else np.asarray(x) for x in data))
