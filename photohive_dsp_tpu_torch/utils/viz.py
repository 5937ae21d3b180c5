"""Visualisation (counterpart of ``photohive_dsp_tpu/utils/viz.py``): the
reference's observability surface, on the host.

Numpy/PIL/matplotlib ports of:
  * the palette block image (reference core.py:182-216);
  * the blur-profile polar render (reference src/blur_profile.c:140-180 —
    including its integer-truncated bin sizes — cropped to the left half as
    in core.py:219-228);
  * the blur-direction frequency-response plot (reference core.py:122-179);
  * an all-in-one report card (the headless stand-in for the reference's
    Tk dashboard, core.py:267-385: image + blur-vector arrows + crop boxes
    with sharpness labels + stats + palette).

Every function takes host numpy arrays and lists, as a ``Report`` holds
them.  PIL and matplotlib are imported inside the functions that draw, so
the module imports without them.
"""

from __future__ import annotations

import io
import math
import numpy as np

from ..config import REFERENCE_PI


def palette_image(colors, quantities, block_size: int = 50):
    """Grid of color blocks with percentage labels -> PIL image.

    colors: list of (r, g, b) 0-255 tuples; quantities: fractions.
    reference core.py:182-216.
    """
    from PIL import Image, ImageDraw, ImageFont

    num_colors = len(colors)
    per_row = int(np.ceil(np.sqrt(max(num_colors, 1))))
    width = per_row * block_size
    height = ((num_colors + per_row - 1) // per_row) * block_size
    img = Image.new("RGB", (max(width, block_size),
                            max(height, block_size)), "black")
    draw = ImageDraw.Draw(img)
    try:
        font = ImageFont.truetype("DejaVuSans.ttf", 12)
    except OSError:
        font = ImageFont.load_default()
    for i, (color, q) in enumerate(zip(colors, quantities)):
        row, col = divmod(i, per_row)
        x1, y1 = col * block_size, row * block_size
        draw.rectangle([x1, y1, x1 + block_size, y1 + block_size],
                       fill=tuple(int(c) for c in color))
        text = f"{q:.1%}"
        tw, th = draw.textbbox((0, 0), text, font=font)[2:]
        draw.text((x1 + (block_size - tw) / 2, y1 + (block_size - th) / 2),
                  text, fill="black", font=font)
    return img


def blur_profile_visual(bins: np.ndarray, height: int, width: int)\
        -> np.ndarray:
    """Render the (A, R) bins back into an FFT-shaped image, left half.

    Faithful to get_blur_profile_visual (src/blur_profile.c:140-180): the
    Blur_Profile struct stores radius_bin_size as an *int* (truncated
    max_radius/R, src/blur_profile.h:21), and the render uses the full
    spatial width with phi from the unshifted-FFT vertical mirror; the
    Python wrapper then crops to the left half (core.py:228).
    Returns (height, width//2) float array in [0, 1].
    """
    a, r = bins.shape
    fft_w = width // 2 + 1
    # height*height/4 is C INT division (blur_profile.c:57: all-int
    # expression under the sqrt), so truncate before the float sqrt.
    max_radius = math.sqrt(fft_w * fft_w + height * height // 4)
    radius_bin_size = int(max_radius / r)        # int field, truncated
    ys = np.arange(height)[:, None].astype(np.float64)
    xs = np.arange(width)[None, :].astype(np.float64)
    delta_y = np.where(ys < height // 2, -ys, height - ys)
    rad = np.sqrt(xs * xs + delta_y * delta_y)
    phi = np.arctan2(delta_y, xs)
    r_bin = (rad / max(radius_bin_size, 1)).astype(np.int64)
    r_bin = np.minimum(r_bin, r - 1)
    phi_bin = ((phi + REFERENCE_PI * 0.5) / REFERENCE_PI
               * (a - 1)).astype(np.int64)
    phi_bin = np.clip(phi_bin, 0, a - 1)
    out = np.asarray(bins)[phi_bin, r_bin]
    return out[:, : width // 2]


def blur_profile_image(bins: np.ndarray, height: int, width: int):
    """blur_profile_visual as an 8-bit PIL image."""
    from PIL import Image

    arr = np.clip(blur_profile_visual(bins, height, width) * 255, 0,
                  255).astype(np.uint8)
    return Image.fromarray(arr, "L")


def frequency_response_plot(blur_vectors, bins: np.ndarray,
                            magnitude_thresh: float,
                            fft_streak_thresh: float,
                            cutoff_ratio_denom: int):
    """Radius-response plot per blur direction -> PIL image.

    reference core.py:122-179 (incl. the 361-degree quantization quirk of
    the angle -> bin mapping and the perpendicular-streak curves).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from PIL import Image

    bins = np.asarray(bins)
    a, r = bins.shape
    xs = np.linspace(0, 1, r)
    plt.figure(figsize=(10, 6))
    for bv in blur_vectors:
        angle = bv.angle if hasattr(bv, "angle") else bv[0]
        mag = bv.magnitude if hasattr(bv, "magnitude") else bv[1]
        if mag == 0.0:
            continue
        q_ang = int(angle / (361 / a) + a / 2) % a
        plt.plot(xs, bins[q_ang], label=f"Directional Angle: {angle} deg")
        perp = angle - 90 if angle > 0.0 else angle + 90
        q_perp = int(perp / (361 / a) + a / 2) % a
        plt.plot(xs, bins[q_perp], label=f"Streak at {perp} deg")
    plt.axhline(y=magnitude_thresh, color="r", linestyle="-",
                label="Blur magnitude threshold")
    half = r // cutoff_ratio_denom
    plt.axhline(y=float(np.mean(bins[:, :half])) * fft_streak_thresh,
                color="b", linestyle="-", label="FFT Streak threshold")
    plt.plot(xs, bins.mean(axis=0), label="Average Response",
             linewidth=2, linestyle="--")
    plt.title("Frequency Response by Angle")
    plt.xlabel("Radius Index")
    plt.ylabel("Magnitude")
    plt.legend()
    plt.grid(True)
    buf = io.BytesIO()
    plt.savefig(buf, format="png")
    plt.close()
    buf.seek(0)
    return Image.open(buf).copy()


def report_card(report, image=None, bounding_boxes=None):
    """Headless all-in-one dashboard -> PIL image.

    Replaces the reference's Tk window (core.py:267-385): the input image
    with blur-vector arrows from the center and crop boxes with sharpness
    labels, beside the stats text and palette image.
    """
    from PIL import Image, ImageDraw, ImageFont

    pal = palette_image(report.color_palette.colors,
                        report.color_palette.quantities)
    if image is not None:
        arr = np.asarray(image)
        if arr.dtype != np.uint8:
            arr = np.clip(arr * 255, 0, 255).astype(np.uint8)
        if arr.ndim == 3 and arr.shape[0] == 3:
            arr = np.moveaxis(arr, 0, -1)
        main = Image.fromarray(arr)
    else:
        main = Image.new("RGB", (report.rgb_stats.width,
                                 report.rgb_stats.height), "gray")
    draw = ImageDraw.Draw(main)
    cx, cy = main.width // 2, main.height // 2
    scale = min(main.width, main.height) / 2
    for bv in report.blur_vectors:
        if bv.magnitude == 0:
            continue
        ex = cx + bv.magnitude * scale * math.cos(math.radians(bv.angle))
        ey = cy - bv.magnitude * scale * math.sin(math.radians(bv.angle))
        draw.line([cx, cy, ex, ey], fill="red", width=2)
    if bounding_boxes is not None:
        boxes, valid = bounding_boxes
        for i in range(len(valid)):
            if not valid[i]:
                continue
            top, bottom, left, right = (int(x) for x in boxes[i])
            draw.rectangle([left, top, right, bottom], outline="red",
                           width=2)
            if i < len(report.sharpnesses):
                draw.text((left + 2, max(top - 14, 0)),
                          f"Sharpness: {report.sharpnesses[i]:.4f}",
                          fill="red")
    stats_lines = [
        f"Red Brightness: {report.rgb_stats.Br:.4f}",
        f"Green Brightness: {report.rgb_stats.Bg:.4f}",
        f"Blue Brightness: {report.rgb_stats.Bb:.4f}",
        f"Red Contrast: {report.rgb_stats.Cr:.4f}",
        f"Green Contrast: {report.rgb_stats.Cg:.4f}",
        f"Blue Contrast: {report.rgb_stats.Cb:.4f}",
        f"Saturation: {report.average_saturation:.4f}",
    ]
    side_w = max(pal.width, 260)
    card = Image.new("RGB", (main.width + side_w + 20,
                             max(main.height, pal.height + 150)), "white")
    card.paste(main, (0, 0))
    d2 = ImageDraw.Draw(card)
    for i, line in enumerate(stats_lines):
        d2.text((main.width + 10, 10 + 16 * i), line, fill="black")
    card.paste(pal, (main.width + 10, 10 + 16 * len(stats_lines) + 10))
    return card
