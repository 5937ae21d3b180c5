"""Photograph-like uint8 frames made from a seed on the device.

A frame is a lit background gradient with a handful of objects (ellipses
with sharp edges, each of one base colour), shaded by a smooth
illumination field and tinted by a colour field, both with a 1/f-like
spectrum, plus fine texture and sensor noise; where the configuration
asks for camera shake, a motion blur of a random length (a range of
shares of the width, or of pixels) at a random angle, which gives the
blur profile the streak its blur vectors look for.  So the palette sees a few dominant
colours with graded shades, the sharpness boxes see edges and texture,
and the blur profile a natural falling spectrum.  Every frame of a seed
has the same size; only its content depends on the seed.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SEED_MOD = 1 << 62


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed) % SEED_MOD)
    return gen


def _uniform(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def _hsv_to_rgb(h, s, v):
    """h in [0, 1), s, v in [0, 1]; tensors of one shape -> (..., 3)."""
    k = torch.stack([(5 + h * 6) % 6, (3 + h * 6) % 6, (1 + h * 6) % 6], -1)
    return v[..., None] - v[..., None] * s[..., None] * torch.clamp(
        torch.minimum(k, 4 - k), 0, 1)


def _pink(gen, channels, h, w, beta, device):
    """A smooth field with amplitude ~ 1/f^beta, unit deviation, made at an
    eighth of the size and scaled up."""
    sh, sw = max(h // 8, 8), max(w // 8, 8)
    z = torch.randn((channels, sh, sw), generator=gen, device=device)
    fy = torch.fft.fftfreq(sh, device=device)[:, None]
    fx = torch.fft.rfftfreq(sw, device=device)[None, :]
    rad = torch.sqrt(fy * fy + fx * fx)
    rad[0, 0] = 1.0
    spec = torch.fft.rfft2(z) / rad ** beta
    spec[..., 0, 0] = 0
    x = torch.fft.irfft2(spec, s=(sh, sw))
    x = x / x.std(dim=(1, 2), keepdim=True).clamp(min=1e-6)
    return F.interpolate(x[None], size=(h, w), mode="bilinear",
                         align_corners=False)[0]


def _motion_blur(img: torch.Tensor, length: float, angle: float)\
        -> torch.Tensor:
    """Camera shake: each channel convolved (circularly, by FFT) with a
    line of ``length`` pixels at ``angle``, so the spectrum carries the
    streak the report's blur vectors look for."""
    _, h, w = img.shape
    n = max(int(length), 1)
    t = torch.linspace(-0.5, 0.5, 4 * n, device=img.device) * length
    ys = torch.round(t * math.sin(angle)).long() % h
    xs = torch.round(t * math.cos(angle)).long() % w
    psf = torch.zeros((h, w), device=img.device)
    psf.index_put_((ys, xs), torch.ones_like(t), accumulate=True)
    psf = psf / psf.sum()
    return torch.fft.irfft2(torch.fft.rfft2(img) * torch.fft.rfft2(psf),
                            s=(h, w))


def photo(gen: torch.Generator, height: int, width: int,
          shake: Optional[Sequence[float]] = None,
          shake_px: Optional[Sequence[float]] = None) -> torch.Tensor:
    """One (H, W, 3) uint8 frame on the generator's device; ``shake`` is
    the (least, most) motion blur length as a share of the width,
    ``shake_px`` the same in pixels."""
    dev = gen.device
    un = lambda n, lo, hi: _uniform(gen, n, lo, hi, dev)  # noqa: E731
    yy = torch.linspace(0, 1, height, device=dev)[:, None]
    xx = torch.linspace(0, 1, width, device=dev)[None, :]
    top, bottom = (_hsv_to_rgb(un(1, 0, 1), un(1, 0.05, 0.6),
                               un(1, 0.3, 0.95)) for _ in range(2))
    img = (top[0][:, None, None] * (1 - yy) + bottom[0][:, None, None] * yy)
    img = img.expand(3, height, width).clone()
    n_obj = 6
    cy, cx = un(n_obj, 0.05, 0.95), un(n_obj, 0.05, 0.95)
    ry, rx = un(n_obj, 0.06, 0.35), un(n_obj, 0.06, 0.35)
    theta = un(n_obj, 0, math.pi)
    colour = _hsv_to_rgb(un(n_obj, 0, 1), un(n_obj, 0.1, 0.9),
                         un(n_obj, 0.08, 0.95))
    aspect = width / height
    for k in range(n_obj):
        dy, dx = yy - cy[k], (xx - cx[k]) * aspect
        c, s = torch.cos(theta[k]), torch.sin(theta[k])
        inside = ((dy * c + dx * s) / ry[k]) ** 2 \
            + ((dx * c - dy * s) / rx[k]) ** 2 <= 1.0
        img = torch.where(inside, colour[k][:, None, None], img)
    light = _pink(gen, 1, height, width, 1.0, dev)
    tint = _pink(gen, 3, height, width, 1.2, dev)
    img = img * (1.0 + 0.18 * light) + 0.035 * tint
    img = img + 0.02 * torch.randn((1, height, width), generator=gen,
                                   device=dev)
    if shake:
        img = _motion_blur(img, float(un(1, *shake)) * width,
                           float(un(1, 0, math.pi)))
    elif shake_px:
        img = _motion_blur(img, float(un(1, *shake_px)),
                           float(un(1, 0, math.pi)))
    img = img + (2.0 / 255) * torch.randn((3, height, width), generator=gen,
                                          device=dev)
    img = torch.round(torch.clamp(img, 0, 1) * 255).to(torch.uint8)
    return img.permute(1, 2, 0).contiguous()


def frames(seed: int, shapes: Sequence[Tuple[int, int]], count: int,
           device, shake: Optional[Sequence[float]] = None,
           shake_px: Optional[Sequence[float]] = None) -> List[np.ndarray]:
    """``count`` host frames, frame i of shape ``shapes[i % len(shapes)]``,
    made on ``device`` and copied to the host once each."""
    gen = generator(seed, device)
    out = []
    for i in range(count):
        h, w = shapes[i % len(shapes)]
        out.append(photo(gen, h, w, shake, shake_px).cpu().numpy())
    return out


def for_config(seed: int, config: dict, count: int, device)\
        -> List[np.ndarray]:
    """The first ``count`` frames of a configuration (its ``shapes``, and
    its ``camera_shake`` or ``camera_shake_px`` where it has one)."""
    return frames(seed, [tuple(s) for s in config["shapes"]], count, device,
                  config.get("camera_shake"), config.get("camera_shake_px"))
