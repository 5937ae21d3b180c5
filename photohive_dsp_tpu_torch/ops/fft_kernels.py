"""K6: |rfft2|^2 of a batch of images by the two FFT kernels, and their
plain versions (counterpart of ``pallas_fft.magnitude2_scrambled``).

Layouts, all natural row-major order (the TPU kernels' lane and sublane
bit-reversal has no counterpart here):

  * input   pgm  (B, H, W) float32;
  * K6a     spec (B, H, W//2+1, 2) float32 [re, im]: each row's real FFT,
    the W//2+1 kept outputs;
  * K6b     mag2 (B, H, W//2+1) float32: each column's complex FFT, then
    re^2 + im^2, the same half spectrum ``torch.fft.rfft2`` gives.

The row pass packs two real rows into one complex sequence (row 2p as the
real part, 2p+1 as the imaginary part; an odd last row pairs with zeros),
transforms it, and splits the two spectra with X[k] = (Z[k] +
conj Z[-k]) / 2 and Y[k] = (Z[k] - conj Z[-k]) / 2i.  Rows of all images
pair alike, since they are independent.

The plain versions run the kernels' Stockham stages (fft_plan.py) step by
step in torch ops on the same twiddle tables, in the same float32
operations and order, so on the CPU they check the plan and on the card
they hold the kernels.  Each wrapper calls its kernel's registered
operator (ops/library.py), which launches the kernel for CUDA tensors and
runs the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from .fft_plan import FftPlan, LengthPlan


def _check_plan(t: torch.Tensor, plan: FftPlan) -> None:
    if plan.rows.twiddles.device != t.device:
        raise ValueError(f"plan on {plan.rows.twiddles.device}, input on "
                         f"{t.device}")


def _cmul(ar, ai, br, bi):
    """(ar + i ai)(br + i bi) as the kernels' cmul: two rounded products
    per part, then one rounded add."""
    return ar * br - ai * bi, ar * bi + ai * br


def stockham_plain(re: torch.Tensor, im: torch.Tensor, lp: LengthPlan):
    """DFT along the last dim of (N, n) float32 re/im, natural order in and
    out, by the kernels' Stockham stages (csrc/fft.cu ``row_pass`` and
    ``col_pass`` run them one or two a pass, in the same operations).

    Stage of radix r after span ns, m = n / r, for j < m and k = j % ns:
    v_q = x[j + q m] W_{ns r}^{q k}; V_t = v_0 + sum_{q>=1} v_q W_r^{qt}
    (the multiply skipped where qt = 0 mod r); y[(j - k) r + k + t ns] =
    V_t."""
    n = lp.n
    twr, twi = lp.twiddles[:, 0], lp.twiddles[:, 1]
    rows = re.shape[0]
    ns = 1
    for r in lp.radices:
        m = n // r
        k = torch.arange(m, device=re.device) % ns
        idx = torch.arange(r, device=re.device)[:, None] * k * (n // (ns * r))
        vr, vi = _cmul(re.reshape(rows, r, m), im.reshape(rows, r, m),
                       twr[idx], twi[idx])
        outs_r, outs_i = [], []
        for t in range(r):
            ar, ai = vr[:, 0], vi[:, 0]
            for q in range(1, r):
                u = (q * t) % r
                if u == 0:
                    ar, ai = ar + vr[:, q], ai + vi[:, q]
                else:
                    pr, pi = _cmul(vr[:, q], vi[:, q], twr[u * m], twi[u * m])
                    ar, ai = ar + pr, ai + pi
            outs_r.append(ar)
            outs_i.append(ai)

        def scatter(outs):
            # (rows, t, j = a ns + k) -> y[a ns r + t ns + k]
            return (torch.stack(outs, dim=1).reshape(rows, r, m // ns, ns)
                    .permute(0, 2, 1, 3).reshape(rows, n))

        re, im = scatter(outs_r), scatter(outs_i)
        ns *= r
    return re, im


# ---------------------------------------------------------------- K6a ---

def fft_rows_plain(pgm: torch.Tensor, plan: FftPlan) -> torch.Tensor:
    """Plain version of K6a: (B, H, W) -> (B, H, W//2+1, 2)."""
    return rows_plain(pgm, plan.rows)


def rows_plain(pgm: torch.Tensor, lp: LengthPlan) -> torch.Tensor:
    """``fft_rows_plain`` by the rows' length plan alone."""
    b, h, w = pgm.shape
    half = w // 2 + 1
    rows = pgm.reshape(b * h, w)
    if rows.shape[0] % 2:
        rows = torch.cat([rows, rows.new_zeros((1, w))])
    zr, zi = stockham_plain(rows[0::2], rows[1::2], lp)
    k = torch.arange(half, device=pgm.device)
    ar, ai = zr[:, k], zi[:, k]
    br, bi = zr[:, (w - k) % w], zi[:, (w - k) % w]
    x0 = torch.stack([(ar + br) * 0.5, (ai - bi) * 0.5], dim=-1)
    x1 = torch.stack([(ai + bi) * 0.5, (br - ar) * 0.5], dim=-1)
    spec = torch.stack([x0, x1], dim=1).reshape(-1, half, 2)
    return spec[:b * h].reshape(b, h, half, 2)


def fft_rows(pgm: torch.Tensor, plan: FftPlan) -> torch.Tensor:
    """K6a: the real FFT of every row, (B, H, W) float32 -> (B, H, W//2+1,
    2) float32."""
    _cuda.require(pgm, "pgm", (torch.float32,), 3)
    if tuple(pgm.shape[1:]) != (plan.height, plan.width):
        raise ValueError(f"pgm: expected (B, {plan.height}, {plan.width}), "
                         f"got {tuple(pgm.shape)}")
    _check_plan(pgm, plan)
    lp = plan.rows
    return torch.ops.photohive.fft_rows(pgm, list(lp.radices), lp.twiddles,
                                        lp.stage_twiddles)


# ---------------------------------------------------------------- K6b ---

def fft_cols_plain(spec: torch.Tensor, plan: FftPlan) -> torch.Tensor:
    """Plain version of K6b: (B, H, W//2+1, 2) -> (B, H, W//2+1)."""
    return cols_plain(spec, plan.cols)


def cols_plain(spec: torch.Tensor, lp: LengthPlan) -> torch.Tensor:
    """``fft_cols_plain`` by the columns' length plan alone."""
    b, h, half, _ = spec.shape
    cols = spec.permute(0, 2, 3, 1).reshape(b * half, 2, h)
    yr, yi = stockham_plain(cols[:, 0], cols[:, 1], lp)
    mag2 = yr * yr + yi * yi
    return mag2.reshape(b, half, h).permute(0, 2, 1).contiguous()


def fft_cols(spec: torch.Tensor, plan: FftPlan) -> torch.Tensor:
    """K6b: the complex FFT of every column of K6a's output, then |X|^2,
    (B, H, W//2+1, 2) float32 -> (B, H, W//2+1) float32."""
    _cuda.require(spec, "spec", (torch.float32,), 4)
    if tuple(spec.shape[1:]) != (plan.height, plan.half, 2):
        raise ValueError(f"spec: expected (B, {plan.height}, {plan.half}, "
                         f"2), got {tuple(spec.shape)}")
    _check_plan(spec, plan)
    lp = plan.cols
    return torch.ops.photohive.fft_cols(spec, list(lp.radices), lp.twiddles,
                                        lp.stage_twiddles)


# ----------------------------------------------------------------- K6 ---

def magnitude2_plain(pgm: torch.Tensor, plan: FftPlan) -> torch.Tensor:
    """Plain version of K6: (B, H, W) -> (B, H, W//2+1) |rfft2|^2."""
    return fft_cols_plain(fft_rows_plain(pgm, plan), plan)


def magnitude2(pgm: torch.Tensor, plan: FftPlan) -> torch.Tensor:
    """|rfft2(pgm)|^2 of (B, H, W) float32 as (B, H, W//2+1) float32, in
    natural order, by K6a then K6b (the plain versions on the CPU)."""
    return fft_cols(fft_rows(pgm, plan), plan)
