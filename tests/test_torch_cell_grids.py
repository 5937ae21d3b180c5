"""The port's cell ids and blur DC term against the JAX package as
``get_report`` runs it, jitted, on the CPU.

Inside ``jax.jit`` XLA lowers ``x / c`` for a constant c as ``x *
f32(1/c)``, and the port does the same (``ops/stats.div_const``).  At the
cell steps of some legal grids the multiply and IEEE division put uint8
triples in other cells (1498 of the 2^24 at 12x3x2, 2640 at 24x5x5, 59 at
8x4x6; none at 18x2x3).  Here: every uint8 triple's cell at those grids
against jitted JAX; ``get_report`` on frames made of the triples where the
two divisions disagree, against ``ph.get_report``; the port's plain cell
counts against the JAX Pallas cell histograms in interpret mode on those
triples; and the blur DC term bit for bit.  The kernels are held to the
same plain versions on the card by chip_smoke.py, on every triple at
these grids."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import photohive_dsp_tpu as ph
from photohive_dsp_tpu.config import ReportConfig as JCfg
from photohive_dsp_tpu.ops import colorspace as jcs
from photohive_dsp_tpu.ops import pallas_kernels as jpk
from photohive_dsp_tpu.ops import pallas_kernels_bf16 as jpkv
from photohive_dsp_tpu.ops import quantize as jq

import photohive_dsp_tpu_torch as pt
from photohive_dsp_tpu_torch.config import ReportConfig as TCfg
from photohive_dsp_tpu_torch.ops import palette_kernels as tpk
from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_hsv, \
    u8_to_unit_f32
from photohive_dsp_tpu_torch.ops.quantize import assign_cells
from photohive_dsp_tpu_torch.ops.stats import blur_dc

from .test_torch_pipeline import assert_match, report_fields

f32 = np.float32
CHUNK = 1 << 22
GRIDS = {"18x2x3": {},
         "12x3x2": dict(h_partitions=12, s_partitions=3, v_partitions=2),
         "24x5x5": dict(h_partitions=24, s_partitions=5, v_partitions=5),
         "8x4x6": dict(h_partitions=8, s_partitions=4, v_partitions=6)}
# Triples whose cell moves when the cell steps divide as IEEE does.
IEEE_MOVES = {"18x2x3": 0, "12x3x2": 1498, "24x5x5": 2640, "8x4x6": 59}


def triples(start: int, stop: int) -> np.ndarray:
    """(3, stop - start) uint8: RGB triples start..stop-1, R most
    significant."""
    i = np.arange(start, stop, dtype=np.uint32)
    return np.stack([i >> 16, (i >> 8) & 255, i & 255]).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def all_hsv():
    """The port's float32 HSV of every uint8 triple, (3, 2^24) each."""
    out = []
    for start in range(0, 1 << 24, CHUNK):
        planes = u8_to_unit_f32(torch.from_numpy(triples(start,
                                                         start + CHUNK)))
        out.append(np.stack([x.numpy() for x in rgb_to_hsv(*planes)]))
    return np.concatenate(out, axis=1)


def numpy_cells(h, s, v, cfg, ieee: bool) -> np.ndarray:
    """assign_cells in numpy float32, the cell steps divided as IEEE does
    (``ieee``) or multiplied by their float32 reciprocals."""
    def index(x, base, step, top):
        y = x if base is None else x - f32(base)
        q = y / f32(step) if ieee else y * (f32(1) / f32(step))
        return np.clip(q, f32(0), f32(top - 1e-6)).astype(np.int64)

    vi = index(v, cfg.black_thresh, cfg.cell_Lv, cfg.v_partitions)
    si = index(s, cfg.gray_thresh, cfg.cell_Ls, cfg.s_partitions)
    hi = index(h, None, cfg.cell_Lh, cfg.h_partitions)
    color = (hi * cfg.s_partitions + si) * cfg.v_partitions + vi
    return np.where(v < f32(cfg.black_thresh), cfg.black_id,
                    np.where(s < f32(cfg.gray_thresh), cfg.gray_start,
                             color))


@functools.lru_cache(maxsize=None)
def ieee_moved(name: str) -> np.ndarray:
    """(N, 3) uint8: the triples whose cell at the grid differs between
    IEEE division and the reciprocal multiply."""
    cfg = TCfg(**GRIDS[name])
    h, s, v = all_hsv()
    moved = np.flatnonzero(numpy_cells(h, s, v, cfg, True)
                           != numpy_cells(h, s, v, cfg, False))
    return triples(0, 1 << 24)[:, moved].T.copy()


def moved_frame(name: str, hh: int, ww: int, seed: int) -> np.ndarray:
    """(hh, ww, 3) uint8 of the grid's moved triples, each at least once
    when the frame holds them all, in a seeded order."""
    moved = ieee_moved(name)
    rng = np.random.default_rng(seed)
    idx = np.resize(rng.permutation(len(moved)), hh * ww)
    return moved[rng.permutation(idx)].reshape(hh, ww, 3)


@pytest.mark.parametrize("name", list(GRIDS))
def test_cells_of_every_uint8_triple_match_jitted_jax(name):
    """u8_to_unit_f32 -> rgb_to_hsv -> assign_cells on all 2^24 triples
    equals JAX's jitted assign_cells(*rgb_to_hsv(...)) on the same float32
    planes, bit for bit; IEEE division would move IEEE_MOVES[name]."""
    tcfg, jcfg = TCfg(**GRIDS[name]), JCfg(**GRIDS[name])
    jfn = jax.jit(lambda r, g, b: jq.assign_cells(*jcs.rgb_to_hsv(r, g, b),
                                                  jcfg))
    for start in range(0, 1 << 24, CHUNK):
        planes = u8_to_unit_f32(torch.from_numpy(triples(start,
                                                         start + CHUNK)))
        got = assign_cells(*rgb_to_hsv(*planes), tcfg).numpy()
        want = np.asarray(jfn(*(jnp.asarray(p.numpy()) for p in planes)))
        assert got.dtype == want.dtype
        assert np.array_equal(got, want), \
            f"{int((got != want).sum())} triples from {start} differ"
    assert len(ieee_moved(name)) == IEEE_MOVES[name]


@pytest.mark.parametrize("name", ["12x3x2", "24x5x5"])
def test_get_report_on_moved_triples_matches_jax(name):
    """A 360x512 frame of the triples IEEE division would move: the port's
    get_report on the CPU against the JAX package's at its bars (ids and
    percentages exact, HSV within 5e-3, blur vectors equal)."""
    img = moved_frame(name, 360, 512, seed=13)
    want = ph.get_report(img, **GRIDS[name])
    got = pt.get_report(img, device="cpu", **GRIDS[name])
    assert want is not None and got is not None
    assert_match(report_fields(got), report_fields(want))


PALLAS_ROUTES = {
    "bf16 u8": (jpkv.cell_counts_s_from_rgb, np.uint8),
    "bf16 f32": (jpkv.cell_counts_s_from_rgb, np.float32),
    "candidate f32": (jpk.cell_counts_s_from_rgb, np.float32)}


@pytest.mark.parametrize("route", list(PALLAS_ROUTES))
def test_plain_cell_counts_match_pallas_on_moved_triples(route):
    """The port's plain cell histogram (K1/K11's twin) on a (1, 3, 8, 256)
    frame of the 12x3x2 moved triples equals the JAX Pallas kernel's in
    interpret mode, as the JAX package's own tests run it."""
    kernel, dtype = PALLAS_ROUTES[route]
    grid = GRIDS["12x3x2"]
    rgb = np.moveaxis(moved_frame("12x3x2", 8, 256, seed=17), -1, 0)[None]
    x = torch.from_numpy(np.ascontiguousarray(rgb))
    if dtype == np.float32:
        x = u8_to_unit_f32(x)
    got, _ = tpk.cell_counts_s_from_rgb(x, TCfg(**grid))
    with pltpu.force_tpu_interpret_mode():
        want, _ = kernel(jnp.asarray(x.numpy()), JCfg(**grid))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_blur_dc_matches_jitted_jax():
    """The DC term the blur stage removes, (Br + Bg + Bb) / 3, on 2^20
    seeded rows of statistics: bit-equal to jitted JAX's."""
    rng = np.random.default_rng(3)
    stats = rng.random((1 << 20, 6), dtype=np.float32)
    want = jax.jit(lambda s: (s[:, 0] + s[:, 1] + s[:, 2]) / 3.0)(stats)
    got = blur_dc(torch.from_numpy(stats)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.int32),
                          np.asarray(want).view(np.int32))
