"""The PyTorch port's elementwise, stencil, FFT, blur and sharpness ops
against the JAX package's, on the same numpy inputs."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from photohive_dsp_tpu.config import ReportConfig as JCfg
from photohive_dsp_tpu.ops import blur as jblur
from photohive_dsp_tpu.ops import colorspace as jcs
from photohive_dsp_tpu.ops import fft as jfft
from photohive_dsp_tpu.ops import filtering as jfilt
from photohive_dsp_tpu.ops import sharpness as jsharp
from photohive_dsp_tpu.ops import stats as jstats

from photohive_dsp_tpu_torch.config import ReportConfig as TCfg
from photohive_dsp_tpu_torch.ops import blur as tblur
from photohive_dsp_tpu_torch.ops import colorspace as tcs
from photohive_dsp_tpu_torch.ops import fft as tfft
from photohive_dsp_tpu_torch.ops import filtering as tfilt
from photohive_dsp_tpu_torch.ops import sharpness as tsharp
from photohive_dsp_tpu_torch.ops import stats as tstats

from .util import snr_db


def _rgb_with_edge_cases(seed=0, shape=(3, 48, 64)):
    """Random RGB plus the HSV branch and clamp edges: grays, channel
    ties, zeros, ones and exact max-channel ties."""
    rng = np.random.default_rng(seed)
    rgb = rng.random(shape).astype(np.float32)
    u8 = rng.integers(0, 256, shape).astype(np.float32) / np.float32(255)
    rgb[:, :8] = u8[:, :8]
    rgb[:, 8, :] = 0.0
    rgb[:, 9, :] = 1.0
    rgb[:, 10, :] = rgb[0, 10, :]                    # gray
    rgb[1, 11, :] = rgb[0, 11, :]                    # r == g max ties
    rgb[2, 12, :] = rgb[1, 12, :]                    # g == b
    rgb[0, 13, :] = 1.0
    return rgb


def test_u8_to_unit_f32_exact_all_256():
    x = np.arange(256, dtype=np.uint8)
    want = x.astype(np.float32) / np.float32(255.0)
    got = tcs.u8_to_unit_f32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jcs.u8_to_unit_f32(jnp.asarray(x))))


def test_rgb_to_hsv_bit_equal():
    rgb = _rgb_with_edge_cases()
    jh, js, jv = jcs.rgb_to_hsv(*jnp.asarray(rgb))
    th, ts, tv = tcs.rgb_to_hsv(*torch.from_numpy(rgb))
    for a, b in ((jh, th), (js, ts), (jv, tv)):
        assert np.array_equal(np.asarray(a), b.numpy())


def test_rgb_to_pgm_and_stats_match():
    rgb = _rgb_with_edge_cases(1)
    jp = np.asarray(jcs.rgb_to_pgm(*jnp.asarray(rgb)))
    tp = tcs.rgb_to_pgm(*torch.from_numpy(rgb)).numpy()
    assert np.abs(jp - tp).max() <= 1e-6
    js = np.asarray(jstats.rgb_statistics(*jnp.asarray(rgb)))
    ts = tstats.rgb_statistics(torch.from_numpy(rgb)[None])[0].numpy()
    assert np.abs(ts / js - 1).max() < 1e-5


@pytest.mark.parametrize("rate", [1, 2, 3])
def test_downsample_row_stride_quirk(rate):
    rgb = _rgb_with_edge_cases(2, (3, 50, 70))
    want = np.asarray(jcs.downsample_rgb(jnp.asarray(rgb), rate))
    got = tcs.downsample_rgb(torch.from_numpy(rgb)[None], rate)[0].numpy()
    assert np.array_equal(got, want)


def test_div_const_matches_xla_constant_division():
    """The JAX package's constant divisions lower to a multiply by the
    float32 reciprocal; div_const reproduces those bits."""
    n = np.arange(0, 5000, dtype=np.float32)
    for d in (184320, 40, 72, 5):
        want = np.asarray(jax.jit(lambda x, d=d: x / d)(jnp.asarray(n)))
        got = tstats.div_const(torch.from_numpy(n), d).numpy()
        assert np.array_equal(got, want)


def test_laplacian_and_trailing_box_match():
    x = np.random.default_rng(3).random((40, 56)).astype(np.float32)
    want = np.asarray(jfilt.laplacian_3x3(jnp.asarray(x)))
    got = tfilt.laplacian_3x3(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5
    v = np.random.default_rng(4).random(72).astype(np.float32)
    want = np.asarray(jfilt.trailing_circular_box(jnp.asarray(v), 5))
    got = tfilt.trailing_circular_box(torch.from_numpy(v), 5).numpy()
    assert np.abs(got - want).max() <= 1e-6


def test_fft_normalized_and_blur_bins_match():
    cfg_j, cfg_t = JCfg(), TCfg()
    rng = np.random.default_rng(5)
    pgm = rng.random((2, 120, 160)).astype(np.float32) - 0.5
    want = np.stack([np.asarray(jfft.magnitude_fft_normalized(
        jnp.asarray(p))) for p in pgm])
    got = tfft.magnitude_fft_normalized(torch.from_numpy(pgm)).numpy()
    assert snr_db(want, got) > 100

    jt = jblur.PolarTables.for_shape(120, 160, cfg_j)
    tt = tblur.PolarTables.for_shape(120, 160, cfg_t)
    a, r = cfg_t.angle_partitions, cfg_t.radius_partitions
    jb = np.stack([np.asarray(jblur.blur_profile_bins(
        jnp.asarray(m), jt, a, r)) for m in want])
    tb = tblur.blur_profile_bins(torch.from_numpy(want), tt, a, r).numpy()
    assert snr_db(jb, tb) > 100


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vectorize_blur_profile_equal(seed):
    """Same bins in, same blur vectors out (the angle table keeps C's
    float32 rounding, the magnitude XLA's constant division)."""
    from .util import directional_blur_image

    cfg_j, cfg_t = JCfg(), TCfg()
    img = directional_blur_image(120, 160, seed=seed).astype(np.float32)
    pgm = img[0] - img[0].mean()
    mag = np.asarray(jfft.magnitude_fft_normalized(jnp.asarray(pgm)))
    bins = np.array(jblur.blur_profile_bins(
        jnp.asarray(mag), jblur.PolarTables.for_shape(120, 160, cfg_j),
        cfg_j.angle_partitions, cfg_j.radius_partitions))
    ja, jm = jblur.vectorize_blur_profile(jnp.asarray(bins), cfg_j)
    ta, tm = tblur.vectorize_blur_profile(torch.from_numpy(bins)[None], cfg_t)
    assert np.array_equal(np.asarray(ja), ta[0].numpy())
    assert np.array_equal(np.asarray(jm), tm[0].numpy())


BOXES = {
    "none": [],
    "fast": [(5, 40, 10, 120), (20, 64, 100, 160), (0, 8, 0, 16)],
    "thin": [(5, 40, 10, 120), (30, 32, 20, 150)],
}


@pytest.mark.parametrize("route", list(BOXES))
def test_sharpness_routes_match(route):
    rng = np.random.default_rng(6)
    pgm = rng.random((2, 64, 160)).astype(np.float32)
    boxes = np.zeros((2, 10, 4), np.int32)
    valid = np.zeros((2, 10), bool)
    for i, bx in enumerate(BOXES[route]):
        boxes[:, i] = bx
        valid[:, i] = True
    want = np.asarray(jsharp.variance_sharpness_batched(
        jnp.asarray(pgm), jnp.asarray(boxes), jnp.asarray(valid)))
    got = tsharp.variance_sharpness_batched(torch.from_numpy(pgm), boxes,
                                            valid).numpy()
    assert np.allclose(got, want, rtol=1e-4, atol=0)
    assert np.array_equal(got[~valid], np.zeros((~valid).sum(), np.float32))


def test_port_never_imports_jax():
    """Every module of the port, kernels and parallel.* included, imports
    without pulling in JAX or the JAX package, or PIL and matplotlib
    (utils.viz imports them inside the functions that draw)."""
    code = ("import importlib, pkgutil, sys, photohive_dsp_tpu_torch as p; "
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
            "p.__name__ + '.')]; "
            "[importlib.import_module(n) for n in names]; "
            "need = {'ops.sharpness_kernels', 'ops.palette_kernels', "
            "'ops.polar_kernels', 'ops.fft_kernels', 'ops.margin_sort', "
            "'parallel.mesh', 'parallel.spatial', 'models.pipeline', "
            "'models.batch', 'utils.io', 'runtime', 'serving', "
            "'ops.library', 'utils.profiling', 'utils.debug', "
            "'utils.viz'}; "
            "missing = need - {n.split('.', 1)[1] for n in names}; "
            "assert not missing, missing; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'photohive_dsp_tpu', 'PIL', 'matplotlib')]; "
            "assert not bad, bad; print('clean')")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
