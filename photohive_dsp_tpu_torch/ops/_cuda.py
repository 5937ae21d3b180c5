"""Build, load and count the port's CUDA kernels.

The kernels live in ``photohive_dsp_tpu_torch/csrc`` and are compiled with
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per source started together,
and linked into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use, into
``photohive_dsp_tpu_torch/_build/<hash of the sources and flags>/``, so an
edited source rebuilds and an unchanged one loads at once.  Nothing here runs
at import time: the CPU-only tests import every module.

Floating point: ``--fmad=false`` forbids FMA contraction and
``--use_fast_math`` is never passed, so ``/`` is IEEE division.  The kernels
also spell their bit-critical arithmetic with the ``__f*_rn`` intrinsics,
with an explicit ``__fmaf_rn`` where jitted XLA contracts the JAX package's
multiply-add (the palette's tie-break distance).

``LAUNCHES`` counts kernel launches by name.  A wrapper adds one exactly
where it launches its kernel, so a run can show which kernels it went
through; ``reset_launch_counts`` zeroes the counts.  The RGB palette
kernels count their uint8 launches (K1, K3, K4) and their float32 launches
(``*_f32``: K11, K12, K13) apart, by the input's dtype and not by the
route: the ``candidate`` route launches only float32, but the ``bf16``
route does too when its frames are float32 (``BatchRunner.run``) or
decimated (``downsample_rate`` above 1).  ``masked_sharpness`` counts
images, not launches: those the masked sharpness route takes, whose
operator (ops/library.py) runs plain PyTorch on the CPU and the card
alike.  ``entry_hwc`` counts frames too: the uint8 frames ``get_report``
sends to the device as (H, W, C) from a staging block and makes planar
there (one copy kernel on the card), on either device; float frames,
made planar on the host, are not counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from .stats import reciprocal_f32

SRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
LIB_NAME = "libphotohive_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC"]

LAUNCHES = {"cell_counts_s": 0, "margin_sort": 0, "palette_sums_q1": 0,
            "palette_sums_q8": 0, "palette_sums_qfull": 0,
            "sharpness_sums": 0, "fft_rows": 0, "fft_cols": 0,
            "polar_bins": 0, "cell_counts_hsv": 0, "palette_sums_flat_q8": 0,
            "palette_sums_flat_qfull": 0, "cell_counts_s_f32": 0,
            "palette_sums_q1_f32": 0, "palette_sums_q8_f32": 0,
            "palette_sums_qfull_f32": 0, "palette_sums_cwide": 0,
            "cell_counts_ids": 0, "masked_sharpness": 0, "entry_hwc": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class CellParams(ctypes.Structure):
    """Mirror of ``struct CellParams`` in csrc/hsv_cells.cuh: the float32
    constants of the HSV -> cell-id mapping (ops/quantize.assign_cells: the
    cell id is XLA's ``x * f32(1/L)``, like ``div_const``) and the device
    address of its index thresholds (``palette_kernels.index_bounds``)."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "black_thresh", "gray_thresh", "inv_lv", "inv_ls", "inv_lh",
        "max_sv", "inv360")] + \
        [(name, ctypes.c_int) for name in (
            "v_top", "s_top", "h_top", "s_partitions", "v_partitions",
            "gray_start", "black_id", "num_cells")] + \
        [("bounds", ctypes.c_void_p)]

    @classmethod
    def for_config(cls, cfg, tops, bounds: torch.Tensor) -> "CellParams":
        """``tops``: the (v, s, h) largest indices; ``bounds``: their
        thresholds on the kernel's device, [v | s | h], top + 2 floats
        each (the caller keeps the tensor alive during the launch)."""
        f32 = np.float32
        return cls(
            black_thresh=f32(cfg.black_thresh),
            gray_thresh=f32(cfg.gray_thresh),
            inv_lv=reciprocal_f32(cfg.cell_Lv),
            inv_ls=reciprocal_f32(cfg.cell_Ls),
            inv_lh=reciprocal_f32(cfg.cell_Lh),
            max_sv=f32(0.999999), inv360=f32(1.0 / 360.0),
            v_top=tops[0], s_top=tops[1], h_top=tops[2],
            s_partitions=cfg.s_partitions, v_partitions=cfg.v_partitions,
            gray_start=cfg.gray_start, black_id=cfg.black_id,
            num_cells=cfg.num_cells, bounds=bounds.data_ptr())


class FftStages(ctypes.Structure):
    """Mirror of ``struct FftStages`` in csrc/fft.cu: one transform length
    and its stage radices (ops/fft_plan.py)."""

    MAX_STAGES = 16
    _fields_ = [("n", ctypes.c_int), ("count", ctypes.c_int),
                ("radix", ctypes.c_int * MAX_STAGES)]

    @classmethod
    def for_plan(cls, n: int, radices) -> "FftStages":
        if len(radices) > cls.MAX_STAGES:
            raise ValueError(f"{len(radices)} stages > {cls.MAX_STAGES}")
        return cls(n=n, count=len(radices),
                   radix=(ctypes.c_int * cls.MAX_STAGES)(*radices))


class ColTile(ctypes.Structure):
    """Mirror of ``struct ColTile`` in csrc/fft.cu: the column kernel's tile
    (``fft_plan.col_tile``)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "lane_bits", "stw_shared", "tw_len", "seq", "bytes")]


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PARAMS = ctypes.POINTER(CellParams)
_STAGES = ctypes.POINTER(FftStages)
_COL_TILE = ctypes.POINTER(ColTile)
_SIGNATURES = {
    # (rgb, is_u8, batch, pixels, params, counts_out, s_out, acc, stream)
    "ph_cell_counts_s": [_P, _I, _I, _LL, _PARAMS, _P, _P, _P, _P],
    # (sal, batch, c, warps, regs, order_out, stream)
    "ph_margin_sort": [_P, _I, _I, _I, _I, _P, _P],
    # (stream): an empty kernel, the launch floor
    "ph_empty_kernel": [_P],
    # (rgb, is_u8, batch, pixels, params, slot_of_cell, offset_of_cell,
    #  sums_out, acc, stream)
    "ph_palette_sums_q1": [_P, _I, _I, _LL, _PARAMS, _P, _P, _P, _P, _P],
    # (rgb, is_u8, batch, pixels, params, cand, q, centers_by_k,
    #  sums_out, acc, stream)
    "ph_palette_sums": [_P, _I, _I, _LL, _PARAMS, _P, _I, _P, _P, _P, _P],
    # (h, s, v, batch, pixels, params, acc, stream)
    "ph_cell_counts_hsv": [_P, _P, _P, _I, _LL, _PARAMS, _P, _P],
    # (h, s, v, batch, pixels, params, cand, q, centers_by_k, acc, stream)
    "ph_palette_sums_hsv": [_P, _P, _P, _I, _LL, _PARAMS, _P, _I, _P, _P,
                            _P],
    # (h, s, v, batch, pixels, params, allowed, words, centers_by_k, acc,
    #  stream)
    "ph_palette_sums_cwide": [_P, _P, _P, _I, _LL, _PARAMS, _P, _I, _P, _P,
                              _P],
    # (cells, batch, pixels, num_cells, counts_out, acc, stream)
    "ph_cell_counts_ids": [_P, _I, _LL, _I, _P, _P, _P],
    # (pgm, halo, batch, height, width, row_offset, boxes, vec, items,
    #  partial, tickets, sums_out, stream)
    "ph_sharpness_sums": [_P, _P, _I, _I, _I, _I, _P, _I, _LL, _P, _P, _P,
                          _P],
    # (pgm, rows, stages, twiddles, stage_twiddles, spec_out, stream)
    "ph_fft_rows": [_P, _I, _STAGES, _P, _P, _P, _P],
    # (spec, batch, half, stages, twiddles, stage_twiddles, tile, mag2_out,
    #  stream)
    "ph_fft_cols": [_P, _I, _I, _STAGES, _P, _P, _COL_TILE, _P, _P],
    # (mag2, bin_ids, batch, pixels, num_bins, bin_counts, acc, max_out,
    #  out, stream)
    "ph_polar_lognorm": [_P, _P, _I, _LL, _I, _P, _P, _P, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc_start(*args) -> subprocess.Popen:
    return subprocess.Popen([_nvcc(), *args], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _nvcc_check(procs) -> None:
    """Wait for every nvcc in ``procs``; raise with the output of those
    that failed."""
    done = [(p.args[-1], *p.communicate(), p.returncode) for p in procs]
    failed = [f"{name} ({rc}):\n{out}" for name, out, _, rc in done if rc]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless the build for the
    current sources already exists; returns its path."""
    out_dir = BUILD_DIR / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        cu = [p for p in _sources() if p.suffix == ".cu"]
        objs = [os.path.join(work, p.stem + ".o") for p in cu]
        _nvcc_check([_nvcc_start(*NVCC_FLAGS, "-I", str(SRC_DIR), "-c", "-o",
                                 obj, str(src))
                     for src, obj in zip(cu, objs)])
        tmp = os.path.join(work, LIB_NAME)
        _nvcc_check([_nvcc_start(*ARCH_FLAGS, "-shared", "-o", tmp, *objs)])
        os.replace(tmp, lib)
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def launch(name: str, t: torch.Tensor, *args) -> None:
    """Call C entry point ``name`` with ``args`` on ``t``'s device and
    current stream (appended as the last argument); raise on the
    cudaError_t it returns."""
    with torch.cuda.device(t.device):
        status = getattr(lib(), name)(*args, stream_ptr(t))
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {status}")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address; None passes a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def require(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """Validate a tensor handed to a kernel wrapper."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name}: CUDA input must be contiguous")
