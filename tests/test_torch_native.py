"""The port's native C++ runtime (photohive_dsp_tpu_torch/runtime): txt
fixture IO and planarization, the cases of tests/test_native.py."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import numpy as np
import pytest

from photohive_dsp_tpu_torch import runtime as native_rt
from photohive_dsp_tpu_torch.utils import io as phio


@pytest.fixture(scope="module")
def native():
    lib = native_rt.get_native()
    if lib is None:
        pytest.skip("no host C++ toolchain")
    return lib


def test_txt_roundtrip_native(native, tmp_path):
    rng = np.random.default_rng(0)
    u8 = rng.integers(0, 256, (37, 23, 3), dtype=np.uint8)
    p = str(tmp_path / "img.txt")
    assert native_rt.write_txt_u8(p, u8)
    back = native_rt.read_txt_u8(p)
    np.testing.assert_array_equal(back, u8)


def test_native_matches_numpy_reader(native, tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.random((3, 41, 29)).astype(np.float32)
    p = str(tmp_path / "img.txt")
    phio.write_txt_image(rgb, p)
    via_io = phio.read_txt_image(p)
    # numpy fallback read
    with open(p) as f:
        first = f.readline().split()
        w, h = int(first[0]), int(first[1])
        data = np.loadtxt(f, dtype=np.int64)
    ref = np.moveaxis(
        data.reshape(h, w, 3).astype(np.float32) / 255.0, -1, 0)
    np.testing.assert_allclose(via_io, ref, atol=1e-7)


def test_planarize(native):
    rng = np.random.default_rng(2)
    u8 = rng.integers(0, 256, (17, 31, 3), dtype=np.uint8)
    planar = native_rt.planarize_u8(u8)
    ref = np.moveaxis(u8.astype(np.float32) / 255.0, -1, 0)
    np.testing.assert_allclose(planar, ref, atol=1e-7)


def test_malformed_and_out_of_range(native, tmp_path):
    p = str(tmp_path / "bad.txt")
    with open(p, "w") as f:
        f.write("not an image")
    with pytest.raises(ValueError):
        native_rt.read_txt_u8(p)
    p2 = str(tmp_path / "range.txt")
    with open(p2, "w") as f:
        f.write("1 1\n999 0 0\n")
    with pytest.raises(ValueError, match="outside"):
        native_rt.read_txt_u8(p2)
    p3 = str(tmp_path / "trunc.txt")
    with open(p3, "w") as f:
        f.write("2 2\n1 2 3\n")  # too few pixels
    with pytest.raises(ValueError):
        native_rt.read_txt_u8(p3)
