"""Native host-runtime bindings (ctypes) with build-on-first-use
(counterpart of ``photohive_dsp_tpu/runtime/__init__.py``).

``get_native()`` returns the loaded library handle or None; callers fall
back to numpy implementations when the host has no C++ compiler.  The
library is built from ``native.cpp`` with the host ``c++`` into the
gitignored ``photohive_dsp_tpu_torch/_build/native/``, beside a hash of the
source that marks an old build stale.  Host-side only: no device or kernel
path depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "native.cpp")
_OUT = os.path.join(os.path.dirname(_HERE), "_build", "native")
_SO = os.path.join(_OUT, "_phnative.so")
_STAMP = _SO + ".srchash"
_lock = threading.Lock()
_lib = None
_tried = False


def _src_hash() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _build() -> bool:
    """Compile into a temporary file and rename it into place, so a
    process that loads the library never sees a half-written one."""
    os.makedirs(_OUT, exist_ok=True)
    for cc in ("c++", "g++", "cc"):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_OUT)
        os.close(fd)
        try:
            subprocess.run([cc, "-O2", "-shared", "-fPIC", _SRC, "-o", tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, _SO)
            with open(_STAMP, "w") as f:
                f.write(_src_hash())
            return True
        except (OSError, subprocess.SubprocessError):
            continue
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return False


def _stale() -> bool:
    # Source-hash staleness (not mtime: a fresh checkout gives the source
    # and a stray old binary the same mtimes).
    if not os.path.exists(_SO):
        return True
    try:
        with open(_STAMP) as f:
            return f.read().strip() != _src_hash()
    except OSError:
        return True


def get_native():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if _stale() and not _build():
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.phn_read_txt_header.restype = ctypes.c_int
        lib.phn_read_txt_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int)]
        lib.phn_read_txt_u8.restype = ctypes.c_int
        lib.phn_read_txt_u8.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long]
        lib.phn_write_txt_u8.restype = ctypes.c_int
        lib.phn_write_txt_u8.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.phn_planarize_u8_to_f32.restype = None
        lib.phn_planarize_u8_to_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_long]
        _lib = lib
        return _lib


def read_txt_u8(path: str):
    """Reference .txt fixture -> (H, W, 3) uint8, or None if no native lib."""
    lib = get_native()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.phn_read_txt_header(path.encode(), ctypes.byref(w),
                                 ctypes.byref(h))
    if rc != 0:
        raise ValueError(f"malformed txt image {path} (header rc={rc})")
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.phn_read_txt_u8(path.encode(),
                             out.ctypes.data_as(ctypes.c_void_p),
                             h.value * w.value)
    if rc == 3:
        raise ValueError(f"pixel values outside [0,255] in {path}")
    if rc != 0:
        raise ValueError(f"malformed txt image {path} (rc={rc})")
    return out


def write_txt_u8(path: str, rgb_u8) -> bool:
    """(H, W, 3) uint8 -> reference .txt fixture; False if no native lib."""
    lib = get_native()
    if lib is None:
        return False
    arr = np.ascontiguousarray(rgb_u8, dtype=np.uint8)
    h, w, _ = arr.shape
    rc = lib.phn_write_txt_u8(path.encode(),
                              arr.ctypes.data_as(ctypes.c_void_p), w, h)
    if rc != 0:
        raise OSError(f"failed writing {path}")
    return True


def planarize_u8(rgb_u8):
    """(H, W, 3) uint8 -> (3, H, W) float32 [0,1]; None if no native lib."""
    lib = get_native()
    if lib is None:
        return None
    arr = np.ascontiguousarray(rgb_u8, dtype=np.uint8)
    h, w, _ = arr.shape
    out = np.empty((3, h, w), np.float32)
    lib.phn_planarize_u8_to_f32(arr.ctypes.data_as(ctypes.c_void_p),
                                out.ctypes.data_as(ctypes.c_void_p), h, w)
    return out
