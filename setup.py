"""Packaging for photohive_dsp_tpu (reference analogue: setup.py:3-24).

The native runtime extension (runtime/native.cpp) builds lazily at first
use via the host compiler; no build-time extension step is required, so a
plain wheel works on hosts without a toolchain (numpy fallbacks engage).
"""

from setuptools import find_packages, setup

setup(
    name="photohive_dsp_tpu",
    version="0.1.0",
    description=(
        "TPU-native image-DSP feature extraction: PhotoHive photo reports "
        "(brightness/contrast, saturation, HSV palette, crop sharpness, "
        "FFT blur profile) as a batched, mesh-shardable JAX pipeline"
    ),
    # photohive_dsp_tpu_torch is the PyTorch/CUDA port; its kernels build
    # from csrc/ with nvcc at first use on a machine with a GPU.
    packages=find_packages(include=["photohive_dsp_tpu*",
                                    "photohive_dsp_tpu_torch*"]),
    package_data={"photohive_dsp_tpu.runtime": ["native.cpp"],
                  "photohive_dsp_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"]},
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "Pillow"],
    extras_require={"viz": ["matplotlib"], "torch": ["torch"]},
)
