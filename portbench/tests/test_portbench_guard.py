"""Nothing a run loads, and nothing under portbench/reference, is JAX or
the JAX package; the reference imports nothing of the port."""

import subprocess
import sys

from portbench import guard
from portbench.spec import PACKAGE, ROOT


def test_top_level_names_compare_whole():
    assert guard.loaded_forbidden(["photohive_dsp_tpu_torch.ops._cuda",
                                   "numpy"]) == []
    assert guard.loaded_forbidden(["photohive_dsp_tpu.ops", "jax.numpy",
                                   "jaxlib", "jaxtyping"]) == [
        "jax", "jaxlib", "photohive_dsp_tpu"]


def test_reference_imports_neither_jax_nor_the_program(tmp_path):
    assert guard.reference_violations(PACKAGE / "reference") == []
    bad = tmp_path / "bad.py"
    bad.write_text("import photohive_dsp_tpu_torch.ops\n"
                   "from jax import numpy\n")
    assert guard.reference_violations(tmp_path) == [
        "bad.py: photohive_dsp_tpu_torch", "bad.py: jax"]


def test_a_run_loads_no_jax():
    code = ("import sys; import portbench.run, portbench.loops, "
            "portbench.check, portbench.calibrate, portbench.trace; "
            "import photohive_dsp_tpu_torch.models.batch, "
            "photohive_dsp_tpu_torch.parallel.spatial, "
            "photohive_dsp_tpu_torch.serving; "
            "from portbench import guard; "
            "print(guard.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
