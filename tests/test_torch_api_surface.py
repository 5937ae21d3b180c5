"""The port's public surface against the JAX package's, read from source
with ``ast`` alone (no JAX is imported): every public top-level name of a
JAX module (a def, a class, an assignment, or an entry of ``__all__``) is
defined in the port's module of the same path, or the allowlist below names
the port name that takes its place, or ROADMAP.md's "Not to port" list
gives the reason it is not ported."""

from . import torch_threads  # noqa: F401 (this worker's cores)

import ast
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "photohive_dsp_tpu"
PORT_PKG = ROOT / "photohive_dsp_tpu_torch"
NOT_TO_PORT = "Not to port"

# (JAX module, name) -> "port module:name" that takes its place, or
# NOT_TO_PORT, whose reason ROADMAP.md's "Not to port" list gives (the name
# must stand there in backticks).
ALLOWED = {
    ("ops/blur.py", "blur_profile_bins_batched"):
        "ops/blur.py:blur_profile_bins",
    ("ops/blur.py", "polar_bin_sums_flat_xla"): NOT_TO_PORT,
    ("ops/pallas_fft.py", "FftPlan"): "ops/fft_plan.py:FftPlan",
    ("ops/pallas_fft.py", "blur_bins_scrambled_lognorm"):
        "ops/blur.py:blur_bins_lognorm",
    ("ops/pallas_fft.py", "eligible"): "ops/fft_plan.py:fft_kernel_eligible",
    ("ops/pallas_fft.py", "use_pallas_fft"):
        "ops/fft_plan.py:fft_kernel_eligible",
    ("ops/pallas_fft.py", "magnitude2_scrambled"):
        "ops/fft_kernels.py:magnitude2",
    ("ops/pallas_fft.py", "magnitude_fft_scrambled_normalized"): NOT_TO_PORT,
    ("ops/pallas_fft.py", "scramble_maps"): NOT_TO_PORT,
    ("ops/pallas_fft.py", "scrambled_polar_tables"): NOT_TO_PORT,
    ("ops/pallas_kernels.py", "cell_counts_batched"):
        "ops/palette_kernels.py:cell_counts_batched",
    ("ops/pallas_kernels.py", "cell_counts_from_hsv"):
        "ops/palette_kernels.py:cell_counts_from_hsv",
    ("ops/pallas_kernels.py", "cell_counts_s_from_rgb"):
        "ops/palette_kernels.py:cell_counts_s_from_rgb",
    ("ops/pallas_kernels.py", "lut_sections"): NOT_TO_PORT,
    ("ops/pallas_kernels.py", "margin_sort"): "ops/margin_sort.py:margin_sort",
    ("ops/pallas_kernels.py", "palette_candidate_lut"):
        "ops/palette_kernels.py:palette_candidate_table",
    ("ops/pallas_kernels.py", "palette_offset_lut"):
        "ops/palette_kernels.py:palette_offset_table",
    ("ops/pallas_kernels.py", "parent_slot_matrix"):
        "ops/palette_kernels.py:palette_offset_table",
    ("ops/pallas_kernels.py", "palette_rgb_eligible"): NOT_TO_PORT,
    ("ops/pallas_kernels.py", "palette_sums_by_k"):
        "ops/palette_kernels.py:palette_sums_by_k",
    ("ops/pallas_kernels.py", "palette_sums_by_k_rgb"):
        "ops/palette_kernels.py:palette_sums_by_k_rgb",
    ("ops/pallas_kernels.py", "palette_sums_by_k_rgb_q1"):
        "ops/palette_kernels.py:palette_sums_by_k_rgb_q1",
    ("ops/pallas_kernels.py", "polar_bin_sums"):
        "ops/polar_kernels.py:polar_bin_sums_lognorm",
    ("ops/pallas_kernels.py", "polar_bin_sums_local"):
        "ops/polar_kernels.py:polar_bin_sums_lognorm",
    ("ops/pallas_kernels_bf16.py", "cell_counts_s_from_rgb"):
        "ops/palette_kernels.py:cell_counts_s_from_rgb",
    ("ops/pallas_kernels_bf16.py", "palette_sums_by_k_rgb"):
        "ops/palette_kernels.py:palette_sums_by_k_rgb",
    ("ops/pallas_kernels_bf16.py", "palette_sums_by_k_rgb_q1"):
        "ops/palette_kernels.py:palette_sums_by_k_rgb_q1",
    ("ops/pallas_kernels_cwide.py", "cwide_tables"):
        "ops/palette_kernels.py:cwide_tables",
    ("ops/pallas_kernels_cwide.py", "palette_sums_by_k_cwide"):
        "ops/palette_kernels.py:palette_sums_by_k_cwide",
    ("ops/pallas_sharpness.py", "eligible"): NOT_TO_PORT,
    ("ops/pallas_sharpness.py", "sharpness_sums"):
        "ops/sharpness_kernels.py:sharpness_sums",
    ("ops/quantize.py", "cell_counts"): NOT_TO_PORT,
    ("ops/quantize.py", "color_palette"): NOT_TO_PORT,
    ("ops/quantize.py", "palette_q_tiers"): NOT_TO_PORT,
    ("ops/quantize.py", "palette_pixel_sums"): NOT_TO_PORT,
    ("ops/quantize.py", "margin_insertion_argsort"):
        "ops/margin_sort.py:margin_insertion_argsort",
    ("ops/quantize.py", "saliency_argsort"): "ops/margin_sort.py:margin_sort",
    ("ops/quantize.py", "palette_finalize"):
        "ops/quantize.py:palette_finalize_by_k",
    ("ops/quantize.py", "parent_assignment"):
        "ops/quantize.py:parent_assignment_from_order",
    ("ops/quantize.py", "select_valid_parents"):
        "ops/quantize.py:parent_assignment_from_order",
    ("ops/quantize.py", "use_rgb_palette_path"):
        "ops/quantize.py:palette_kernel_variant",
    ("ops/sharpness.py", "variance_sharpness"):
        "ops/sharpness.py:variance_sharpness_batched",
}


def public_names(path: Path) -> set:
    names, exported = set(), set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        exported = set(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith("_")} | exported


def not_to_port_section() -> str:
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index(f"### {NOT_TO_PORT}")
    end = text.index("\n## ", start)
    return text[start:end]


def test_port_covers_the_jax_public_surface():
    section = not_to_port_section()
    missing, stale = [], []
    for jax_mod in sorted(JAX_PKG.rglob("*.py")):
        rel = jax_mod.relative_to(JAX_PKG).as_posix()
        port_mod = PORT_PKG / rel
        have = public_names(port_mod) if port_mod.exists() else set()
        for name in sorted(public_names(jax_mod)):
            where = ALLOWED.get((rel, name))
            if name in have:
                if where is not None:
                    stale.append((rel, name))
            elif where is None:
                missing.append((rel, name))
            elif where == NOT_TO_PORT:
                assert re.search(rf"`(\w+\.)*{name}`", section), \
                    f"{rel}:{name} is not in ROADMAP.md's {NOT_TO_PORT}"
            else:
                mod, alt = where.split(":")
                assert alt in public_names(PORT_PKG / mod), \
                    f"{rel}:{name} -> {where}, which the port lacks"
    assert not missing, f"JAX names the port lacks: {missing}"
    assert not stale, f"allowlisted names the port now has: {stale}"
    jax_names = {(p.relative_to(JAX_PKG).as_posix(), n)
                 for p in JAX_PKG.rglob("*.py") for n in public_names(p)}
    assert set(ALLOWED) <= jax_names, set(ALLOWED) - jax_names
