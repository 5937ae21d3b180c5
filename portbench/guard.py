"""What a run may not load: JAX, and the JAX package the port was made
from.  Names are compared as whole top-level module names (the part
before the first dot), so ``photohive_dsp_tpu_torch`` is not
``photohive_dsp_tpu``."""

from __future__ import annotations

import ast
import sys
from pathlib import Path
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "photohive_dsp_tpu"})
PROGRAM = "photohive_dsp_tpu_torch"


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules: Iterable[str] = None) -> List[str]:
    """Forbidden top-level names among ``modules`` (default: sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & FORBIDDEN)


def imported_names(path: Path) -> List[str]:
    """Top-level names of every module a Python source imports."""
    tree = ast.parse(Path(path).read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [top_level(a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(top_level(node.module))
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.append(top_level(str(node.args[0].value)))
    return out


def reference_violations(directory: Path) -> List[str]:
    """``file: name`` for each import under ``directory`` of a forbidden
    module or of the program (the reference must not use the program)."""
    bad = []
    for path in sorted(Path(directory).rglob("*.py")):
        for name in imported_names(path):
            if name in FORBIDDEN or name == PROGRAM:
                bad.append(f"{path.name}: {name}")
    return bad
