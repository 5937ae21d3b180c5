"""The cell a run measures, resolved by name from ``BENCHMARK.json`` and
the files under ``portbench/``: its configuration, its traffic mix and the
readers of its metrics."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    source: str
    read: object            # read(run) -> Optional[float]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]
    root: Path


def load_reader(root: Path, name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_cell(workload: str, root: Optional[Path] = None) -> Cell:
    """Resolve ``workload`` (a name in BENCHMARK.json's ``workloads``)."""
    root = Path(root) if root is not None else ROOT
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells: Dict[str, dict] = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    # Every per-layer metric names its cells: a reader is bound to the
    # cells where it finds something to read, and to no others.
    layer = [m for m in bench["per_layer"] if workload in m["workloads"]]

    def metrics(entries):
        return [Metric(m["name"], m["unit"], m["source"],
                       load_reader(root, m["name"])) for m in entries]

    return Cell(workload, int(w["chips"]), config, traffic, metrics(e2e),
                metrics(layer), root)
