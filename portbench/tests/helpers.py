"""Small cells for the CPU tests: a copy of the benchmark in a temporary
directory with its configurations cut to a size the CPU runs in seconds."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from portbench.spec import ROOT

SMALL = {
    "photo_1080p": dict(shapes=[[360, 512]], frames=3),
    "corpus_mixed": dict(shapes=[[360, 512], [384, 640]], frames=8,
                         batch_size=2),
    "race_mesh4": dict(shapes=[[384, 512]], frames=4, spatial_route_mp=0.1),
}


def small_root(tmp: Path, **traffic) -> Path:
    """A checkout-like directory holding BENCHMARK.json and portbench/
    with every configuration cut to ``SMALL``; each traffic mix samples
    as many reports of each batch position as it does committed."""
    root = Path(tmp) / "bench"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for name, over in SMALL.items():
        path = root / "portbench" / "configs" / f"{name}.json"
        cfg = json.loads(path.read_text())
        cfg.update(over)
        path.write_text(json.dumps(cfg))
    for path in (root / "portbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(traffic)
        if "batches_per_shape" in t:
            t["batches_per_shape"] = 2
        path.write_text(json.dumps(t))
    return root
