"""The readings a cell's limits are set from.  The benchmark's runs never
run this.

    python3 -m portbench.calibrate --workload NAME --seeds 11 12 13

prints, per seed, the control's numbers: the reference computed in
bfloat16, the precision below the configuration's float32, put in the
program's place and judged by ``portbench.check`` against the float32
reference on the cell's own frames (a sound control fails).  With
``--program SECONDS`` it prints instead the program's own numbers from a
window of that length per seed, all seeds in one process (one-card cells).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

import torch

from . import check, frames
from .loops import sample_size
from .reference.report import Reference
from .run import box_dicts, run_cell
from .spec import load_cell


def control_numbers(cell, seed: int, device) -> dict:
    """The check's numbers for the bfloat16 reference on ``seed``'s frames
    (as many as a run samples)."""
    cfg = cell.config
    n = min(sample_size(cell.traffic, cfg), cfg["frames"])
    imgs = frames.for_config(seed, cfg, n, device)
    ref = Reference(cfg["report_config"], device)
    ctl = Reference(cfg["report_config"], device, dtype=torch.bfloat16)
    per = []
    for img in imgs:
        boxes = [(b["top"], b["bottom"], b["left"], b["right"])
                 for b in box_dicts(cfg.get("boxes", []), *img.shape[:2])]
        got = ctl.report(img, boxes)
        want = ref.report(img, boxes)
        per.append(check.gaps(got, want, img.shape[0] * img.shape[1],
                              cfg["report_config"]))
    numbers = check.combine(per)
    names = check.required(bool(cfg.get("boxes")))
    return {"seed": seed, "frames": n,
            "passes": check.verdict(numbers, 1, 0, n, names),
            "numbers": {k: numbers[k] for k in names}}


def program_numbers(cell, seed: int, seconds: float) -> dict:
    """The check's numbers of a short run of the cell on ``seed``."""
    out = run_cell(cell, seed, seconds, False)
    return {"seed": seed, "correct": out["correct"],
            "numbers": {k: v["value"] for k, v in out["check"].items()}}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", type=float, metavar="SECONDS")
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    for seed in args.seeds:
        got = program_numbers(cell, seed, args.program) if args.program \
            else control_numbers(cell, seed, "cuda")
        print(json.dumps(got), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
