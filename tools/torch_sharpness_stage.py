"""Time the PyTorch port's crop-box sharpness stage on one GPU, in this
checkout and, with --against, in another checkout of the port (for example
a `git archive` of an earlier commit unpacked into a directory), in turns:

    python3 tools/torch_sharpness_stage.py [--against DIR]

The stage is ``photohive_dsp_tpu_torch.ops.sharpness.
variance_sharpness_batched`` on the float32 luma of uniform uint8 noise
frames, 1080x1920, at B=1 and B=8, each frame with three crop boxes none
thinner than 4 px, one on the top and right edges (the boxes of
chip_smoke.py's main_boxes).  Each checkout runs in a process of its own
(the port's package name is the same in both); with --against the order is
DIR, this, this, DIR.  A process times 20 warm calls by CUDA events five
times and reports the median per call; the sharpness values of the two
checkouts must agree within rtol 1e-4 (the port's bar against its CPU
path).  Prints one line per process, the card's name and power limit, and
a last JSON line with the medians per checkout.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

H, W = 1080, 1920
BATCHES = (1, 8)
SEED = 0
RTOL = 1e-4


def boxes_of(h: int, w: int) -> list:
    return [(h // 10, h * 2 // 3, w // 10, w * 5 // 8),
            (h * 3 // 10, h * 5 // 6, w // 2, w - 20),
            (0, h // 4, w * 3 // 4, w)]


def worker(root: str) -> dict:
    """Times the stage of the checkout at ``root``; returns ms per call by
    batch and the B=1 sharpness values."""
    sys.path.insert(0, root)
    import torch

    from photohive_dsp_tpu_torch import set_bounding_boxes
    from photohive_dsp_tpu_torch.ops.colorspace import rgb_to_pgm, \
        u8_to_unit_f32
    from photohive_dsp_tpu_torch.ops.sharpness import \
        variance_sharpness_batched

    rng = np.random.default_rng(SEED)
    frame = rng.integers(0, 256, (3, H, W), dtype=np.uint8)
    boxes, valid = set_bounding_boxes([
        dict(top=t, bottom=b, left=lf, right=r)
        for t, b, lf, r in boxes_of(H, W)])
    out = {"root": root, "ms": {}}
    for b in BATCHES:
        rgb = u8_to_unit_f32(torch.as_tensor(
            np.stack([frame] * b), device="cuda"))
        pgm = rgb_to_pgm(rgb[:, 0], rgb[:, 1], rgb[:, 2]).contiguous()
        bx, vd = np.stack([boxes] * b), np.stack([valid] * b)

        def call():
            return variance_sharpness_batched(pgm, bx, vd)

        sharp = call()
        torch.cuda.synchronize()
        if b == 1:
            out["sharpness"] = sharp[0].cpu().tolist()
        runs = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            call()
            start.record()
            for _ in range(20):
                call()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / 20)
        out["ms"][f"B{b}"] = float(np.median(runs))
    return out


def run_worker(root: str) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--worker", root], capture_output=True, text=True,
                          timeout=600)
    if proc.returncode:
        raise SystemExit(f"worker for {root} failed ({proc.returncode}):\n"
                         f"{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another checkout of the port")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    order = [here] if not args.against else \
        [os.path.abspath(args.against), here, here,
         os.path.abspath(args.against)]
    results = []
    for root in order:
        res = run_worker(root)
        results.append(res)
        print(json.dumps(res), flush=True)
    ref = np.array(results[0]["sharpness"])
    for res in results[1:]:
        if not np.allclose(res["sharpness"], ref, rtol=RTOL, atol=0):
            raise SystemExit(f"sharpness of {res['root']} differs: "
                             f"{res['sharpness']} vs {list(ref)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    summary = {}
    for root in dict.fromkeys(order):
        mine = [r["ms"] for r in results if r["root"] == root]
        summary[root] = {k: [m[k] for m in mine] for k in mine[0]}
    print(json.dumps({"ms_per_call": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
