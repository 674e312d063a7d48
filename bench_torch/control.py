"""The control of a cell's comparison, read on the card at the cell's own
size: the plain reference's count (references/<name>.count) against the
control's (references/<name>.control, the same count by a fingerprint with
its verify left out), over the whole corpus of each seed.

    python3 bench_torch/control.py --workload CELL --seeds S1 S2 S3 ...

Prints one JSON line a seed: {"workload", "seed", "reference", "control",
"control_gap"}; the control's count gap is the number the run compares
(its limit is 0), and a sound control reads above it on every seed.  A
multi-card cell's corpus is counted whole on one card.  The benchmark's
own runs do not run this.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_torch import gen, spec  # noqa: E402


def readings(cell, seed, device):
    ref = cell.reference()
    text, panel = gen.make_inputs(cell.config, cell.traffic, seed, device)
    t0 = time.perf_counter()
    r = ref.count(text, panel, cell.sigma)
    t1 = time.perf_counter()
    c = ref.control(text, panel, cell.sigma)
    return {"workload": cell.name, "seed": seed, "reference": r,
            "control": c, "control_gap": abs(c - r),
            "reference_s": t1 - t0}


def main(argv=None):
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load(args.workload, ROOT)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, torch.device(args.device))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
