"""Compare two sweep JSONL files cell by cell (repeatability check); the
port's copy of scripts/compare_sweeps.py.

Reports per-cell relative disagreement of the sync and device rates and
the median / p90 / max across matching cells.  The median and p90 are
statistics.median and numpy.percentile's (linear interpolation); the
reference's raw-index quantiles lean high on an even count.

    python -m tpu_smatcher_torch.tools.compare_sweeps A.jsonl B.jsonl
"""

import json
import statistics
import sys

import numpy as np


def load(path):
    cells = {}
    with open(path) as fh:
        for line in fh:
            r = json.loads(line)
            if "engine" not in r or "error" in r or "bytes_per_s" not in r:
                continue
            cells[(r["corpus"], r["p_size"], r["engine"])] = r
    return cells


def compare(a, b):
    """{"sync" | "device": {"median", "p90", "max", "at", "n"}} of the
    relative disagreement over the cells both sweeps hold (a label with no
    comparable cell is left out), printing one line per cell."""
    keys = sorted(set(a) & set(b))
    print(f"{len(keys)} matching cells ({len(a)} in A, {len(b)} in B)")
    stats = {"sync": [], "device": []}
    for k in keys:
        ra, rb = a[k], b[k]
        row = []
        for label, field in (("sync", "bytes_per_s"),
                             ("device", "device_bytes_per_s")):
            va, vb = ra.get(field), rb.get(field)
            if not va or not vb:
                continue
            rel = abs(va - vb) / min(va, vb)
            stats[label].append((rel, k))
            row.append(f"{label} {rel * 100:5.1f}%")
        print(f"  {k[0]:15s} p={k[1]:<5d} {k[2]:5s} " + "  ".join(row))
    out = {}
    for label, vals in stats.items():
        if not vals:
            continue
        rels = [v[0] for v in vals]
        worst = max(vals)
        out[label] = {"median": statistics.median(rels),
                      "p90": float(np.percentile(rels, 90)),
                      "max": worst[0], "at": worst[1], "n": len(rels)}
        s = out[label]
        print(f"{label}: median {s['median'] * 100:.1f}%  "
              f"p90 {s['p90'] * 100:.1f}%  max {s['max'] * 100:.1f}% at "
              f"{s['at']}  n={s['n']}")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    compare(load(argv[0]), load(argv[1]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
