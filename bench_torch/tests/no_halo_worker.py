"""A rank process of bench_torch/run.py whose halo exchange is left out:
each rank takes the out-of-alphabet pad instead of its right neighbour's
first m-1 bytes, so windows across rank boundaries are lost.  For
test_harness.py only.

    python no_halo_worker.py <bench_torch/run.py's rank options>
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from tpu_smatcher_torch.parallel import dist  # noqa: E402


def _no_halo(local, mesh, *, halo, sigma):
    return torch.full((halo,), sigma, dtype=torch.uint8, device=local.device)


dist._halo = _no_halo

from bench_torch import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run.main())
