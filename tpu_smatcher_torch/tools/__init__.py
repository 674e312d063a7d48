"""The port's experiment and conformance tools, each the counterpart of a
reference script of the same name in scripts/ (which import the JAX
package):

    python -m tpu_smatcher_torch.tools.soak [--device cuda|cpu] [--trials 60]
    python -m tpu_smatcher_torch.tools.sweep [--full] [--engines ...]
    python -m tpu_smatcher_torch.tools.ladder [--n BYTES] ...
    python -m tpu_smatcher_torch.tools.compare_sweeps A.jsonl B.jsonl
    python -m tpu_smatcher_torch.tools.find_fp_collision

Each runs on the card unless --device cpu is passed, and exits non-zero
on any count that differs from the ground truth."""
