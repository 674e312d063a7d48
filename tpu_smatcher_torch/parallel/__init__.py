from tpu_smatcher_torch.parallel.mesh import make_mesh, shard_text
from tpu_smatcher_torch.parallel.dist import (DistributedCounter,
                                              DistributedPositions)
from tpu_smatcher_torch.parallel.multihost import (
    init_distributed, load_corpus_shards, host_shard_ranges)

__all__ = ["make_mesh", "shard_text", "DistributedCounter",
           "DistributedPositions",
           "init_distributed", "load_corpus_shards", "host_shard_ranges"]
