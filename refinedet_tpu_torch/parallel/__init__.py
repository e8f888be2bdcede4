from refinedet_tpu_torch.parallel import distributed
from refinedet_tpu_torch.parallel.mesh import replicate, shard_batch

__all__ = ["distributed", "replicate", "shard_batch"]
