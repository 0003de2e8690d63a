"""Data-parallel runs over torch.distributed (counterpart of
naruto_tpu/parallel/): the ray and voxel axes split across ranks, the
field's parameters replicated."""
from naruto_tpu_torch.parallel.mesh import (data_sharding, make_mesh,
                                            replicated)
from naruto_tpu_torch.parallel.sharded import (sharded_grad_step,
                                               sharded_volume_query)

__all__ = ["make_mesh", "data_sharding", "replicated",
           "sharded_grad_step", "sharded_volume_query"]
