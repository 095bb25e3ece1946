from deepspeed_tpu_torch.parallel.context import (current_plan,
                                                  parallel_context,
                                                  set_parallel_context)
from deepspeed_tpu_torch.parallel.mesh import (Mesh, MeshPlan, build_mesh,
                                               single_mesh)
from deepspeed_tpu_torch.parallel.partitioning import (RULES, shard_leaf,
                                                       sharded_bytes,
                                                       spec_tree)

__all__ = ["Mesh", "MeshPlan", "RULES", "build_mesh", "current_plan",
           "parallel_context", "set_parallel_context", "shard_leaf",
           "sharded_bytes", "single_mesh", "spec_tree"]
