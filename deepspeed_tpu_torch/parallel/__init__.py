from deepspeed_tpu_torch.parallel.context import (current_plan,
                                                  parallel_context,
                                                  set_parallel_context)
from deepspeed_tpu_torch.parallel.mesh import (AXIS_ORDER, BATCH_AXES, Mesh,
                                               MeshPlan, Topology, build_mesh,
                                               plan_from_config, single_mesh)
from deepspeed_tpu_torch.parallel.partitioning import (RULES, make_rules,
                                                       shard_leaf,
                                                       sharded_bytes,
                                                       spec_tree)

__all__ = ["AXIS_ORDER", "BATCH_AXES", "Mesh", "MeshPlan", "RULES",
           "Topology", "build_mesh", "current_plan", "make_rules",
           "parallel_context", "plan_from_config", "set_parallel_context",
           "shard_leaf", "sharded_bytes", "single_mesh", "spec_tree"]
