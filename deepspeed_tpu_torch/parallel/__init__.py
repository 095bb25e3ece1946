from deepspeed_tpu_torch.parallel.context import (current_plan,
                                                  parallel_context,
                                                  seq_parallel_degree,
                                                  set_parallel_context)
from deepspeed_tpu_torch.parallel.mesh import (AXIS_ORDER, BATCH_AXES, Mesh,
                                               MeshPlan, Topology, build_mesh,
                                               plan_from_config, single_mesh)
from deepspeed_tpu_torch.parallel.partitioning import (RULES, make_rules,
                                                       shard_leaf,
                                                       sharded_bytes,
                                                       spec_tree)
from deepspeed_tpu_torch.parallel.pipeline import (bubble_fraction,
                                                   make_pipeline_1f1b,
                                                   pipeline_spmd)

__all__ = ["AXIS_ORDER", "BATCH_AXES", "Mesh", "MeshPlan", "RULES",
           "Topology", "bubble_fraction", "build_mesh", "current_plan",
           "make_pipeline_1f1b", "make_rules", "parallel_context",
           "pipeline_spmd", "plan_from_config", "seq_parallel_degree",
           "set_parallel_context", "shard_leaf", "sharded_bytes",
           "single_mesh", "spec_tree"]
