from deepspeed_tpu_torch.comm import schedule
from deepspeed_tpu_torch.comm.comm import (all_gather, all_reduce, barrier,
                                           broadcast, counts, get_local_rank,
                                           get_rank, get_world_size,
                                           init_distributed, is_initialized,
                                           reduce_scatter, reset_counts)

__all__ = ["all_gather", "all_reduce", "barrier", "broadcast", "counts",
           "get_local_rank", "get_rank", "get_world_size",
           "init_distributed", "is_initialized", "reduce_scatter",
           "reset_counts", "schedule"]
