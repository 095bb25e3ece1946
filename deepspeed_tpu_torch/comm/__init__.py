from deepspeed_tpu_torch.comm import schedule
from deepspeed_tpu_torch.comm.comm import (CommsLogger, all_gather,
                                           all_reduce, barrier, broadcast,
                                           comms_logger, configure, counts,
                                           get_local_rank, get_rank,
                                           get_world_size, init_distributed,
                                           is_initialized, log_summary,
                                           ppermute, reduce_scatter,
                                           reset_counts)

__all__ = ["CommsLogger", "all_gather", "all_reduce", "barrier", "broadcast",
           "comms_logger", "configure", "counts", "get_local_rank",
           "get_rank", "get_world_size", "init_distributed",
           "is_initialized", "log_summary", "ppermute", "reduce_scatter",
           "reset_counts", "schedule"]
