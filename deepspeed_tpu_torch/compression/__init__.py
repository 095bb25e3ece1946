from deepspeed_tpu_torch.compression.compress import (
    CompressionTransform, init_compression, make_distillation_loss,
    redundancy_clean, student_params_from_teacher)

__all__ = ["CompressionTransform", "init_compression",
           "make_distillation_loss", "redundancy_clean",
           "student_params_from_teacher"]
