from deepspeed_tpu_torch.inference.engine import (InferenceConfig,
                                                  InferenceEngine,
                                                  init_inference)
from deepspeed_tpu_torch.inference.serving import (ServingConfig,
                                                   ServingEngine,
                                                   init_serving)

__all__ = ["InferenceConfig", "InferenceEngine", "ServingConfig",
           "ServingEngine", "init_inference", "init_serving"]
