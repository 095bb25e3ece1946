from deepspeed_tpu_torch.inference.engine import (InferenceConfig,
                                                  InferenceEngine,
                                                  init_inference)
from deepspeed_tpu_torch.inference.scheduler import AdmissionRejected
from deepspeed_tpu_torch.inference.serving import (DecodeDispatchHang,
                                                   ServingConfig,
                                                   ServingEngine,
                                                   init_serving)

__all__ = ["AdmissionRejected", "DecodeDispatchHang", "InferenceConfig",
           "InferenceEngine", "ServingConfig", "ServingEngine",
           "init_inference", "init_serving"]
