from deepspeed_tpu_torch.inference.engine import (InferenceConfig,
                                                  InferenceEngine,
                                                  init_inference)
from deepspeed_tpu_torch.inference.scheduler import AdmissionRejected
from deepspeed_tpu_torch.inference.serving import (DecodeDispatchHang,
                                                   ResumeIncompatible,
                                                   ServingConfig,
                                                   ServingEngine,
                                                   init_serving,
                                                   load_drain_state)
from deepspeed_tpu_torch.inference.router import (ReplicaDead,
                                                  ReplicaHandle,
                                                  ReplicaUnreachable,
                                                  RouterConfig,
                                                  ServingRouter)
from deepspeed_tpu_torch.inference.fleet import (FleetConfig,
                                                 FleetController)

__all__ = ["AdmissionRejected", "DecodeDispatchHang", "FleetConfig",
           "FleetController", "InferenceConfig", "InferenceEngine",
           "ReplicaDead", "ReplicaHandle", "ReplicaUnreachable",
           "ResumeIncompatible", "RouterConfig", "ServingConfig",
           "ServingEngine", "ServingRouter", "init_inference",
           "init_serving", "load_drain_state"]
