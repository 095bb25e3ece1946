from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                state_from_numpy)
from deepspeed_tpu_torch.models.transformer import (ModelSpec,
                                                    TransformerConfig,
                                                    llama_config, make_model)

__all__ = ["ModelSpec", "TransformerConfig", "llama_config", "make_model",
           "params_from_numpy", "state_from_numpy"]
