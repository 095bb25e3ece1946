from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                state_from_numpy)
from deepspeed_tpu_torch.models.hf_import import (export_hf_state_dict,
                                                  hf_config_to_transformer,
                                                  load_hf_params,
                                                  load_megatron_params,
                                                  load_peft_adapter)
from deepspeed_tpu_torch.models.transformer import (ModelSpec,
                                                    TransformerConfig,
                                                    gpt2_config,
                                                    llama_config, make_model)

__all__ = ["ModelSpec", "TransformerConfig", "export_hf_state_dict",
           "gpt2_config", "hf_config_to_transformer", "llama_config",
           "load_hf_params", "load_megatron_params", "load_peft_adapter",
           "make_model", "params_from_numpy", "state_from_numpy"]
