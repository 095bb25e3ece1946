from deepspeed_tpu_torch.moe.mappings import drop_tokens, gather_tokens
from deepspeed_tpu_torch.moe.sharded_moe import (moe_ffn, record_routing,
                                                 top_k_gating)

__all__ = ["drop_tokens", "gather_tokens", "moe_ffn", "record_routing",
           "top_k_gating"]
