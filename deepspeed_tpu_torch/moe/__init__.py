from deepspeed_tpu_torch.moe.sharded_moe import moe_ffn, top_k_gating

__all__ = ["moe_ffn", "top_k_gating"]
