from deepspeed_tpu_torch.runtime.engine import Engine, initialize

__all__ = ["Engine", "initialize"]
