from deepspeed_tpu_torch.config.config import Config
from deepspeed_tpu_torch.config.config_utils import ConfigError

__all__ = ["Config", "ConfigError"]
