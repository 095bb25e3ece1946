from deepspeed_tpu_torch.monitor.monitor import JSONLMonitor

__all__ = ["JSONLMonitor"]
