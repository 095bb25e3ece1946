from deepspeed_tpu_torch.monitor.monitor import JSONLMonitor, MonitorMaster

__all__ = ["JSONLMonitor", "MonitorMaster"]
