"""Fault tolerance, the port's copy of ``deepspeed_tpu/robustness``:
deterministic fault injection, checkpoint integrity, bounded-retry I/O and
graceful preemption."""

from deepspeed_tpu_torch.robustness import events
from deepspeed_tpu_torch.robustness.faults import (KINDS, ROUTER_KINDS,
                                                   BackendFault,
                                                   DispatchFault,
                                                   FaultInjector,
                                                   FaultSchedule,
                                                   HandoffFault, active,
                                                   clear, dispatch_seam,
                                                   install,
                                                   install_from_config,
                                                   io_seam, kv_handoff_seam,
                                                   mutate_seam, router_seam,
                                                   serving_round_seam)
from deepspeed_tpu_torch.robustness.integrity import (newest_valid_tag,
                                                      prune_tags,
                                                      validate_tag,
                                                      write_commit_marker,
                                                      write_manifest)
from deepspeed_tpu_torch.robustness.preemption import (Preempted,
                                                       PreemptionHandler)
from deepspeed_tpu_torch.robustness.retry import retry_io

__all__ = [
    "BackendFault", "DispatchFault", "FaultInjector", "FaultSchedule",
    "HandoffFault", "KINDS", "Preempted", "PreemptionHandler",
    "ROUTER_KINDS", "active", "clear", "dispatch_seam", "events",
    "install", "install_from_config", "io_seam", "kv_handoff_seam",
    "mutate_seam", "newest_valid_tag", "prune_tags", "retry_io",
    "router_seam", "serving_round_seam", "validate_tag",
    "write_commit_marker", "write_manifest",
]
