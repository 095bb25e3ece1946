"""Elastic membership, the port's part of ``deepspeed_tpu/elasticity``: the
file-store rendezvous the serving router uses as its replica registry.
The elastic training agent and the batch plans (``elastic_agent.py``,
``elasticity.py``) are ROADMAP A11."""

from deepspeed_tpu_torch.elasticity.rendezvous import (
    GENERATION_MANIFEST_SCHEMA, HEARTBEAT_SCHEMA, FileRendezvous, reform_step)

__all__ = ["FileRendezvous", "GENERATION_MANIFEST_SCHEMA",
           "HEARTBEAT_SCHEMA", "reform_step"]
