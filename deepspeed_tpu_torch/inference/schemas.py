"""Wire-schema version constants of the serving control plane, the port's
copy of ``deepspeed_tpu/inference/schemas.py`` with the same numbers:
drain-state tags and KV handoff payloads written by either package read
in the other.

Every serialized payload that crosses a disk or process boundary carries
a version key so readers can version-gate. The heartbeat and generation
manifest constants (``HEARTBEAT_SCHEMA``, ``GENERATION_MANIFEST_SCHEMA``)
are defined by ``elasticity/rendezvous`` and re-exported here, as JAX's
module does: the rendezvous cannot import the inference package (its
``__init__`` pulls in the router, which imports the rendezvous).
"""

from deepspeed_tpu_torch.elasticity.rendezvous import (  # noqa: F401
    GENERATION_MANIFEST_SCHEMA,
    HEARTBEAT_SCHEMA,
)

# ---- drain-state tags (serving.drain / resume / accept_migration) -----
# v1: requests only (pre-integrity seed format; readers still load it).
# v2: + rng_counter/source/engine geometry (resume refuses a geometry
#     mismatch instead of corrupting the KV cache).
# v3: + per-request trace/adapter/deadline fields.
DRAIN_STATE_V1 = 1
DRAIN_STATE_V2 = 2
DRAIN_STATE_V3 = 3
#: what the CURRENT writers emit
DRAIN_STATE_VERSION = DRAIN_STATE_V3
#: every version the CURRENT readers accept
DRAIN_STATE_VERSIONS = (DRAIN_STATE_V1, DRAIN_STATE_V2, DRAIN_STATE_V3)

# ---- KV handoff payloads (serving.export_kv / accept_migration) -------
# Bulk-bytes payload: carries a crc32 over the row bytes; readers verify
# it before installing rows.
KV_PAYLOAD_SCHEMA = 1

# ---- telemetry / fleet events (robustness.events.emit) ----------------
# Events that downstream tooling consumes across a process boundary carry
# an explicit schema key; the emit() envelope's "type"/"ts" are
# transport, not schema.
EVENT_SCHEMA = 1

__all__ = [
    "DRAIN_STATE_V1",
    "DRAIN_STATE_V2",
    "DRAIN_STATE_V3",
    "DRAIN_STATE_VERSION",
    "DRAIN_STATE_VERSIONS",
    "KV_PAYLOAD_SCHEMA",
    "EVENT_SCHEMA",
    "GENERATION_MANIFEST_SCHEMA",
    "HEARTBEAT_SCHEMA",
]
