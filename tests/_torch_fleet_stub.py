"""A pure-host stub replica for the port's router tests, written to the
router's handle protocol (``inference/router.ReplicaHandle``) as JAX's
``_StubReplica`` (``deepspeed_tpu/analysis/serving_lint.py``) is, and
behaving as it does, so one scenario driven through either package's
router reads the same. Imports the port only.

Admissions append to a FIFO; each ``step`` serves up to ``service_rate``
of them; heartbeats carry the same schema-versioned meta. ``die()`` is a
supervised kill: the in-flight FIFO drains through the real integrity
chain (state, manifest, COMMITTED last), then the replica goes silent —
it still accepts dispatches and completes nothing, and never heartbeats
again."""

import dataclasses
import json
import os
import time
from typing import Any, Dict

from deepspeed_tpu_torch.elasticity.rendezvous import FileRendezvous
from deepspeed_tpu_torch.inference.router import ReplicaUnreachable
from deepspeed_tpu_torch.inference.schemas import DRAIN_STATE_V2
from deepspeed_tpu_torch.robustness import integrity


@dataclasses.dataclass
class StubFinished:
    """Just enough of a finished Request for the router's bookkeeping."""
    rid: int
    submit_t: float
    first_token_t: float


class StubReplica:
    def __init__(self, name: str, store_dir: str, drain_root: str,
                 capacity: int = 4, service_rate: int = 2, clock=None):
        self.name = name
        self.rdzv = FileRendezvous(store_dir, name, clock=clock)
        self.drain_dir = os.path.join(drain_root, name)
        self.capacity = capacity
        self.service_rate = service_rate
        self._clock = clock or time.time
        self.dead = False            # router-visible only AFTER failover
        self.silent = False          # the actual death: no beats, no work
        self.partitioned = False
        self.mute_heartbeat = False
        self.killed_t = None
        self._q: list = []           # [(rid, submit_t)]
        self.completed = 0

    # -- handle protocol ------------------------------------------------
    def meta(self) -> Dict[str, Any]:
        return {"role": "replica", "queue_depth": len(self._q),
                "running": 0, "capacity": self.capacity,
                "pool_free": 1.0, "draining": False}

    def publish(self) -> None:
        if self.silent or self.mute_heartbeat:
            return
        self.rdzv.heartbeat(meta=self.meta())

    def try_admit(self, prompt, max_new_tokens: int, rid: int,
                  **_deadlines) -> int:
        self._q.append((rid, self._clock()))
        return rid

    def step(self):
        if self.partitioned:
            raise ReplicaUnreachable(
                f"router partition: replica {self.name} unreachable")
        if self.silent:
            return []                # accepted, never served
        now = self._clock()
        out = [StubFinished(rid=rid, submit_t=sub, first_token_t=now)
               for rid, sub in self._q[:self.service_rate]]
        del self._q[:len(out)]
        self.completed += len(out)
        try:
            self.publish()
        except OSError:
            pass     # a store-write hiccup never drops completed work
        return out

    def accept_migration(self, recs, rng_counter=None, source=None,
                         geometry=None):
        rids = [int(r["rid"]) for r in recs]
        now = self._clock()
        self._q.extend((rid, now) for rid in rids)
        return rids

    def new_cancelled(self):
        return []

    @property
    def done(self) -> bool:
        return self.silent or not self._q

    def inflight(self) -> int:
        return len(self._q)

    # -- the orchestrated death ------------------------------------------
    def die(self) -> None:
        tag_dir = os.path.join(self.drain_dir, f"drain_{self.name}")
        os.makedirs(tag_dir, exist_ok=True)
        state = {"version": DRAIN_STATE_V2, "source": self.name,
                 "engine": {"max_model_len": 4096, "block_size": 16,
                            "table_width": 256, "max_seqs": self.capacity},
                 "requests": [{"rid": rid, "prompt": [1, 2, 3],
                               "max_new_tokens": 8, "generated": []}
                              for rid, _ in self._q]}
        integrity.atomic_write(os.path.join(tag_dir, "state.json"),
                               json.dumps(state, indent=1),
                               what="stub drain state write")
        integrity.write_manifest(tag_dir)
        integrity.write_commit_marker(tag_dir)
        self._q = []
        self.silent = True
