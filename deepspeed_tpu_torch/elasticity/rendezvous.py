"""File-store rendezvous, the port's copy of
``deepspeed_tpu/elasticity/rendezvous.py`` (stdlib only): a heartbeat or a
generation manifest written by either package reads in the other.

The store is a shared directory. Every member writes an ``hb_<host>.json``
heartbeat (a beat counter, wall time, ``schema`` and an optional ``meta``
payload) by a temp file and a rename; a host whose heartbeat is older than
``dead_after_s`` is dead. The leader (the lexicographically first live
host) publishes ``gen_<N>.json`` manifests ({generation, hosts,
coordinator}). A torn heartbeat is skipped like a temp file, and a torn
newest manifest falls back to the newest readable one, so a publisher
behind a torn write continues the history instead of restarting it at
generation 0.

The serving router uses the store as its replica registry
(``publish_generation`` over an explicit host list, ``retire`` of a
failed-over host's heartbeat). ``reform_step`` is the elastic training
agent's membership round; that agent is ROADMAP A11, so nothing in the
port calls it yet.

Time is injectable (``clock``, ``sleep``): several simulated hosts share
one directory in a test.
"""

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("deepspeed_tpu_torch")

# Wire-schema versions for the two payloads this module writes. Defined
# HERE (not in inference/schemas.py, which re-exports them) because the
# inference package's __init__ imports the router, which imports this
# module — a module-level import the other way would be a cycle.
HEARTBEAT_SCHEMA = 1
GENERATION_MANIFEST_SCHEMA = 1


class FileRendezvous:
    """One participant's view of the membership store."""

    def __init__(self, store_dir: str, host: str, *,
                 coordinator_port: int = 8476,
                 dead_after_s: float = 15.0,
                 clock: Optional[Callable[[], float]] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        self.store = store_dir
        self.host = host
        self.port = coordinator_port
        self.dead_after = dead_after_s
        self._clock = clock or time.time
        # sleep must come from the same time source as the deadline checks:
        # a full poll_s time.sleep under an injected fake clock either hangs
        # (clock never advances) or insta-times-out (clock jumped past the
        # deadline). With a fake clock and no injected sleep, yield a bounded
        # 1ms real sleep per poll — the deadline logic stays on the fake
        # clock, but the loop cannot busy-spin a core (or hammer the store
        # with heartbeats) while another thread advances time.
        if sleep is not None:
            self._sleep = sleep
        elif clock is None:
            self._sleep = time.sleep
        else:
            self._sleep = lambda s: time.sleep(min(s, 0.001))
        self._beats = 0
        self._seen_gen = -1   # newest generation this member has acted on
        os.makedirs(store_dir, exist_ok=True)

    # -- heartbeats ----------------------------------------------------
    def _hb_path(self, host: str) -> str:
        return os.path.join(self.store, f"hb_{host}.json")

    def heartbeat(self, meta: Optional[Dict[str, Any]] = None):
        """Atomic write (tmp + rename): a torn read must not kill a host.

        ``meta`` is an optional opaque payload the host wants its peers to
        see next to its liveness (the serving router publishes queue depth
        / capacity here). The payload carries ``schema`` so readers can
        version-gate: hosts that predate the field wrote neither ``schema``
        nor ``meta``, and readers treat both as absent — old and new hosts
        interop over one store (pinned by a unit test)."""
        self._beats += 1
        payload: Dict[str, Any] = {"host": self.host, "beats": self._beats,
                                   "ts": self._clock(),
                                   "schema": HEARTBEAT_SCHEMA}
        if meta is not None:
            payload["meta"] = dict(meta)
        tmp = self._hb_path(self.host) + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._hb_path(self.host))

    def read_heartbeats(self) -> Dict[str, Dict[str, Any]]:
        """Every readable heartbeat payload by host, with NO liveness
        filter — the router's registry cache wants stale payloads too
        (staleness there IS the health signal). Torn/partial heartbeat
        files are skipped exactly like ``.tmp.`` temps: an unreadable
        payload must never take the reader down or invent a host."""
        out: Dict[str, Dict[str, Any]] = {}
        for fn in sorted(os.listdir(self.store)):
            # atomic-write temps (hb_<host>.json.tmp.<pid>) share the hb_
            # prefix: counting one would duplicate a host (wrong world size,
            # spurious reform)
            if not fn.startswith("hb_") or ".tmp." in fn:
                continue
            try:
                with open(os.path.join(self.store, fn)) as f:
                    hb = json.load(f)
                float(hb["ts"])                    # required fields only:
                out[hb["host"]] = hb               # schema/meta optional
            except (OSError, ValueError, KeyError, TypeError):  # torn write
                continue
        return out

    def live_host_info(self) -> Dict[str, Dict[str, Any]]:
        """{host: payload} for every host whose heartbeat is fresh (within
        ``dead_after_s``), meta included when the host published one."""
        now = self._clock()
        return {h: p for h, p in self.read_heartbeats().items()
                if now - float(p["ts"]) <= self.dead_after}

    def live_hosts(self) -> List[str]:
        return sorted(self.live_host_info())

    # -- generations ---------------------------------------------------
    def _gen_path(self, n: int) -> str:
        return os.path.join(self.store, f"gen_{n:08d}.json")

    def current_generation(self) -> Optional[Dict[str, Any]]:
        # gen_N.json.tmp.<pid> sorts AFTER gen_N.json: reading a torn temp
        # as "the newest manifest" would make this return None and let a
        # leader republish generation 0 over existing history
        gens = sorted(fn for fn in os.listdir(self.store)
                      if fn.startswith("gen_") and ".tmp." not in fn)
        # a torn/unreadable NEWEST manifest must not erase history either:
        # returning None there would let the leader republish generation 0
        # over existing generations (and every follower's _seen_gen
        # bookkeeping with it) — fall back to the next-newest readable one
        for fn in reversed(gens):
            try:
                with open(os.path.join(self.store, fn)) as f:
                    return json.load(f)
            except (OSError, ValueError):  # torn write: try the previous
                logger.warning(f"rendezvous: manifest {fn} unreadable; "
                               "falling back to the previous generation")
                continue
        return None

    def is_leader(self) -> bool:
        live = self.live_hosts()
        return bool(live) and live[0] == self.host

    def should_reform(self) -> bool:
        """Membership drifted from the published manifest (host died or
        rejoined) — time for a new generation."""
        cur = self.current_generation()
        live = self.live_hosts()
        if cur is None:
            return bool(live)
        return sorted(cur["hosts"]) != live

    def publish_generation(self, hosts: List[str],
                           coordinator: Optional[str] = None
                           ) -> Dict[str, Any]:
        """Publish the next generation manifest over an explicit host list.
        Registry use (the serving router's replica membership): the
        publisher needn't be a live heartbeating member — leadership is the
        CALLER's contract. ``propose_generation`` is the leader-elected
        wrapper the elastic agent uses. The next generation number comes
        from ``current_generation`` — whose torn-newest-manifest fallback
        guarantees a publisher behind a torn write continues the history
        instead of republishing generation 0 over it."""
        hosts = sorted(hosts)
        cur = self.current_generation()
        n = (cur["generation"] + 1) if cur else 0
        manifest = {"generation": n, "hosts": hosts,
                    "coordinator": coordinator or (
                        f"{hosts[0]}:{self.port}" if hosts else None),
                    "ts": self._clock(),
                    "schema": GENERATION_MANIFEST_SCHEMA}
        tmp = self._gen_path(n) + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, self._gen_path(n))
        self._seen_gen = n
        logger.info(f"rendezvous: generation {n} published — "
                    f"{len(hosts)} host(s), coordinator "
                    f"{manifest['coordinator']}")
        return manifest

    def propose_generation(self) -> Optional[Dict[str, Any]]:
        """Leader-only: publish the next generation over the live set.
        Returns the manifest (followers get it via wait_generation)."""
        if not self.is_leader():
            return None
        return self.publish_generation(self.live_hosts())

    def wait_generation(self, min_generation: int = 0,
                        timeout_s: float = 60.0,
                        poll_s: float = 0.5) -> Dict[str, Any]:
        """Block until a manifest with generation >= min_generation exists.
        Followers call this after noticing membership drift (or on join).

        Keeps heartbeating while blocked: a reform can take most of a
        minute, and a follower that goes silent for dead_after_s would be
        declared dead and excluded from the very generation it waits for."""
        deadline = self._clock() + timeout_s
        while True:
            self.heartbeat()
            cur = self.current_generation()
            if cur is not None and cur["generation"] >= min_generation:
                return cur
            if self._clock() > deadline:
                raise TimeoutError(
                    f"rendezvous: no generation >= {min_generation} within "
                    f"{timeout_s}s ({len(self.live_hosts())} live hosts)")
            self._sleep(poll_s)

    def leave(self):
        """Graceful exit: drop the heartbeat so the next round excludes us."""
        try:
            os.remove(self._hb_path(self.host))
        except OSError:
            pass

    def retire(self, host: str):
        """Remove ANOTHER host's heartbeat from the store. Only for a
        coordinator holding death evidence (the serving router after a
        decommission or a failover): a retired-but-alive host
        simply re-appears on its next beat, so this can hide a live host
        for at most one heartbeat interval, never fence one out. Without
        it, autoscale cycles accumulate dead entries forever."""
        try:
            os.remove(self._hb_path(host))
        except OSError:
            pass


def reform_step(rdzv: FileRendezvous) -> Optional[Dict[str, Any]]:
    """One membership round: heartbeat; if the live set drifted from the
    manifest the leader publishes the next generation (followers wait for
    it); and ANY generation this member hasn't acted on yet is returned —
    so a follower whose leader already re-formed still learns about it on
    its next round. Returns None when nothing changed. The caller (elastic
    agent / launcher) rebuilds its process group against
    manifest['coordinator'] and resumes from the latest checkpoint with
    the new world's batch plan."""
    rdzv.heartbeat()
    published = None
    if rdzv.should_reform():
        cur = rdzv.current_generation()
        want = (cur["generation"] + 1) if cur else 0
        if rdzv.is_leader():
            published = rdzv.propose_generation()
        else:
            rdzv.wait_generation(min_generation=want)
    if published is not None:
        return published
    newest = rdzv.current_generation()
    if newest is not None and newest["generation"] > rdzv._seen_gen:
        rdzv._seen_gen = newest["generation"]
        return newest
    return None
