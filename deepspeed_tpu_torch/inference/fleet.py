"""Autoscaling fleet controller, the port's copy of
``deepspeed_tpu/inference/fleet.py`` (host only).

The router routes and fails over a fixed replica set; this controller
sizes it. It observes the rendezvous store the replicas heartbeat into:
it never touches engines, only the registry meta the replicas publish
(queue depth, running count, capacity, draining flag, role), plus two
router verbs —

  * ``spawn`` (caller-supplied factory) + ``ServingRouter.register`` when
    load pressure on its tier is SUSTAINED — ``scale_up_after``
    consecutive ticks at or above ``scale_up_load`` — and the tier is
    below ``max_replicas``;
  * ``ServingRouter.decommission`` (the SIGTERM drain the chaos suite
    already exercises: drain through the integrity chain, fail the
    in-flight work over to survivors, retire the heartbeat) when the lull
    is sustained — ``scale_down_after`` ticks at or below
    ``scale_down_load`` — and the tier is above ``min_replicas``.

Both paths republish the generation manifest (registration and failover
already do), so the rendezvous history records every scale event.
Hysteresis lives in three places so the controller cannot flap: the two
sustain counters, the band between the up/down thresholds, and
``cooldown_ticks`` of enforced quiet after any scale action (a freshly
spawned replica needs a beat before its heartbeat moves the average).

The controller manages ONE role tier (``FleetConfig.role``) — a
disaggregated pod runs one controller for the decode tier (where SLO
pressure lands: every admitted request becomes decode work) and can run a
second for the prefill tier; a colocated pod runs a single ``role="both"``
controller. Replicas of other roles are invisible to it, so two
controllers on one store never fight over a replica.
"""

import dataclasses
from typing import Any, Callable, Dict, Optional

from deepspeed_tpu_torch.elasticity.rendezvous import FileRendezvous
from deepspeed_tpu_torch.inference.schemas import EVENT_SCHEMA
from deepspeed_tpu_torch.robustness import events as rb_events


@dataclasses.dataclass
class FleetConfig:
    """Autoscaler knobs. Loads are
    tier averages of the replicas' heartbeat ``(queue_depth + running) /
    capacity`` — 1.0 means the average replica is exactly full, >1.0
    means queues are building."""
    min_replicas: int = 1
    max_replicas: int = 4
    # scale up after `scale_up_after` consecutive ticks at/above this load
    scale_up_load: float = 1.0
    scale_up_after: int = 3
    # scale down after `scale_down_after` consecutive ticks at/below this
    scale_down_load: float = 0.1
    scale_down_after: int = 6
    # enforced quiet ticks after any scale action (anti-flap)
    cooldown_ticks: int = 2
    # the role tier this controller manages: prefill | decode | both
    role: str = "decode"
    # heartbeats older than this don't count as tier members (matches the
    # router's liveness horizon)
    dead_after_s: float = 5.0

    def __post_init__(self):
        if self.role not in ("prefill", "decode", "both"):
            raise ValueError(f"FleetConfig.role={self.role!r}: one of "
                             "prefill | decode | both")
        if self.min_replicas < 0 or self.max_replicas < self.min_replicas:
            raise ValueError(
                f"FleetConfig: need 0 <= min_replicas <= max_replicas, got "
                f"{self.min_replicas}..{self.max_replicas}")
        if self.scale_down_load >= self.scale_up_load:
            raise ValueError(
                "FleetConfig: scale_down_load must sit BELOW scale_up_load "
                f"(got {self.scale_down_load} >= {self.scale_up_load}) — "
                "without the band the controller flaps")


class FleetController:
    """Tick-driven autoscaler over one router's registry.

    >>> ctl = FleetController(router, spawn=make_replica,
    ...                       config=FleetConfig(role="decode"))
    >>> while serving:
    ...     router.step()
    ...     ctl.tick()          # one observation + at most one action

    ``spawn(name, role)`` is the deployment's replica factory: it returns
    either a ``ServingEngine`` (registered via ``router.register(name,
    engine, role=role)``) or a prebuilt handle with a ``try_admit``
    attribute (registered via ``register_handle`` — the test suite's stub
    replicas enter here). Names are fresh per spawn, never reused: a
    router registration is forever (dead replicas keep their slot for
    post-mortem stats), so reusing a name would collide.
    """

    def __init__(self, router, spawn: Callable[[str, str], Any],
                 config: Optional[FleetConfig] = None):
        self.router = router
        self.spawn = spawn
        self.config = config or FleetConfig()
        # own observer on the router's store: the controller watches
        # HEARTBEATS (what a per-process deployment would see), not the
        # router's in-process handles
        self._rdzv = FileRendezvous(
            router.config.store_dir, "fleet-controller",
            dead_after_s=self.config.dead_after_s,
            clock=router.config.clock)
        self._hot = 0        # consecutive ticks at/above scale_up_load
        self._idle = 0       # consecutive ticks at/below scale_down_load
        self._cooldown = 0
        self._seq = 0        # fresh-name counter (names never reused)
        self._counters = {"ticks": 0, "scale_ups": 0, "scale_downs": 0}
        self._last_load = 0.0
        self._last_tier = 0

    # ---- observation -------------------------------------------------

    def _tier(self) -> Dict[str, Dict[str, Any]]:
        """Live, non-draining heartbeats of the managed role tier:
        {host: meta}. Role resolution mirrors the router's — anything
        that isn't exactly prefill/decode (old "replica" metas included)
        is "both"."""
        out: Dict[str, Dict[str, Any]] = {}
        for host, payload in self._rdzv.live_host_info().items():
            meta = payload.get("meta") or {}
            role = meta.get("role")
            role = role if role in ("prefill", "decode") else "both"
            if role != self.config.role or meta.get("draining"):
                continue
            out[host] = meta
        return out

    @staticmethod
    def _load(meta: Dict[str, Any]) -> float:
        cap = max(1, int(meta.get("capacity") or 1))
        return (int(meta.get("queue_depth", 0))
                + int(meta.get("running", 0))) / cap

    # ---- the control loop --------------------------------------------

    def tick(self) -> Optional[str]:
        """One observation + at most one scale action. Returns the name
        of the replica spawned/decommissioned, or None."""
        cfg = self.config
        self._counters["ticks"] += 1
        # cooldown_ticks=N suppresses actions for exactly the N ticks
        # AFTER a scale event (observe-only ticks: the sustain counters
        # keep running so pressure that persists through the cooldown
        # acts the moment it lifts)
        cooling = self._cooldown > 0
        if cooling:
            self._cooldown -= 1
        tier = self._tier()
        self._last_tier = len(tier)
        if not tier:
            # empty tier: nothing to average. Bootstrapping up to
            # min_replicas is still this controller's job (a fleet that
            # starts at zero, or whose last replica just died)
            self._last_load = 0.0
            self._hot = self._idle = 0
            if cfg.min_replicas > 0 and len(tier) < cfg.min_replicas \
                    and not cooling:
                return self._scale_up(reason="below_min")
            return None
        load = sum(self._load(m) for m in tier.values()) / len(tier)
        self._last_load = load
        if load >= cfg.scale_up_load:
            self._hot += 1
            self._idle = 0
        elif load <= cfg.scale_down_load:
            self._idle += 1
            self._hot = 0
        else:
            self._hot = self._idle = 0
        if cooling:
            return None
        if len(tier) < cfg.min_replicas:
            return self._scale_up(reason="below_min")
        if self._hot >= cfg.scale_up_after and len(tier) < cfg.max_replicas:
            return self._scale_up(reason="sustained_pressure", load=load)
        if self._idle >= cfg.scale_down_after \
                and len(tier) > cfg.min_replicas:
            victim = min(tier, key=lambda h: self._load(tier[h]))
            return self._scale_down(victim, load=load)
        return None

    # ---- actions -----------------------------------------------------

    def _scale_up(self, **detail) -> Optional[str]:
        cfg = self.config
        name = f"auto-{cfg.role}-{self._seq}"
        self._seq += 1
        made = self.spawn(name, cfg.role)
        if made is None:
            # the deployment refused (no capacity to rent): not a scale
            # event, try again next tick
            return None
        if hasattr(made, "try_admit"):
            self.router.register_handle(made)
            name = made.name
        else:
            self.router.register(name, made, role=cfg.role)
        self._counters["scale_ups"] += 1
        self._cooldown = cfg.cooldown_ticks
        self._hot = 0
        rb_events.emit("fleet_scale_up", schema=EVENT_SCHEMA, replica=name,
                       role=cfg.role, tier=self._last_tier + 1, **detail)
        return name

    def _scale_down(self, name: str, **detail) -> Optional[str]:
        if name not in self.router.replicas:
            # a heartbeat from a host this router doesn't drive (foreign
            # member on a shared store): leave it alone
            return None
        self.router.decommission(name)
        self._counters["scale_downs"] += 1
        self._cooldown = self.config.cooldown_ticks
        self._idle = 0
        rb_events.emit("fleet_scale_down", schema=EVENT_SCHEMA,
                       replica=name, role=self.config.role,
                       tier=self._last_tier - 1, **detail)
        return name

    # ---- introspection -----------------------------------------------

    def stats(self) -> Dict[str, float]:
        out = {k: float(v) for k, v in self._counters.items()}
        out["tier_replicas"] = float(self._last_tier)
        out["tier_load"] = float(round(self._last_load, 4))
        out["cooldown"] = float(self._cooldown)
        return out
