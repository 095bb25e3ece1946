"""Mesh plan over a ``torch.distributed`` group, the serving half of
``deepspeed_tpu/parallel/mesh.py``.

JAX lays its devices on a named mesh and GSPMD inserts the collectives
an annotation implies. The port lays the ranks of a process group on the
same named grid and the model calls ``torch.distributed`` itself where a
sharded dim is met (``models/transformer.py``). The axis order is JAX's
(``AXIS_ORDER``: tensor innermost), so rank ``r`` of a plan with
``expert = E`` and ``tensor = T`` sits at ``(r // T, r % T)``: the ranks
of one tensor group are adjacent.

Serving needs the ``expert`` and ``tensor`` axes only; ``data`` must be 1
(data-parallel serving is a fleet of replicas, ROADMAP A7; data-parallel
training over ranks is ROADMAP A4).
"""

import dataclasses
from typing import Dict, List, Optional

import torch.distributed as dist

AXIS_ORDER = ("data", "expert", "tensor")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Parallel degrees of one serving engine."""
    data: int = 1
    expert: int = 1
    tensor: int = 1

    def __post_init__(self):
        for axis in AXIS_ORDER:
            if int(getattr(self, axis)) < 1:
                raise ValueError(f"MeshPlan {axis}={getattr(self, axis)}: "
                                 "degrees are >= 1")
        if self.data != 1:
            raise NotImplementedError(
                f"MeshPlan data={self.data}: data-parallel ranks are not "
                "ported yet: ROADMAP A4 (multi-rank training) / A7 "
                "(replicated serving)")

    @property
    def world_size(self) -> int:
        return self.data * self.expert * self.tensor

    def axis_sizes(self) -> Dict[str, int]:
        return {axis: int(getattr(self, axis)) for axis in AXIS_ORDER}

    def describe(self) -> str:
        """JAX's label: "tensor=2", "expert=4", "expert=2xtensor=2" or
        "single"."""
        return "x".join(f"{k}={v}" for k, v in self.axis_sizes().items()
                        if v > 1) or "single"


class Mesh:
    """A ``MeshPlan`` laid over the ranks of a process group: this rank's
    coordinates and the subgroup of each axis it belongs to (None for an
    axis of size 1, and the whole group for an axis that spans it).

    ``shape``: {axis: size}, as a JAX mesh's; ``rank``: this process's
    rank in the group; ``src``: the global rank of the group's rank 0 (the
    serving controller broadcasts from it)."""

    def __init__(self, plan: MeshPlan, group=None, rank: int = 0,
                 ranks: Optional[List[int]] = None,
                 groups: Optional[Dict[str, object]] = None):
        self.plan = plan
        self.group = group
        self.rank = rank
        self.ranks = list(ranks) if ranks is not None else [0]
        self.src = self.ranks[0]
        self._groups = dict(groups or {})
        e, t = divmod(rank, plan.tensor)
        self._coords = {"data": 0, "expert": e, "tensor": t}

    @property
    def shape(self) -> Dict[str, int]:
        return self.plan.axis_sizes()

    @property
    def world_size(self) -> int:
        return self.plan.world_size

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self._coords[axis]

    def axis_group(self, axis: str):
        """The process group of this rank's ``axis`` (None when the axis
        has size 1: nothing to reduce over)."""
        return self._groups.get(axis)

    def describe(self) -> str:
        return self.plan.describe()

    def __repr__(self) -> str:
        return (f"Mesh({self.describe()}, rank {self.rank} of "
                f"{self.world_size}, coords {self._coords})")


def single_mesh() -> Mesh:
    """The one-rank mesh of an engine that serves on one card."""
    return Mesh(MeshPlan())


def build_mesh(plan: MeshPlan, group=None) -> Mesh:
    """Lay ``plan`` over ``group`` (None: the default group; a plan of
    world size 1 needs no process group at all). Collective: every rank
    of the group calls it with the same plan, since each subgroup is made
    by ``torch.distributed.new_group`` on every rank in the same order."""
    if plan.world_size == 1:
        return single_mesh()
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"mesh {plan.describe()} needs {plan.world_size} ranks of an "
            "initialized torch.distributed process group "
            "(init_process_group first, one process a rank)")
    world = dist.get_world_size(group)
    if world != plan.world_size:
        raise ValueError(
            f"mesh {plan.describe()} needs {plan.world_size} ranks; the "
            f"process group has {world}")
    rank = dist.get_rank(group)
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(world)))
    T, E = plan.tensor, plan.expert
    groups: Dict[str, object] = {}
    for axis, members in (
            ("tensor", [[ranks[e * T + t] for t in range(T)]
                        for e in range(E)]),
            ("expert", [[ranks[e * T + t] for e in range(E)]
                        for t in range(T)])):
        if len(members[0]) == 1:
            continue
        if len(members[0]) == world:
            groups[axis] = group if group is not None else dist.group.WORLD
            continue
        for m in members:
            g = dist.new_group(m)       # every rank makes every subgroup
            if ranks[rank] in m:
                groups[axis] = g
    return Mesh(plan, group=group, rank=rank, ranks=ranks, groups=groups)
