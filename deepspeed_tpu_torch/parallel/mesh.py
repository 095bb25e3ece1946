"""Mesh plan over a ``torch.distributed`` group, a port of
``deepspeed_tpu/parallel/mesh.py``.

JAX lays its devices on a named mesh and GSPMD inserts the collectives
an annotation implies. The port lays the ranks of a process group on the
same named grid, and the engines and the model call the collectives
themselves, by axis name (``comm/comm.py``), where a sharded dim is met.
The axis order is JAX's (``AXIS_ORDER``: pipe outermost, then data,
fsdp, expert, seq, and tensor innermost), so a rank sits at the
coordinates of the JAX device of the same index: rank ``r`` of a plan
with ``expert = E`` and ``tensor = T`` is at ``(r // T, r % T)``, and the
ranks of one tensor group are adjacent; with ``pipe = P`` the first
``world / P`` ranks are stage 0.

Training runs every axis: ``data`` and ``fsdp`` (ZeRO,
``runtime/zero.py``; ``plan_from_config`` puts the data-parallel degree
on ``data`` for ZeRO stage <= 2 and on ``fsdp`` for stage 3), ``expert``
(a batch axis whose ranks also hold their own experts), ``tensor``
(Megatron's column and row cuts), ``pipe`` (the stacked layers cut in
stages, ``parallel/pipeline.py``) and ``seq`` (each rank holds a piece
of the sequence; attention runs as a ring, ``ops/ring_attention.py``);
serving runs ``data`` (``InferenceEngine`` splits a batch by rows),
``expert`` and ``tensor``.

Point-to-point (the comm facade's ``ppermute``, which the pipeline and
the ring use) runs over one of two transports, chosen once here when
the mesh is built: "p2p" (``batch_isend_irecv``: NCCL, one rank a card,
and gloo on CPU tensors) or "pairs" (a two-rank subgroup for every two
neighbours of a ``pipe`` or ``seq`` ring, and a ``broadcast`` from the
source over the pair's group: gloo on CUDA tensors, which refuses
``send``/``recv`` of a CUDA tensor).
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "tensor")

# the axes that together carry the global batch dim, as in JAX
BATCH_AXES = ("data", "fsdp", "expert")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Resolved parallel degrees, JAX's fields."""
    data: int = 1
    fsdp: int = 1
    expert: int = 1
    tensor: int = 1
    pipe: int = 1
    seq: int = 1

    def __post_init__(self):
        for axis in AXIS_ORDER:
            if int(getattr(self, axis)) < 1:
                raise ValueError(f"MeshPlan {axis}={getattr(self, axis)}: "
                                 "degrees are >= 1")

    @property
    def world_size(self) -> int:
        return (self.pipe * self.data * self.fsdp * self.expert * self.seq
                * self.tensor)

    @property
    def dp_world_size(self) -> int:
        """The data-parallel degree: every batch axis takes its own rows
        (expert groups included, JAX's expert-data-parallel groups)."""
        return self.data * self.fsdp * self.expert

    def axis_sizes(self) -> Dict[str, int]:
        return {axis: int(getattr(self, axis)) for axis in AXIS_ORDER}

    def describe(self) -> str:
        """JAX's label: "data=2", "expert=2xtensor=2" or "single"."""
        return "x".join(f"{k}={v}" for k, v in self.axis_sizes().items()
                        if v > 1) or "single"


def plan_from_config(config, world_size: int) -> MeshPlan:
    """JAX's ``plan_from_config``: explicit ``mesh.axes`` wins (their
    product must be the world size; ``expert`` defaults to
    ``moe.expert_parallel_size`` when ``moe`` is enabled); otherwise
    ``pipeline.stages``, ``tensor_parallel.tp_size`` and
    ``sequence_parallel.sp_size`` take their axes, the rest is the
    data-parallel degree, of which ``moe.expert_parallel_size`` (when
    ``moe`` is enabled) goes to ``expert`` and the remainder to ``data``
    for ZeRO stage <= 2 or to ``fsdp`` for stage 3."""
    explicit = dict(config.mesh.axes or {})
    moe = getattr(config, "moe", None)
    moe_on = bool(moe is not None and moe.enabled)
    if explicit:
        unknown = set(explicit) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"mesh.axes names unknown axes "
                             f"{sorted(unknown)}; the axes are {AXIS_ORDER}")
        axes = {k: int(v) for k, v in explicit.items()}
        axes.setdefault("expert", moe.expert_parallel_size if moe_on else 1)
        plan = MeshPlan(**axes)
        if plan.world_size != world_size:
            raise ValueError(f"mesh.axes product {plan.world_size} != world "
                             f"size {world_size}")
        return plan
    pp = max(1, config.pipeline.stages)
    tp = max(1, config.tensor_parallel.tp_size)
    sp = max(1, config.sequence_parallel.sp_size)
    if world_size % (pp * tp * sp) != 0:
        raise ValueError(f"world size {world_size} not divisible by "
                         f"pipe({pp})*tensor({tp})*seq({sp})")
    dp = world_size // (pp * tp * sp)
    ep = max(1, moe.expert_parallel_size) if moe_on else 1
    if dp % ep != 0:
        raise ValueError(f"expert_parallel_size {ep} must divide dp degree "
                         f"{dp}")
    dp //= ep
    if config.zero_optimization.stage >= 3:
        return MeshPlan(pipe=pp, fsdp=dp, expert=ep, seq=sp, tensor=tp)
    return MeshPlan(pipe=pp, data=dp, expert=ep, seq=sp, tensor=tp)


class Topology:
    """Rank-grid queries over a plan, JAX's ``Topology`` (the reference's
    ``ProcessTopology``): ``get_rank(axis=coord)``, ``get_coord``,
    ``get_axis_comm_lists``, ``filter_match``."""

    def __init__(self, plan: MeshPlan):
        self.plan = plan
        self.axes = list(AXIS_ORDER)
        self.dims = [getattr(plan, ax) for ax in AXIS_ORDER]

    def world_size(self) -> int:
        return int(np.prod(self.dims))

    def get_rank(self, **coords) -> int:
        idx = [coords.get(ax, 0) for ax in self.axes]
        return int(np.ravel_multi_index(idx, self.dims))

    def get_coord(self, rank: int) -> Dict[str, int]:
        return {ax: int(c) for ax, c in
                zip(self.axes, np.unravel_index(rank, self.dims))}

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)]

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """The groups of ranks that differ only along ``axis``, each in
        coordinate order."""
        ai = self.axes.index(axis)
        groups: Dict[tuple, List[int]] = {}
        for rank in range(self.world_size()):
            coord = np.unravel_index(rank, self.dims)
            key = tuple(int(c) for i, c in enumerate(coord) if i != ai)
            groups.setdefault(key, []).append(rank)
        return [sorted(v) for _, v in sorted(groups.items())]

    def filter_match(self, **coords) -> List[int]:
        return [r for r in range(self.world_size())
                if all(self.get_coord(r)[k] == v
                       for k, v in coords.items())]


class Mesh:
    """A ``MeshPlan`` laid over the ranks of a process group: this rank's
    coordinates and the subgroup of each axis it belongs to (None for an
    axis of size 1, and the whole group for an axis that spans it).

    ``shape``: {axis: size}, as a JAX mesh's; ``rank``: this process's
    rank in the group; ``src``: the global rank of the group's rank 0 (the
    serving controller broadcasts from it); ``p2p``: the point-to-point
    transport ("p2p" or "pairs", module docstring)."""

    def __init__(self, plan: MeshPlan, group=None, rank: int = 0,
                 ranks: Optional[List[int]] = None,
                 groups: Optional[Dict[str, object]] = None,
                 members: Optional[Dict[str, List[int]]] = None,
                 pairs: Optional[Dict[tuple, object]] = None,
                 p2p: str = "p2p"):
        self.plan = plan
        self.group = group
        self.rank = rank
        self.ranks = list(ranks) if ranks is not None else [0]
        self.src = self.ranks[0]
        self._groups = dict(groups or {})
        self._members = dict(members or {})
        self._pairs = dict(pairs or {})
        self.p2p = p2p
        self._coords = Topology(plan).get_coord(rank)

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

    def axis_ranks(self, axis: str) -> List[int]:
        """The global ranks of this rank's ``axis`` group, in coordinate
        order."""
        return self._members.get(axis) or [self.rank]

    def pair_group(self, axis: str, i: int, j: int):
        """The two-rank subgroup of neighbour coordinates ``i`` and ``j``
        (``j = i +- 1`` mod the axis size) of this rank's ``axis`` group
        (the "pairs" transport, built for the ``P2P_AXES``)."""
        a, b = self.axis_ranks(axis)[i], self.axis_ranks(axis)[j]
        group = self._pairs.get((min(a, b), max(a, b)))
        if group is None:
            raise ValueError(f"no pair group of ranks {a} and {b} over "
                             f"{axis}: the pairs transport serves ring "
                             f"neighbours of {P2P_AXES}")
        return group

    def describe(self) -> str:
        return self.plan.describe()

    def __repr__(self) -> str:
        return (f"Mesh({self.describe()}, rank {self.rank} of "
                f"{self.world_size}, coords {self._coords})")


# the axes whose ranks exchange point to point (``comm.ppermute``)
P2P_AXES = ("pipe", "seq")


def single_mesh() -> Mesh:
    """The one-rank mesh of an engine on one card."""
    return Mesh(MeshPlan())


def _transport(group) -> str:
    """The point-to-point transport of a process group's backend: NCCL
    and gloo on the CPU send and receive; gloo on a machine with CUDA
    may carry CUDA tensors, whose ``send``/``recv`` it refuses, so there
    a pair's broadcast carries them."""
    backend = str(dist.get_backend(group)).lower()
    if "gloo" in backend and torch.cuda.is_available():
        return "pairs"
    return "p2p"


def build_mesh(plan: MeshPlan, group=None) -> Mesh:
    """Lay ``plan`` over ``group`` (None: the default group; a plan of
    world size 1 needs no process group at all). Collective: every rank
    of the group calls it with the same plan, since each subgroup is made
    by ``torch.distributed.new_group`` on every rank in the same order.
    The point-to-point transport is the backend's (``_transport``)."""
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
    p2p = _transport(group)
    rank = dist.get_rank(group)
    ranks = (dist.get_process_group_ranks(group) if group is not None
             else list(range(world)))
    topo = Topology(plan)
    groups: Dict[str, object] = {}
    members: Dict[str, List[int]] = {}
    pairs: Dict[tuple, object] = {}
    for axis in AXIS_ORDER:
        if plan.axis_sizes()[axis] == 1:
            continue
        lists = topo.get_axis_comm_lists(axis)
        for m in lists:
            if rank in m:
                members[axis] = [ranks[i] for i in m]
        if len(lists[0]) == world:
            groups[axis] = group if group is not None else dist.group.WORLD
        else:
            for m in lists:
                g = dist.new_group([ranks[i] for i in m])
                if rank in m:       # every rank makes every subgroup
                    groups[axis] = g
        if p2p == "pairs" and axis in P2P_AXES:
            for m in lists:
                for a, b in sorted({tuple(sorted((i, (i + 1) % len(m))))
                                    for i in range(len(m))}):
                    key = (ranks[m[a]], ranks[m[b]])
                    g = dist.new_group(list(key))
                    if rank in (m[a], m[b]):
                        pairs[key] = g
    return Mesh(plan, group=group, rank=rank, ranks=ranks, groups=groups,
                members=members, pairs=pairs, p2p=p2p)
