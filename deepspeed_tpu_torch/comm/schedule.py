"""Collective schedule of the data-parallel gradient reduction, a port of
``deepspeed_tpu/comm/schedule.py``.

JAX expresses its schedule as structure handed to GSPMD; in eager
PyTorch a schedule is *when* the engine calls the comm facade:

* **default** (eager): each micro-batch's grads are reduced as they are
  made: over every batch axis the leaf is not sharded on, an
  ``all_reduce``; onto the ZeRO grad spec's slice (stage >= 2), a
  ``reduce_scatter``. Then the 1 / dp mean.
* **deferred** (``comm.deferred_grad_sync``): each rank accumulates its
  *local* grads over all ``gas`` micro-batches and the same reduction
  runs once at the boundary (``boundary_reduce``): the count of
  data-parallel collectives a step does not depend on ``gas`` (JAX's
  ``TestDeferredCensus`` law). As in JAX it needs a ``data`` axis: with
  the data-parallel degree on ``fsdp`` (stage 3) ZeRO-3's per-use
  reductions are the schedule.
* **hierarchical** (``comm.hierarchical_grad_reduce``) on a ``data x
  fsdp`` plan: a ``reduce_scatter`` over ``fsdp`` onto the leaf's
  ``hierarchical_spec``, an ``all_reduce`` over ``data`` of that 1/fsdp
  shard, then the shard gathered back over ``fsdp`` and cut to the grad
  spec (the reshard GSPMD does after JAX's two phases).
* ``comm.microbatch_unroll`` is accepted: an eager loop has no scan to
  unroll, and the results are the same.

A grad of a ZeRO-3 leaf sharded over ``fsdp`` arrives already summed over
``fsdp``: the backward of the gather that made the layer's whole weights
is a ``reduce_scatter`` (``runtime/zero.py``).
"""

import dataclasses
import logging
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.parallel.mesh import BATCH_AXES, MeshPlan
from deepspeed_tpu_torch.parallel.partitioning import (Spec, entry_axes,
                                                       from_entries,
                                                       spec_axes,
                                                       spec_entries,
                                                       sub_slices)

logger = logging.getLogger("deepspeed_tpu_torch")

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"


def axis_dim(spec: Spec, axis: str) -> Optional[int]:
    """The dim whose entry carries ``axis``, or None."""
    for i, e in enumerate(spec):
        if axis in entry_axes(e):
            return i
    return None


def drop_axis(spec: Spec, axis: str) -> Spec:
    """``spec`` without any reference to ``axis``."""
    return from_entries([tuple(a for a in e if a != axis)
                         for e in spec_entries(spec)])


def hierarchical_spec(grad_spec: Spec, shape: Sequence[int],
                      plan: MeshPlan) -> Spec:
    """JAX's intermediate fsdp-sharded spec of a grad leaf: a leaf already
    sharded over fsdp keeps its spec; otherwise the largest dim that is
    unsharded-divisible by the fsdp degree gains ``fsdp``; a leaf where
    nothing divides stays as it is (it rides the flat reduction)."""
    if plan.fsdp <= 1 or FSDP_AXIS in spec_axes(grad_spec):
        return grad_spec
    sizes = plan.axis_sizes()
    entries = spec_entries(grad_spec, len(shape))
    best_dim, best_size = -1, 0
    for i, dim in enumerate(shape):
        denom = int(np.prod([sizes.get(a, 1) for a in entries[i]])) \
            if entries[i] else 1
        local = dim // denom if denom and dim % denom == 0 else 0
        if local and local % plan.fsdp == 0 and local > best_size:
            best_dim, best_size = i, local
    if best_dim < 0:
        return grad_spec
    entries[best_dim] = entries[best_dim] + (FSDP_AXIS,)
    return from_entries(entries)


def deferred_supported(plan: MeshPlan) -> Tuple[bool, str]:
    """JAX's gate: the axes that restructure the step itself cannot
    defer (the pipeline's schedule, ring attention's ``seq``
    exchanges, expert-data routing, which folds the data axis at
    dispatch time)."""
    if plan.pipe > 1:
        return False, ("pipeline parallelism wraps the step in its own "
                       "manual mesh region")
    if plan.seq > 1:
        return False, ("ring attention's seq-axis collectives cannot nest "
                       "inside a manual-data region")
    if plan.expert > 1:
        return False, ("expert-data routing folds the data axis at "
                       "dispatch time")
    return True, ""


@dataclasses.dataclass(frozen=True)
class GradSchedule:
    """Where the engine reduces each micro-batch's grads."""
    deferred: bool = False
    hierarchical: bool = False

    @classmethod
    def resolve(cls, comm_cfg, plan: MeshPlan, *, onebit: bool = False):
        """The config's ``comm`` section against the plan, logged as JAX
        logs it (a request the plan cannot honour is a no-op, not an
        error)."""
        hier = False
        if comm_cfg.hierarchical_grad_reduce:
            if plan.data > 1 and plan.fsdp > 1:
                hier = True
            else:
                logger.info("comm.hierarchical_grad_reduce is a no-op: needs "
                            f"a 2D data x fsdp mesh (have {plan.describe()})")
        deferred = False
        if comm_cfg.deferred_grad_sync:
            ok, why = deferred_supported(plan)
            if onebit:
                logger.info("comm.deferred_grad_sync: the 1-bit step is "
                            "already deferred by construction")
            elif not ok:
                logger.warning(f"comm.deferred_grad_sync ignored: {why}")
            elif plan.data <= 1:
                logger.info("comm.deferred_grad_sync: no `data` axis to defer "
                            "over (dp rides fsdp; per-use reductions are "
                            "ZeRO-3 semantics), eager path unchanged")
            else:
                deferred = True
        return cls(deferred=deferred, hierarchical=hier)


def reduce_grad(g: torch.Tensor, pspec: Spec, gspec: Spec,
                hspec: Optional[Spec], plan: MeshPlan, mesh,
                inv_dp: float, dtype: torch.dtype) -> torch.Tensor:
    """One leaf's local f32 grad (laid out as its param shard ``pspec``)
    -> its ``gspec`` slice summed over every batch axis and over ``seq``
    (each rank's loss is its piece of the sequences' tokens over the
    whole count), times ``inv_dp``.
    Axes the param is sharded on were summed by ZeRO-3's gather backward.
    ``hspec``: the leaf's hierarchical spec (None: the flat reduction).
    ``dtype``: the param's; a narrower float rounds the summed grad to it
    before the scale, as JAX's grad of a bf16 param is bf16 at every stage
    and as autograd casts ZeRO-3's summed piece to the shard's dtype."""
    todo = [a for a in BATCH_AXES
            if plan.axis_sizes()[a] > 1 and a not in spec_axes(pspec)]
    if hspec is not None and FSDP_AXIS in todo and DATA_AXIS in todo \
            and axis_dim(hspec, FSDP_AXIS) is not None:
        h = axis_dim(hspec, FSDP_AXIS)
        g = comm.reduce_scatter(g, FSDP_AXIS, dim=h)
        comm.all_reduce(g, DATA_AXIS)
        g = comm.all_gather(g, FSDP_AXIS, dim=h)
        todo = [a for a in todo if a not in (FSDP_AXIS, DATA_AXIS)]
        g = g[sub_slices(g.shape, pspec, drop_axis(gspec, FSDP_AXIS),
                         mesh)]
    # scatter onto the grad spec first (major axis first), then sum the
    # smaller piece over the rest
    pent = spec_entries(pspec, g.dim())
    for d, e in enumerate(spec_entries(gspec, g.dim())):
        for a in e[len(pent[d]):]:
            if a in todo:
                g = comm.reduce_scatter(g, a, dim=d)
                todo.remove(a)
    if plan.seq > 1:
        todo.append("seq")
    for a in todo:
        comm.all_reduce(g, a)
    if dtype.is_floating_point and dtype.itemsize < g.element_size():
        g = g.to(dtype).float()
    return g.mul_(inv_dp)


def boundary_reduce(grads, layouts, dtypes, plan: MeshPlan, mesh,
                    inv_dp: float):
    """``reduce_grad`` of every leaf's grad (each micro-batch's on the
    eager schedule, the accumulated ones at the boundary on the deferred
    one); ``dtypes``: the param leaves' dtypes, in the same order."""
    return [reduce_grad(g, lay.pspec, lay.gspec, lay.hspec, plan, mesh,
                        inv_dp, dt)
            for g, lay, dt in zip(grads, layouts, dtypes)]
