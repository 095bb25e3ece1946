"""ZeRO stages over ``torch.distributed``, a port of
``deepspeed_tpu/runtime/zero.py``.

In the JAX package a stage is a set of sharding specs and GSPMD inserts
the collectives; here the same specs (``zero_param_spec``,
``opt_state_spec``, ``grad_spec``: JAX's functions) decide what each rank
holds, and ``Partition`` holds exactly the slice of each leaf that JAX
puts on the device at the rank's mesh coordinates:

- stage 0: params, grads and optimizer state whole on every rank; grads
  all-reduced (mean);
- stage 1: the optimizer state (f32 masters and moments) sharded over
  ``data`` (the largest free dim that ``data`` divides); each rank
  updates its slice and the updated params are all-gathered;
- stage 2: also the grads, reduce-scattered onto the same slice;
- stage 3: the params themselves sharded over ``fsdp`` (the stage-3
  rules of ``parallel/partitioning.make_rules``). A leaf of at most
  ``stage3_param_persistence_threshold`` values stays whole. The model
  gathers each layer's whole weights where the layer runs
  (``parallel/context.gather_params``) through ``GatherShard``, whose
  backward reduce-scatters the layer's grads onto the shards; under the
  remat policy's checkpoint the gather replays in the backward, so a
  layer's whole weights live only while it runs (the reference's
  fetch / release). The embedding and the head are gathered once a pass.

Over the model axes: a leaf sharded over ``expert`` (an expert stack)
has its grad summed over data x fsdp only, every other leaf over data x
fsdp x expert (``expert`` is a batch axis); every leaf's grad is summed
over ``seq`` (each rank differentiates its piece of the sequences); the
stacked layers are sliced over ``pipe`` (each stage holds its layers;
the data / fsdp partition of ZeRO applies inside a stage's slice) and
the grads of the leaves every stage holds whole are summed over ``pipe``
by the pipeline schedule itself (``parallel/pipeline.py``); no grad is
summed over ``tensor`` (a leaf sharded there holds its own slice's grad, and a leaf
replicated there has the same grad on every tensor rank: the model's
``copy_to_tensor`` / ``reduce_from_tensor`` see to it). The global norm
adds the shards' sums over the axes that shard each leaf, so each element
counts once.

The collectives go through the comm facade by axis name; when they run
is the schedule's (``comm/schedule.py``).
"""

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm import schedule as comm_sched
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
from deepspeed_tpu_torch.parallel.mesh import (AXIS_ORDER, BATCH_AXES, Mesh,
                                               MeshPlan)
from deepspeed_tpu_torch.parallel.partitioning import (Spec, entry_axes,
                                                       from_entries,
                                                       make_rules, mesh_axes,
                                                       shard_slices,
                                                       spec_axes,
                                                       spec_entries,
                                                       sub_slices,
                                                       sum_groups)


def zero_param_spec(spec: Spec, shape: Sequence[int], plan: MeshPlan,
                    zero_cfg) -> Spec:
    """A param's spec for the stage: the stage-3 rules already shard over
    ``fsdp``; a leaf of at most the persistence threshold's values goes
    back to replicated over ``fsdp``. Then ``_divisible_spec``."""
    if zero_cfg.stage < 3 or plan.fsdp <= 1:
        return _divisible_spec(spec, shape, plan)
    numel = int(np.prod(shape)) if len(shape) else 1
    if numel <= zero_cfg.stage3_param_persistence_threshold:
        spec = from_entries([tuple(a for a in e if a != "fsdp")
                             for e in spec_entries(spec)])
    return _divisible_spec(spec, shape, plan)


def _divisible_spec(spec: Spec, shape: Sequence[int],
                    plan: MeshPlan) -> Spec:
    """Drop the axes of a dim that they do not divide (that dim stays
    replicated instead of failing)."""
    sizes = plan.axis_sizes()
    entries = spec_entries(spec)
    for i, e in enumerate(entries):
        if not e or i >= len(shape):
            continue
        kept, denom = [], 1
        for a in e:
            n = sizes.get(a, 1)
            if shape[i] % (denom * n) == 0:
                kept.append(a)
                denom *= n
        entries[i] = tuple(kept)
    return from_entries(entries)


def opt_state_spec(param_spec: Spec, shape: Sequence[int], plan: MeshPlan,
                   zero_cfg, dp_axis: str = "data") -> Spec:
    """The spec of a leaf's optimizer state (f32 master, moments): at
    stage >= 1 the largest dim that is not sharded yet and whose local
    size ``data`` divides gains ``data``; a leaf where nothing divides
    keeps the param spec."""
    if zero_cfg.stage < 1 or plan.data <= 1:
        return param_spec
    entries = spec_entries(param_spec, len(shape))
    if dp_axis in {a for e in entries for a in e}:
        return param_spec
    sizes = plan.axis_sizes()
    best_dim, best_size = -1, 0
    for i, dim in enumerate(shape):
        denom = int(np.prod([sizes.get(a, 1) for a in entries[i]])) \
            if entries[i] else 1
        local = dim // denom if denom and dim % denom == 0 else 0
        if local and local % plan.data == 0 and local > best_size:
            best_dim, best_size = i, local
    if best_dim < 0:
        return param_spec
    entries[best_dim] = entries[best_dim] + (dp_axis,)
    return from_entries(entries)


def grad_spec(param_spec: Spec, shape: Sequence[int], plan: MeshPlan,
              zero_cfg) -> Spec:
    """Stage >= 2: the grads live where the optimizer reads them (the
    optimizer-state spec); below, they follow the params."""
    if zero_cfg.stage >= 2:
        return opt_state_spec(param_spec, shape, plan, zero_cfg)
    return param_spec


def describe(zero_cfg, plan: MeshPlan) -> str:
    return (f"ZeRO stage {zero_cfg.stage} | mesh {plan.describe()} | "
            f"params {'fsdp-sharded' if zero_cfg.stage >= 3 else 'replicated'}, "
            f"grads {'dp-sharded' if zero_cfg.stage >= 2 else 'replicated'}, "
            f"opt {'dp-sharded' if zero_cfg.stage >= 1 else 'replicated'}")


# --------------------------------------------------------------------------
# one engine's layout
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """One param leaf: its whole shape and the specs of its param, its
    optimizer state, its grad, and (hierarchical reduction) the
    intermediate grad spec."""
    path: str
    shape: Tuple[int, ...]
    pspec: Spec
    ospec: Spec
    gspec: Spec
    hspec: Optional[Spec] = None


class GatherShard(torch.autograd.Function):
    """A sharded leaf made whole along ``dim`` (``all_gather`` over the
    dim's axes); the backward sums the whole leaf's grad over those axes
    and keeps this rank's piece (``reduce_scatter``, in f32)."""

    @staticmethod
    def forward(ctx, shard, axes, dim, mesh):
        ctx.axes, ctx.dim, ctx.mesh = axes, dim, mesh
        return comm.all_gather(shard, axes, dim=dim, mesh=mesh)

    @staticmethod
    def backward(ctx, grad):
        piece = comm.reduce_scatter(grad.float(), ctx.axes, dim=ctx.dim,
                                    mesh=ctx.mesh)
        return piece, None, None, None


def _leaf_paths(tree, prefix: str = "") -> List[str]:
    """The paths of a nested dict's leaves in ``tree_leaves`` order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += _leaf_paths(v, f"{prefix}{k}/")
        else:
            out.append(prefix + k)
    return out


def _flat_axes(tree, prefix: str = "") -> Dict[str, tuple]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_axes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


class Partition:
    """The ZeRO layout of one engine on a mesh of more than one rank:
    every param leaf's ``LeafLayout`` (by path), this rank's slices of
    params, optimizer state and grads, the gradient reduction, the
    global norm, the post-update gather and stage 3's gatherer."""

    def __init__(self, logical_axes, plan: MeshPlan, mesh: Mesh, zero_cfg,
                 hierarchical: bool = False):
        self.plan, self.mesh, self.zero_cfg = plan, mesh, zero_cfg
        self.stage = zero_cfg.stage
        self.rules = make_rules(self.stage, tp=plan.tensor > 1,
                                pipe=plan.pipe > 1)
        self._logical = _flat_axes(logical_axes)
        self._hier = hierarchical
        self.layouts: Dict[str, LeafLayout] = {}
        self.inv_dp = float(np.float32(1.0 / plan.dp_world_size))

    def layout(self, path: str, shape: Sequence[int]) -> LeafLayout:
        lay = self.layouts.get(path)
        if lay is not None:
            return lay
        shape = tuple(int(s) for s in shape)
        base = mesh_axes(self._logical.get(path), self.rules)
        pspec = zero_param_spec(base, shape, self.plan, self.zero_cfg)
        ospec = opt_state_spec(pspec, shape, self.plan, self.zero_cfg)
        gspec = grad_spec(pspec, shape, self.plan, self.zero_cfg)
        hspec = (comm_sched.hierarchical_spec(gspec, shape, self.plan)
                 if self._hier else None)
        lay = LeafLayout(path, shape, pspec, ospec, gspec, hspec)
        self.layouts[path] = lay
        return lay

    def in_order(self, params) -> List[LeafLayout]:
        """The layouts of ``params``' leaves, in ``tree_leaves`` order."""
        return [self.layouts[p] for p in _leaf_paths(params)]

    # --- this rank's slices ---------------------------------------------
    def param_shard(self, path: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a whole param (a copy when it is a strict
        slice, so the whole leaf's storage can go)."""
        lay = self.layout(path, full.shape)
        part = full[shard_slices(full.shape, lay.pspec, self.mesh, path)]
        return part.clone() if part.shape != full.shape else part

    def opt_view(self, lay: LeafLayout, local_param: torch.Tensor):
        """The optimizer's slice of a local param (a view)."""
        return local_param[sub_slices(local_param.shape, lay.pspec,
                                      lay.ospec, self.mesh)]

    def grad_view(self, lay: LeafLayout, local_grad: torch.Tensor):
        """The optimizer's slice of a reduced grad (a view)."""
        return local_grad[sub_slices(local_grad.shape, lay.gspec, lay.ospec,
                                     self.mesh)]

    # --- the step's collectives -------------------------------------------
    def reduce_grads(self, grads, params) -> List[torch.Tensor]:
        """Every leaf's local grad -> its grad-spec slice, the mean over
        the data-parallel ranks, rounded to its param leaf's dtype (a
        bf16 param's grad is bf16 at every stage, as JAX's is and as
        stage 3's gather backward hands it over)."""
        return comm_sched.boundary_reduce(
            grads, self.in_order(params),
            [p.dtype for p in tree_leaves(params)], self.plan, self.mesh,
            self.inv_dp)

    def _sharded_over(self, spec: Spec) -> Tuple[str, ...]:
        return tuple(a for a in sorted(spec_axes(spec))
                     if self.mesh.size(a) > 1)

    def grad_norm(self, grads, layouts, sum_sq) -> torch.Tensor:
        """The global norm of the reduced grads: each leaf's sum of
        squares counted once (the shards' sums added over the axes that
        shard the leaf, a whole leaf's taken as it is)."""
        groups: Dict[Tuple[str, ...], torch.Tensor] = {}
        for g, lay in zip(grads, layouts):
            key = self._sharded_over(lay.gspec)
            s = sum_sq(g)
            groups[key] = s if key not in groups else groups[key] + s
        total = None
        for key, s in sorted(sum_groups(groups).items()):
            total = s if total is None else total + s
        return total.sqrt()

    def leaf_reducer(self, layouts):
        """``ops.optimizers.leaf_reduction``'s function: a per-leaf
        statistic summed over the axes that shard the leaf's optimizer
        state."""
        def reduce(i: int, t: torch.Tensor) -> torch.Tensor:
            for a in self._sharded_over(layouts[i].ospec):
                comm.all_reduce(t, a)
            return t
        return reduce

    def any_rank(self, flag: torch.Tensor) -> torch.Tensor:
        """A bool flag true on every rank when it is true on any (the
        fp16 overflow, each rank's over its shards of the grads: every
        rank skips the same step)."""
        f = flag.to(torch.float32).reshape(1)
        comm.all_reduce(f, AXIS_ORDER, op="max")
        return f[0] > 0

    def mean_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """A per-rank scalar (the loss) summed over ``seq`` (each rank's
        is its piece of the sequences') and averaged over the
        data-parallel ranks."""
        x = x.detach().float().reshape(1).clone()
        comm.all_reduce(x, "seq")
        return comm.all_reduce(x, BATCH_AXES, op="mean")[0]

    def gather_updated(self, params, layouts) -> None:
        """After an update of the optimizer's slices (written through
        into the params): every param whose optimizer spec is finer than
        its param spec gathered whole again."""
        for p, lay in zip(params, layouts):
            if lay.ospec == lay.pspec:
                continue
            view = self.opt_view(lay, p)
            pent = spec_entries(lay.pspec, p.dim())
            for d, e in enumerate(spec_entries(lay.ospec, p.dim())):
                extra = e[len(pent[d]):]
                if extra:
                    view = comm.all_gather(view, extra, dim=d,
                                           mesh=self.mesh)
            with torch.no_grad():
                p.detach().copy_(view)

    # --- stage 3 ------------------------------------------------------------
    def gatherer(self):
        """``parallel.context.param_gather``'s function: ``fn(tree,
        prefix)`` with every param sharded over ``fsdp`` made whole along
        that axis by ``GatherShard`` (the stacked "layers" subtree passes
        through at the top: each layer gathers its own slices, prefix
        "layers/"). Shards over ``expert`` and ``tensor`` stay: the model
        runs on them. A dim split over (fsdp, tensor) together (the
        stage-3 table's vocab) holds interleaved pieces of the tensor
        ranks' slices, so it is gathered over both and cut to this rank's
        contiguous tensor slice; the backward's sum over ``tensor`` adds
        exact zeros outside each rank's slice."""
        def gather(tree, prefix: str = ""):
            out = {}
            for k, v in tree.items():
                path = prefix + k
                lay = self.layouts.get(path)
                if lay is None or not isinstance(v, torch.Tensor):
                    out[k] = v
                    continue
                shift = v.dim() - len(lay.shape)     # -1 for a layer slice
                for d, e in enumerate(spec_entries(lay.pspec)):
                    live = tuple(a for a in e if self.mesh.size(a) > 1)
                    if "fsdp" not in live or d + shift < 0:
                        continue
                    dim = d + shift
                    if live == ("fsdp",):
                        v = GatherShard.apply(v, live, dim, self.mesh)
                        continue
                    whole = GatherShard.apply(v, live, dim, self.mesh)
                    n = self.mesh.size("tensor")
                    part = whole.shape[dim] // n
                    v = whole.narrow(dim, self.mesh.index("tensor") * part,
                                     part)
                out[k] = v
            return out
        return gather

    # --- universal checkpoints ----------------------------------------------
    def whole(self, local: torch.Tensor, spec: Spec) -> torch.Tensor:
        """A leaf made whole from every rank's slice under ``spec``
        (collective)."""
        out = local
        for d, e in enumerate(spec_entries(spec, local.dim())):
            axes = tuple(a for a in e if self.mesh.size(a) > 1)
            if axes:
                out = comm.all_gather(out, axes, dim=d, mesh=self.mesh)
        return out

    def slice_of(self, full, spec: Spec):
        """This rank's slice of a whole leaf (array or tensor)."""
        return full[shard_slices(full.shape, spec, self.mesh)]
