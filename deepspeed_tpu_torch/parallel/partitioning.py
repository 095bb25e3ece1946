"""Logical-axis partitioning, a port of
``deepspeed_tpu/parallel/partitioning.py``.

Every parameter carries a tuple of logical axis names
(``models/transformer.logical_axes``); a rules table (``make_rules``:
JAX's, for a ZeRO stage and with or without a tensor axis) maps each
name to a mesh axis, or to a tuple of mesh axes that split the dim
together. JAX hands the resulting specs to GSPMD, which lays each leaf
out over the devices; the port cuts each rank's slice of a leaf by the
same spec (``shard_slices``), so a rank holds exactly the shard JAX puts
on the device at its mesh coordinates. A sharded dim is split in equal
contiguous pieces; over a tuple of axes the piece index is row-major in
the tuple's order (JAX's ``PartitionSpec(("fsdp", "tensor"))``).

A spec here is JAX's ``PartitionSpec`` as a plain tuple: one entry a
dim, None (replicated), an axis name or a tuple of names; trailing Nones
dropped.

``model_split`` is how the model axes (``tensor``, ``expert``, ``pipe``)
cut a leaf as the model sees it (after ZeRO-3's gather over ``fsdp``):
the training extras compute a mask, a threshold or a scale on the whole
leaf, as JAX's GSPMD program does, and apply this rank's slice of it.

``row_parallel_matmul`` is JAX's chunked tensor-parallel out-projection
(``transformer.tp_overlap_chunks``): the product cut along the sequence
dim, each piece's matmul followed by its own ``all_reduce`` over
``tensor``.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepspeed_tpu_torch.parallel import context as _ctx
from deepspeed_tpu_torch.parallel.mesh import Mesh

MeshAxis = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxis, ...]


def make_rules(zero_stage: int, tp: bool = True, pipe: bool = False,
               fsdp_axis: str = "fsdp",
               tensor_axis: str = "tensor") -> Dict[str, MeshAxis]:
    """JAX's ``make_rules``. Stage <= 2: params replicated across
    data-parallel ranks, the logical axes map to ``tensor`` only. Stage 3:
    ``embed`` shards over ``fsdp``, ``vocab`` over (fsdp, tensor), and
    without a tensor axis ``mlp``, ``heads`` and ``qkv`` over ``fsdp`` too
    (the first of them in a leaf takes it: a mesh axis shards one dim of a
    leaf). ``pipe``: the stacked ``layers`` dim shards over ``pipe`` (each
    pipeline stage holds its contiguous run of layers)."""
    t = tensor_axis if tp else None
    layers = "pipe" if pipe else None
    if zero_stage >= 3:
        return {"vocab": (fsdp_axis, t) if t else fsdp_axis,
                "embed": fsdp_axis,
                "mlp": t if t else fsdp_axis,
                "heads": t if t else fsdp_axis,
                "qkv": t if t else fsdp_axis,
                "kv": None, "expert": "expert", "layers": layers,
                "unmodeled": None}
    return {"vocab": t, "embed": None, "mlp": t, "heads": t, "qkv": t,
            "kv": None, "expert": "expert", "layers": layers,
            "unmodeled": None}


# the serving table: JAX's ``make_rules(0)`` with its tensor axis (vocab,
# mlp, heads and qkv over ``tensor``, expert over ``expert``). On a mesh
# whose tensor axis has size 1, ``shard_slices`` cuts nothing along it,
# which is what JAX's table without the tensor axis says.
RULES = make_rules(0, tp=True)


def entry_axes(entry: MeshAxis) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_entries(spec: Spec, ndim: int = 0):
    """A spec as a list of per-dim axis tuples (padded to ``ndim``)."""
    out = [entry_axes(e) for e in spec]
    while len(out) < ndim:
        out.append(())
    return out


def from_entries(entries) -> Spec:
    """Per-dim axis tuples back to a spec (JAX's form)."""
    out = [tuple(e) if len(e) > 1 else (e[0] if e else None)
           for e in entries]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_axes(spec: Spec):
    """Every mesh axis a spec names."""
    return {a for e in spec for a in entry_axes(e)}


def mesh_axes(logical_axes: Optional[Sequence[Optional[str]]],
              rules: Optional[Dict[str, MeshAxis]] = None) -> Spec:
    """The mesh axes of each dim (None: replicated) under ``rules``
    (default: the serving table). A mesh axis shards at most one dim of
    a leaf: a later dim whose rule names an axis already used stays
    replicated, as in JAX."""
    if logical_axes is None:
        return ()
    table = RULES if rules is None else rules
    out, used = [], set()
    for name in logical_axes:
        axis = table.get(name) if name is not None else None
        key = entry_axes(axis)
        if key and any(a in used for a in key):
            axis = None
        used.update(entry_axes(axis))
        out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_axes(x) -> bool:
    return x is None or (isinstance(x, tuple)
                         and all(a is None or isinstance(a, str) for a in x))


def spec_tree(logical_tree, rules: Optional[Dict[str, MeshAxis]] = None):
    """Map a tree (nested dicts) of logical-axis tuples to mesh specs."""
    if _is_axes(logical_tree):
        return mesh_axes(logical_tree, rules)
    return {k: spec_tree(v, rules) for k, v in logical_tree.items()}


def shard_slices(shape: Sequence[int], spec: Spec, mesh: Mesh,
                 what: str = "leaf") -> Tuple[slice, ...]:
    """This rank's slice of a leaf of ``shape`` under ``spec``: each dim
    sharded over mesh axes of sizes n1, n2, ... is cut in n1 * n2 * ...
    equal pieces and the rank takes the piece at its coordinates, raveled
    in the entry's order. A dim that does not split raises, naming the
    leaf."""
    out = []
    for d, size in enumerate(shape):
        axes = entry_axes(spec[d]) if d < len(spec) else ()
        n, i = 1, 0
        for a in axes:
            n, i = n * mesh.size(a), i * mesh.size(a) + mesh.index(a)
        if n == 1:
            out.append(slice(None))
            continue
        if size % n:
            raise ValueError(f"{what}: dim {d} of size {size} does not "
                             f"split over the {axes} axes of size {n}")
        part = size // n
        out.append(slice(i * part, (i + 1) * part))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh: Mesh,
                what: str = "leaf") -> Tuple[int, ...]:
    """The shape of this rank's shard of a leaf of ``shape``."""
    return tuple(len(range(*s.indices(n)))
                 for s, n in zip(shard_slices(shape, spec, mesh, what),
                                 shape))


def sub_slices(local_shape: Sequence[int], outer: Spec, inner: Spec,
               mesh: Mesh) -> Tuple[slice, ...]:
    """Within a tensor already cut by ``outer``, the slice that the finer
    ``inner`` keeps: each dim's ``inner`` axes extend its ``outer`` ones
    (ZeRO's optimizer spec appends ``data`` to a dim of the param spec),
    and the extra axes cut the local dim as ``shard_slices`` would."""
    out = []
    for d, size in enumerate(local_shape):
        o = entry_axes(outer[d]) if d < len(outer) else ()
        i_ax = entry_axes(inner[d]) if d < len(inner) else ()
        if i_ax[:len(o)] != o:
            raise ValueError(f"spec {inner} does not refine {outer} on dim "
                             f"{d}")
        n, i = 1, 0
        for a in i_ax[len(o):]:
            n, i = n * mesh.size(a), i * mesh.size(a) + mesh.index(a)
        part = size // n
        out.append(slice(None) if n == 1
                   else slice(i * part, (i + 1) * part))
    return tuple(out)


def shard_leaf(a, spec: Spec, mesh: Mesh, what: str = "leaf"):
    """This rank's slice of ``a`` (numpy array or tensor; a view)."""
    return a[shard_slices(np.shape(a) if not isinstance(a, torch.Tensor)
                          else a.shape, spec, mesh, what)]


def own_shard(a, spec: Spec, mesh: Mesh, what: str = "leaf"):
    """``shard_leaf``, copied when it is a strict slice of a tensor, so
    the rank keeps its slice and not the whole leaf's storage; a leaf
    the mesh leaves whole is returned as it is."""
    part = shard_leaf(a, spec, mesh, what)
    if isinstance(a, torch.Tensor) and part.shape != a.shape:
        part = part.clone()
    return part


def sharded_bytes(tree: Any) -> int:
    """Per-rank resident bytes of a tree of this rank's tensors (what the
    port holds IS the shard, so this is their sum; JAX prices each leaf
    at its shard shape for the same number)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(sharded_bytes(v) for v in tree.values())
    return 0


# the mesh axes that cut a leaf into the slice the model computes with
# (ZeRO's ``data`` and ``fsdp`` cuts are gathered before the model runs)
MODEL_AXES = ("tensor", "expert", "pipe")


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """How the live model axes cut one leaf: ``shape`` is the whole
    leaf's, ``dims`` per dim the axes that cut it (row-major, as the
    spec names them), ``slices`` this rank's slice of the whole."""
    shape: Tuple[int, ...]
    dims: Tuple[Tuple[str, ...], ...]
    slices: Tuple[slice, ...]
    mesh: Mesh

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(a for e in self.dims for a in e)

    def whole(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaf from every rank's slice, detached: the values
        the one-rank run sees (collective over ``axes``)."""
        out = local.detach()
        from deepspeed_tpu_torch.comm import comm
        for d, axes in enumerate(self.dims):
            if axes:
                out = comm.all_gather(out, axes, dim=d, mesh=self.mesh)
        return out

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t``, a tensor of the whole leaf's shape
        or one that broadcasts against it (its dims aligned to the
        leaf's last ones; a dim of size 1 is kept), as a copy."""
        off = len(self.shape) - t.dim()
        part = t[tuple(slice(None) if t.shape[i] == 1
                       else self.slices[off + i] for i in range(t.dim()))]
        # a copy, so the whole leaf's storage can go
        return part.clone() if part.shape != t.shape else part

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` (this rank's statistic) maxed over ``axes``: a copy."""
        from deepspeed_tpu_torch.comm import comm
        return comm.all_reduce(t.clone(), self.axes, op="max",
                               mesh=self.mesh)


def model_split(shape: Sequence[int], spec: Spec,
                mesh: Mesh) -> Optional[ModelSplit]:
    """How the model axes of more than one rank cut a leaf of ``shape``
    laid out by ``spec`` (a ZeRO param spec: its ``fsdp`` entries are
    gathered before the model runs; a dim split over (fsdp, tensor)
    leaves the rank its contiguous ``tensor`` piece); None when the rank
    holds the whole leaf."""
    dims = tuple(tuple(a for a in (entry_axes(spec[d]) if d < len(spec)
                                   else ())
                       if a in MODEL_AXES and mesh.size(a) > 1)
                 for d in range(len(shape)))
    if not any(dims):
        return None
    shape = tuple(int(n) for n in shape)
    return ModelSplit(shape, dims,
                      shard_slices(shape, from_entries(dims), mesh), mesh)


def sum_groups(groups: Dict[Tuple[str, ...], torch.Tensor],
               mesh: Optional[Mesh] = None
               ) -> Dict[Tuple[str, ...], torch.Tensor]:
    """Each group's tensor summed in place over the axes of its key, one
    ``all_reduce`` per axis, the groups in sorted order (every rank
    issues the same collectives)."""
    from deepspeed_tpu_torch.comm import comm
    for axes, t in sorted(groups.items()):
        for a in axes:
            comm.all_reduce(t, a, mesh=mesh)
    return groups


def shard_sums(values: List[torch.Tensor],
               splits: Sequence[Optional[ModelSplit]]) -> List[torch.Tensor]:
    """Per-leaf statistics (``values[i]``: this rank's partial sum over
    its slice of leaf i) summed over the axes that cut each leaf, so
    that every element of a leaf counts once and a leaf every rank holds
    whole counts once (``sum_groups`` of the leaves cut alike)."""
    out = list(values)
    idx: Dict[Tuple[str, ...], List[int]] = {}
    for i, sp in enumerate(splits):
        if sp is not None:
            idx.setdefault(sp.axes, []).append(i)
    if not idx:
        return out
    mesh = next(sp.mesh for sp in splits if sp is not None)
    sums = sum_groups({axes: torch.stack([values[i] for i in ii])
                       for axes, ii in idx.items()}, mesh)
    for axes, ii in idx.items():
        for j, i in enumerate(ii):
            out[i] = sums[axes][j]
    return out


class _RowParallelChunked(torch.autograd.Function):
    """The forward in ``chunks`` pieces along dim -2, each piece's matmul
    then its ``all_reduce``; the backward is the plain matmul's (JAX pins
    it with ``custom_vjp``: a chunked transpose would split the weight
    grad's sequence contraction into partial sums, a reordering)."""

    @staticmethod
    def forward(ctx, x, w, chunks):
        from deepspeed_tpu_torch.comm import comm
        ctx.save_for_backward(x, w)
        dim, size = x.dim() - 2, x.shape[-2] // chunks
        # each piece reduced in a copy: a remat policy that keeps matmul
        # outputs hands its replay the product it saved, which must not
        # be the reduced one
        return torch.cat([comm.all_reduce(
            (x.narrow(dim, i * size, size) @ w).clone(), "tensor")
            for i in range(chunks)], dim)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_(ctx.needs_input_grad[0])
            wr = w.detach().requires_grad_(ctx.needs_input_grad[1])
            wanted = [t for t in (xr, wr) if t.requires_grad]
            got = iter(torch.autograd.grad(xr @ wr, wanted, g))
        return (next(got) if xr.requires_grad else None,
                next(got) if wr.requires_grad else None, None)


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor, *,
                        chunks: int = 0) -> torch.Tensor:
    """``x @ w`` for a row-parallel weight (its in dim sharded over
    ``tensor``), summed over the tensor axis, with the sum cut into
    ``chunks`` independent ``all_reduce`` calls along the sequence dim
    (-2): the largest divisor of it that is at most ``chunks``. Each
    output element sums the same partials in the same order as the
    unchunked path, and the backward is the plain matmul's (the
    reduction's backward is the identity, ``reduce_from_tensor``), so
    values and grads equal the unchunked path's bit for bit. Without a
    tensor axis it is the plain matmul; with one but ``chunks`` <= 1, the
    matmul and one reduction."""
    if _ctx.axis_size("tensor") == 1:
        return x @ w
    c = min(int(chunks or 0), x.shape[-2]) if x.dim() >= 2 else 0
    while c > 1 and x.shape[-2] % c:
        c -= 1
    if c <= 1:
        return _ctx.reduce_from_tensor(x @ w)
    return _RowParallelChunked.apply(x, w, c)
