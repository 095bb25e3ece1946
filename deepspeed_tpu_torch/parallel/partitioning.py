"""Logical-axis partitioning, the port of the stage <= 2 half of
``deepspeed_tpu/parallel/partitioning.py``.

Every parameter carries a tuple of logical axis names
(``models/transformer.logical_axes``); one rules table (``RULES``)
maps each name to a mesh axis. JAX hands the resulting specs to GSPMD,
which lays each leaf out over the devices; the port cuts each rank's
slice of a leaf by the same spec (``shard_slices``), so a rank holds
exactly the shard JAX puts on the device at its mesh coordinates. A sharded dim is split in equal
contiguous pieces, in rank order along its mesh axis.
"""

from typing import Any, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deepspeed_tpu_torch.parallel.mesh import Mesh

MeshAxis = Union[str, None]
Spec = Tuple[MeshAxis, ...]


# JAX's ``make_rules`` for ZeRO stage <= 2 (params replicated across
# data), with its tensor axis: vocab, mlp, heads and qkv shard over
# ``tensor``, expert over ``expert``, everything else replicates. On a
# mesh whose tensor axis has size 1, ``shard_slices`` cuts nothing along
# it, which is what JAX's table without the tensor axis says.
RULES = {
    "vocab": "tensor",
    "embed": None,
    "mlp": "tensor",
    "heads": "tensor",
    "qkv": "tensor",
    "kv": None,
    "expert": "expert",
    "layers": None,
    "unmodeled": None,
}


def mesh_axes(logical_axes: Optional[Sequence[Optional[str]]]) -> Spec:
    """The mesh axis of each dim (None: replicated). A mesh axis shards
    at most one dim of a leaf: a later dim that maps to an axis already
    used stays replicated, as in JAX. Trailing Nones are dropped (JAX's
    ``PartitionSpec`` form)."""
    if logical_axes is None:
        return ()
    out, used = [], set()
    for name in logical_axes:
        axis = RULES.get(name) if name is not None else None
        if axis is not None and axis in used:
            axis = None
        if axis is not None:
            used.add(axis)
        out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_axes(x) -> bool:
    return x is None or (isinstance(x, tuple)
                         and all(a is None or isinstance(a, str) for a in x))


def spec_tree(logical_tree):
    """Map a tree (nested dicts) of logical-axis tuples to mesh specs."""
    if _is_axes(logical_tree):
        return mesh_axes(logical_tree)
    return {k: spec_tree(v) for k, v in logical_tree.items()}


def shard_slices(shape: Sequence[int], spec: Spec, mesh: Mesh,
                 what: str = "leaf") -> Tuple[slice, ...]:
    """This rank's slice of a leaf of ``shape`` under ``spec``: each dim
    sharded over a mesh axis of size n is cut in n equal pieces and the
    rank takes the piece at its coordinate. A dim that n does not divide
    raises, naming the leaf."""
    out = []
    for d, size in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        n = mesh.size(axis) if axis is not None else 1
        if n == 1:
            out.append(slice(None))
            continue
        if size % n:
            raise ValueError(f"{what}: dim {d} of size {size} does not "
                             f"split over the {axis} axis of size {n}")
        part = size // n
        i = mesh.index(axis)
        out.append(slice(i * part, (i + 1) * part))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Spec, mesh: Mesh,
                what: str = "leaf") -> Tuple[int, ...]:
    """The shape of this rank's shard of a leaf of ``shape``."""
    return tuple(len(range(*s.indices(n)))
                 for s, n in zip(shard_slices(shape, spec, mesh, what),
                                 shape))


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
