"""Ambient parallel context, the port of
``deepspeed_tpu/parallel/context.py``.

The engine publishes its mesh here and the model reads it where a sharded
dim meets a collective (``models/transformer.py``, ``moe/sharded_moe.py``),
so the mesh is not threaded through every model signature; JAX's engine
publishes its mesh the same way. The context is process-wide (the serving
engine's watchdog issues from a thread of its own); ``parallel_context``
sets it around one call and puts the previous one back.
"""

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.parallel.mesh import Mesh

_MESH: Optional[Mesh] = None


def set_parallel_context(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def current_plan():
    return None if _MESH is None else _MESH.plan


@contextlib.contextmanager
def parallel_context(mesh: Optional[Mesh]):
    """Publish ``mesh`` for the duration of the block."""
    global _MESH
    prev, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = prev


def axis_size(axis: str) -> int:
    """The ambient mesh's size along ``axis`` (1 without a mesh)."""
    return 1 if _MESH is None else _MESH.size(axis)


def axis_index(axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if _MESH is None else _MESH.index(axis)


def all_reduce(x: torch.Tensor, *axes: str) -> torch.Tensor:
    """Sum ``x`` in place over each of ``axes`` of the ambient mesh (a
    no-op along an axis of size 1) and return it: where GSPMD would
    insert the reduction."""
    if _MESH is None:
        return x
    for axis in axes:
        group = _MESH.axis_group(axis)
        if group is not None:
            dist.all_reduce(x, group=group)
    return x
