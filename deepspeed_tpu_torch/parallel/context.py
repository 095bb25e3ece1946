"""Ambient parallel context, the port of
``deepspeed_tpu/parallel/context.py``.

The engines publish their mesh here and the model reads it where a
sharded dim meets a collective (``models/transformer.py``,
``moe/sharded_moe.py``), so the mesh is not threaded through every model
signature; JAX's engine publishes its mesh the same way. The context is
process-wide (the serving engine's watchdog issues from a thread of its
own); ``parallel_context`` sets it around one call and puts the previous
one back.

Two more things ride the context during a training step on more than one
rank: ZeRO stage 3's parameter gatherer (``param_gather``: the model
gathers each layer's shards where the layer runs, ``gather_params``) and
where this rank's rows start in the one-rank run's micro-batch
(``batch_row``: dropout seeds each row's mask by its row there, so a
data-parallel run drops what the one-rank run drops).
"""

import contextlib
from typing import Callable, Optional

import torch

from deepspeed_tpu_torch.parallel.mesh import Mesh

_MESH: Optional[Mesh] = None
_GATHER: Optional[Callable] = None
_ROW: int = 0


def set_parallel_context(mesh: Optional[Mesh]) -> None:
    global _MESH
    _MESH = mesh


def current_mesh() -> Optional[Mesh]:
    return _MESH


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
    insert the reduction. One path with every other collective: the comm
    facade."""
    # imported here: the facade reads the ambient mesh from this module
    from deepspeed_tpu_torch.comm import comm
    for axis in axes:
        comm.all_reduce(x, axis)
    return x


@contextlib.contextmanager
def param_gather(fn: Optional[Callable]):
    """Publish ZeRO-3's ``fn(tree, prefix)`` for the block: it returns
    the tree with each sharded leaf gathered whole (``prefix``
    "layers/" for one layer's slices of the stacked leaves)."""
    global _GATHER
    prev, _GATHER = _GATHER, fn
    try:
        yield
    finally:
        _GATHER = prev


def gather_params(tree, prefix: str = ""):
    """``tree`` with its ZeRO-3 shards gathered (itself without a
    gatherer: every leaf is whole)."""
    return tree if _GATHER is None else _GATHER(tree, prefix)


@contextlib.contextmanager
def batch_rows(start: int):
    """This rank's micro-batch is rows ``start``.. of the one-rank run's,
    for the block."""
    global _ROW
    prev, _ROW = _ROW, start
    try:
        yield
    finally:
        _ROW = prev


def batch_row() -> int:
    """Where this rank's rows start in the one-rank run's micro-batch (0
    outside ``batch_rows``)."""
    return _ROW
