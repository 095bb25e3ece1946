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

The training path reaches the ``tensor`` and batch axes through
collectives autograd can differentiate (Megatron's conventions: a tensor
group's ranks hold the same rows and count their loss once, the ranks of
a batch axis hold their own rows and their losses add up):

- ``copy_to_tensor``: identity forward, ``all_reduce`` over ``tensor``
  backward (the input of a column-parallel projection: each rank's
  partial grad of a replicated activation is summed);
- ``reduce_from_tensor``: ``all_reduce`` forward, identity backward (the
  output of a row-parallel projection);
- ``gather_along``: an ``all_gather`` along a dim over axes, whose
  backward is the ``reduce_scatter`` (the tokens a MoE layer gathers
  over the batch axes);
- ``scatter_along``: the ``reduce_scatter`` forward, ``all_gather``
  backward (each rank's rows of a summed MoE output).

Each goes through the comm facade, so its counts of calls and bytes hold,
and each is the identity where its axes have size 1. The serving path
keeps the in-place ``all_reduce``: it keeps no graph.

Over ``seq`` (sequence parallelism) each rank holds a contiguous piece
of every sequence: ``seq_parallel_degree`` (JAX's name) routes the
model's attention to the ring, ``seq_offset`` is where this rank's piece
starts (rotary positions, dropout masks); over ``pipe`` the engine runs
the pipeline schedule and a stage's index is ``axis_index("pipe")``.
"""

import contextlib
from typing import Callable, Optional

import torch

from deepspeed_tpu_torch.parallel.mesh import BATCH_AXES, Mesh

_MESH: Optional[Mesh] = None
_GATHER: Optional[Callable] = None
_ROW: int = 0
_SPLIT: bool = False


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


def seq_parallel_degree() -> int:
    """The ambient mesh's ``seq`` degree (1 without a mesh)."""
    return axis_size("seq")


def seq_offset(local_len: int) -> int:
    """Where this rank's piece of a sequence starts, for a piece of
    ``local_len`` positions (the pieces are contiguous, in ``seq``
    coordinate order)."""
    return axis_index("seq") * local_len


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


def _live(axes) -> tuple:
    return tuple(a for a in axes if axis_size(a) > 1)


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from deepspeed_tpu_torch.comm import comm
        return comm.all_reduce(g.clone(), "tensor")


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        from deepspeed_tpu_torch.comm import comm
        return comm.all_reduce(x.clone(), "tensor")

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        from deepspeed_tpu_torch.comm import comm
        ctx.axes, ctx.dim = axes, dim
        return comm.all_gather(x, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        from deepspeed_tpu_torch.comm import comm
        return comm.reduce_scatter(g, ctx.axes, dim=ctx.dim), None, None


class _ScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes, dim):
        from deepspeed_tpu_torch.comm import comm
        ctx.axes, ctx.dim = axes, dim
        return comm.reduce_scatter(x, axes, dim=dim)

    @staticmethod
    def backward(ctx, g):
        from deepspeed_tpu_torch.comm import comm
        return comm.all_gather(g, ctx.axes, dim=ctx.dim), None, None


def copy_to_tensor(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; the backward sums the grad over ``tensor``."""
    return _CopyToTensor.apply(x) if axis_size("tensor") > 1 else x


def reduce_from_tensor(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``tensor`` (a new tensor); identity backward."""
    return _ReduceFromTensor.apply(x) if axis_size("tensor") > 1 else x


def gather_along(x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` along ``axes`` concatenated along ``dim`` in
    coordinate order (row-major over the axes); the backward sums the
    grad over the axes and keeps this rank's piece."""
    axes = _live((axes,) if isinstance(axes, str) else axes)
    return _GatherAlong.apply(x, axes, dim) if axes else x


def scatter_along(x: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """``x`` summed over ``axes``, this rank's piece along ``dim``; the
    backward gathers the pieces' grads."""
    axes = _live((axes,) if isinstance(axes, str) else axes)
    return _ScatterAlong.apply(x, axes, dim) if axes else x


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
    for the block: the batch axes split the rows (``split_axes``)."""
    global _ROW, _SPLIT
    prev, _ROW = (_ROW, _SPLIT), start
    _SPLIT = True
    try:
        yield
    finally:
        _ROW, _SPLIT = prev


def split_axes() -> tuple:
    """Inside ``batch_rows``: the batch axes of size > 1 whose ranks hold
    their own rows (a MoE layer gathers the micro-batch over them);
    elsewhere ()."""
    return _live(BATCH_AXES) if _SPLIT else ()


def batch_row() -> int:
    """Where this rank's rows start in the one-rank run's micro-batch (0
    outside ``batch_rows``)."""
    return _ROW
