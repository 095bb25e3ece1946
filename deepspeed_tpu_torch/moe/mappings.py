"""Token split and gather across the tensor group, the port of
``deepspeed_tpu/moe/mappings.py`` (the reference's ``_DropTokens`` /
``_GatherTokens``).

``drop_tokens(x, dim)`` keeps this tensor rank's piece of ``dim``;
``gather_tokens(x, dim)`` concatenates the ranks' pieces back. Each is
the other's backward (Megatron's scatter to and gather from the model
parallel region: the tensor ranks hold the same rows, so a gathered
activation's grad is the same on each of them and each keeps its
piece). With a tensor axis of size 1 both are the identity.

In JAX the pair is a sharding constraint with no numeric effect around
the MoE block: GSPMD still gates every token of the batch. The port
routes every token on every tensor rank too, since splitting them before
the gate would change T, hence the capacity and the drops
(``moe/sharded_moe.py``). Where the port uses the pair: on the training
path, ``moe_ffn`` sums its tensor ranks' partial expert outputs onto
this rank's piece of the sequence (a ``reduce_scatter``, where the rows
are dropped) and ``gather_tokens`` gathers the pieces back, whose
backward is ``drop_tokens``.
"""

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.parallel.context import axis_index, axis_size

__all__ = ["drop_tokens", "gather_tokens"]


def _piece(x: torch.Tensor, dim: int, tp_axis: str) -> torch.Tensor:
    n = axis_size(tp_axis)
    if x.shape[dim] % n:
        raise ValueError(f"drop_tokens: dim {dim} of shape {tuple(x.shape)} "
                         f"does not split over {tp_axis} of size {n}")
    size = x.shape[dim] // n
    return x.narrow(dim, axis_index(tp_axis) * size, size).contiguous()


class _DropTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp_axis):
        ctx.dim, ctx.axis = dim, tp_axis
        return _piece(x, dim, tp_axis)

    @staticmethod
    def backward(ctx, g):
        return comm.all_gather(g, ctx.axis, dim=ctx.dim), None, None


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, tp_axis):
        ctx.dim, ctx.axis = dim, tp_axis
        return comm.all_gather(x, tp_axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _piece(g, ctx.dim, ctx.axis), None, None


def drop_tokens(x: torch.Tensor, dim: int = 1,
                tp_axis: str = "tensor") -> torch.Tensor:
    """This rank's piece of ``dim`` (the sequence) over the tensor group;
    the backward gathers the pieces' grads."""
    if axis_size(tp_axis) == 1:
        return x
    return _DropTokens.apply(x, dim, tp_axis)


def gather_tokens(x: torch.Tensor, dim: int = 1,
                  tp_axis: str = "tensor") -> torch.Tensor:
    """The tensor ranks' pieces of ``dim`` concatenated in rank order; the
    backward keeps this rank's piece of the grad."""
    if axis_size(tp_axis) == 1:
        return x
    return _GatherTokens.apply(x, dim, tp_axis)
