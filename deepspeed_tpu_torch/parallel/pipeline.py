"""Pipeline parallelism over the ``pipe`` mesh axis, a port of
``deepspeed_tpu/parallel/pipeline.py``.

The stacked layers are cut in ``P`` contiguous stages (the ``layers``
dim sharded over ``pipe``: ``parallel/partitioning.make_rules(pipe=
True)``), stage ``s`` on the ranks at ``pipe`` coordinate ``s``. JAX
compiles the schedule into one program, a ``lax.scan`` over ticks inside
a ``shard_map`` with ``lax.ppermute`` between stages; here every rank
runs the same tick loop eagerly and the stages exchange activations and
their grads through ``comm.ppermute``.

``make_pipeline_1f1b``: JAX's 1F1B training schedule, T = M + 2(P - 1)
ticks over M micro-batches. At tick t stage s forwards micro-batch
f(s, t) = t - s and backpropagates b(s, t) = t - 2(P - 1) + s, each when
it is in [0, M):

- forward: stage 0 embeds its micro-batch's tokens, the others take
  what the stage before sent last tick; the stage runs without a graph
  and its input is kept, as a copy, in a ring of 2P slots;
- backward: the stage runs again from its kept input under autograd
  (the recompute JAX's ``jax.vjp`` does) and ``torch.autograd.grad``
  gives the stage's param grads and the grad of its input, which goes
  to the stage before; stage 0 differentiates its embedding with it;
- the last stage backpropagates micro-batch i in the tick that forwards
  it (b = f at s = P - 1), so it runs its layers and the loss head once,
  under autograd, and one ``torch.autograd.grad`` seeded with 1 / M
  gives its grads: two forwards of its layers a micro-batch where the
  others run three (with a remat replay), where JAX's uniform scan
  recomputes on every stage;
- then the exchanges: activations one stage down, grads one stage up.
  A pair exchanges only when its sender ran that subtick (the receiver
  runs the same micro-batch next tick, so the two always agree).

A MoE model's aux losses ride the backward seeds with weight
``aux_weight / M``. The loss is a mean over micro-batches of each
micro-batch's CE mean (the head's), JAX's contract. The grads of the
leaves outside the layer stack (embedding, head, final norm: each stage
holds them whole) are summed over ``pipe`` in f32, in one all-reduce
that also sums the loss (JAX: the ``psum`` of ``dother`` and of the
loss); tied embeddings meet there.

``pipeline_spmd``: the GPipe forward (M + P - 1 ticks), the last stage's
outputs broadcast to every stage; ``bubble_fraction``: its idle share.
"""

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from deepspeed_tpu_torch.comm import comm


def bubble_fraction(num_microbatches: int, stages: int) -> float:
    """The schedule's idle share of a stage, (P - 1) / (M + P - 1), as
    JAX's (GPipe's and 1F1B's forward bubble)."""
    return (stages - 1) / (num_microbatches + stages - 1)


def _fwd_edges(t: int, P: int, M: int) -> List[Tuple[int, int]]:
    """The (s, s + 1) pairs whose sender forwarded a micro-batch at t."""
    return [(s, s + 1) for s in range(P - 1) if 0 <= t - s < M]


def _bwd_edges(t: int, P: int, M: int) -> List[Tuple[int, int]]:
    """The (s, s - 1) pairs whose sender backpropagated at t."""
    return [(s, s - 1) for s in range(1, P)
            if 0 <= t - 2 * (P - 1) + s < M]


def pipeline_spmd(stage_fn: Callable, mesh, *, num_microbatches: int,
                  pipe_axis: str = "pipe"):
    """The GPipe forward: ``fn(x_mb [M, mb, ...]) -> y_mb [M, mb, ...]``
    on every rank of the ``pipe`` group. ``stage_fn(x, i)`` applies this
    rank's stage to micro-batch i; stage 0 reads ``x_mb`` (the others
    pass any tensor of its shape). No graph is kept."""
    M = num_microbatches

    @torch.no_grad()
    def run(x_mb):
        P, s = mesh.size(pipe_axis), mesh.index(pipe_axis)
        outputs = torch.zeros_like(x_mb)
        recv = torch.zeros_like(x_mb[0])
        for t in range(M + P - 1):
            i = t - s
            y = recv
            if 0 <= i < M:
                y = stage_fn(x_mb[i] if s == 0 else recv, i)
                if s == P - 1:
                    outputs[i] = y
            if P > 1:
                recv = comm.ppermute(y, pipe_axis, _fwd_edges(t, P, M),
                                     mesh=mesh)
        if P > 1:
            comm.broadcast(outputs, pipe_axis, src_index=P - 1, mesh=mesh)
        return outputs

    return run


def _grad(outputs, inputs, grad_outputs):
    """``torch.autograd.grad`` over the inputs that need a grad, zeros
    (f32) for the rest and for inputs the outputs do not reach."""
    want = [i for i, t in enumerate(inputs) if t.requires_grad]
    outs = [(o, g) for o, g in zip(outputs, grad_outputs)
            if o is not None and o.requires_grad]
    got = {}
    if want and outs:
        gs = torch.autograd.grad([o for o, _ in outs], [inputs[i] for i in
                                                        want],
                                 [g for _, g in outs], allow_unused=True)
        got = {i: g for i, g in zip(want, gs) if g is not None}
    return [got[i].float() if i in got else
            torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for i, t in enumerate(inputs)]


def make_pipeline_1f1b(embed_fn: Callable, stage_fn: Callable,
                       head_loss_fn: Callable, mesh, *,
                       num_microbatches: int, act_shape: Sequence[int],
                       act_dtype: torch.dtype, aux_weight: float = 0.0,
                       pipe_axis: str = "pipe"):
    """JAX's ``make_pipeline_1f1b`` (module note). Contracts:

    - ``embed_fn(other, tokens [mb, S]) -> x [mb, S, H]``;
    - ``stage_fn(stage, x, mb_idx) -> (y [mb, S, H], aux)`` (aux a 0-dim
      f32 tensor);
    - ``head_loss_fn(other, y, mb_idx) -> the micro-batch's mean loss``;

    ``stage`` and ``other``: flat dicts of this rank's leaves (the stage's
    layer slices; the rest). ``act_shape`` / ``act_dtype``: one
    micro-batch's activation, the buffers of stages that receive before
    they send. Returns ``fn(stage, other, tokens [M, mb, S], grads=True)
    -> (loss, dstage, dother)`` (f32 grads as dicts; ``grads=False``:
    the forward schedule only, M + P - 1 ticks, and empty dicts).
    Collective over the ``pipe`` group."""
    M = num_microbatches

    def run(stage: Dict[str, torch.Tensor], other: Dict[str, torch.Tensor],
            tokens, grads: bool = True):
        P, s = mesh.size(pipe_axis), mesh.index(pipe_axis)
        first, last = s == 0, s == P - 1
        R = 2 * P
        device = tokens.device
        s_names, o_names = list(stage), list(other)
        s_leaves = [stage[n] for n in s_names]
        o_leaves = [other[n] for n in o_names]
        dstage = [torch.zeros(t.shape, dtype=torch.float32, device=device)
                  for t in s_leaves] if grads else []
        dother = [torch.zeros(t.shape, dtype=torch.float32, device=device)
                  for t in o_leaves] if grads else []
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        idle = torch.zeros(tuple(act_shape), dtype=act_dtype, device=device)
        ring: List[Optional[torch.Tensor]] = [None] * R
        fwd_recv = bwd_recv = idle
        aux_seed = torch.tensor(aux_weight / M, dtype=torch.float32,
                                device=device)
        ticks = M + 2 * (P - 1) if grads else M + P - 1
        n_s, n_o = len(s_leaves), len(o_leaves)
        inv_m = torch.tensor(1.0 / M, dtype=torch.float32, device=device)

        def embed_grads(i, dx):
            with torch.enable_grad():
                x_e = embed_fn(other, tokens[i]).to(act_dtype)
            for a, g in zip(dother, _grad([x_e], o_leaves, [dx])):
                a += g

        for t in range(ticks):
            # ---------------- forward subtick ----------------
            f_i = t - s
            y = dx = idle
            if 0 <= f_i < M:
                with torch.no_grad():
                    x_in = (embed_fn(other, tokens[f_i]).to(act_dtype)
                            if first else fwd_recv)
                if last and grads:
                    # forward and backward of one micro-batch in one pass
                    x_b = x_in.detach().requires_grad_(True)
                    with torch.enable_grad():
                        y_b, aux_b = stage_fn(stage, x_b, f_i)
                        loss_mb = head_loss_fn(other, y_b, f_i)
                    loss_sum += (loss_mb.detach().float() / M
                                 + (aux_weight / M) * aux_b.detach().float())
                    gs = _grad([loss_mb, aux_b], s_leaves + o_leaves + [x_b],
                               [inv_m.to(loss_mb.dtype), aux_seed])
                    del y_b, aux_b, loss_mb
                    for a, g in zip(dstage + dother, gs):
                        a += g
                    dx = gs[n_s + n_o].to(act_dtype)
                    if first:
                        embed_grads(f_i, dx)
                else:
                    with torch.no_grad():
                        if grads:
                            # the recompute's input: a copy nothing else
                            # holds
                            ring[f_i % R] = x_in.detach().clone()
                        y, aux = stage_fn(stage, x_in, f_i)
                        loss_sum += (aux_weight / M) * aux.float()
                        if last:
                            loss_sum += head_loss_fn(other, y,
                                                     f_i).float() / M
            # ---------------- backward subtick ----------------
            b_i = t - 2 * (P - 1) + s
            if grads and not last and 0 <= b_i < M:
                x_b = ring[b_i % R].requires_grad_(True)
                ring[b_i % R] = None
                with torch.enable_grad():
                    y_b, aux_b = stage_fn(stage, x_b, b_i)
                gs = _grad([y_b, aux_b], s_leaves + [x_b],
                           [bwd_recv, aux_seed])
                del y_b, aux_b
                for a, g in zip(dstage, gs):
                    a += g
                dx = gs[-1].to(act_dtype)
                if first:
                    embed_grads(b_i, dx)
            # ---------------- the exchanges ----------------
            if P > 1:
                fwd_recv = comm.ppermute(y, pipe_axis, _fwd_edges(t, P, M),
                                         mesh=mesh)
                if grads:
                    bwd_recv = comm.ppermute(dx, pipe_axis,
                                             _bwd_edges(t, P, M), mesh=mesh)
        # the loss and the grads of the leaves every stage holds whole:
        # one f32 sum over pipe
        flat = torch.cat([loss_sum.reshape(1)]
                         + [g.reshape(-1) for g in dother])
        if P > 1:
            comm.all_reduce(flat, pipe_axis, mesh=mesh)
        loss = flat[0]
        out_other, at = {}, 1
        for n, g in zip(o_names, dother):
            out_other[n] = flat[at:at + g.numel()].view(g.shape)
            at += g.numel()
        return loss, dict(zip(s_names, dstage)), out_other

    return run


class _PipelineLoss(torch.autograd.Function):
    """JAX's ``as_loss_fn``: the schedule's loss as a differentiable
    scalar whose backward hands back the grads the schedule computed
    (times the incoming grad: a scaled loss scales them)."""

    @staticmethod
    def forward(ctx, run, *leaves):
        loss, grads = run()
        ctx.save_for_backward(*grads)
        return loss

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (None,) + tuple(t * g.float() for t in ctx.saved_tensors)


def as_loss_fn(run: Callable[[], Tuple[torch.Tensor, List[torch.Tensor]]],
               leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """``run()`` -> (loss, [f32 grad of each of ``leaves``]) as a loss
    tensor that autograd differentiates into those grads."""
    return _PipelineLoss.apply(run, *leaves)
