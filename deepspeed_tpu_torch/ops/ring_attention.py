"""Ring attention over the ``seq`` mesh axis, a port of
``deepspeed_tpu/ops/ring_attention.py``.

Each rank of a ``seq`` group holds a contiguous piece of every sequence
(``Sl`` positions, rank ``r`` at ``r * Sl``). Its queries meet every
piece's keys: the K/V pieces go around the ring (``comm.ppermute``, rank
``i`` to rank ``i + 1``), so at step ``t`` rank ``r`` holds the piece of
rank ``(r - t) mod P``. Causality is decided per piece: a piece in the
future is skipped (it still travels on), the rank's own piece is
causal, a past piece is not.

On the card each (query piece, key piece) pair is one call of the flash
kernels at a square ``Sl x Sl`` shape, so the ring needs no kernel of
its own:

- forward: B1 (``flash_attention_fwd``) gives the pair's O and f32 LSE;
  the partials merge in f32 by their LSE (``o = sum_t o_t exp(lse_t -
  lse)``, ``lse = logsumexp_t lse_t``);
- backward (``torch.autograd.Function``): B2 and B3
  (``flash_attention_bwd``) for every pair the forward ran, each given
  the *global* O and LSE of the local queries, so p = exp(s - lse) is
  the true softmax's and delta = rowsum(dO * O) the true delta. dQ sums
  over the pairs on the rank; each piece's dK / dV accumulate (in f32)
  as they travel with it around the ring, and one more step brings them
  back to the piece's owner.

K and V travel GQA-native ([B, Sl, Nkv, D]); JAX repeats the kv heads
over the query group first (``models/transformer.py:555-558``), which is
the same function with more bytes on the wire. A causal ring over P
ranks launches B1 (and B2, and B3) ``r + 1`` times on rank ``r`` for
one attention call.

A key mask ([B, Sl] of this rank's keys) is gathered over ``seq`` once
and each pair takes its piece's columns. A query row that sees no key
at all gets O = 0 (the flash kernels' rule; ROADMAP C2: JAX's XLA
branch, which takes masked batches under ``seq``, gives such a row the
mean of V). Every row that sees a key computes JAX's function.

The plain version (a CPU tensor, and ``reference=True``) is the same
ring over ``flash_attention_reference`` / ``flash_attention_bwd_reference``
per pair.
"""

import math
from typing import Optional

import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_reference)
from deepspeed_tpu_torch.parallel import context as _ctx


def _merge(acc, o_t, lse_t):
    """Fold one pair's (O [B, S, N, D], LSE [B, N, S, 1]) into the running
    f32 (o, lse)."""
    o_t = o_t.float()
    if acc is None:
        return o_t, lse_t
    o, lse = acc
    new = torch.logaddexp(lse, lse_t)
    a = torch.exp(lse - new).permute(0, 2, 1, 3)        # [B, S, N, 1]
    b = torch.exp(lse_t - new).permute(0, 2, 1, 3)
    return o * a + o_t * b, new


def _pairs(causal: bool, P: int, r: int):
    """(step, source piece, the pair is computed, it is causal) of the
    ring's P steps on rank r."""
    for t in range(P):
        src = (r - t) % P
        yield t, src, not (causal and src > r), causal and src == r


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, sm_scale, fused, reference,
                axis, mesh):
        P = mesh.size(axis) if mesh is not None else 1
        r = mesh.index(axis) if mesh is not None else 0
        Sl = q.shape[1]
        mask = None
        if kv_mask is not None:
            mask = comm.all_gather(kv_mask.contiguous(), axis, dim=1,
                                   mesh=mesh)
        fwd = flash_attention_reference if reference else flash_attention_fwd
        perm = [(i, (i + 1) % P) for i in range(P)]
        kc, vc, acc = k, v, None
        for t, src, on, diag in _pairs(causal, P, r):
            if on:
                m = None if mask is None else \
                    mask[:, src * Sl:(src + 1) * Sl]
                acc = _merge(acc, *fwd(q, kc, vc, causal=diag,
                                       sm_scale=sm_scale, kv_mask=m))
            if t < P - 1:
                kc = comm.ppermute(kc, axis, perm, mesh=mesh)
                vc = comm.ppermute(vc, axis, perm, mesh=mesh)
        o = acc[0].to(q.dtype).contiguous()
        lse = acc[1].contiguous()
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.causal, ctx.sm_scale, ctx.fused = causal, sm_scale, fused
        ctx.reference, ctx.axis, ctx.mesh = reference, axis, mesh
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, mask, o, lse = ctx.saved_tensors
        axis, mesh = ctx.axis, ctx.mesh
        P = mesh.size(axis) if mesh is not None else 1
        r = mesh.index(axis) if mesh is not None else 0
        Sl = q.shape[1]
        do = do.contiguous()
        bwd = (flash_attention_bwd_reference if ctx.reference
               else flash_attention_bwd)
        perm = [(i, (i + 1) % P) for i in range(P)]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for t, src, on, diag in _pairs(ctx.causal, P, r):
            if on:
                m = None if mask is None else \
                    mask[:, src * Sl:(src + 1) * Sl]
                dq_t, dk_t, dv_t = bwd(q, kc, vc, o, lse, do, causal=diag,
                                       sm_scale=ctx.sm_scale, kv_mask=m,
                                       fused=ctx.fused)
                dq += dq_t.float()
                dk += dk_t.float()
                dv += dv_t.float()
            if t < P - 1:
                kc = comm.ppermute(kc, axis, perm, mesh=mesh)
                vc = comm.ppermute(vc, axis, perm, mesh=mesh)
            if P > 1:
                # the piece's grads travel with it; the P-th step hands
                # them back to the piece's owner
                dk = comm.ppermute(dk, axis, perm, mesh=mesh)
                dv = comm.ppermute(dv, axis, perm, mesh=mesh)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None, None)


def ring_attention_local(q, k, v, *, axis_name: str = "seq",
                         causal: bool = True,
                         sm_scale: Optional[float] = None, kv_mask=None,
                         fused_backward: bool = False,
                         reference: bool = False, mesh=None):
    """This rank's pieces q [B, Sl, N, D], k / v [B, Sl, Nkv, D] (and
    ``kv_mask`` [B, Sl], optional) -> this rank's O [B, Sl, N, D],
    differentiable in q, k and v. Collective over ``axis_name`` of
    ``mesh`` (default: the ambient mesh): every rank of the group calls
    it. ``reference``: the plain versions of the kernels on any device
    (comparisons); a CPU tensor takes them anyway."""
    mesh = mesh if mesh is not None else _ctx.current_mesh()
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q, k, v, kv_mask, bool(causal),
                                float(sm_scale), bool(fused_backward),
                                bool(reference), axis_name, mesh)


def ring_attention(q, k, v, mesh=None, *, axis_name: str = "seq",
                   causal: bool = True, sm_scale: Optional[float] = None,
                   reference: bool = False):
    """JAX's SPMD entry: q / k / v are the GLOBAL [B, S, N, D] (k / v may
    carry fewer heads) on every rank of the ``seq`` group; each rank
    takes its piece of the sequence, runs the ring, and the pieces of the
    output are gathered, so every rank returns the whole [B, S, N, D].
    A forward (the training path calls ``ring_attention_local`` on the
    pieces it holds)."""
    mesh = mesh if mesh is not None else _ctx.current_mesh()
    P = mesh.size(axis_name) if mesh is not None else 1
    S = q.shape[1]
    if S % P:
        raise ValueError(f"ring_attention: sequence {S} does not split over "
                         f"{axis_name}={P}")
    Sl, r = S // P, (mesh.index(axis_name) if mesh is not None else 0)

    def piece(t):
        return t[:, r * Sl:(r + 1) * Sl].contiguous()
    out = ring_attention_local(piece(q), piece(k), piece(v),
                               axis_name=axis_name, causal=causal,
                               sm_scale=sm_scale, reference=reference,
                               mesh=mesh)
    return comm.all_gather(out, axis_name, dim=1, mesh=mesh)
