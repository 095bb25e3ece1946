"""Flash attention (GQA-native), forward and backward, PyTorch port of
``deepspeed_tpu/ops/flash_attention.py``.

Three hand-written CUDA kernels for sm_90a (each source's note says what
bounds it and how it is laid out):

- ``csrc/flash_fwd.cu`` (B1): O and the f32 log-sum-exp;
- ``csrc/flash_bwd_dq.cu`` (B2): dQ, K/V tiles innermost;
- ``csrc/flash_bwd_dkv.cu`` (B3): dK and dV, query tiles innermost.

``flash_attention`` is a ``torch.autograd.Function``: its forward launches
B1 and keeps (q, k, v, O, LSE); its backward launches B2 then B3, the TPU
module's two-grid decomposition (no atomics, so the gradients are
deterministic). ``fused_backward`` moves delta = rowsum(dO * O) into both
backward kernels; otherwise it is one plain torch pass before them, as it
was one XLA pass in JAX.

B1 runs as the custom op ``dstpu_torch::flash_fwd`` so that a selective
checkpoint policy can see it and keep its outputs (the ``dots_and_attn``
remat policy of ``models/transformer``); a plain ctypes launch would be
invisible to the dispatcher and always replayed.

Layout: [B, S, N, D] in and out, as the models hold it. GQA: query head h
reads kv head h // (N // Nkv), the TPU kernel's (Nkv, rep) grouping.

Dispatch: a tensor on the CPU takes the plain PyTorch version; a CUDA
tensor launches the kernel or raises. Nothing falls back.
"""

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops._build import (FLASH_BWD_DKV, FLASH_BWD_DQ,
                                            FLASH_FWD, stream_handle)

NEG_INF = -1e30
# floor of the running row max: a fully masked row outputs 0 (and LSE
# M_FLOOR) instead of attending uniformly to its masked keys
M_FLOOR = -1e20
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_REP = 64
BWD_PARTS = ("dq", "dkv")


def _default_scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else sm_scale


def _visible(B, S, causal, kv_mask, device):
    """[B | 1, 1, 1, S, S] bool: key t visible to query s."""
    keep = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None, None, None]
    if kv_mask is not None:
        keep = keep & (kv_mask != 0)[:, None, None, None, :]
    return keep


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              sm_scale: Optional[float] = None,
                              kv_mask=None) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Plain version: ``reference_attention`` plus the log-sum-exp, with
    the kernel's masking rule (running max floored at M_FLOOR). Returns
    (O [B, S, N, D] in q's dtype, LSE [B, N, S, 1] f32)."""
    B, S, N, D = q.shape
    Nkv = k.shape[2]
    rep = N // Nkv
    sm_scale = _default_scale(q, sm_scale)
    qg = q.float().reshape(B, S, Nkv, rep, D) * sm_scale
    s = torch.einsum("bsgrd,btgd->bgrst", qg, k.float())
    keep = _visible(B, S, causal, kv_mask, q.device)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bgrst,btgd->bsgrd", p / l_safe, v.float())
    lse = (m + torch.log(l_safe)).reshape(B, N, S, 1)
    return o.reshape(B, S, N, D).to(q.dtype).contiguous(), lse.contiguous()


def flash_attention_bwd_reference(q, k, v, o, lse, do, *, causal: bool = True,
                                  sm_scale: Optional[float] = None,
                                  kv_mask=None, fused: bool = False,
                                  parts=BWD_PARTS):
    """Plain version of the backward (B2 + B3): the kernels' decomposition
    written out in torch, not autograd through the forward.

    p = exp(s - LSE) with masked scores at NEG_INF (a fully masked row has
    LSE M_FLOOR, so its p and its dQ are 0); delta = rowsum(dO * O) from
    the O the forward stored; dS = p (dP - delta) sm_scale; dQ = dS K,
    dK = dS^T Q and dV = p^T dO, dK/dV of kv head g summed over its rep
    query heads. ``fused`` is taken only so that this function has
    ``flash_attention_bwd``'s signature (and the TPU module's ``_bwd``
    option): it says where the kernels compute delta, and the plain
    arithmetic is the same either way. ``parts`` picks "dq" (B2) and/or
    "dkv" (B3); a part left out comes back as None. Returns (dQ, dK, dV)
    in q's dtype."""
    del fused                      # signature parity only, see above
    B, S, N, D = q.shape
    Nkv = k.shape[2]
    rep = N // Nkv
    sm_scale = _default_scale(q, sm_scale)
    qg = q.float().reshape(B, S, Nkv, rep, D)
    dog = do.float().reshape(B, S, Nkv, rep, D)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bsgrd,btgd->bgrst", qg, kf) * sm_scale
    keep = _visible(B, S, causal, kv_mask, q.device)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse.reshape(B, Nkv, rep, S, 1))
    del s, keep
    delta = (dog * o.float().reshape(B, S, Nkv, rep, D)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)[..., None]          # [B, Nkv, rep, S, 1]
    dp = torch.einsum("bsgrd,btgd->bgrst", dog, vf)
    ds = p * (dp - delta) * sm_scale
    del dp
    dq = dk = dv = None
    if "dq" in parts:
        dq = torch.einsum("bgrst,btgd->bsgrd", ds, kf).reshape(B, S, N, D) \
            .to(q.dtype)
    if "dkv" in parts:
        dk = torch.einsum("bgrst,bsgrd->btgd", ds, qg).to(k.dtype)
        dv = torch.einsum("bgrst,bsgrd->btgd", p, dog).to(v.dtype)
    return dq, dk, dv


def _check(q, k, v, kv_mask, name="flash_fwd"):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name} wants q [B,S,N,D], k/v [B,S,Nkv,D]; got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, S, N, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    Nkv = k.shape[2]
    if N % Nkv or N // Nkv > _MAX_REP:
        raise ValueError(f"n_q_heads {N} must be a multiple (<= {_MAX_REP}x) "
                         f"of n_kv_heads {Nkv}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name} supports head_dim {_HEAD_DIMS}, got {D}")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} must start on a 16-byte boundary "
                             "(the kernels load 16 bytes at once)")
    if kv_mask is not None and (kv_mask.shape != (B, S)
                                or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be [B, S] = {(B, S)} on {q.device}")


def _on_cuda(q, name):
    """True for a CUDA tensor, False for a CPU one (the plain version);
    any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda (or cpu), not {q.device}")
    return True


def _mask_u8(kv_mask):
    return None if kv_mask is None else (kv_mask != 0).to(torch.uint8) \
        .contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        kv_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: [B, S, N, D]; k, v: [B, S, Nkv, D] (Nkv divides N); kv_mask:
    optional [B, S] key-padding mask (nonzero = visible). Returns (O
    [B, S, N, D] in q's dtype, LSE [B, N, S, 1] f32)."""
    sm_scale = _default_scale(q, sm_scale)
    if not _on_cuda(q, "flash_fwd"):
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=sm_scale, kv_mask=kv_mask)
    _check(q, k, v, kv_mask)
    B, S, N, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, N, S, 1), dtype=torch.float32, device=q.device)
    mask = _mask_u8(kv_mask)
    FLASH_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(mask),
                     o.data_ptr(), lse.data_ptr(), B, S, N, k.shape[2], D,
                     _DTYPES[q.dtype], int(bool(causal)), float(sm_scale),
                     stream_handle(q))
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        sm_scale: Optional[float] = None, kv_mask=None,
                        fused: bool = False, parts=BWD_PARTS):
    """Gradients (dQ, dK, dV) of ``flash_attention`` from the forward's O
    and LSE and the output gradient ``do`` [B, S, N, D]. On CUDA: B2 (dQ)
    then B3 (dK/dV); unfused, delta = rowsum(dO * O) is one torch pass
    before them, fused, each kernel computes it from O. ``parts`` picks
    the kernels ("dq", "dkv"; a part left out comes back as None)."""
    sm_scale = _default_scale(q, sm_scale)
    if not _on_cuda(q, "flash_bwd"):
        return flash_attention_bwd_reference(q, k, v, o, lse, do,
                                             causal=causal, sm_scale=sm_scale,
                                             kv_mask=kv_mask, fused=fused,
                                             parts=parts)
    _check(q, k, v, kv_mask, "flash_bwd")
    B, S, N, D = q.shape
    for nm, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"flash_bwd: {nm} must be a contiguous "
                             f"{q.dtype} {tuple(q.shape)} on {q.device}")
    if lse.shape != (B, N, S, 1) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_bwd: lse must be contiguous float32 "
                         f"{(B, N, S, 1)} on {q.device}")
    if o.data_ptr() % 16 or do.data_ptr() % 16:
        raise ValueError("flash_bwd: o and do must start on a 16-byte "
                         "boundary (the kernels load 16 bytes at once)")
    delta = None
    if not fused:
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    mask = _mask_u8(kv_mask)
    common = (B, S, N, k.shape[2], D, _DTYPES[q.dtype], int(bool(causal)),
              float(sm_scale), stream_handle(q))
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
              do.data_ptr(), lse.data_ptr(), _ptr(delta), _ptr(mask))
    dq = dk = dv = None
    if "dq" in parts:
        dq = torch.empty_like(q)
        FLASH_BWD_DQ.launch(*inputs, dq.data_ptr(), *common)
    if "dkv" in parts:
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        FLASH_BWD_DKV.launch(*inputs, dk.data_ptr(), dv.data_ptr(), *common)
    return dq, dk, dv


@torch.library.custom_op("dstpu_torch::flash_fwd", mutates_args=())
def _flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  kv_mask: Optional[torch.Tensor], causal: bool,
                  sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_mask=kv_mask)


FLASH_FWD_OP = torch.ops.dstpu_torch.flash_fwd.default


class _FlashAttention(torch.autograd.Function):
    """``jax.custom_vjp`` of the TPU module: forward B1, backward B2 + B3
    (``reference``: their plain versions, by name). The key mask gets no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, sm_scale, fused, reference):
        if reference:
            o, lse = flash_attention_reference(q, k, v, causal=causal,
                                               sm_scale=sm_scale,
                                               kv_mask=kv_mask)
        else:
            o, lse = _flash_fwd_op(q, k, v, kv_mask, causal, sm_scale)
        ctx.save_for_backward(q, k, v, kv_mask, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.fused, ctx.reference = fused, reference
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, kv_mask, o, lse = ctx.saved_tensors
        bwd = (flash_attention_bwd_reference if ctx.reference
               else flash_attention_bwd)
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
                         sm_scale=ctx.sm_scale, kv_mask=kv_mask,
                         fused=ctx.fused)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None, kv_mask=None,
                    fused_backward: bool = False,
                    reference: bool = False) -> torch.Tensor:
    """q: [B, S, Nq, D]; k, v: [B, S, Nkv, D] -> O [B, S, Nq, D],
    differentiable in q, k and v. fused_backward: compute delta inside
    the backward kernels (no separate pass over dO and O). reference: the
    plain versions of all three kernels, on any device (comparisons)."""
    if not reference:
        _on_cuda(q, "flash_fwd")
    return _FlashAttention.apply(q, k, v, kv_mask, bool(causal),
                                 float(_default_scale(q, sm_scale)),
                                 bool(fused_backward), bool(reference))
