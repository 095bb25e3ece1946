"""Flash attention forward (GQA-native), PyTorch port of
``deepspeed_tpu/ops/flash_attention.py``.

The kernel is ``csrc/flash_fwd.cu`` (hand-written CUDA for sm_90a); its
note says what bounds it and how it is laid out. The backward grids of the
TPU module (B2, B3) come with the training slice.

Layout: [B, S, N, D] in and out, as the models hold it. GQA: query head h
reads kv head h // (N // Nkv), the TPU kernel's (Nkv, rep) grouping.

Dispatch: a tensor on the CPU takes the plain PyTorch version; a CUDA
tensor launches the kernel or raises. Nothing falls back.
"""

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops._build import FLASH_FWD, stream_handle

NEG_INF = -1e30
# floor of the running row max: a fully masked row outputs 0 (and LSE
# M_FLOOR) instead of attending uniformly to its masked keys
M_FLOOR = -1e20
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_REP = 64


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
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, S, Nkv, rep, D) * sm_scale
    s = torch.einsum("bsgrd,btgd->bgrst", qg, k.float())
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None, None, None]
    if kv_mask is not None:
        keep = keep & (kv_mask != 0)[:, None, None, None, :]
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True).clamp_min(M_FLOOR)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bgrst,btgd->bsgrd", p / l_safe, v.float())
    lse = (m + torch.log(l_safe)).reshape(B, N, S, 1)
    return o.reshape(B, S, N, D).to(q.dtype), lse


def _check(q, k, v, kv_mask):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_fwd wants q [B,S,N,D], k/v [B,S,Nkv,D]; got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, S, N, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    Nkv = k.shape[2]
    if N % Nkv or N // Nkv > _MAX_REP:
        raise ValueError(f"n_q_heads {N} must be a multiple (<= {_MAX_REP}x) "
                         f"of n_kv_heads {Nkv}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd supports head_dim {_HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous on "
                             f"{q.device}")
    if kv_mask is not None and (kv_mask.shape != (B, S)
                                or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be [B, S] = {(B, S)} on {q.device}")


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        kv_mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: [B, S, N, D]; k, v: [B, S, Nkv, D] (Nkv divides N); kv_mask:
    optional [B, S] key-padding mask (nonzero = visible). Returns (O
    [B, S, N, D] in q's dtype, LSE [B, N, S, 1] f32)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=sm_scale, kv_mask=kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_fwd runs on cuda (or cpu), not {q.device}")
    _check(q, k, v, kv_mask)
    B, S, N, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, N, S, 1), dtype=torch.float32, device=q.device)
    mask = None
    if kv_mask is not None:
        mask = (kv_mask != 0).to(torch.uint8).contiguous()
    FLASH_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None if mask is None else mask.data_ptr(),
                     o.data_ptr(), lse.data_ptr(), B, S, N, k.shape[2], D,
                     _DTYPES[q.dtype], int(bool(causal)), float(sm_scale),
                     stream_handle(q))
    return o, lse


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    kv_mask=None) -> torch.Tensor:
    """q: [B, S, Nq, D]; k, v: [B, S, Nkv, D] -> O [B, S, Nq, D]."""
    return flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                               kv_mask=kv_mask)[0]
