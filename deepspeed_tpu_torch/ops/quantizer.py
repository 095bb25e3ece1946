"""int8 quantization for serving, PyTorch port of the serving half of
``deepspeed_tpu/ops/quantizer.py``: per-row int8 for KV-cache storage
(``quantize_rows``), per-out-channel int8 for weights
(``quantize_channels``), the weight-only matmul with its scale in the
epilogue (``weight_matmul``), and the exact int8 x int8 -> int32
contraction the int8 attention math runs on (``int8_matmul``).

The numerics are JAX's: ``torch.round`` and ``jnp.round`` both round half
to even, the clip ranges and scale floors are the same, and every
division is the same IEEE f32 division, so identical inputs give
identical int8 payloads and scales.

The rest of the JAX module (``quantize`` / ``dequantize``, int4 packing,
``fake_quant``, ``quantize_tree``) belongs to compression: ROADMAP A11.

JAX contracts int8 x int8 into int32 on the MXU (XLA, not a Pallas
kernel), and so does this module with plain torch ops: there is no kernel
to port (a Hopper kernel for the int8 read is ROADMAP R8).
"""

import torch

# An f32 sum of int8 x int8 products is exact while it stays below 2^24:
# 127^2 * 1024 = 16,516,096 < 16,777,216. ``int8_matmul`` contracts in
# pieces of this many terms, each exact in f32 whatever the summation
# order (every partial sum is an integer below 2^24), converts each
# piece to int32 exactly and sums the pieces in int32: the int32 result
# of XLA's ``preferred_element_type=jnp.int32``. The operands are
# integers of at most 127 in magnitude, exact in f32, TF32 and bf16
# alike, so the route is exact on the card whatever the matmul precision
# setting. (torch has no integer einsum on the card, and ``torch._int_mm``
# takes 2-D operands only.)
EXACT_TERMS = 1024


def quantize_rows(x):
    """Per-row symmetric int8 for KV-cache storage: x [..., T, D] float ->
    (int8 [..., T, D], f32 scale [..., T]). The scale factors out of the
    head-dim contraction, so the attention read consumes the int8 bytes
    (scores = int8 dot * q_scale * k_scale)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1)
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_channels(w):
    """Per-out-channel symmetric int8 for weight storage: w [..., In, Out]
    float -> (int8 [..., In, Out], f32 scale [..., 1, Out]). Leading dims
    (the layer stack) each get their own scales."""
    w32 = w.float()
    amax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-12)
    q = torch.clamp(torch.round(w32 / scale), -127, 127)
    return q.to(torch.int8), scale


def weight_matmul(x, w, scale=None):
    """x @ w with the dequantization in the epilogue: ``w`` int8 [In, Out]
    is cast to x's dtype for the matmul, and the per-out-channel f32
    ``scale`` (any shape ending in Out), cast to x's dtype, multiplies the
    [..., Out] result rows. A float ``w`` (scale None) is the plain
    matmul."""
    y = x @ w.to(x.dtype)
    if scale is None:
        return y
    return y * scale.reshape(scale.shape[-1:]).to(x.dtype)


def int8_matmul(a, b):
    """a [..., M, K] @ b [..., K, N] for int8-valued operands (int8
    tensors, or floats holding such integers), accumulated exactly:
    int32 [..., M, N]. K is cut in pieces of ``EXACT_TERMS``."""
    K = a.shape[-1]
    out = None
    for s in range(0, K, EXACT_TERMS):
        part = torch.matmul(a[..., s:s + EXACT_TERMS].float(),
                            b[..., s:s + EXACT_TERMS, :].float())
        part = part.to(torch.int32)
        out = part if out is None else out + part
    return out
