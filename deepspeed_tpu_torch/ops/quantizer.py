"""Quantization, PyTorch port of ``deepspeed_tpu/ops/quantizer.py``: for
serving, per-row int8 for KV-cache storage (``quantize_rows``),
per-out-channel int8 for weights (``quantize_channels``), the
weight-only matmul with its scale in the epilogue (``weight_matmul``),
and the exact int8 x int8 -> int32 contraction the int8 attention math
runs on (``int8_matmul``); for compression and MoQ, grouped int8 / int4
``quantize`` / ``dequantize`` (symmetric or with a zero point; int4 two
nibbles a byte, ``pack_int4`` / ``unpack_int4``), the straight-through
``fake_quant`` (QAT's forward: x + (xq - x) with the difference
detached) and ``quantize_tree`` / ``dequantize_tree``.

The numerics are JAX's: ``torch.round`` and ``jnp.round`` both round half
to even, the clip ranges and scale floors are the same, and every
division is the same IEEE f32 division, so identical inputs give
identical int8 payloads and scales.

JAX contracts int8 x int8 into int32 on the MXU (XLA, not a Pallas
kernel), and so does this module with plain torch ops: there is no kernel
to port (a Hopper kernel for the int8 read is ROADMAP R8).
"""

import dataclasses
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops.optimizers import tree_map

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


@dataclasses.dataclass
class QuantizedTensor:
    """A quantized payload with its per-group scale (and zero point when
    asymmetric), JAX's container: ``q`` int8 [groups, n] (int4: uint8
    [groups, n / 2], two nibbles a byte), ``scale`` / ``zero`` f32
    [groups, 1], the original ``shape`` and the dtype ``dequantize``
    returns."""
    q: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor]
    bits: int
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16


def _grouped(x, num_groups: int):
    n = x.numel()
    if n % num_groups:
        raise ValueError(f"size {n} not divisible by num_groups {num_groups}")
    return x.reshape(num_groups, n // num_groups)


def quantize(x, bits: int = 8, symmetric: bool = True,
             num_groups: int = 1, amax=None) -> QuantizedTensor:
    """int8 or int4 with a scale per group of the flattened ``x`` (and a
    zero point with ``symmetric=False``), JAX's arithmetic in f32.
    ``amax`` (symmetric): each group's largest magnitude, given instead
    of taken from ``x`` (a rank's slice of a leaf quantized at the whole
    leaf's scale)."""
    if bits not in (4, 8):
        raise ValueError("bits must be 4 or 8")
    g = _grouped(x.float(), num_groups)
    qmax = 2 ** (bits - 1) - 1          # 127 / 7
    qmin = -(2 ** (bits - 1))           # -128 / -8
    if symmetric:
        amax = (g.abs().amax(dim=1, keepdim=True) if amax is None
                else amax.float().reshape(num_groups, 1))
        scale = torch.clamp_min(amax / qmax, 1e-12)
        q = torch.clamp(torch.round(g / scale), qmin, qmax).to(torch.int8)
        zero = None
    else:
        lo = g.amin(dim=1, keepdim=True)
        hi = g.amax(dim=1, keepdim=True)
        scale = torch.clamp_min((hi - lo) / (2 ** bits - 1), 1e-12)
        zero = torch.round(-lo / scale) + qmin
        q = torch.clamp(torch.round(g / scale) + zero, qmin,
                        qmax).to(torch.int8)
    if bits == 4:
        q = pack_int4(q)
    return QuantizedTensor(q=q, scale=scale, zero=zero, bits=bits,
                           shape=tuple(x.shape), dtype=x.dtype)


def dequantize(qt: QuantizedTensor):
    q = unpack_int4(qt.q) if qt.bits == 4 else qt.q
    g = q.float()
    if qt.zero is not None:
        g = g - qt.zero
    return (g * qt.scale).reshape(qt.shape).to(qt.dtype)


def pack_int4(q):
    """[G, N] int8 in [-8, 7] -> [G, N / 2] uint8 (element 2j in the low
    nibble, 2j + 1 in the high one)."""
    if q.shape[1] % 2:
        raise ValueError("int4 packing needs an even group size")
    u = (q.to(torch.int32) & 0xF).to(torch.uint8)
    return u[:, 0::2] | (u[:, 1::2] << 4)


def unpack_int4(p):
    lo = (p & 0xF).to(torch.int8)
    hi = ((p >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)          # sign-extend
    hi = torch.where(hi >= 8, hi - 16, hi)
    G, M = p.shape
    return torch.stack([lo, hi], dim=2).reshape(G, 2 * M)


def fake_quant(x, bits: int = 8, symmetric: bool = True,
               num_groups: int = 1, amax=None):
    """Quantize-dequantize with the straight-through gradient: the
    forward sees the quantized values, the gradient passes unchanged.
    ``amax``: as ``quantize``'s."""
    qt = quantize(x, bits=bits, symmetric=symmetric, num_groups=num_groups,
                  amax=amax)
    xq = dequantize(qt).to(x.dtype)
    return x + (xq - x).detach()


def quantize_tree(params, bits: int = 8, symmetric: bool = True,
                  group_size: int = 128, min_size: int = 4096):
    """Every matmul-sized leaf of a (nested dict) param tree quantized for
    storage, groups of about ``group_size``; small leaves (norms, biases)
    stay float."""
    def one(x):
        if not isinstance(x, torch.Tensor) or x.numel() < min_size \
                or x.dim() < 2:
            return x
        n = x.numel()
        groups = max(1, n // group_size)
        while n % groups:
            groups -= 1
        return quantize(x, bits=bits, symmetric=symmetric, num_groups=groups)
    return tree_map(one, params)


def dequantize_tree(params):
    return tree_map(lambda x: dequantize(x) if isinstance(
        x, QuantizedTensor) else x, params)
