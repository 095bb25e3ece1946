"""The fused host AdamW, a port of ``deepspeed_tpu/ops/cpu_adam.py``: the
compute half of ZeRO-Offload. The f32 master, m and v stay in host
memory and the update runs on the host's cores
(``csrc/host/dstpu_cpu_adam.cpp``, built with ``g++ -O3 -march=native
-fopenmp`` by ``ops/host_build``), so a step moves only the compute-dtype
grads down and the params up.

Buffers are contiguous CPU tensors or numpy arrays, passed by address: f32
state, and grads as f32 or as bf16 bits (a bf16 tensor, or a uint16
array). The updated params come out the same way (bf16 bits for bf16
grads, rounded to nearest even as ``Tensor.to(torch.bfloat16)`` rounds).
The plain version is ``ops/adam.fused_adam_update`` over the same
tensors.
"""

import math
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops import host_build

_F32 = (np.dtype(np.float32), torch.float32)
_BITS = (np.dtype(np.uint16), torch.bfloat16, torch.int16)


def _addr(name: str, buf, n: int, kinds) -> int:
    """The address of a contiguous host buffer of ``n`` values of one of
    ``kinds`` (numpy dtypes or torch dtypes); anything else raises: a short
    or strided buffer would be silent memory corruption in the C++."""
    if isinstance(buf, torch.Tensor):
        ok = (buf.device.type == "cpu" and buf.is_contiguous()
              and buf.dtype in kinds and buf.numel() == n)
        if not ok:
            raise ValueError(f"{name}: need a contiguous CPU tensor of {n} "
                             f"values of {kinds}, got {buf.dtype}"
                             f"[{buf.numel()}] on {buf.device}")
        return buf.data_ptr()
    ok = (isinstance(buf, np.ndarray) and buf.dtype in kinds
          and buf.flags.c_contiguous and buf.size == n)
    if not ok:
        raise ValueError(f"{name}: need a contiguous array of {n} values of "
                         f"{kinds}, got {getattr(buf, 'dtype', type(buf))}"
                         f"[{getattr(buf, 'size', '?')}]")
    return buf.ctypes.data


def _numel(buf) -> int:
    return buf.numel() if isinstance(buf, torch.Tensor) else buf.size


def is_bits(buf) -> bool:
    """bf16 bits (a bf16 / int16 tensor or a uint16 array)?"""
    return buf.dtype in _BITS


def sq_norm(grads) -> float:
    """The squared L2 norm of a flat grad buffer (f32 or bf16 bits),
    summed in double on the host."""
    n = _numel(grads)
    if is_bits(grads):
        return float(host_build.CPU_ADAM.call(
            "dstpu_sq_norm_bf16", _addr("grads", grads, n, _BITS), n))
    return float(host_build.CPU_ADAM.call(
        "dstpu_sq_norm_f32", _addr("grads", grads, n, _F32), n))


def clip_coef(sq_total: float, clip: float, grad_scale: float = 1.0) -> float:
    """The global-norm clip coefficient to fold into ``grad_scale``: clip /
    (norm + 1e-6) where the norm of the grads times ``grad_scale`` passes
    ``clip``, else 1."""
    gnorm = math.sqrt(sq_total) * grad_scale
    if clip and clip > 0 and gnorm > clip:
        return clip / (gnorm + 1e-6)
    return 1.0


def adam_step_flat(master, m, v, grads, *, step_num: int, lr: float,
                   betas=(0.9, 0.999), eps: float = 1e-8,
                   weight_decay: float = 0.0, adamw_mode: bool = True,
                   bias_correction: bool = True, grad_scale: float = 1.0,
                   out=None) -> None:
    """One fused AdamW step over caller-owned flat f32 buffers (updated in
    place). ``grads``: f32 or bf16 bits; ``out`` (optional) receives the
    updated params, bf16 bits for bf16 grads and f32 otherwise.
    ``grad_scale`` multiplies the grads (the accumulation mean, the clip
    coefficient and 1 / loss scale folded in by the caller)."""
    b1, b2 = betas
    if bias_correction:
        c1, c2 = 1.0 - b1 ** step_num, 1.0 - b2 ** step_num
    else:
        c1 = c2 = 1.0
    n = _numel(grads)
    bits = is_bits(grads)
    ptrs = [_addr(k, b, n, _F32) for k, b in
            (("master", master), ("m", m), ("v", v))]
    ptrs.append(_addr("grads", grads, n, _BITS if bits else _F32))
    ptrs.append(None if out is None
                else _addr("out", out, n, _BITS if bits else _F32))
    host_build.CPU_ADAM.call(
        "dstpu_adam_step_bf16" if bits else "dstpu_adam_step_f32", *ptrs, n,
        float(lr), b1, b2, eps, weight_decay, int(adamw_mode), c1, c2,
        float(grad_scale))


class CPUAdam:
    """Fused host AdamW over flat f32 state it owns (``master``, ``m``,
    ``v``: CPU tensors, pinned where ``pin`` says so)."""

    def __init__(self, n: int, lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 bias_correction: bool = True, pin: bool = False):
        host_build.CPU_ADAM.lib()          # build now: a failure raises here
        self.n = int(n)
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.awm, self.bc = adamw_mode, bias_correction
        self.master, self.m, self.v = (
            torch.zeros(self.n, dtype=torch.float32, pin_memory=pin)
            for _ in range(3))

    def state(self):
        return {"master": self.master, "m": self.m, "v": self.v}

    sq_norm = staticmethod(sq_norm)
    clip_coef = staticmethod(clip_coef)

    def step(self, grads, step_num: int, lr: Optional[float] = None,
             grad_scale: float = 1.0, out=None):
        """grads: f32 or bf16 bits, length n. Returns ``out`` (allocated
        when None: bf16 for bf16 grads, else f32)."""
        if out is None:
            out = torch.empty(self.n, dtype=torch.bfloat16
                              if is_bits(grads) else torch.float32)
        adam_step_flat(self.master, self.m, self.v, grads, step_num=step_num,
                       lr=float(self.lr if lr is None else lr),
                       betas=(self.b1, self.b2), eps=self.eps,
                       weight_decay=self.wd, adamw_mode=self.awm,
                       bias_correction=self.bc, grad_scale=grad_scale,
                       out=out)
        return out
