"""The fused host Adagrad, a port of ``deepspeed_tpu/ops/cpu_adagrad.py``
over ``csrc/host/dstpu_cpu_adagrad.cpp``: ``accum += g^2; p -= lr * g /
(sqrt(accum) + eps)``, weight decay folded into g. Buffers as in
``ops/cpu_adam.py``; the plain version is ``ops/optimizers.adagrad``'s
update over the same tensors.
"""

from typing import Optional

import torch

from deepspeed_tpu_torch.ops import host_build
from deepspeed_tpu_torch.ops.cpu_adam import (_BITS, _F32, _addr, _numel,
                                              clip_coef, is_bits, sq_norm)


def adagrad_step_flat(master, accum, grads, *, lr: float, eps: float = 1e-10,
                      weight_decay: float = 0.0, grad_scale: float = 1.0,
                      out=None) -> None:
    """One fused Adagrad step over caller-owned flat f32 buffers (updated
    in place); ``grads`` f32 or bf16 bits; ``out`` optional, as in
    ``adam_step_flat``."""
    n = _numel(grads)
    bits = is_bits(grads)
    ptrs = [_addr("master", master, n, _F32),
            _addr("accum", accum, n, _F32),
            _addr("grads", grads, n, _BITS if bits else _F32),
            None if out is None
            else _addr("out", out, n, _BITS if bits else _F32)]
    host_build.CPU_ADAGRAD.call(
        "dstpu_adagrad_step_bf16" if bits else "dstpu_adagrad_step_f32",
        *ptrs, n, float(lr), eps, weight_decay, float(grad_scale))


class CPUAdagrad:
    """Fused host Adagrad over flat f32 state it owns (``master``,
    ``accum``), with ``CPUAdam``'s step interface (``step_num`` unused: no
    bias correction)."""

    def __init__(self, n: int, lr=1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, pin: bool = False, **_ignored):
        host_build.CPU_ADAGRAD.lib()
        host_build.CPU_ADAM.lib()          # the norm's entry points
        self.n = int(n)
        self.lr, self.eps, self.wd = lr, eps, weight_decay
        self.master, self.accum = (
            torch.zeros(self.n, dtype=torch.float32, pin_memory=pin)
            for _ in range(2))

    def state(self):
        return {"master": self.master, "accum": self.accum}

    sq_norm = staticmethod(sq_norm)
    clip_coef = staticmethod(clip_coef)

    def step(self, grads, step_num: int, lr: Optional[float] = None,
             grad_scale: float = 1.0, out=None):
        if out is None:
            out = torch.empty(self.n, dtype=torch.bfloat16
                              if is_bits(grads) else torch.float32)
        adagrad_step_flat(self.master, self.accum, grads,
                          lr=float(self.lr if lr is None else lr),
                          eps=self.eps, weight_decay=self.wd,
                          grad_scale=grad_scale, out=out)
        return out
