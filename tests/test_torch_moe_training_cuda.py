"""Model-parallel training's kernels on the card: an f32 MoE training
step at 2 layers through the attention kernels against the plain path,
and B1-B3 at head dim 128 with rep 4 (the MoE cell's 32/8 heads) and rep
1 (a tensor=2 rank's 16/16 heads). Every test here needs an NVIDIA GPU
(marker ``cuda``) and skips without one; this file imports neither jax
nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_moe_training_cuda.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_reference)
from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_l2(got, want) -> float:
    got, want = got.double().ravel(), want.double().ravel()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.cuda
def test_moe_training_step_kernels_match_plain(cuda):
    """f32, 2 layers, hidden 512, 4/2 heads of 128, 4 experts (top-2) at
    capacity 0.5 (tokens drop), B=2, S=256, dots_saveable: the loss and
    every leaf's grad through B1-B3 within 1e-4 of the plain versions,
    with B1 launched twice a layer (the replay) and B2, B3 once."""
    cfg = tt.TransformerConfig(
        vocab_size=256, hidden_size=512, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=128, intermediate_size=256, max_seq_len=256,
        position_type="rotary", activation="silu_glu", norm_type="rmsnorm",
        tie_embeddings=False, num_experts=4, top_k=2, capacity_factor=0.5,
        remat=True, remat_policy="dots_saveable", dtype=torch.float32)
    params = tt.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            cuda, dtype=torch.float32)
    leaves = list(ckpt_mod.flatten(params).values())
    for t in leaves:
        t.requires_grad_(True)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 256), dtype=np.int64)).to(cuda)
    out = {}
    for ref in (False, True):
        _build.reset_launch_counts()
        loss = tt.lm_loss(params, {"input_ids": ids}, cfg, reference=ref,
                          train=True)
        out[ref] = (loss.detach(), torch.autograd.grad(loss, leaves),
                    _build.launch_counts())
    (lk, gk, la), (lp, gp, lb) = out[False], out[True]
    assert la["flash_fwd"] == 4 and la["flash_bwd_dq"] == 2 \
        and la["flash_bwd_dkv"] == 2
    assert not any(lb[k] for k in ("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"))
    assert abs(float(lk) - float(lp)) <= 1e-5 * abs(float(lp))
    for a, b in zip(gk, gp):
        assert rel_l2(a, b) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("heads,kv_heads", [(32, 8), (16, 16)])
def test_flash_kernels_at_d128_match_plain(cuda, heads, kv_heads):
    """B1, B2 and B3 in bf16 at B=2, S=1024, D=128 (rep 4 and rep 1)
    within 2e-2 of their plain versions, and bit for bit across two
    launches."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, do = (torch.randn((2, 1024, heads, 128), generator=g, device=cuda,
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((2, 1024, kv_heads, 128), generator=g, device=cuda,
                        dtype=torch.bfloat16) for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    ro, _ = flash_attention_reference(q, k, v, causal=True)
    assert rel_l2(o, ro) < 2e-2
    assert torch.equal(o, flash_attention_fwd(q, k, v, causal=True)[0])
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True, fused=True)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                fused=True)
    for a, b, c in zip(got, want, again):
        assert rel_l2(a, b) < 2e-2
        assert torch.equal(a, c)
