"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (marker ``cuda``) and skips
without one; this file imports neither jax nor the JAX package, so it runs
on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: relative L2 <= 2e-2 at bf16 (the kernel and the plain version
round at different places), <= 1e-4 at f32 (other summation order).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.decode_attention import (paged_decode_attention,
                                                      paged_decode_reference)
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                     flash_attention_reference)

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def rel_l2(got, want):
    got = got.double().cpu().ravel()
    want = want.double().cpu().ravel()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rep,D,masked,causal", [
    (1, 128, False, True), (4, 64, False, True), (8, 128, True, True),
    (3, 64, True, False)])
def test_flash_kernel_matches_plain(cuda, dtype, rep, D, masked, causal):
    rng = np.random.default_rng(rep)
    B, S, Nkv = 2, 200, 2               # 200: a ragged edge for every tile
    q = _randn(rng, (B, S, Nkv * rep, D), dtype, cuda)
    k = _randn(rng, (B, S, Nkv, D), dtype, cuda)
    v = _randn(rng, (B, S, Nkv, D), dtype, cuda)
    mask = None
    if masked:                          # padding, and key 0 masked: row 0
        lens = torch.tensor([150, 200], device=cuda)     # fully masked
        mask = torch.arange(S, device=cuda)[None, :] < lens[:, None]
        mask[:, 0] = False
    before = _build.FLASH_FWD.launches
    o, lse = flash_attention_fwd(q, k, v, causal=causal, kv_mask=mask)
    ro, rlse = flash_attention_reference(q, k, v, causal=causal,
                                         kv_mask=mask)
    torch.cuda.synchronize()
    assert _build.FLASH_FWD.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert rel_l2(o, ro) <= TOL[dtype]
    assert rel_l2(lse, rlse) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rep,D,bs", [(1, 128, 64), (8, 128, 64),
                                      (4, 64, 64), (2, 128, 24), (3, 64, 16)])
def test_paged_decode_kernel_matches_plain(cuda, dtype, rep, D, bs):
    rng = np.random.default_rng(rep)
    S, NB, MB, Nkv = 4, 20, 4, 2
    q = _randn(rng, (S, 1, Nkv * rep, D), dtype, cuda)
    kp = _randn(rng, (NB, Nkv, bs, D), dtype, cuda)
    vp = _randn(rng, (NB, Nkv, bs, D), dtype, cuda)
    kp[0] = vp[0] = 1e4                 # the trash block holds garbage
    row = (_randn(rng, (S, Nkv, 1, D), dtype, cuda),
           _randn(rng, (S, Nkv, 1, D), dtype, cuda))
    tables = torch.from_numpy(rng.permutation(np.arange(1, NB))[:S * MB]
                              .reshape(S, MB).astype(np.int32)).to(cuda)
    tables[0] = 0                       # the empty slot: an all-trash table
    lens = torch.tensor([0, 1, MB * bs // 2 + 3, MB * bs], dtype=torch.int32,
                        device=cuda)
    before = _build.PAGED_DECODE.launches
    got = paged_decode_attention(q, kp, vp, tables, lens, kv_row=row)
    ref = paged_decode_reference(q, kp, vp, tables, lens, kv_row=row)
    torch.cuda.synchronize()
    assert _build.PAGED_DECODE.launches == before + 1
    assert rel_l2(got, ref) <= TOL[dtype]
    # the empty slot: exactly v_row, for each query head of the group
    assert torch.equal(got[0, 0], row[1][0, :, 0].repeat_interleave(rep, 0))


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 64, 4, 32), device=cuda)     # head_dim 32
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q)
    q = torch.zeros((1, 64, 4, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, q, q)
