"""The float16 instantiations of the attention kernels (B1 flash forward,
B2 / B3 flash backward, B4 paged decode) against their plain PyTorch
versions, on the card. Every test here needs an NVIDIA GPU (marker
``cuda``) and skips without one; this file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_fp16_cuda.py

Tolerances: relative L2 <= 2e-2, as the bf16 cases of
``test_torch_kernels.py`` (f16 keeps 3 more mantissa bits than bf16, so
the measured distance is smaller); LSE <= 1e-4 over the rows that see a
key. Two launches on the same inputs must agree bit for bit. The overflow
case holds the backward to f16's range: a gradient past 65504 must come
out inf, as a loss scaler needs to see it, and never a saturated finite
value.
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.decode_attention import (paged_decode_attention,
                                                      paged_decode_reference)
from deepspeed_tpu_torch.ops.flash_attention import (
    M_FLOOR, flash_attention, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_reference)

F16 = torch.float16
TOL = 2e-2
F16_MAX = 65504.0


def rel_l2(got, want):
    got = got.double().cpu().ravel()
    want = want.double().cpu().ravel()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _randn(rng, shape, device, scale=1.0, dtype=F16):
    a = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _inputs(rng, B, S, N, Nkv, D, device, masked):
    q = _randn(rng, (B, S, N, D), device)
    k = _randn(rng, (B, S, Nkv, D), device)
    v = _randn(rng, (B, S, Nkv, D), device)
    do = _randn(rng, (B, S, N, D), device)
    mask = None
    if masked:                          # padding, and key 0 masked: causal
        lens = torch.tensor([S - S // 3] + [S] * (B - 1), device=device)
        mask = torch.arange(S, device=device)[None, :] < lens[:, None]
        mask[:, 0] = False              # row 0 is then fully masked
    return q, k, v, do, mask


def _live_rows(B, S, causal, mask, device):
    keep = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None].expand(B, S, S)
    if mask is not None:
        keep = keep & mask[:, None, :]
    return keep.any(-1)


# rep, D, masked, causal, S: the bf16 grid of test_torch_kernels.py plus
# llama-1b's training head group (32 / 8 heads, D = 64) at S = 2048
FWD_CASES = [(1, 128, False, True, 200), (4, 64, False, True, 200),
             (8, 128, True, True, 200), (3, 64, True, False, 200),
             (64, 64, False, True, 200), (4, 64, True, True, 17),
             (1, 128, False, False, 300), (4, 64, False, True, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("rep,D,masked,causal,S", FWD_CASES)
def test_flash_fwd_f16_matches_plain(cuda, rep, D, masked, causal, S):
    rng = np.random.default_rng(rep * D + S)
    B, Nkv = 2, 2
    q, k, v, _, mask = _inputs(rng, B, S, Nkv * rep, Nkv, D, cuda, masked)
    before = _build.FLASH_FWD.launches
    o, lse = flash_attention_fwd(q, k, v, causal=causal, kv_mask=mask)
    ro, rlse = flash_attention_reference(q, k, v, causal=causal,
                                         kv_mask=mask)
    torch.cuda.synchronize()
    assert _build.FLASH_FWD.launches == before + 1
    assert o.dtype == F16 and lse.dtype == torch.float32
    assert rel_l2(o, ro) <= TOL
    live = _live_rows(B, S, causal, mask, cuda)
    by_row = lse[..., 0].transpose(1, 2)
    assert rel_l2(by_row[live], rlse[..., 0].transpose(1, 2)[live]) <= 1e-4
    assert torch.all(o[~live] == 0)
    assert torch.all(by_row[~live] == M_FLOOR)


# causal, rep, D, masked, fused, S (a ragged edge, whole tiles, and the
# ring wrapping many times)
BWD_CASES = [(True, 1, 64, False, False, 200), (True, 2, 128, False, True, 200),
             (True, 4, 64, True, False, 200), (False, 1, 128, True, True, 200),
             (False, 4, 64, True, True, 200), (True, 8, 128, False, False, 256),
             (True, 4, 64, False, True, 1024), (True, 8, 64, True, False, 1024),
             (True, 4, 64, False, False, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("causal,rep,D,masked,fused,S", BWD_CASES)
def test_flash_bwd_f16_matches_plain(cuda, causal, rep, D, masked, fused, S):
    rng = np.random.default_rng(rep * D + int(causal) + S)
    B, Nkv = 2, 2
    q, k, v, do, mask = _inputs(rng, B, S, Nkv * rep, Nkv, D, cuda, masked)
    o, lse = flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
    before = (_build.FLASH_BWD_DQ.launches, _build.FLASH_BWD_DKV.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              kv_mask=mask, fused=fused)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                         kv_mask=mask)
    torch.cuda.synchronize()
    assert (_build.FLASH_BWD_DQ.launches,
            _build.FLASH_BWD_DKV.launches) == (before[0] + 1, before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == F16 and a.shape == b.shape
        assert torch.isfinite(a).all(), name
        assert rel_l2(a, b) <= TOL, name
    if masked and causal:
        assert torch.all(got[0][:, 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("masked,fused", [(False, True), (True, False)])
def test_flash_f16_kernels_are_deterministic(cuda, masked, fused):
    """Two launches of B1, B2 and B3 in f16 give the same bits."""
    rng = np.random.default_rng(13)
    q, k, v, do, mask = _inputs(rng, 2, 1024, 16, 4, 64, cuda, masked)
    fwd = [flash_attention_fwd(q, k, v, kv_mask=mask) for _ in range(2)]
    o, lse = fwd[0]
    bwd = [flash_attention_bwd(q, k, v, o, lse, do, kv_mask=mask,
                               fused=fused) for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse"), *fwd):
        assert torch.equal(a, b), name
    for name, a, b in zip(("dq", "dk", "dv"), *bwd):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_flash_bwd_f16_overflow_is_inf(cuda):
    """A positive dO at a loss scale of 2^12: dV = p^T dO of the first
    keys (summed over many queries and the 4 heads of the group) passes
    65504 where the f32 truth does, and comes out inf there, finite well
    inside the range. Every dQ / dK / dV entry whose f32 truth is past the
    range is not finite. The plain f16 version overflows at the same dV
    entries."""
    rng = np.random.default_rng(17)
    q, k, v, _, _ = _inputs(rng, 1, 512, 8, 2, 64, cuda, False)
    do = _randn(rng, (1, 512, 8, 64), cuda, 4096.0).abs()
    o, lse = flash_attention_reference(q, k, v)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    o32, lse32 = flash_attention_reference(q.float(), k.float(), v.float())
    truth = flash_attention_bwd_reference(
        q.float(), k.float(), v.float(), o32, lse32, do.float())
    _, _, dv_plain = flash_attention_bwd_reference(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    dv, dv32 = got[2], truth[2]
    big = dv32.abs() > 1.05 * F16_MAX
    small = dv32.abs() < 0.95 * F16_MAX
    assert big.any() and small.any()
    assert torch.isinf(dv[big]).all()
    assert torch.isfinite(dv[small]).all()
    assert torch.isinf(dv_plain[big]).all()
    for name, a, t in zip(("dq", "dk", "dv"), got, truth):
        over = t.abs() > 1.05 * F16_MAX
        assert not torch.isfinite(a[over]).any(), name


@pytest.mark.cuda
def test_flash_attention_f16_autograd_launches_b1_b2_b3(cuda):
    """The differentiable op in f16: B1 forward, B2 + B3 backward, grads
    within the tolerance of the plain versions'."""
    rng = np.random.default_rng(19)
    q, k, v, do, _ = _inputs(rng, 2, 256, 8, 2, 64, cuda, False)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = _build.launch_counts()
    o = flash_attention(*leaves)
    o.backward(do)
    counts = _build.launch_counts()
    ro = flash_attention(*ref_leaves, reference=True)
    ro.backward(do)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert counts[name] == before[name] + 1, name
    assert rel_l2(o, ro) <= TOL
    for a, b in zip(leaves, ref_leaves):
        assert a.grad.dtype == F16
        assert rel_l2(a.grad, b.grad) <= TOL


def _decode_inputs(rng, rep, D, bs, device):
    S, NB, MB, Nkv = 4, 20, 4, 2
    q = _randn(rng, (S, 1, Nkv * rep, D), device)
    kp = _randn(rng, (NB, Nkv, bs, D), device)
    vp = _randn(rng, (NB, Nkv, bs, D), device)
    kp[0] = vp[0] = 1e4                 # the trash block holds garbage
    row = (_randn(rng, (S, Nkv, 1, D), device),
           _randn(rng, (S, Nkv, 1, D), device))
    tables = torch.from_numpy(rng.permutation(np.arange(1, NB))[:S * MB]
                              .reshape(S, MB).astype(np.int32)).to(device)
    tables[0] = 0                       # the empty slot: an all-trash table
    lens = torch.tensor([0, 1, MB * bs // 2 + 3, MB * bs], dtype=torch.int32,
                        device=device)
    return q, kp, vp, tables, lens, row


@pytest.mark.cuda
@pytest.mark.parametrize("rep,D,bs", [(1, 128, 64), (8, 128, 64),
                                      (4, 64, 64), (2, 128, 24), (3, 64, 16)])
def test_paged_decode_f16_matches_plain(cuda, rep, D, bs):
    rng = np.random.default_rng(rep + D)
    q, kp, vp, tables, lens, row = _decode_inputs(rng, rep, D, bs, cuda)
    before = _build.PAGED_DECODE.launches
    got = paged_decode_attention(q, kp, vp, tables, lens, kv_row=row)
    again = paged_decode_attention(q, kp, vp, tables, lens, kv_row=row)
    ref = paged_decode_reference(q, kp, vp, tables, lens, kv_row=row)
    torch.cuda.synchronize()
    assert _build.PAGED_DECODE.launches == before + 2
    assert got.dtype == F16
    assert rel_l2(got, ref) <= TOL
    assert torch.equal(got, again)
    assert torch.equal(got[0, 0], row[1][0, :, 0].repeat_interleave(rep, 0))
