"""The training extras on the card: compression's quantile past 2^24
values against a float64 sort (and its masks against the CPU's), a
random-LTD layer and a progressive-layer-drop stack through B1-B3
against the plain versions with their launch counts, and the eigenvalue
probe's launches (two gradient passes a Hessian-vector product, each
through B1-B3). Every test here needs an NVIDIA GPU (marker ``cuda``)
and skips without one; this file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_training_extras_cuda.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.compression import compress
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime import data_pipeline, quantize

FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_l2(got, want) -> float:
    got, want = got.double().ravel(), want.double().ravel()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _model(cuda, layers, dtype, **over):
    cfg = tt.llama_config("tiny", num_layers=layers, hidden_size=256,
                          num_heads=4, num_kv_heads=2, intermediate_size=512,
                          vocab_size=512, max_seq_len=512, dtype=dtype,
                          **over)
    gen = torch.Generator(device=cuda).manual_seed(layers)
    params = tt.init_params(cfg, gen, cuda, dtype=dtype)
    return cfg, params


@pytest.mark.cuda
def test_quantile_past_2_pow_24_matches_float64_sort(cuda):
    """2^24 + 1000 values (torch.quantile refuses them): the port's
    quantile equals JAX's f32 position over a float64 sort of the same
    values, and the sparse and row masks of a stacked leaf equal the
    CPU's."""
    n = 2 ** 24 + 1000
    g = torch.Generator(device=cuda).manual_seed(0)
    a = torch.rand(n, generator=g, device=cuda)
    srt = np.sort(a.cpu().double().numpy())
    for q in (0.5, 0.3, 0.9):
        pos = np.float32(q) * (np.float32(n) - np.float32(1.0))
        lo, hi = int(np.floor(pos)), int(np.ceil(pos))
        hw = np.float32(pos - np.floor(pos))
        want = np.float32(np.float32(srt[lo]) * np.float32(1.0 - hw)
                          + np.float32(srt[hi]) * hw)
        assert float(compress.quantile(a, q)) == float(want), q
    w = torch.randn((4, 256, 192), generator=g, device=cuda)
    for fn in (compress._topk_mask, compress._row_mask,
               compress._channel_mask):
        assert torch.equal(fn(w, 0.5).cpu(), fn(w.cpu(), 0.5)), fn.__name__
    assert torch.equal(compress._head_mask(w, 0.5, 4).cpu(),
                       compress._head_mask(w.cpu(), 0.5, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_random_ltd_layer_through_b1_b3(cuda, dtype):
    """One layer on 100 of 260 tokens (S = 100 for B1-B3: off every tile)
    with a key mask: the output and the grads of x and of every weight
    within 2e-2 (bf16) / 1e-4 (f32) of the plain versions; B1, B2, B3
    each launched once."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    cfg, params = _model(cuda, 1, dtype)
    lp = {k: v[0] for k, v in params["layers"].items()}
    B, S, keep = 2, 260, 100
    g = torch.Generator(device=cuda).manual_seed(1)
    x0 = torch.randn((B, S, cfg.hidden_size), generator=g, device=cuda,
                     dtype=dtype)
    mask = torch.ones((B, S), dtype=torch.int32, device=cuda)
    mask[1, 200:] = 0
    sel = torch.from_numpy(data_pipeline.ltd_selection(
        (0, 0, 0, 1), B, S, keep)).to(cuda)
    pos = torch.arange(S, device=cuda)[None].expand(B, S)
    out = {}
    for ref in (False, True):
        x = x0.clone().requires_grad_(True)
        w = {k: v.detach().clone().requires_grad_(True)
             for k, v in lp.items()}

        def layer(xs, positions=None, mask=None, w=w, ref=ref):
            return tt.transformer_layer(xs, w, cfg, positions=positions,
                                        mask=mask, reference=ref)
        _build.reset_launch_counts()
        y = data_pipeline.random_ltd_layer(x, layer, sel, positions=pos,
                                           mask=mask)[0]
        grads = torch.autograd.grad((y.float() ** 2).sum(),
                                    [x] + list(w.values()))
        out[ref] = (y.detach(), grads, _build.launch_counts())
    (yk, gk, lk), (yp, gp, lp_) = out[False], out[True]
    assert {k: lk[k] for k in FLASH} == dict.fromkeys(FLASH, 1)
    assert all(lp_[k] == 0 for k in FLASH)
    assert rel_l2(yk, yp) <= tol
    for a, b in zip(gk, gp):
        assert rel_l2(a, b) <= tol
    kept = torch.zeros((B, S), dtype=torch.bool, device=cuda)
    kept.scatter_(1, sel, True)
    assert torch.equal(yk[~kept], x0[~kept])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pld_stack_through_b1_b3(cuda, dtype):
    """4 layers under dots_saveable with layers 1 and 2 dropped: the loss
    and its grads within 2e-2 (bf16) / 1e-4 (f32) of the plain versions;
    B1 = 2 x 2 kept layers (the replay), B2 = B3 = 2."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    cfg, params = _model(cuda, 4, dtype, remat=True,
                         remat_policy="dots_saveable",
                         progressive_layer_drop=True)
    ids = torch.randint(0, 512, (2, 384), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(2))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    out = {}
    for ref in (False, True):
        _build.reset_launch_counts()
        loss = tt.lm_loss(params, {"input_ids": ids}, cfg, reference=ref,
                          train=True, pld_theta=0.5,
                          pld_keep=[True, False, False, True])
        grads = torch.autograd.grad(loss, leaves)
        out[ref] = (loss.detach(), grads, _build.launch_counts())
    (lk, gk, ck), (lp, gp, cp) = out[False], out[True]
    assert (ck["flash_fwd"], ck["flash_bwd_dq"], ck["flash_bwd_dkv"]) == \
        (4, 2, 2)
    assert all(cp[k] == 0 for k in FLASH)
    assert abs(float(lk) - float(lp)) <= tol * abs(float(lp))
    total = float(torch.sqrt(sum(g.double().square().sum() for g in gp)))
    for a, b in zip(gk, gp):
        err = float((a.double() - b.double()).norm()
                    / max(float(b.double().norm()), 1e-3 * total))
        assert err <= tol


@pytest.mark.cuda
def test_eigenvalue_probe_launches(cuda):
    """MoQ's probe on 2 f32 layers (dots_saveable), 2 power iterations:
    (2 + 1) Hessian-vector products x 2 gradient passes, each launching
    B1 twice a layer (the replay) and B2 / B3 once; the per-layer
    eigenvalues within 1e-3 of the same probe through the plain
    versions."""
    cfg, params = _model(cuda, 2, torch.float32, remat=True,
                         remat_policy="dots_saveable")
    batch = {"input_ids": torch.randint(
        0, 512, (2, 256), device=cuda,
        generator=torch.Generator(device=cuda).manual_seed(3))}
    moq = quantize.MoQ({"eigenvalue": {"enabled": True, "max_iter": 2}}, 2)
    out = {}
    for ref in (False, True):
        _build.reset_launch_counts()
        evs = moq.layer_eigenvalues(
            lambda p, b, ref=ref: tt.lm_loss(p, b, cfg, reference=ref),
            params, batch,
            generator=torch.Generator(device=cuda).manual_seed(4))
        out[ref] = (evs, _build.launch_counts())
    passes = 2 * (2 + 1)
    (ek, ck), (ep, cp) = out[False], out[True]
    assert (ck["flash_fwd"], ck["flash_bwd_dq"], ck["flash_bwd_dkv"]) == \
        (2 * 2 * passes, 2 * passes, 2 * passes)
    assert all(cp[k] == 0 for k in FLASH)
    assert np.all(np.isfinite(ek)) and np.all(ek > 0)
    assert np.max(np.abs(ek - ep) / ep) <= 1e-3, (ek, ep)
