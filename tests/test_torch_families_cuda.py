"""The model families' kernels on the card: B1-B3 bidirectional with a
key mask (the encoders' route) at head dims 64 and 128 against their plain
versions, a GPT-2-shaped and a GPT-Neo-shaped model served with their
launch counts (B1 on every prefill layer, B4 on every decode layer for
GPT-2; B1 on the global layers only and no B4 for GPT-Neo's windows), and
a head dim the kernels do not take (GPT-J's 256) raising on the card
instead of running a plain path. Every test here needs an NVIDIA GPU
(marker ``cuda``) and skips without one; this file imports neither jax nor
the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_families_cuda.py
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention_bwd, flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_reference)


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
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bidirectional_masked_flash_kernels_match_plain(cuda, D, dtype):
    """B1, B2 and B3 with ``causal=False`` and a [B, S] key mask (row 1's
    last 100 keys padded), B=2, S=384, 8 heads: O and dQ, dK, dV within
    2e-2 (bf16) / 1e-4 (f32) of the plain versions, bit for bit across
    two launches."""
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    g = torch.Generator(device=cuda).manual_seed(D)
    q, k, v, do = (torch.randn((2, 384, 8, D), generator=g, device=cuda,
                               dtype=dtype) for _ in range(4))
    mask = torch.ones((2, 384), dtype=torch.int32, device=cuda)
    mask[1, 284:] = 0
    kw = dict(causal=False, kv_mask=mask)
    o, lse = flash_attention_fwd(q, k, v, **kw)
    ro, _ = flash_attention_reference(q, k, v, **kw)
    assert rel_l2(o, ro) <= tol
    assert torch.equal(o, flash_attention_fwd(q, k, v, **kw)[0])
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, **kw)
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    for a, b, c in zip(got, want, again):
        assert rel_l2(a, b) <= tol
        assert torch.equal(a, c)


def _family(**kw):
    return tt.TransformerConfig(
        vocab_size=512, hidden_size=256, num_layers=2, num_heads=4,
        max_seq_len=256, activation="gelu", norm_type="layernorm",
        dtype=torch.float32, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gpt2", "gpt_neo"])
def test_family_serving_launch_counts(cuda, kind):
    """A GPT-2-shaped model (learned positions, every bias, D=64) served
    in f32: B1 = prefills x 2 layers, B4 = decode steps x 2. A
    GPT-Neo-shaped one (windows (0, 32), ``attn_scale`` 1.0): B1 on the
    global layer only, B4 = 0 (its decode reads the gathered view).
    ``forward`` through the kernels within 1e-4 of the plain versions."""
    neo = kind == "gpt_neo"
    cfg = _family(position_type="learned",
                  **(dict(qkv_bias=False, attn_out_bias=True,
                          attn_windows=(0, 32), attn_scale=1.0)
                     if neo else {}))
    srv = deepspeed_tpu_torch.init_serving(
        tt.make_model(cfg), config={"kv_cache_bits": 0},
        serving=dict(max_seqs=2, block_size=64, max_model_len=256),
        dtype=torch.float32, seed=0)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, 512, n).astype(np.int32), 8) for n in (40, 90)]
    srv.reset_stats()
    _build.reset_launch_counts()
    outs = srv.run(reqs)
    torch.cuda.synchronize()
    got = _build.launch_counts()
    st = srv.stats()
    assert len(outs) == 2 and st["prefills"] == 2
    global_layers = 1 if neo else 2
    assert got["flash_fwd"] == st["prefills"] * global_layers
    assert got["paged_decode"] == (0 if neo else st["decode_steps"] * 2)
    assert srv.decode_backend == ("xla" if neo else "pallas")
    params = srv.engine.params
    ids = torch.from_numpy(rng.integers(0, 512, (2, 100))).to(cuda)
    with torch.no_grad():
        k = tt.forward(params, ids, srv.engine.model.config)
        p = tt.forward(params, ids, srv.engine.model.config, reference=True)
    assert rel_l2(k, p) <= 1e-4


@pytest.mark.cuda
def test_head_dim_256_raises_on_the_card(cuda):
    """GPT-J's head dim 256 is none of the kernels' (64, 128): on the card
    its forward raises ``ValueError`` and runs no plain path (ROADMAP R7);
    on the CPU the plain versions take it."""
    cfg = tt.TransformerConfig(
        vocab_size=256, hidden_size=512, num_layers=1, num_heads=2,
        max_seq_len=64, position_type="rotary", rotary_dim=64,
        rotary_interleaved=True, parallel_block=True, activation="gelu",
        norm_type="layernorm", qkv_bias=False, tie_embeddings=False,
        head_bias=True, dtype=torch.float32)
    ids = torch.zeros((1, 16), dtype=torch.long)
    cpu = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.isfinite(tt.forward(cpu, ids, cfg)).all()
    card = tt.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                          cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tt.forward(card, ids.to(cuda), cfg)
