"""Sharded serving on the card: the flash forward (B1) and the paged
decode kernel (B4) at the head counts a rank sees under tensor and expert
parallelism (llama-7b at tp=2: 16 / 16 heads; Mixtral 8x7b at tp=1: 32 /
8, at tp=2: 16 / 4) against their plain versions, a gloo ``all_reduce``
of CUDA tensors across two processes sharing the card, and a 2-layer
tp=2 serving engine on the card whose greedy f32 streams equal tp=1's.
Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; this file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_tp_serving_cuda.py
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from deepspeed_tpu_torch import init_serving
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.decode_attention import (paged_decode_attention,
                                                      paged_decode_reference)
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention_fwd,
                                                     flash_attention_reference)
from deepspeed_tpu_torch.parallel import MeshPlan
from deepspeed_tpu_torch.parallel.launch import run_group

# (query heads, kv heads) a rank holds
SHARD_HEADS = {"llama-7b tp=2": (16, 16), "mixtral tp=1": (32, 8),
               "mixtral tp=2": (16, 4)}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_l2(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("heads", sorted(SHARD_HEADS))
def test_flash_fwd_at_shard_heads(cuda, heads):
    Nq, Nkv = SHARD_HEADS[heads]
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((1, 512, Nq, 128), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    k = torch.randn((1, 512, Nkv, 128), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    o, lse = flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = flash_attention_reference(q, k, v, causal=True)
    assert rel_l2(o, ro) < 2e-2
    assert rel_l2(lse, rlse) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("heads", sorted(SHARD_HEADS))
def test_paged_decode_at_shard_heads(cuda, heads):
    """16 slots at the serving geometry (block 64), lengths up to 1000."""
    Nq, Nkv = SHARD_HEADS[heads]
    S, bs, MB, D = 16, 64, 16, 128
    g = torch.Generator(device=cuda).manual_seed(2)
    pool_k = torch.randn((S * MB + 1, Nkv, bs, D), generator=g, device=cuda,
                         dtype=torch.bfloat16)
    pool_v = torch.randn_like(pool_k)
    tables = torch.arange(1, S * MB + 1, dtype=torch.int32,
                          device=cuda).reshape(S, MB)
    lens = torch.randint(1, 1000, (S,), generator=g, device=cuda,
                         dtype=torch.int32)
    q = torch.randn((S, 1, Nq, D), generator=g, device=cuda,
                    dtype=torch.bfloat16)
    row = (torch.randn((S, Nkv, 1, D), generator=g, device=cuda,
                       dtype=torch.bfloat16),) * 2
    got = paged_decode_attention(q, pool_k, pool_v, tables, lens, kv_row=row)
    want = paged_decode_reference(q, pool_k, pool_v, tables, lens,
                                  kv_row=row)
    assert rel_l2(got, want) < 2e-2


def _all_reduce_on_card(rank, world):
    torch.cuda.set_device(0)
    x = torch.full((1024,), float(rank + 1), device="cuda")
    dist.all_reduce(x)
    y = torch.arange(8, device="cuda", dtype=torch.int64) * (rank + 1)
    dist.broadcast(y, 0)
    return x.cpu(), y.cpu()


@pytest.mark.cuda
def test_gloo_all_reduce_of_cuda_tensors(cuda):
    """Two processes sharing the card, one gloo group: all_reduce and
    broadcast take CUDA tensors (the collectives sharded serving uses)."""
    x, y = run_group(_all_reduce_on_card, 2, timeout_s=120)
    assert torch.equal(x, torch.full((1024,), 3.0))
    assert torch.equal(y, torch.arange(8))


VOCAB = 512
SERVING = dict(max_seqs=4, block_size=64, max_model_len=512,
               decode_quantum=4)


def _streams(outs):
    return [np.asarray(outs[k]) for k in sorted(outs)]


def _serve_tp2(rank, world, load):
    """tp=2 on the card (both ranks on cuda:0), then tp=1 on rank 0."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = tt.make_model(tt.llama_config("tiny", vocab_size=VOCAB,
                                          num_layers=2, max_seq_len=512,
                                          dtype=torch.float32))
    srv = init_serving(model, config={"kv_cache_bits": 0},
                       serving=SERVING, dtype=torch.float32, seed=3,
                       mesh=MeshPlan(tensor=2))
    if rank:
        srv.run_worker()
        return None
    _build.reset_launch_counts()
    tp2 = _streams(srv.run(list(load)))
    launches = _build.launch_counts()
    st = srv.stats()
    srv.close()
    one = init_serving(model, config={"kv_cache_bits": 0}, serving=SERVING,
                       dtype=torch.float32, seed=3)
    return {"tp2": tp2, "tp1": _streams(one.run(list(load))),
            "launches": launches, "prefills": st["prefills"],
            "decode_steps": st["decode_steps"],
            "pool_law": st["pool_bytes"] * 2 == st["pool_bytes_logical"]}


@pytest.mark.cuda
def test_tp2_serving_stream_equals_tp1_on_card(cuda):
    """A 2-layer llama (tiny width, head_dim 64) at tp=2, two processes on
    one card over gloo: greedy f32 streams equal the tp=1 engine's, and
    rank 0's kernels ran for every prefill and decode step."""
    _build.build([_build.FLASH_FWD, _build.PAGED_DECODE])  # before spawning
    rng = np.random.default_rng(4)
    load = [(rng.integers(0, VOCAB, size=(n,)).astype(np.int32), 12)
            for n in (30, 70, 130, 9, 200)]
    r = run_group(_serve_tp2, 2, load, timeout_s=300)
    assert len(r["tp2"]) == len(load)
    for i, (a, b) in enumerate(zip(r["tp2"], r["tp1"])):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    assert r["pool_law"]
    assert r["launches"]["flash_fwd"] == r["prefills"] * 2
    assert r["launches"]["paged_decode"] == r["decode_steps"] * 2
