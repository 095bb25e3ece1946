"""Ring attention on the card: ``ring_attention_local`` over a gloo group
of 2 or 4 processes sharing the card (the "pairs" transport: a broadcast
over the group of each two ring neighbours), its pairs through B1
(merged in f32 by their LSE) and B2 / B3 (each given the merged O and
LSE), against one B1 / B2 / B3 call over the whole sequence, in bf16 and
f32; two calls bit for bit. Every test here needs an NVIDIA GPU (marker
``cuda``) and skips without one; this file imports neither jax nor the
JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_ring_cuda.py
"""

import math

import pytest
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                     flash_attention_fwd)
from deepspeed_tpu_torch.ops.ring_attention import ring_attention_local
from deepspeed_tpu_torch.parallel import MeshPlan, build_mesh
from deepspeed_tpu_torch.parallel.launch import run_group

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def rel_l2(got, want):
    got, want = got.double().ravel(), want.double().ravel()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _inputs(B, S, N, Nkv, D, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((B, S, N, D), generator=g, device="cuda",
                         dtype=dtype) for _ in range(2))
    k, v = (torch.randn((B, S, Nkv, D), generator=g, device="cuda",
                        dtype=dtype) for _ in range(2))
    return q, k, v, do


def _ring_rank(rank, world, dtype_name, shape, causal, seed, runs):
    """One rank of a seq=world ring over gloo on one card: the mesh's
    transport, this rank's B1 / B2 / B3 launches of one ring call, and
    (O, dQ, dK, dV) of its piece for each of ``runs`` calls."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, N, Nkv, D = shape
    q, k, v, do = _inputs(B, S, N, Nkv, D, getattr(torch, dtype_name),
                          seed=seed)
    mesh = build_mesh(MeshPlan(seq=world))
    Sl = S // world
    outs, launches = [], None
    for _ in range(runs):
        piece = [t[:, rank * Sl:(rank + 1) * Sl].clone().requires_grad_(True)
                 for t in (q, k, v)]
        _build.reset_launch_counts()
        o = ring_attention_local(*piece, causal=causal, mesh=mesh)
        o.backward(do[:, rank * Sl:(rank + 1) * Sl])
        torch.cuda.synchronize()
        launches = launches or _build.launch_counts()
        outs.append([o.detach().cpu()] + [p.grad.cpu() for p in piece])
    gathered = [None] * world
    dist.all_gather_object(gathered, (mesh.p2p, launches, outs))
    return gathered


def _ring(dtype, shape, P, causal, seed=0, runs=1):
    """The ring of P ranks (``ring_attention_local`` over a P-process gloo
    group sharing the card): every rank's (transport, launches, [[O, dQ,
    dK, dV] of its piece for each run])."""
    return run_group(_ring_rank, P, str(dtype)[6:], shape, causal, seed,
                     runs, timeout_s=300)


def _whole(ranks, run=0):
    """The ranks' pieces of run ``run`` put together: [O, dQ, dK, dV]."""
    return [torch.cat([r[2][run][i] for r in ranks], 1) for i in range(4)]


def _one_call(q, k, v, do, causal):
    """One B1 / B2 / B3 call over the whole sequence: (O, dQ, dK, dV)."""
    sm = 1.0 / math.sqrt(q.shape[-1])
    o, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm)
    return (o,) + tuple(flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=causal, sm_scale=sm))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("P,causal", [(2, True), (4, True), (2, False)])
def test_ring_pairs_match_one_call(cuda, dtype, P, causal):
    """The ring over P ranks (rank r of a causal ring runs r + 1 pairs,
    merged by LSE, and their B2 / B3 with the global O and LSE) against
    one call over the whole sequence: O and every grad within the dtype's
    tolerance; rank r launches B1, B2 and B3 r + 1 times (causal) or P."""
    shape = (2, 2048, 32, 8, 64)
    ranks = _ring(dtype, shape, P, causal)
    for r, (_, n, _) in enumerate(ranks):
        pairs = r + 1 if causal else P
        assert n["flash_fwd"] == n["flash_bwd_dq"] == \
            n["flash_bwd_dkv"] == pairs, (r, n)
    want = _one_call(*_inputs(*shape, dtype), causal)
    for name, a, b in zip(("o", "dq", "dk", "dv"), _whole(ranks), want):
        assert rel_l2(a, b.cpu()) <= TOL[dtype], name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ring_pairs_bitwise_repeat(cuda, dtype):
    """Two calls of the ring agree bit for bit (no atomics in B1-B3, a
    fixed merge and travel order)."""
    ranks = _ring(dtype, (1, 4096, 16, 4, 128), 2, True, seed=1, runs=2)
    assert all(torch.equal(x, y) for x, y in zip(_whole(ranks, 0),
                                                  _whole(ranks, 1)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_seq2_ring_over_gloo_matches_one_call(cuda, dtype):
    """Two processes sharing the card over gloo run the ring over the
    "pairs" transport; their O and grads, put together, equal one call
    over the whole sequence."""
    dt = getattr(torch, dtype)
    shape = (1, 2048, 32, 8, 64)
    ranks = _ring(dt, shape, 2, True, seed=2)
    assert [r[0] for r in ranks] == ["pairs", "pairs"]
    want = _one_call(*_inputs(*shape, dt, seed=2), True)
    for i, (got, w) in enumerate(zip(_whole(ranks), want)):
        assert rel_l2(got, w.cpu()) <= TOL[dt], i
