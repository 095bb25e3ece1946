"""Multi-rank training on the card: every collective of the comm facade on
CUDA tensors over a two-process gloo group sharing the card, ZeRO-3's
gather / scatter pair against the plain whole-leaf product, and a 2-layer
engine whose ZeRO stages 1-3 equal stage 0 with the attention kernels
running on every rank. Every test here needs an NVIDIA GPU (marker
``cuda``) and skips without one; this file imports neither jax nor the
JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_zero_cuda.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.comm.compressed import compressed_allreduce_1bit
from deepspeed_tpu_torch.parallel import MeshPlan, build_mesh
from deepspeed_tpu_torch.parallel import context as par_ctx
from deepspeed_tpu_torch.parallel.launch import run_group


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _collectives(rank, world):
    """Each facade collective on CUDA tensors; (name, max |error|, the
    output's device) a row."""
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    mesh = build_mesh(MeshPlan(data=2))
    x = (torch.arange(24, dtype=torch.float32, device=dev).reshape(4, 6)
         + 100 * rank)
    both = [torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * r
            for r in range(2)]
    out = []
    with par_ctx.parallel_context(mesh):
        def check(name, got, want):
            out.append((name, float((got.cpu() - want).abs().max()),
                        str(got.device)))

        check("all_reduce", comm.all_reduce(x.clone(), "data"),
              both[0] + both[1])
        check("all_reduce_max", comm.all_reduce(x.clone(), "data",
                                                op="max"), both[1])
        check("all_reduce_mean", comm.all_reduce(x.clone(), "data",
                                                 op="mean"),
              (both[0] + both[1]) / 2)
        check("all_gather_dim0", comm.all_gather(x, "data", dim=0),
              torch.cat(both, 0))
        check("all_gather_dim1", comm.all_gather(x, "data", dim=1),
              torch.cat(both, 1))
        check("reduce_scatter_dim0", comm.reduce_scatter(x, "data", dim=0),
              (both[0] + both[1])[2 * rank:2 * rank + 2])
        check("reduce_scatter_dim1", comm.reduce_scatter(x, "data", dim=1),
              (both[0] + both[1])[:, 3 * rank:3 * rank + 3])
        check("broadcast", comm.broadcast(x.clone(), "data", src_index=1),
              both[1])
        packed = torch.full((5,), 3 + rank, dtype=torch.uint8, device=dev)
        check("all_gather_uint8",
              comm.all_gather(packed[None], "data").float(),
              torch.tensor([[3.0] * 5, [4.0] * 5]))
        y = torch.linspace(-1, 1, 11, device=dev) * (rank + 1)
        scales = torch.tensor([y.abs().mean().item() / (rank + 1) * (r + 1)
                               for r in range(2)])
        signs = torch.where(torch.linspace(-1, 1, 11) >= 0, 1.0, -1.0)
        check("compressed_allreduce_1bit",
              compressed_allreduce_1bit(y, "data"), signs * scales.mean())
    return out


@pytest.mark.cuda
def test_facade_collectives_on_cuda_tensors(cuda):
    rows = run_group(_collectives, 2, timeout_s=120)
    assert len(rows) == 10
    for name, err, dev in rows:
        assert err <= 1e-6 and dev.startswith("cuda"), (name, err, dev)


def _gather_scatter(rank, world):
    """ZeRO-3's pair on a [64, 48] leaf cut over fsdp along dim 0: the
    gathered leaf and this rank's grad shard of sum((x_r @ W)^2)."""
    from deepspeed_tpu_torch.runtime.zero import GatherShard
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    mesh = build_mesh(MeshPlan(fsdp=2))
    g = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((64, 48), generator=g, device=dev)
    xs = [torch.randn((8, 64), generator=g, device=dev) for _ in range(2)]
    shard = w[32 * rank:32 * rank + 32].clone().requires_grad_(True)
    with par_ctx.parallel_context(mesh):
        whole = GatherShard.apply(shard, ("fsdp",), 0, mesh)
        y = xs[rank] @ whole
        (grad,) = torch.autograd.grad(y.square().sum(), shard)
    w_plain = w.clone().requires_grad_(True)
    total = sum((x @ w_plain).square().sum() for x in xs)
    (want,) = torch.autograd.grad(total, w_plain)
    return [float((y - xs[rank] @ w).abs().max()),
            float(((grad - want[32 * rank:32 * rank + 32]).norm()
                   / want.norm()))]


@pytest.mark.cuda
def test_stage3_gather_scatter_grads_match_whole_leaf(cuda):
    fwd_err, grad_rel = run_group(_gather_scatter, 2, timeout_s=120)
    assert fwd_err <= 1e-5 and grad_rel <= 1e-6


def _stages(rank, world):
    """A 2-layer llama (head_dim 64, the kernels' width) at f32 on the
    card, ZeRO stages 0-3, 3 steps each: the losses and the attention
    kernels' launches of each stage."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tt
    from deepspeed_tpu_torch.ops import _build
    torch.cuda.set_device(0)
    cfg = tt.llama_config("tiny", num_layers=2, hidden_size=256,
                          num_heads=4, num_kv_heads=2, vocab_size=512,
                          max_seq_len=256, dtype=torch.float32)
    ids = np.random.default_rng(0).integers(0, 512, (4, 256), dtype=np.int32)
    out = {}
    for stage in range(4):
        e, *_ = deepspeed_tpu_torch.initialize(
            model=tt.make_model(cfg), config={
                "train_batch_size": 4, "bf16": {"enabled": False},
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
                "zero_optimization": {
                    "stage": stage, "stage3_param_persistence_threshold": 0},
                "seed": 0})
        _build.reset_launch_counts()
        losses = [float(e.train_batch({"input_ids": ids})["loss"])
                  for _ in range(3)]
        out[stage] = (losses, _build.launch_counts())
    return out


@pytest.mark.cuda
def test_zero_stages_train_alike_on_the_card(cuda):
    out = run_group(_stages, 2, timeout_s=300)
    for stage in (1, 2, 3):
        np.testing.assert_allclose(out[stage][0], out[0][0], rtol=1e-5)
    for losses, launches in out.values():
        assert launches["flash_fwd"] >= 3 * 2 and \
            launches["flash_bwd_dq"] == launches["flash_bwd_dkv"] == 3 * 2
