"""The resumable trainer on the card: an async checkpoint round trip and
the ``offload_dots`` remat policy, through the CUDA kernels. Every test
here needs an NVIDIA GPU (marker ``cuda``) and skips without one; this
file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_checkpoint_cuda.py

Both checks are bit for bit: a resume and an offload change where state
lives, not what is computed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.optimizers import tree_leaves
from deepspeed_tpu_torch.runtime.checkpointing import flatten
from deepspeed_tpu_torch.runtime.dataloader import (DataLoader,
                                                    RepeatingLoader,
                                                    random_token_batches)

VOCAB, S, B = 512, 128, 4


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _cfg(**kw):
    # head_dim 64: the flash kernels' (tiny: hidden 256, 4 heads)
    return tt.llama_config("tiny", vocab_size=VOCAB, num_layers=2,
                           max_seq_len=S, **kw)


def _bits(t):
    t = t.detach()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.cuda
def test_async_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """bf16 with f32 masters, the loop with prefetch: 2 steps, an async
    save, a step while the write is in flight, the wait, 1 more step. A
    fresh engine loads `latest` and takes the same 2 steps: losses and
    the whole state equal, bit for bit, and the kernels ran."""
    rows = [{"input_ids": r} for r in next(
        random_token_batches(32, S, VOCAB, 1, seed=0))["input_ids"]]
    config = {"train_batch_size": B,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
              "pipeline": {"in_flight": 2, "prefetch": True},
              "checkpoint": {"async_save": True}}
    cfg = _cfg(remat=True, remat_policy="dots_with_no_batch_dims")

    def engine():
        e, *_ = deepspeed_tpu_torch.initialize(model=tt.make_model(cfg),
                                               config=dict(config))
        loader = RepeatingLoader(DataLoader(rows, batch_size=B, shuffle=True,
                                            seed=1))
        e.attach_dataloader(loader)
        return e, loader

    e1, ld1 = engine()
    e1.train_batches(ld1, 2)
    e1.save_checkpoint(str(tmp_path))
    _build.reset_launch_counts()
    want = [e1.train_batches(ld1, 1)["loss"]]
    e1.wait_checkpoint()
    want.append(e1.train_batches(ld1, 1)["loss"])
    assert _build.launch_counts()["flash_bwd_dq"] == 2 * cfg.num_layers

    e2, ld2 = engine()
    e2.load_checkpoint(str(tmp_path))
    got = [e2.train_batches(ld2, 1)["loss"] for _ in range(2)]
    assert [float(x) for x in got] == [float(x) for x in want]
    a, b = flatten(e1.state), flatten(e2.state)
    assert set(a) == set(b)
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(_bits(v), _bits(b[k])), k
        else:
            assert v == b[k], k
    assert e2.global_steps == e1.global_steps == 4
    assert ld2.state_dict() == ld1.state_dict()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_offload_dots_grads_equal_dots_with_no_batch_dims(cuda, dtype):
    """The matmul outputs kept in pinned host memory come back bit for
    bit, so the grads are those of the policy that keeps them on the
    card; both replay B1."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = tt.init_params(_cfg(), gen, cuda, dtype=dtype)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, VOCAB, (B, S))).to(cuda)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    out = {}
    for policy in ("dots_with_no_batch_dims", "offload_dots"):
        cfg = dataclasses.replace(_cfg(dtype=dtype), remat=True,
                                  remat_policy=policy)
        _build.reset_launch_counts()
        loss = tt.lm_loss(params, {"input_ids": ids}, cfg)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        out[policy] = (loss.detach(), grads, _build.launch_counts())
    (l1, g1, n1), (l2, g2, n2) = out.values()
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        assert torch.equal(_bits(a), _bits(b))
    assert n1 == n2 and n1["flash_fwd"] == 2 * 2   # forward + replay
