"""Multi-LoRA serving and the KV handoff on the card: a LoRA engine's
decode steps go through the paged decode kernel with the delta added
around it and give the CPU engine's f32 logits and streams; a bf16 KV
payload (shipped as its raw 2-byte view) lands in the receiver's pool
bit for bit; the payload geometry names the pool dtype as JAX does.
Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; this file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_lora_cuda.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.lora import make_random_adapter
from deepspeed_tpu_torch.inference.serving import ServingConfig, ServingEngine
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import _build

VOCAB = 512
SERVING = dict(max_seqs=4, block_size=64, max_model_len=512,
               decode_quantum=4)
LORA = dict(adapter_slots=4, lora_rank=8)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model(dtype=torch.float32):
    # head_dim 64: the flash and paged decode kernels' (tiny: hidden 256,
    # 4 heads)
    return tt.make_model(tt.llama_config("tiny", vocab_size=VOCAB,
                                         num_layers=2, max_seq_len=512,
                                         dtype=dtype))


def _host(params):
    return {k: ({n: t.cpu() for n, t in v.items()} if k == "layers"
                else v.cpu()) for k, v in params.items()}


def _lora_srv(device, params=None, **config):
    eng = init_inference(_model(), config={"kv_cache_bits": 0, **config},
                         params=params, dtype=torch.float32,
                         device=device, seed=3)
    srv = ServingEngine(eng, ServingConfig(**SERVING, **LORA))
    for a in (1, 2, 3):
        srv.register_adapter(a, make_random_adapter(
            eng.model.config, 8, seed=a, scale=0.2))
    return srv


def _streams(outs):
    return [outs[k] for k in sorted(outs)]


@pytest.mark.cuda
def test_lora_decode_on_the_card_matches_the_cpu(cuda):
    """A mixed batch {base, 1, 2, 3}: the LoRA decode step's logits on the
    card within 1e-4 of the CPU's (relative L2), and the served streams
    token-identical; every decode step ran B4 on every layer, and no
    prefill ran B1 (a LoRA engine prefills on the span path)."""
    rng = np.random.default_rng(0)
    load = [(rng.integers(0, VOCAB, n).astype(np.int32), 16, a)
            for n, a in ((70, 0), (130, 1), (9, 2), (40, 3))]
    gpu = _lora_srv(cuda)
    cpu = _lora_srv("cpu", params=_host(gpu.engine.params))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = _streams(gpu.run(list(load)))
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    st = gpu.stats()
    L = gpu.model.config.num_layers
    assert launches["paged_decode"] == L * st["decode_steps"] > 0
    assert launches.get("flash_fwd", 0) == 0 and st["prefills"] == 0
    assert st["adapter_page_ins"] == 3.0
    want = _streams(cpu.run(list(load)))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i}")
    # one decode step of all four slots at the served lengths, by hand
    logits = {}
    for name, srv in (("gpu", gpu), ("cpu", cpu)):
        S, MB, dev = 4, srv.MB, srv.device
        tab = torch.arange(1, S * MB + 1, dtype=torch.int32,
                           device=dev).reshape(S, MB)
        lens = torch.tensor([70, 130, 9, 40], dtype=torch.int32, device=dev)
        toks = torch.tensor([5, 6, 7, 8], device=dev)
        aidx = torch.tensor([0, srv.adapter_slots.slot_of(1),
                             srv.adapter_slots.slot_of(2),
                             srv.adapter_slots.slot_of(3)], device=dev)
        logits[name] = tt.decode_step_paged(
            srv.engine.params, toks, srv.model.config, srv.pools, tab, lens,
            lora=(srv.adapter_pool, aidx)).cpu()
    err = (logits["gpu"] - logits["cpu"]).norm() / logits["cpu"].norm()
    assert float(err) < 1e-4


@pytest.mark.cuda
def test_bf16_handoff_round_trip_is_bit_identical(cuda):
    """export_kv of a bf16 pool ships each leaf as its raw int16 view; the
    receiver's pool rows below the payload's row count equal the
    sender's, bit for bit, after the import (and after decoding on)."""
    rng = np.random.default_rng(1)
    eng = init_inference(_model(torch.bfloat16),
                         config={"kv_cache_bits": 0},
                         dtype=torch.bfloat16, device=cuda, seed=3)
    src = ServingEngine(eng, ServingConfig(**SERVING))
    dst = ServingEngine(eng, ServingConfig(**SERVING))
    rids = [src.add_request(rng.integers(0, VOCAB, n).astype(np.int32), 12)
            for n in (150, 61)]
    src.step()
    sent = {}
    for rid in rids:
        req = src._requests[rid]
        sent[rid] = {name: pool[:, req.block_ids].clone()
                     for name, pool in src.pools.items()}
    payloads = src.export_kv(rids)
    for rid in rids:
        pl = payloads[rid]
        assert pl["geometry"]["dtype"] == "bfloat16"
        assert {a.dtype for a in pl["data"].values()} == {np.dtype(np.int16)}
    recs = src.release_requests(rids)
    dst.accept_migration(recs, kv=payloads)
    dst.step()          # admission: the scatter, the tail span, a quantum
    assert dst.stats()["handoff_fallbacks"] == 0
    assert dst.stats()["handoffs"] == 2
    for rid in rids:
        req = dst._requests[rid]
        n, rows = payloads[rid]["blocks"], payloads[rid]["rows"]
        for name in ("k", "v"):
            def rows_of(t):       # [L, n, nkv, bs, hd] -> [L, nkv, rows, hd]
                L, _, nkv, bs, hd = t.shape
                t = t[:, :n].transpose(1, 2).reshape(L, nkv, n * bs, hd)
                return t[:, :, :rows].view(torch.int16)
            got = rows_of(dst.pools[name][:, req.block_ids[:n]])
            assert torch.equal(rows_of(sent[rid][name]), got)
    while not dst.scheduler.done:
        dst.step()
    assert dst.allocator.used_blocks == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,bits,names", [
    (torch.float32, 0, {"k": "float32", "v": "float32"}),
    (torch.bfloat16, 0, {"k": "int16", "v": "int16"}),
    (torch.float32, 8, {"k": "int8", "v": "int8", "k_scale": "float32",
                        "v_scale": "float32"}),
])
def test_geometry_names_the_pool_dtype_as_jax(cuda, dtype, bits, names):
    eng = init_inference(_model(dtype), config={"kv_cache_bits": bits},
                         dtype=dtype, device=cuda, seed=3)
    srv = ServingEngine(eng, ServingConfig(**SERVING))
    rid = srv.add_request(np.arange(80, dtype=np.int32) % VOCAB, 8)
    srv.step()
    pl = srv.export_kv([rid])[rid]
    want = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    assert pl["geometry"]["dtype"] == ("int8" if bits else want)
    assert pl["geometry"]["kv_bits"] == bits
    assert {k: str(a.dtype) for k, a in pl["data"].items()} == names
