"""Quantized and speculative decode on the card: int8 KV pools and
speculation serve without the paged decode kernel (an int8 pool and a
verify span read plain torch ops, as JAX's do), the exact int8 x int8
contraction gives the CPU's integer result past 2^24, and int8 weights
give the CPU's logits. Every test here needs an NVIDIA GPU (marker
``cuda``) and skips without one; this file imports neither jax nor the
JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_quantized_cuda.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.serving import ServingConfig, ServingEngine
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.quantizer import int8_matmul

VOCAB = 512
SERVING = dict(max_seqs=2, block_size=64, max_model_len=512,
               decode_quantum=4)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _model():
    # head_dim 64: the flash and paged decode kernels' (tiny: hidden 256,
    # 4 heads)
    return tt.make_model(tt.llama_config("tiny", vocab_size=VOCAB,
                                         num_layers=2, max_seq_len=512,
                                         dtype=torch.float32))


def _engine(device, **config):
    return init_inference(_model(), config=config, dtype=torch.float32,
                          device=device, seed=3)


def _streams(outs):
    return [outs[k] for k in sorted(outs)]


def _motif_load(rng, n=3, new=24):
    """Prompts of a repeated motif plus a random tail (the n-gram
    proposer's home traffic)."""
    out = []
    for _ in range(n):
        motif = rng.integers(0, VOCAB, 12)
        out.append((np.concatenate([np.tile(motif, 6),
                                    rng.integers(0, VOCAB, 5)])
                    .astype(np.int32), new))
    return out


def _host(params):
    return {k: ({n: t.cpu() for n, t in v.items()} if k == "layers"
                else v.cpu()) for k, v in params.items()}


def _run_counted(srv, load):
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    outs = srv.run(list(load))
    torch.cuda.synchronize()
    return _streams(outs), _build.launch_counts(), srv.stats()


@pytest.mark.cuda
def test_int8_pool_serves_without_the_decode_kernel(cuda):
    """An int8 pool (asked for: the 512-token cap is below the default's
    1024), greedy f32 streams on the card: the first p + 4 tokens of each
    equal the CPU int8 engine's and > 0.9 of all tokens agree (JAX's int8
    bar); the prefill runs B1 on every layer, B4 never runs."""
    rng = np.random.default_rng(0)
    load = [(rng.integers(0, VOCAB, n).astype(np.int32), 20)
            for n in (70, 130, 9)]
    eng = _engine(cuda, kv_cache_bits=8)
    srv = ServingEngine(eng, ServingConfig(**SERVING))
    assert srv.pools["k"].dtype == torch.int8
    assert srv.decode_backend == "xla"
    got, launches, st = _run_counted(srv, load)
    L = eng.model.config.num_layers
    assert launches.get("paged_decode", 0) == 0
    assert launches["flash_fwd"] == L * st["prefills"] > 0
    assert st["decode_steps"] > 0
    cpu = ServingEngine(
        init_inference(_model(), config={"kv_cache_bits": 8},
                       params=_host(eng.params), dtype=torch.float32,
                       device="cpu"), ServingConfig(**SERVING))
    want = _streams(cpu.run(list(load)))
    for (p, _), g, w in zip(load, got, want):
        assert (g[:p.size + 4] == w[:p.size + 4]).all()
        assert (g == w).mean() > 0.9


@pytest.mark.cuda
def test_speculation_serves_without_the_decode_kernel(cuda):
    """K = 3 on a float pool and on an int8 pool, proposals from an
    oracle draft hook (the spec-off continuation, so some are accepted
    whatever the random model emits): the spec-off stream token for token
    on the float pool (f32), JAX's int8 bar on the int8 pool; every
    decoding round is one verify step on the span path, so B4 never runs
    while B1 runs every prefill."""
    load = _motif_load(np.random.default_rng(1))
    for bits in (0, 8):
        eng = _engine(cuda, kv_cache_bits=bits)
        off, off_launches, off_st = _run_counted(
            ServingEngine(eng, ServingConfig(**SERVING)), load)
        # the prompts' first 12 tokens (one motif each) tell them apart
        oracle = {tuple(p[:12].tolist()): o for (p, _), o in zip(load, off)}

        def draft(ctx, k):
            o = oracle[tuple(np.asarray(ctx)[:12].tolist())]
            return o[ctx.size:ctx.size + k]

        srv = ServingEngine(eng, ServingConfig(**SERVING, spec_tokens=3,
                                               spec_proposer=draft))
        on, launches, st = _run_counted(srv, load)
        L = eng.model.config.num_layers
        assert launches.get("paged_decode", 0) == 0
        assert launches["flash_fwd"] == L * st["prefills"] > 0
        assert st["decode_steps"] == 0 and st["verify_steps"] > 0
        assert off_launches.get("paged_decode", 0) == (
            L * off_st["decode_steps"] if bits == 0 else 0)
        for (p, _), g, w in zip(load, on, off):
            if bits == 0:
                np.testing.assert_array_equal(g, w)
            else:
                assert (g[:p.size + 4] == w[:p.size + 4]).all()
                assert (g == w).mean() > 0.9
        assert st["spec_accepted"] > 0
        assert srv.allocator.used_blocks == 0


@pytest.mark.cuda
@pytest.mark.parametrize("tf32", [False, True])
def test_int8_contractions_are_exact_on_the_card(cuda, tf32):
    """The score and PV contractions at Tp = 2048 rows (the serving
    geometry: 32 blocks of 64), int8 operands up to +-127 so the PV sums
    pass 2^24: the card's result equals the CPU's integer matmul exactly,
    with TF32 off and on."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        g = torch.Generator().manual_seed(0)
        q = torch.randint(-127, 128, (4, 8, 4, 128), generator=g,
                          dtype=torch.int8)
        k = torch.randint(-127, 128, (4, 8, 2048, 128), generator=g,
                          dtype=torch.int8)
        p = torch.randint(0, 128, (4, 8, 4, 2048), generator=g,
                          dtype=torch.int8)
        p[0, 0, 0] = 127
        v = torch.randint(-127, 128, (4, 8, 2048, 128), generator=g,
                          dtype=torch.int8)
        v[0, 0, :, 0] = 127
        for a, b in ((q, k.transpose(-1, -2)), (p, v)):
            want = torch.matmul(a.long(), b.long())
            got = int8_matmul(a.to(cuda), b.to(cuda))
            assert got.dtype == torch.int32
            assert torch.equal(got.cpu().long(), want)
        assert int(torch.matmul(p.long(), v.long()).max()) > 2 ** 24
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["weight_bits", "quantize_bits"])
def test_int8_weights_on_the_card_match_the_cpu(cuda, mode):
    """The same float weights quantized on the card and on the CPU: the
    same int8 payloads, forward logits within 1e-4; serving keeps B4 on
    every decode step (float pool)."""
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, 64))
    host = _host(_engine(cuda, kv_cache_bits=0).params)
    config = {"kv_cache_bits": 0, mode: 8}
    gpu = init_inference(_model(), config=config, params=host,
                         dtype=torch.float32, device=cuda)
    cpu = init_inference(_model(), config=config, params=host,
                         dtype=torch.float32, device="cpu")
    wq = gpu.params["layers"]["wq"]
    assert wq["q"].dtype == torch.int8
    assert torch.equal(wq["q"].cpu(), cpu.params["layers"]["wq"]["q"])
    got, want = gpu.forward(ids).cpu(), cpu.forward(ids)
    assert float((got - want).norm() / want.norm()) < 1e-4
    srv = ServingEngine(gpu, ServingConfig(**SERVING))
    _, launches, st = _run_counted(srv, [(ids[0][:40].astype(np.int32), 12)])
    L = gpu.model.config.num_layers
    assert launches["paged_decode"] == L * st["decode_steps"] > 0
    assert st["weight_bits"] == (8 if mode == "weight_bits" else 0)
