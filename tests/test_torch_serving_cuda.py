"""Serving breadth on the card: the watchdog's round thread issues on the
caller's stream, and the latency tier (prefix cache, chunked prefill)
leaves greedy f32 streams as the plain engine gives them through the CUDA
kernels. Every test here needs an NVIDIA GPU (marker ``cuda``) and skips
without one; this file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_serving_cuda.py
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import _build

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


def _srv(**serving):
    return deepspeed_tpu_torch.init_serving(
        _model(), config={"kv_cache_bits": 0},
        serving={**SERVING, **serving}, dtype=torch.float32, seed=3)


def _streams(outs):
    return [outs[k] for k in sorted(outs)]


@pytest.mark.cuda
def test_round_thread_issues_on_the_callers_stream(cuda):
    """Under dispatch_timeout_s the decode quantum runs on a thread; its
    kernels must go on the stream the caller's prefills went on (a
    thread's current stream is its own), and the greedy stream must be
    the one without a watchdog."""
    rng = np.random.default_rng(0)
    load = [(rng.integers(0, VOCAB, n).astype(np.int32), 20)
            for n in (70, 130, 9)]
    plain = _streams(_srv().run(list(load)))
    srv = _srv(dispatch_timeout_s=30.0)
    seen = []
    real = srv._quantum

    def spy(*args):
        seen.append(torch.cuda.current_stream().cuda_stream)
        return real(*args)

    srv._quantum = spy
    torch.cuda.synchronize()          # the pools' zero fill is done
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = _streams(srv.run(list(load)))
    torch.cuda.synchronize()
    assert len(seen) > 1 and set(seen) == {side.cuda_stream}
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b)
    assert srv.close()


@pytest.mark.cuda
def test_prefix_cache_and_chunks_keep_f32_streams(cuda):
    """A shared 200-token prefix, tails of 30-90 tokens, a retried
    prompt (a fork): with the cache and a 128-token budget the streams
    equal the plain engine's, the kernels ran (B1 for the whole prompts,
    B4 every decode step) and the pool holds only the cache's blocks."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, VOCAB, 200)
    prompts = [np.concatenate([shared, rng.integers(0, VOCAB, t)])
               .astype(np.int32) for t in (37, 90, 30, 61)]
    plain = _streams(_srv().run([(p, 16) for p in prompts]))
    srv = _srv(enable_prefix_cache=True, prefill_token_budget=128)
    first = srv.run([(prompts[0], 16)])
    srv.reset_stats()
    _build.reset_launch_counts()
    rest = srv.run([(p, 16) for p in prompts[1:]] + [(prompts[0], 16)])
    launches = _build.launch_counts()
    got = _streams(first) + _streams(rest)
    for i, (a, b) in enumerate(zip(got, plain + [plain[0]])):
        np.testing.assert_array_equal(a, b, err_msg=f"request {i}")
    st = srv.stats()
    assert st["prefix_hits"] >= 4 and st["cow_forks"] >= 1
    assert st["prefill_chunks"] >= 1
    assert launches["paged_decode"] >= 2 * st["decode_steps"] > 0
    assert srv.allocator.used_blocks == st["prefix_held_blocks"]


@pytest.mark.cuda
def test_generate_on_the_card(cuda):
    """One-shot generate on the card: B1 once per layer for the prefill,
    no paged decode, tokens equal to the paged engine's at f32."""
    eng = deepspeed_tpu_torch.init_inference(
        _model(), config={"kv_cache_bits": 0}, dtype=torch.float32, seed=3)
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, 100))
    _build.reset_launch_counts()
    out = eng.generate(ids, max_new_tokens=24).cpu().numpy()
    launches = _build.launch_counts()
    assert launches["flash_fwd"] == 2 and launches["paged_decode"] == 0
    srv = _srv()
    paged = _streams(srv.run([(p, 24) for p in ids]))
    np.testing.assert_array_equal(out, np.stack(paged))
