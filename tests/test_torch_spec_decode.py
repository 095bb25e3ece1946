"""The port's speculative decoding against the JAX package at f32: the
n-gram proposer and the greedy accept rule against JAX's; speculative
streams token-identical to the port's own spec-off streams and to JAX's
spec-off streams on JAX's test loads (the reference is JAX's spec-off
engine, held to its own spec-on stream by JAX's tests); an oracle draft
hook, the context
cap, and the prefix cache + chunked prefill + speculation composed; the
config gates. A verify step replaces the decode quantum, so the paged
decode kernel never runs under speculation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import spec_decode as jspec
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.inference import spec_decode as pspec
from deepspeed_tpu_torch.models import transformer as pt

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

# tests/unit/test_spec_decode.py's _cfg and _serving, at f32
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=256, position_type="rotary",
           activation="silu_glu", norm_type="rmsnorm", tie_embeddings=False)
SERVING = dict(max_seqs=2, block_size=16, max_model_len=128,
               decode_quantum=4, prompt_bucket=16)


@pytest.fixture(scope="module")
def params():
    jm = jt.make_model(jt.TransformerConfig(**CFG, dtype=jnp.float32,
                                            attention_impl="xla"))
    return jax.tree.map(np.asarray,
                        jax.device_get(jm.init(jax.random.PRNGKey(0))))


def _jax_srv(params, **serving):
    jm = jt.make_model(jt.TransformerConfig(**CFG, dtype=jnp.float32,
                                            attention_impl="xla"))
    return deepspeed_tpu.init_serving(jm, config={},
                                      serving={**SERVING, **serving},
                                      dtype=jnp.float32, params=params)


def _port_srv(params, **serving):
    pm = pt.make_model(pt.TransformerConfig(**CFG, dtype=torch.float32))
    return deepspeed_tpu_torch.init_serving(
        pm, config={}, serving={**SERVING, **serving}, params=params,
        dtype=torch.float32, device="cpu")


def _repetitive_load(rng, n=3):
    """JAX's ``_repetitive_load``: prompts of repeated motifs."""
    reqs = []
    for _ in range(n):
        motif = rng.integers(0, 128, size=(4,)).astype(np.int32)
        prompt = np.concatenate([motif, motif, motif,
                                 rng.integers(0, 128, size=(3,))
                                 .astype(np.int32)])
        reqs.append((prompt, 10))
    return reqs


def _count_decode_steps(srv):
    """Wrap the model's single-token decode step (the paged decode
    kernel's only caller) with a call counter."""
    calls = [0]
    inner = srv.model.decode_step_paged

    def counted(*args, **kwargs):
        calls[0] += 1
        return inner(*args, **kwargs)
    srv.model = dataclasses.replace(srv.model, decode_step_paged=counted)
    return calls


# ---------------------------------------------------------------------------
# proposer and accept rule
# ---------------------------------------------------------------------------

CONTEXTS = {
    "recent-wins": ([1, 2, 9, 9, 1, 2, 7, 8, 1, 2], 2, 3),
    "no-match": ([5, 6, 7, 8, 9], 3, 4),
    "short": ([4], 3, 2),
    "two": ([4, 4], 3, 2),
    "truncated": ([3, 1, 2, 3, 1], 2, 5),
    "self-overlap": ([7, 7, 7, 7], 2, 3),
}


@pytest.mark.parametrize("case", sorted(CONTEXTS))
def test_ngram_proposer_matches_jax(case):
    ctx, n, k = CONTEXTS[case]
    ctx = np.asarray(ctx, np.int32)
    want = jspec.NgramProposer(n).propose(ctx, k)
    got = pspec.NgramProposer(n).propose(ctx, k)
    assert got.dtype == want.dtype and got.shape == (k,)
    np.testing.assert_array_equal(got, want)


def test_ngram_proposer_random_contexts_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        ctx = rng.integers(0, 6, size=(int(rng.integers(1, 40)),))
        n, k = int(rng.integers(1, 5)), int(rng.integers(1, 6))
        np.testing.assert_array_equal(
            pspec.NgramProposer(n).propose(ctx, k),
            jspec.NgramProposer(n).propose(ctx, k))
    with pytest.raises(ValueError, match="ngram"):
        pspec.NgramProposer(0)
    assert pspec.make_proposer(len, 3) is len
    assert isinstance(pspec.make_proposer(None, 2).__self__,
                      pspec.NgramProposer)


def test_greedy_accept_len_matches_jax():
    rng = np.random.default_rng(1)
    nxt = rng.integers(0, 3, size=(64, 5))
    prop = rng.integers(0, 3, size=(64, 4))
    prop[:8] = nxt[:8, :4]                     # all accepted
    want = np.asarray(jspec.greedy_accept_len(jnp.asarray(nxt),
                                              jnp.asarray(prop)))
    got = pspec.greedy_accept_len(torch.from_numpy(nxt),
                                  torch.from_numpy(prop))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:8].eq(4).all()


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("new_tokens", [10, 20])
def test_spec_streams_equal_spec_off_and_jax(params, new_tokens):
    """K = 3 on JAX's repetitive load (its 10 new tokens, and the same
    prompts with 20): token-identical to the port's K = 0 stream and to
    JAX's spec-off stream; every decoding round was one verify step (no
    single-token decode step, so no paged decode kernel launch). At 10
    tokens the random model does not yet repeat itself, and neither
    engine accepts a proposal (JAX's ``test_spec_bit_parity_and_acceptance``
    fails on that count); at 20 its greedy stream loops and proposals are
    accepted."""
    reqs = [(p, new_tokens)
            for p, _ in _repetitive_load(np.random.default_rng(2))]
    want = _jax_srv(params).run(list(reqs))
    off = _port_srv(params).run(list(reqs))
    srv = _port_srv(params, spec_tokens=3)
    calls = _count_decode_steps(srv)
    on = srv.run(list(reqs))
    for rid in want:
        np.testing.assert_array_equal(off[rid], want[rid],
                                      err_msg=f"spec-off {rid}")
        np.testing.assert_array_equal(on[rid], want[rid],
                                      err_msg=f"spec-on {rid}")
    st = srv.stats()
    assert calls[0] == 0 and st["decode_steps"] == 0
    assert st["verify_steps"] > 0 and st["spec_steps"] >= st["verify_steps"]
    assert st["spec_proposed"] == 3 * st["spec_steps"]
    assert st["generated_tokens"] == sum(n for _, n in reqs)
    assert srv.allocator.used_blocks == 0
    if new_tokens == 20:
        assert st["spec_accepted"] > 0 and st["spec_accept_rate"] > 0


def test_spec_draft_hook_is_used(params):
    """An oracle draft hook (the spec-off continuation) reaches an accept
    rate >= 0.6 and leaves the stream unchanged (JAX's
    ``test_spec_draft_hook_is_used``)."""
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, 128, size=(9,)).astype(np.int32), 8)]
    base = _jax_srv(params).run(list(reqs))
    oracle = base[0]

    def draft(ctx, k):
        return oracle[ctx.size:ctx.size + k]

    srv = _port_srv(params, spec_tokens=2, spec_proposer=draft)
    on = srv.run(list(reqs))
    np.testing.assert_array_equal(on[0], base[0])
    st = srv.stats()
    assert st["spec_accept_rate"] >= 0.6 and st["spec_accepted"] >= 4


def test_spec_at_context_cap_stays_exact(params):
    """prompt + budget fills max_model_len: the verify step's rows past
    the table land in the trash block 0, never in the slot's last
    block."""
    rng = np.random.default_rng(31)
    reqs = [(rng.integers(0, 128, size=(100,)).astype(np.int32), 28)]
    want = _jax_srv(params).run(list(reqs))
    on = _port_srv(params, spec_tokens=3).run(list(reqs))
    np.testing.assert_array_equal(on[0], want[0])


def test_cache_budget_and_spec_compose_exactly(params):
    """Prefix cache + a 32-token budget + K = 2 on JAX's shared-prefix
    load: token-identical to JAX's spec-off stream, and at drain time
    every held block is the cache's (rejected rows rolled back without
    freeing shared blocks)."""
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 128, size=(40,)).astype(np.int32)
    reqs = [(np.concatenate([shared, rng.integers(0, 128, size=(5,))
                             .astype(np.int32)]), 8) for _ in range(4)]
    want = _jax_srv(params).run(list(reqs))
    srv = _port_srv(params, enable_prefix_cache=True,
                    prefill_token_budget=32, spec_tokens=2)
    outs = srv.run(list(reqs))
    for rid in want:
        np.testing.assert_array_equal(outs[rid], want[rid],
                                      err_msg=f"request {rid} diverged")
    st = srv.stats()
    assert st["prefix_hits"] >= 1 and st["spec_steps"] > 0
    assert srv.allocator.used_blocks == srv._prefix_cache.held_blocks


def test_spec_config_gates(params):
    """Greedy only; a negative K is refused; K sets the scheduler's row
    guarantee to K + 1 when it passes the quantum."""
    with pytest.raises(ValueError, match="greedy-only"):
        _port_srv(params, spec_tokens=2, temperature=0.7)
    with pytest.raises(ValueError, match="spec_tokens"):
        _port_srv(params, spec_tokens=-1)
    assert _port_srv(params, spec_tokens=6).scheduler.quantum == 7
    assert _port_srv(params, spec_tokens=2).scheduler.quantum == 4
    assert _port_srv(params).stats()["spec_steps"] == 0
