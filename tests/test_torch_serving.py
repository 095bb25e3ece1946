"""The port's ServingEngine against the JAX ServingEngine: same weights,
same load (more requests than slots, a pool below full residency),
token-identical greedy streams at f32. Three loads: a mixed one, one of
uniform long generations whose growth forces preemptions (re-prefill), and
one whose first request ends at max_model_len mid-quantum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.models import make_model as jax_make_model
from deepspeed_tpu_torch.models import TransformerConfig, make_model

# tests/unit/test_serving.py's _cfg at f32
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=256, position_type="rotary",
           activation="silu_glu", norm_type="rmsnorm", tie_embeddings=False)
SERVING = dict(max_seqs=2, block_size=16, max_model_len=128,
               decode_quantum=4, prompt_bucket=16)
# name: (num_blocks, ((prompt tokens, new tokens), ...), preemptions)
LOADS = {
    "mixed": (10, ((30, 40), (25, 30), (5, 12), (40, 20), (17, 8)), 0),
    "preempting": (9, ((26, 40),) * 4, 2),
    # request 0 reaches max_model_len (128 rows: its whole table) at the
    # second step of a decode quantum; the two steps left write rows 128
    # and 129 past its table (dropped by JAX, trash block in the port)
    "capped": (13, ((30, 98), (20, 40)), 0),
}


def _load(name, seed=3):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, size=(n,)).astype(np.int32), k)
            for n, k in LOADS[name][1]]


@pytest.fixture(scope="module", params=sorted(LOADS))
def jax_run(request):
    name = request.param
    model = jax_make_model(JaxConfig(**CFG, dtype=jnp.float32,
                                     attention_impl="xla"))
    srv = deepspeed_tpu.init_serving(
        model, config={"kv_cache_bits": 0},
        serving={**SERVING, "num_blocks": LOADS[name][0]}, dtype=jnp.float32)
    outs = srv.run(_load(name))
    params = jax.tree.map(np.asarray, jax.device_get(srv.engine.params))
    return name, params, [outs[k] for k in sorted(outs)]


def _port_engine(name, params, **serving):
    model = make_model(TransformerConfig(**CFG, dtype=torch.float32))
    return deepspeed_tpu_torch.init_serving(
        model, config={"kv_cache_bits": 0},
        serving={**SERVING, "num_blocks": LOADS[name][0], **serving},
        params=params, dtype=torch.float32, device="cpu")


def test_greedy_streams_match_jax(jax_run):
    name, params, want = jax_run
    srv = _port_engine(name, params)
    outs = srv.run(_load(name))
    got = [outs[k] for k in sorted(outs)]
    load = LOADS[name][1]
    assert len(got) == len(want) == len(load)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"request {i} diverged")
    assert srv.allocator.used_blocks == 0
    st = srv.stats()
    for key in ("p50_ttft_ms", "p99_ttft_ms", "tok_per_sec"):
        assert st[key] > 0, key
    assert st["completed"] == len(load)
    assert st["preemptions"] == LOADS[name][2]
    assert st["generated_tokens"] == sum(k for _, k in load)
    assert st["prefills"] == len(load) + st["preemptions"]
    assert st["decode_steps"] % SERVING["decode_quantum"] == 0


def test_eos_truncates_and_frees_blocks(jax_run):
    name, params, want = jax_run
    n0 = LOADS[name][1][0][0]
    eos = int(want[0][n0 + 3])              # request 0's 4th generated token
    srv = _port_engine(name, params, eos_token_id=eos)
    outs = srv.run(_load(name))
    first = outs[min(outs)]
    assert first[-1] == eos and len(first) <= n0 + 4
    np.testing.assert_array_equal(first, want[0][:len(first)])
    assert srv.allocator.used_blocks == 0


def test_deferred_serving_features_raise():
    model = make_model(TransformerConfig(**CFG, dtype=torch.float32))
    for field, value in (("spec_tokens", 2), ("enable_prefix_cache", True),
                         ("prefill_token_budget", 64), ("adapter_slots", 2),
                         ("ttft_deadline_ms", 5.0)):
        with pytest.raises(NotImplementedError, match="ROADMAP A6"):
            deepspeed_tpu_torch.init_serving(
                model, serving={**SERVING, field: value},
                dtype=torch.float32, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A6a"):
        deepspeed_tpu_torch.init_serving(model, config={"kv_cache_bits": 8},
                                         serving=SERVING, device="cpu")


def test_temperature_sampling_is_seeded():
    """temperature > 0 draws from the engine's own seeded generator (it
    cannot match JAX's bits, so it has no parity test): same seed, same
    streams; in-vocab tokens; the pool drains."""
    model = make_model(TransformerConfig(**CFG, dtype=torch.float32))
    runs = []
    for _ in range(2):
        srv = deepspeed_tpu_torch.init_serving(
            model, serving={**SERVING, "temperature": 1.0},
            dtype=torch.float32, device="cpu", seed=7)
        outs = srv.run(_load("mixed"))
        runs.append([outs[k] for k in sorted(outs)])
        assert srv.allocator.used_blocks == 0
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
        assert a.min() >= 0 and a.max() < CFG["vocab_size"]
