"""Dropout in the port against the JAX package's ``_dropout``: the same
function (keep with probability 1 - rate, scale by 1 / keep) on the
attention and FFN outputs before each residual add, on the training path
only. The masks come from another generator than JAX's, so the two are
compared in distribution (the keep fraction within 5 sigma of the
binomial's mean, the kept values exactly 1 / keep), not bit for bit.
Held in the port alone: rate 0 is bitwise the old path; eval, ``forward``
and the serving prefill never drop; the two branches are the only sites;
rematerialized grads equal the grads without remat for one seed; one
seed gives one loss.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import convert, transformer as tt

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

DIMS = dict(vocab_size=256, num_layers=2, max_seq_len=64, hidden_size=64,
            num_heads=4, num_kv_heads=2, intermediate_size=128)
RATE = 0.1


def _cfg(**kw):
    return tt.llama_config("tiny", dtype=torch.float32,
                           **dict(DIMS, **kw))


def _params(cfg, seed=0):
    jcfg = jt.llama_config("tiny", dtype=jnp.float32, **DIMS)
    p = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed),
                                                jcfg))
    return convert.params_from_numpy(p, cfg, device="cpu",
                                     dtype=torch.float32)


def _batch(seed=0, rows=2, cols=64):
    return {"input_ids": torch.from_numpy(np.random.default_rng(seed).integers(
        0, DIMS["vocab_size"], (rows, cols))).long()}


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_fraction_and_scale_match_jax_in_distribution(rate):
    n = 200_000
    keep = 1.0 - rate
    bound = 5 * np.sqrt(keep * rate / n)
    scaled = np.float32(1) / np.float32(keep)
    tcfg = _cfg(dropout_rate=rate)
    jcfg = jt.llama_config("tiny", dtype=jnp.float32,
                           **dict(DIMS, dropout_rate=rate))
    fracs = []
    for salt in (0, 1):
        got = tt._dropout(torch.ones(n), tcfg, 1234, salt).numpy()
        want = np.asarray(jt._dropout(jnp.ones(n, jnp.float32), jcfg,
                                      jax.random.PRNGKey(7), False, salt))
        for out in (got, want):
            kept = out != 0
            assert abs(kept.mean() - keep) <= bound
            np.testing.assert_array_equal(out[kept], scaled)
        fracs.append(got != 0)
    # the two salts draw different masks
    assert (fracs[0] != fracs[1]).mean() > 0.5 * 2 * keep * rate


def test_rate_zero_is_bitwise_the_old_path():
    cfg0, cfg1 = _cfg(), _cfg(dropout_rate=RATE)
    p, b = _params(cfg0), _batch()
    base = tt.lm_loss(p, b, cfg0)
    assert torch.equal(tt.lm_loss(p, b, cfg0, dropout_seed=99), base)
    # a dropout model without a seed (eval) drops nothing
    assert torch.equal(tt.lm_loss(p, b, cfg1), base)
    assert not torch.equal(tt.lm_loss(p, b, cfg1, dropout_seed=99), base)


def test_eval_forward_and_serving_never_drop():
    cfg0, cfg1 = _cfg(), _cfg(dropout_rate=RATE)
    p = _params(cfg0)
    b = _batch(1)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(cfg1), config={"train_batch_size": 2, "bf16": {
            "enabled": False}}, params=jax.tree.map(
            np.asarray, jt.init_params(jax.random.PRNGKey(0), jt.llama_config(
                "tiny", dtype=jnp.float32, **DIMS))), device="cpu")
    assert torch.equal(engine.eval_batch(b), tt.lm_loss(p, b, cfg0))
    assert torch.equal(tt.forward(p, b["input_ids"], cfg1),
                       tt.forward(p, b["input_ids"], cfg0))
    pools = [tt.init_paged_cache(c, 6, 16, device="cpu")
             for c in (cfg0, cfg1)]
    ids = b["input_ids"][:1, :48]
    logits = [tt.prefill_paged(p, ids, c, pl, [1, 2, 3], length=40)
              for c, pl in zip((cfg0, cfg1), pools)]
    assert torch.equal(logits[0], logits[1])
    assert torch.equal(pools[0]["k"], pools[1]["k"])
    srv = deepspeed_tpu_torch.init_serving(
        tt.make_model(cfg1), config={"kv_cache_bits": 0},
        serving=dict(max_seqs=2, block_size=16, max_model_len=64,
                     prompt_bucket=16), params=jax.tree.map(
            np.asarray, jt.init_params(jax.random.PRNGKey(0), jt.llama_config(
                "tiny", dtype=jnp.float32, **DIMS))), dtype=torch.float32,
        device="cpu")
    ref = deepspeed_tpu_torch.init_serving(
        tt.make_model(cfg0), config={"kv_cache_bits": 0},
        serving=dict(max_seqs=2, block_size=16, max_model_len=64,
                     prompt_bucket=16), params=jax.tree.map(
            np.asarray, jt.init_params(jax.random.PRNGKey(0), jt.llama_config(
                "tiny", dtype=jnp.float32, **DIMS))), dtype=torch.float32,
        device="cpu")
    load = [(b["input_ids"][0, :20].numpy().astype(np.int32), 6),
            (b["input_ids"][1, :9].numpy().astype(np.int32), 6)]
    got, want = srv.run(list(load)), ref.run(list(load))
    for g, w in zip(sorted(got), sorted(want)):
        np.testing.assert_array_equal(got[g], want[w])


@pytest.mark.parametrize("zero", [("wo", "w_out"), ("w_out",), ("wo",)])
def test_dropout_sits_only_on_the_two_branches(zero):
    """With both branches' output projections zeroed, dropout changes
    nothing (no other site: not the embeddings, norms or logits); with
    one zeroed, the other branch's dropout changes the logits."""
    cfg = _cfg(dropout_rate=RATE)
    p = _params(_cfg())
    for name in zero:
        p["layers"][name] = torch.zeros_like(p["layers"][name])
    ids = _batch(2)["input_ids"]
    plain = tt.forward(p, ids, cfg)
    dropped = tt.forward(p, ids, cfg, dropout_seed=5)
    assert torch.equal(plain, dropped) == (len(zero) == 2)


@pytest.mark.parametrize("policy", ["dots_saveable", "full", "dots_and_attn"])
def test_remat_grads_equal_grads_without_remat(policy):
    """The replayed forward redraws the masks its forward drew: the grads
    under a remat policy equal the grads without remat for one seed
    (and a second seed gives other grads)."""
    p = _params(_cfg())
    b = _batch(3)

    def grads(cfg, seed):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in p["layers"].items()}
        q = dict(p, layers=leaves)
        loss = tt.lm_loss(q, b, cfg, dropout_seed=seed)
        return loss, torch.autograd.grad(loss, list(leaves.values()))

    l0, g0 = grads(_cfg(dropout_rate=RATE), 11)
    l1, g1 = grads(_cfg(dropout_rate=RATE, remat_policy=policy), 11)
    assert torch.equal(l0, l1)
    for a, c in zip(g0, g1):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-7)
    l2, g2 = grads(_cfg(dropout_rate=RATE, remat_policy=policy), 12)
    assert not torch.equal(l0, l2)


def test_one_seed_one_loss():
    """Two engines from one config seed (and the same weights) take the
    same steps; another seed draws other masks."""
    p0 = jax.tree.map(np.asarray, jt.init_params(
        jax.random.PRNGKey(0), jt.llama_config("tiny", dtype=jnp.float32,
                                               **DIMS)))

    def losses(seed):
        engine, *_ = deepspeed_tpu_torch.initialize(
            model=tt.make_model(_cfg(dropout_rate=RATE)), config={
                "train_batch_size": 2, "seed": seed, "bf16": {
                    "enabled": False}, "gradient_accumulation_steps": 2,
                "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}},
            params=p0, device="cpu")
        b = _batch(4)
        return [float(engine.train_batch(b)["loss"]) for _ in range(2)]

    a, b, c = losses(1), losses(1), losses(2)
    assert a == b
    assert a[0] != c[0]
