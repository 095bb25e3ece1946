"""fp16 in the port against the JAX package: the dynamic loss scaler
(``runtime/fp16.py``) exactly, an fp16 engine against JAX's fp16 engine,
the overflow skip, the checkpoint of the scaler's state, the config rules,
the refusal of a sparse model under fp16, and f16 serving logits.

On the CPU the attention kernels take their plain versions (in f32, the
output cast to f16); JAX's fp16 models take XLA attention (f16
probabilities). Schedules overflow by orders of magnitude or not at all,
so no test depends on a borderline overflow. Tolerances: the scaler's
state exactly; losses within 1e-2 relative; f16 logits within 1e-2
relative L2.
"""

import itertools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config import Config as JaxConfig
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime import fp16 as jax_fp16
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.models import convert, transformer as tt
from deepspeed_tpu_torch.runtime import fp16 as port_fp16

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

DIMS = dict(vocab_size=256, num_layers=2, max_seq_len=32, hidden_size=64,
            num_heads=4, num_kv_heads=2, intermediate_size=128)


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _ls_tuple(state):
    return (float(np.asarray(state.scale)), int(np.asarray(state.good_steps)),
            int(np.asarray(state.hysteresis)))


UPDATE_CASES = [dict(dynamic=False)] + [
    dict(scale_window=w, min_scale=m, max_hysteresis=h,
         consecutive_hysteresis=c)
    for w, m, h, c in itertools.product((1, 3), (1.0, 2.0 ** 20), (1, 3),
                                        (False, True))]


@pytest.mark.parametrize("kw", UPDATE_CASES,
                         ids=[str(i) for i in range(len(UPDATE_CASES))])
def test_update_loss_scale_matches_jax_exactly(kw):
    """Random overflow sequences (runs of both kinds, from 2^22): the
    port's state equals JAX's after every update, bit for bit."""
    rng = np.random.default_rng(len(str(kw)))
    h0 = kw.get("max_hysteresis", 2)
    js = jax_fp16.init_loss_scale(22, hysteresis=h0)
    ts = port_fp16.init_loss_scale(22, hysteresis=h0)
    flips = rng.random(40) < 0.4
    for i, of in enumerate(flips):
        js = jax_fp16.update_loss_scale(js, jnp.asarray(bool(of)), **kw)
        ts = port_fp16.update_loss_scale(ts, torch.tensor(bool(of)), **kw)
        assert ts.scale.dtype == torch.float32
        assert ts.good_steps.dtype == ts.hysteresis.dtype == torch.int32
        assert _ls_tuple(ts) == _ls_tuple(js), (i, kw)


def test_overflow_check_scale_and_unscale_match_jax():
    g = {"a": np.ones((3, 4), np.float32) * 3.0,
         "b": np.full((2,), 7.0, np.float32)}
    tg = {k: torch.from_numpy(v).half() for k, v in g.items()}
    jg = {k: jnp.asarray(v, jnp.float16) for k, v in g.items()}
    assert not bool(port_fp16.has_overflow(tg))
    tg["b"][1] = float("inf")
    jg["b"] = jg["b"].at[1].set(jnp.inf)
    assert bool(port_fp16.has_overflow(tg)) and bool(jax_fp16.has_overflow(jg))
    tg["b"][1] = float("nan")
    assert bool(port_fp16.has_overflow(tg))
    ts, js = port_fp16.static_loss_scale(128.0), \
        jax_fp16.static_loss_scale(128.0)
    assert _ls_tuple(ts) == _ls_tuple(js)
    un = port_fp16.unscale_grads({"a": tg["a"]}, ts)["a"]
    assert un.dtype == torch.float32
    np.testing.assert_array_equal(un.numpy(), np.asarray(
        jax_fp16.unscale_grads({"a": jg["a"]}, js)["a"]))
    loss = torch.tensor(2.5)
    assert float(port_fp16.scale_loss(loss, ts)) == float(
        jax_fp16.scale_loss(jnp.float32(2.5), js))


def _engine_config(**fp16):
    return {"train_batch_size": 4, "gradient_clipping": 1.0,
            "fp16": {"enabled": True, **fp16},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}}


def _engines(**fp16):
    jcfg = jt.llama_config("tiny", dtype=jnp.float16, **DIMS)
    tcfg = tt.llama_config("tiny", dtype=torch.float16, **DIMS)
    je, *_ = deepspeed_tpu.initialize(model=jt.make_model(jcfg),
                                      config=_engine_config(**fp16),
                                      devices=jax.devices()[:1])
    p0 = jax.tree.map(np.asarray,
                      jt.make_model(jcfg).init(jax.random.PRNGKey(42)))
    te, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(tcfg), config=_engine_config(**fp16), params=p0,
        device="cpu")
    return je, te


def _scaler(state):
    ls = state["loss_scale"]
    return (float(np.asarray(ls["scale"])), int(np.asarray(ls["good_steps"])),
            int(np.asarray(ls["hysteresis"])))


# (fp16 section, steps after which both scales are set to 2^8): "never"
# grows from 2^8 without an overflow; "huge" overflows at 2^40 (the
# logits' grads alone pass f16's range by ~10^5) until the poke
SCHEDULES = {"never": (dict(initial_scale_power=8, loss_scale_window=2),
                       None),
             "huge": (dict(initial_scale_power=40, hysteresis=2,
                           loss_scale_window=2), 3)}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_engine_matches_jax_fp16_engine(schedule):
    """6 steps: the same steps skipped, the same scaler state after each
    step, losses within 1e-2; the applied-update count and the skip count
    as JAX's."""
    fp16, poke = SCHEDULES[schedule]
    je, te = _engines(**fp16)
    assert te.compute_dtype == torch.float16
    assert te.state["params"]["tok_embed"].dtype == torch.float16
    rng = np.random.default_rng(0)
    skipped = []
    for step in range(6):
        if step == poke:
            je.state["loss_scale"] = dict(je.state["loss_scale"],
                                          scale=jnp.float32(256.0))
            te.state["loss_scale"]["scale"].fill_(256.0)
        batch = {"input_ids": rng.integers(0, 256, (4, 32), dtype=np.int32)}
        jm, tm = je.train_batch(batch), te.train_batch(batch)
        assert bool(tm["overflow"]) == bool(jm["overflow"]), step
        assert float(tm["loss_scale"]) == float(jm["loss_scale"]), step
        skipped.append(bool(tm["overflow"]))
        assert _scaler(te.state) == _scaler(je.state), step
        jl, tl = float(jm["loss"]), float(tm["loss"])
        assert abs(tl - jl) <= 1e-2 * abs(jl), step
    assert skipped == ([True] * 3 + [False] * 3 if poke else [False] * 6)
    assert te.skipped_steps == je.skipped_steps == sum(skipped)
    assert te.state["step"] == int(np.asarray(je.state["step"])) \
        == 6 - sum(skipped)
    assert te.global_steps == je.global_steps == 6
    assert te.get_loss_scale() == je.get_loss_scale()


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = v
    return out


def _port_engine(**fp16):
    cfg = tt.llama_config("tiny", dtype=torch.float16, **DIMS)
    te, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(cfg), config=_engine_config(**fp16),
        device="cpu")
    return te


def test_skipped_step_leaves_the_state_bitwise_unchanged():
    """One good step (so the moments are non-zero), then a forced overflow
    (the scale set to 2^40): params, f32 masters and every optimizer leaf
    bit for bit as before; the scale halves (hysteresis 1), the
    applied-update count holds, the skip is counted."""
    te = _port_engine(initial_scale_power=8, hysteresis=1)
    rng = np.random.default_rng(1)
    batch = lambda: {"input_ids": rng.integers(  # noqa: E731
        0, 256, (4, 32), dtype=np.int32)}
    assert not bool(te.train_batch(batch())["overflow"])
    te.state["loss_scale"]["scale"].fill_(2.0 ** 40)
    before = {k: v.detach().clone() for k, v in _leaves(
        {"params": te.state["params"], "opt": te.state["opt"]}).items()}
    assert any(k.startswith("opt/master/") for k in before)
    m = te.train_batch(batch())
    assert bool(m["overflow"]) and float(m["loss_scale"]) == 2.0 ** 40
    after = _leaves({"params": te.state["params"], "opt": te.state["opt"]})
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert te.state["opt"]["step"] == te.state["step"] == 1
    assert te.skipped_steps == 1 and te.global_steps == 2
    assert te.get_loss_scale() == 2.0 ** 39


def test_checkpoint_keeps_the_scaler_and_skipped_steps(tmp_path):
    te = _port_engine(initial_scale_power=40, hysteresis=2)
    rng = np.random.default_rng(2)
    for _ in range(3):
        te.train_batch({"input_ids": rng.integers(0, 256, (4, 32),
                                                  dtype=np.int32)})
    assert te.skipped_steps == 3
    saved = _scaler(te.state)
    te.save_checkpoint(str(tmp_path))
    fresh = _port_engine(initial_scale_power=8, hysteresis=2)
    _, client = fresh.load_checkpoint(str(tmp_path))
    assert client["skipped_steps"] == 3
    assert fresh.skipped_steps == 3 and fresh.global_steps == 3
    assert _scaler(fresh.state) == saved == (2.0 ** 38, 0, 1)


def test_fp16_and_bf16_pick_fp16_as_jax(caplog):
    both = {"fp16": {"enabled": True}, "bf16": {"enabled": True}}
    with caplog.at_level(logging.WARNING, logger="deepspeed_tpu_torch"):
        cfg = Config.load(dict(both))
    assert "fp16 and bf16 both enabled" in caplog.text
    jcfg = JaxConfig.load(dict(both))
    assert cfg.compute_dtype == torch.float16
    assert jcfg.compute_dtype == jnp.float16
    assert not cfg.bf16.enabled and not jcfg.bf16.enabled
    keys = dict(loss_scale=0.0, initial_scale_power=12, loss_scale_window=50,
                hysteresis=3, consecutive_hysteresis=True, min_loss_scale=4.0)
    a = Config.load({"fp16": {"enabled": True, **keys}}).fp16
    b = JaxConfig.load({"fp16": {"enabled": True, **keys}}).fp16
    for k in keys:
        assert getattr(a, k) == getattr(b, k), k
    assert a.dynamic and b.dynamic
    assert not Config.load({"fp16": {"enabled": True, "loss_scale": 128.0}}
                           ).fp16.dynamic


def test_sparse_model_under_fp16_raises():
    cfg = tt.llama_config("tiny", dtype=torch.float16, **dict(
        DIMS, sparse_attention={"mode": "fixed", "block": 16}))
    p = tt.make_model(cfg).init(torch.Generator().manual_seed(0), "cpu",
                                dtype=torch.float16)
    with pytest.raises(ValueError, match="float16"):
        tt.lm_loss(p, {"input_ids": torch.zeros((1, 32), dtype=torch.long)},
                   cfg)


def test_f16_serving_prefill_logits_match_jax():
    """A 48-row prefill of a 41-token prompt at f16 (the flash kernel's
    plain version here; XLA attention in JAX): the last logits and the
    pool rows within 1e-2. Then an f16 ``ServingEngine`` serves a load
    on f16 pools."""
    jcfg = jt.llama_config("tiny", dtype=jnp.float16, **DIMS)
    params = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    tcfg = tt.llama_config("tiny", dtype=torch.float16, **DIMS)
    p = convert.params_from_numpy(params, tcfg, device="cpu",
                                  dtype=torch.float16)
    P, bs, NB, length = 48, 16, 8, 41
    ids = np.random.default_rng(4).integers(0, 256, (1, P)).astype(np.int32)
    blocks = np.asarray([2, 5, 3], np.int32)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float16), params)
    jpools = jt.init_paged_cache(jcfg, NB, bs, dtype=jnp.float16)
    want, jpools = jax.jit(lambda pr, i, pl, b: jt.prefill_paged(
        pr, i, jcfg, pl, b, length=length))(jparams, ids, jpools, blocks)
    pools = tt.init_paged_cache(tcfg, NB, bs, dtype=torch.float16,
                                device="cpu")
    got = tt.prefill_paged(p, torch.from_numpy(ids).long(), tcfg, pools,
                           blocks, length=length)
    assert rel_l2(got.numpy(), np.asarray(want, np.float32)) <= 1e-2
    for name in ("k", "v"):
        assert pools[name].dtype == torch.float16
        assert rel_l2(pools[name][:, 1:].float().numpy(), np.asarray(
            jpools[name], np.float32)[:, 1:]) <= 1e-2
    srv = deepspeed_tpu_torch.init_serving(
        tt.make_model(tcfg), config={"kv_cache_bits": 0},
        serving=dict(max_seqs=2, block_size=16, max_model_len=32,
                     prompt_bucket=16), params=params, dtype=torch.float16,
        device="cpu")
    outs = srv.run([(ids[0, :20], 6), (ids[0, :9], 6)])
    assert [len(outs[k]) for k in sorted(outs)] == [20 + 6, 9 + 6]
    assert srv.pools["k"].dtype == torch.float16
