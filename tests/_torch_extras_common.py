"""Shared pieces of the training extras' parity tests
(``test_torch_compression.py``, ``test_torch_data_efficiency.py``,
``test_torch_moq_pld.py``): hidden-64 llama configs for both packages,
the two engines on the same initial params, JAX's own draws of random-LTD
and progressive layer drop recomputed from its step key, and the
comparisons."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import transformer as tt

VOCAB, S = 128, 32
DIMS = dict(vocab_size=VOCAB, hidden_size=64, num_heads=4, num_kv_heads=2,
            intermediate_size=128, max_seq_len=64)


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def np_tree(tree):
    """A torch or JAX tree as numpy f32."""
    if isinstance(tree, dict):
        return {k: np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(jnp.asarray(tree, jnp.float32))


def leaves(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def cfgs(layers=2, **kw):
    """(JAX config, port config), f32 hidden-64 llama."""
    base = dict(DIMS, num_layers=layers, **kw)
    return (jt.llama_config("tiny", dtype=jnp.float32, attention_impl="xla",
                            **base),
            tt.llama_config("tiny", dtype=torch.float32, **base))


def init_np(jcfg, seed=42):
    """JAX's engine's initial params (its init at the config seed)."""
    return jax.tree.map(np.asarray,
                        jt.make_model(jcfg).init(jax.random.PRNGKey(seed)))


def ids(seed, rows, cols=S):
    return np.random.default_rng(seed).integers(0, VOCAB, (rows, cols),
                                                dtype=np.int32)


def base_conf(rows=4, **extra):
    c = {"train_batch_size": rows,
         "optimizer": {"type": "adamw", "params": {"lr": 1e-2}},
         "bf16": {"enabled": False}, "steps_per_print": 10 ** 6}
    c.update(extra)
    return c


def engines(jcfg, tcfg, conf, jmodel=None, tmodel=None, params=None):
    """(JAX engine on one device, port engine on the CPU) on the same
    initial params (``params``, default JAX's engine init)."""
    je, *_ = deepspeed_tpu.initialize(
        model=jmodel or jt.make_model(jcfg), config=dict(conf),
        devices=jax.devices()[:1])
    p0 = params if params is not None else init_np(jcfg)
    te, *_ = deepspeed_tpu_torch.initialize(
        model=tmodel or tt.make_model(tcfg), config=dict(conf), params=p0,
        device="cpu")
    return je, te


def step_key(je):
    """The key JAX's next ``train_batch`` hands its loss (gas 1)."""
    return jax.random.split(je._rng)[1]


def jax_ltd_selection(key, num_layers, rows, seq, keep):
    """JAX's random-LTD selections of one forward: the unrolled stack's
    key chain (layer 0 splits 2, each LTD layer 1 .. L - 2 splits 3 and
    draws argsort(uniform)[:, :keep], sorted)."""
    rng, _ = jax.random.split(key)
    out = {}
    for i in range(1, num_layers - 1):
        rng, _, sel_rng = jax.random.split(rng, 3)
        u = jax.random.uniform(sel_rng, (rows, seq))
        out[i] = np.sort(np.asarray(jnp.argsort(u, axis=1)[:, :keep]), 1)
    return out


def jax_pld_coins(key, theta, num_layers):
    """JAX's PLD coins of one forward: bernoulli(fold_in(key, 7919 + i),
    1 - (i + 1) / L * (1 - theta)) in f32."""
    out = []
    for i in range(num_layers):
        p = 1.0 - jnp.float32(i + 1) / num_layers * (1.0 - jnp.float32(theta))
        out.append(bool(jax.random.bernoulli(
            jax.random.fold_in(key, 7919 + i), p)))
    return out


def train_both(je, te, batches, before=None):
    """Step both engines on ``batches``; ``before(step)`` runs ahead of
    each step (to feed JAX's draws to the port). Returns the two loss
    lists."""
    jl, tl = [], []
    for t, b in enumerate(batches):
        if before is not None:
            before(t)
        jl.append(float(je.train_batch(dict(b))["loss"]))
        tl.append(float(te.train_batch(dict(b))["loss"]))
    return jl, tl


def assert_losses(jl, tl, tol=1e-5):
    for a, b in zip(jl, tl):
        assert abs(a - b) <= tol * max(abs(a), 1.0), (jl, tl)


def assert_params(je, te, tol=1e-4):
    want = leaves(np_tree(jax.device_get(je.state["params"])))
    got = leaves(np_tree(te.state["params"]))
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) <= tol, (k, rel_l2(got[k], want[k]))
