"""The port's single-rank optimizers (SGD, Adagrad, Lion, LAMB) against
the JAX package's: 5 updates on fixed grads held leaf for leaf (state and
params, with and without f32 masters), each config name through
``initialize`` -> ``train_batch`` engine against engine, and the
host-offloaded names (which build their device optimizer, as in JAX).

Tolerances as ``test_torch_training.py``'s Adam parity: relative L2 <=
1e-5 at f32, <= 2e-2 for bf16 params; engine losses within 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops import optimizers as jax_opt
from deepspeed_tpu.ops.lamb import lamb as jax_lamb
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import optimizers as port_opt
from deepspeed_tpu_torch.ops.registry import get_optimizer_builder

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tree(seed, dtype, zero_leaf=False):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 8, 16), "layers": {"a": (4, 16), "b": (4, 16, 8)}}

    def make(shape):
        return rng.standard_normal(shape).astype(np.float32)
    tree = {"w": make(shapes["w"]),
            "layers": {k: make(v) for k, v in shapes["layers"].items()}}
    if zero_leaf:                   # LAMB: ||w|| = 0 -> trust 1
        tree["layers"]["a"] = np.zeros_like(tree["layers"]["a"])
    if dtype == "bfloat16":
        tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)
                                                 .astype(jnp.float32)), tree)
    return tree


def _to_torch(tree, dtype):
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return port_opt.tree_map(lambda a: torch.from_numpy(np.array(a)).to(td),
                             tree)


def _to_jax(tree, dtype):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jax.tree.map(lambda a: jnp.asarray(a, jd), tree)


JAX_BUILDERS = {"sgd": jax_opt.sgd, "adagrad": jax_opt.adagrad,
                "lion": jax_opt.lion, "lamb": jax_lamb, "fusedlamb": jax_lamb}
# name, kwargs, params dtype (bf16: f32 masters), a zero leaf
CASES = [
    ("sgd", dict(lr=0.1), "float32", False),
    ("sgd", dict(lr=0.05, momentum=0.9), "bfloat16", False),
    ("sgd", dict(lr=0.05, momentum=0.9, nesterov=True), "float32", False),
    ("sgd", dict(lr=0.05, momentum=0.5, weight_decay=0.1,
                 use_master_weights=False), "float32", False),
    ("adagrad", dict(lr=0.1, weight_decay=0.01), "bfloat16", False),
    ("adagrad", dict(lr=0.05, initial_accumulator=0.1,
                     use_master_weights=False), "float32", False),
    ("lion", dict(lr=1e-3, weight_decay=0.1), "float32", False),
    ("lion", dict(lr=1e-3, beta1=0.8, beta2=0.95), "bfloat16", False),
    ("lamb", dict(lr=1e-2, weight_decay=0.01), "float32", True),
    # the trust ratio clipped from below, then from above
    ("lamb", dict(lr=1e-2, min_trust=2.0), "bfloat16", False),
    ("fusedlamb", dict(lr=1e-2, max_trust=0.5, use_master_weights=False),
     "float32", True),
]


@pytest.mark.parametrize("name,kw,dtype,zero_leaf", CASES)
def test_updates_match_jax(name, kw, dtype, zero_leaf):
    """5 updates on fixed grads: the step count, every f32 state leaf and
    the params, leaf for leaf."""
    jopt = JAX_BUILDERS[name](**kw)
    topt = get_optimizer_builder(name)(**kw)
    p = _tree(0, dtype, zero_leaf)
    grads = [_tree(s, "float32") for s in range(1, 6)]
    jp, tp = _to_jax(p, dtype), _to_torch(p, dtype)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    assert sorted(tstate) == sorted(jstate)
    for g in grads:
        jp, jstate = jopt.update(_to_jax(g, "float32"), jstate, jp)
        tp, tstate = topt.update(_to_torch(g, "float32"), tstate, tp)
    assert int(np.asarray(jstate["step"])[0]) == tstate["step"] == 5
    for key in sorted(jstate):
        if key == "step":
            continue
        if jstate[key] is None:
            assert tstate[key] is None, key
            continue
        jl, tl = _leaves(jstate[key]), _leaves(tstate[key])
        assert sorted(jl) == sorted(tl), key
        for leaf in jl:
            assert tl[leaf].dtype == torch.float32
            assert rel_l2(_np(tl[leaf]), _np(jl[leaf])) <= 1e-5, (key, leaf)
    jl, tl = _leaves(jp), _leaves(tp)
    for leaf in jl:
        tol = 2e-2 if dtype == "bfloat16" else 1e-5
        assert rel_l2(_np(tl[leaf]), _np(jl[leaf])) <= tol, leaf


def test_lamb_trust_ratio_is_clipped_both_ways():
    """One LAMB step from zero moments: the update is sign-like, so a
    leaf's trust ratio is ||w|| / ||u||. min_trust above it and max_trust
    below it move the leaf by lr * bound * u (to 1e-4: sqrt(v / c2) is
    |g| times sqrt((1 - b2) / c2), 1 + 6e-6 in f32, as in JAX)."""
    p = _to_torch(_tree(0, "float32"), "float32")
    g = _to_torch(_tree(1, "float32"), "float32")
    w = p["w"].clone()
    for kw, bound in ((dict(min_trust=50.0, max_trust=100.0), 50.0),
                      (dict(min_trust=0.001, max_trust=0.002), 0.002)):
        q = port_opt.tree_map(lambda t: t.clone(), p)
        opt = get_optimizer_builder("lamb")(lr=0.1, use_master_weights=False,
                                            **kw)
        q, _ = opt.update(g, opt.init(q), q)
        u = g["w"] / (g["w"].abs() + 1e-6)        # (m / c1) / (sqrt(v / c2) + eps)
        ratio = float(w.norm() / u.norm())
        assert not kw["min_trust"] <= ratio <= kw["max_trust"]
        torch.testing.assert_close(q["w"], w - 0.1 * bound * u, rtol=1e-4,
                                   atol=1e-6)


ENGINE = {"train_batch_size": 4, "gradient_clipping": 1.0, "bf16":
          {"enabled": False}}
ENGINE_CASES = [
    ("sgd", {"lr": 0.05, "momentum": 0.9, "nesterov": True}),
    ("lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("fusedlamb", {"lr": 1e-2, "max_trust": 2.0}),
    # a non-zero accumulator keeps the first step off lr * sign(g), whose
    # sign flips with the last bit of a gradient near 0
    ("adagrad", {"lr": 0.05, "initial_accumulator": 0.1}),
    ("lion", {"lr": 1e-3, "weight_decay": 0.1}),
]


@pytest.mark.parametrize("name,params", ENGINE_CASES,
                         ids=[c[0] for c in ENGINE_CASES])
def test_engine_names_match_jax_engine(name, params):
    """The config's optimizer name through ``initialize``: 3 train_batch
    steps, losses within 1e-5 of the JAX engine's."""
    dims = dict(vocab_size=256, num_layers=2, max_seq_len=32, hidden_size=64,
                num_heads=4, num_kv_heads=2, intermediate_size=128)
    jcfg = jt.llama_config("tiny", dtype=jnp.float32, **dims)
    tcfg = tt.llama_config("tiny", dtype=torch.float32, **dims)
    conf = dict(ENGINE, optimizer={"type": name, "params": dict(params)})
    je, *_ = deepspeed_tpu.initialize(model=jt.make_model(jcfg),
                                      config=dict(conf),
                                      devices=jax.devices()[:1])
    p0 = jax.tree.map(np.asarray,
                      jt.make_model(jcfg).init(jax.random.PRNGKey(42)))
    te, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(tcfg), config=dict(conf), params=p0,
        device="cpu")
    rng = np.random.default_rng(0)
    for step in range(3):
        batch = {"input_ids": rng.integers(0, 256, (4, 32), dtype=np.int32)}
        jl = float(je.train_batch(batch)["loss"])
        tl = float(te.train_batch(batch)["loss"])
        assert abs(tl - jl) <= 1e-5 * abs(jl), (name, step)
    assert te.state["opt"]["step"] == 3


@pytest.mark.parametrize("name,item", [
    ("cpuadam", "A8"), ("cpuadagrad", "A8")])
def test_unported_names_raise_naming_their_item(name, item):
    """The host-offloaded names, ported with ``item`` (ROADMAP A8), build
    the device optimizer they stand for, as JAX's registry does
    (``cpuadam`` -> AdamW, ``cpuadagrad`` -> Adagrad); the host update
    itself is ``offload_optimizer.use_cpu_adam``
    (``tests/test_torch_offload.py``)."""
    from deepspeed_tpu.ops.registry import get_optimizer_builder as jax_reg
    alias = {"cpuadam": "adamw", "cpuadagrad": "adagrad"}[name]
    assert get_optimizer_builder(name) is get_optimizer_builder(alias)
    assert jax_reg(name) is jax_reg(alias)
    assert callable(get_optimizer_builder(name)().update)


def test_large_leaf_norm_is_exact_on_the_cpu():
    """ROADMAP C3: a 65,536,000-value normal leaf (std 0.02, an embedding
    of llama size) read 0.6 % low through an f32 CPU sum (160.97 against
    161.90). The two-level sum of squares (f32 rows, f64 over the rows)
    behind the clip's global norm and LAMB's trust ratio is within 1e-6
    of the f64 norm."""
    from deepspeed_tpu_torch.ops.lamb import trust_ratio
    x = torch.empty(65_536_000).normal_(0.0, 0.02, generator=torch.Generator()
                                        .manual_seed(0))
    want = float(sum(c.double().square().sum()
                     for c in x.split(1 << 20)) ** 0.5)
    assert abs(float(port_opt.global_grad_norm([x])) - want) <= 1e-6 * want
    assert abs(float(port_opt.l2_norm(x)) - want) <= 1e-6 * want
    # LAMB's ratio of the leaf to itself / 2: exactly 2 only if both norms
    # are the whole leaf's
    assert float(trust_ratio(0, x, x / 2, 0.01, 10.0)) == pytest.approx(
        2.0, rel=1e-6)
