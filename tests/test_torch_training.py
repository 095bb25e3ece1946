"""The port's training slice against the JAX package's: the loss and its
gradients under every remat policy, the optimizers and LR schedules, the
config surface, and ``initialize`` -> ``train_batch`` engine against
engine.

Everything runs on the CPU, where the attention kernels take their plain
versions. The same numpy-seeded weights and batches go to both packages.
Tolerances: relative L2 <= 1e-5 at f32 (1e-4 for params after 5 optimizer
steps), <= 2e-2 at bf16.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops.adam import adam as jax_adam, adamw as jax_adamw
from deepspeed_tpu.ops import optimizers as jax_opt
from deepspeed_tpu.runtime import lr_schedules as jax_lr
from deepspeed_tpu_torch.config import Config, ConfigError
from deepspeed_tpu_torch.models import params_from_numpy
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import flash_attention as port_flash
from deepspeed_tpu_torch.ops import optimizers as port_opt
from deepspeed_tpu_torch.ops.registry import get_optimizer_builder
from deepspeed_tpu_torch.runtime import lr_schedules as port_lr

VOCAB, S, B = 256, 64, 2


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(dtype="float32", **kw):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    base = dict(vocab_size=VOCAB, num_layers=2, max_seq_len=S)
    base.update(kw)
    return (jt.llama_config("tiny", dtype=jd, **base),
            tt.llama_config("tiny", dtype=td, **base))


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _ids(seed, rows=B, cols=S):
    return np.random.default_rng(seed).integers(0, VOCAB, (rows, cols),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# (e) weights cast to the activation dtype at every matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("bfloat16", 2e-2), ("float32", 1e-5)])
def test_forward_on_f32_params_matches_jax(dtype, tol):
    """f32 params (the trainer's storage) under a bf16 compute config: the
    JAX model casts each weight at its matmul, and so must the port."""
    jcfg, tcfg = _cfgs(dtype)
    p = _jax_params(jcfg)
    ids = _ids(1)
    want = jt.forward(jax.tree.map(jnp.asarray, p), jnp.asarray(ids), jcfg)
    tp = params_from_numpy(p, tcfg, device="cpu", dtype=torch.float32)
    got = tt.forward(tp, torch.from_numpy(ids), tcfg)
    assert got.dtype == torch.float32 and got.shape == (B, S, VOCAB)
    assert rel_l2(_np(got), _np(want)) <= tol


# ---------------------------------------------------------------------------
# (b) lm_loss and its gradients, every remat policy, chunked loss on/off
# ---------------------------------------------------------------------------

_JAX_LOSS = {}


def _jax_value_and_grad(loss_chunk, masked):
    key = (loss_chunk, masked)
    if key not in _JAX_LOSS:
        jcfg, _ = _cfgs(loss_chunk=loss_chunk)
        p = _jax_params(jcfg)
        batch = _batch(masked)
        fn = jax.jit(jax.value_and_grad(lambda q: jt.lm_loss(
            q, jax.tree.map(jnp.asarray, batch), jcfg)))
        loss, grads = fn(jax.tree.map(jnp.asarray, p))
        _JAX_LOSS[key] = (p, float(loss), jax.tree.map(np.asarray, grads))
    return _JAX_LOSS[key]


def _batch(masked):
    batch = {"input_ids": _ids(2)}
    if masked:
        mask = np.ones((B, S), np.int32)
        mask[1, S - 20:] = 0
        batch["attention_mask"] = mask
    return batch


def _port_value_and_grad(p, cfg, masked):
    tp = params_from_numpy(p, cfg, device="cpu", dtype=torch.float32)
    leaves = _leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(masked).items()}
    loss = tt.lm_loss(tp, batch, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), dict(zip(leaves, grads))


@pytest.mark.parametrize("loss_chunk,masked", [(0, False), (16, False),
                                               (0, True)])
@pytest.mark.parametrize("policy", tt.REMAT_POLICIES)
def test_lm_loss_and_grads_match_jax(policy, loss_chunk, masked):
    p, jloss, jgrads = _jax_value_and_grad(loss_chunk, masked)
    _, tcfg = _cfgs(loss_chunk=loss_chunk)
    base_loss, base = _port_value_and_grad(p, tcfg, masked)
    cfg = dataclasses.replace(tcfg, remat=policy != "none",
                              remat_policy=policy)
    loss, grads = _port_value_and_grad(p, cfg, masked)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert abs(loss - base_loss) <= 1e-6 * abs(base_loss)
    jl = _leaves(jgrads)
    assert set(grads) == set(jl)
    for name, g in grads.items():
        assert rel_l2(_np(g), jl[name]) <= 1e-5, name
        assert rel_l2(_np(g), _np(base[name])) <= 1e-6, name


def test_left_padded_loss_and_grads_match_jax_pallas():
    """Left padding: batch row 1's first 4 keys are masked, so its first 4
    query rows see no key. The port's flash route gives them O = 0, as
    JAX's Pallas kernel does (run here in interpret mode through
    ``attention_impl="pallas"``); JAX's XLA branch gives the mean of V
    instead (``models/transformer.attention``'s docstring)."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, attention_impl="pallas")
    p = _jax_params(jcfg)
    mask = np.ones((B, S), np.int32)
    mask[1, :4] = 0
    batch = {"input_ids": _ids(2), "attention_mask": mask}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda q: jt.lm_loss(
        q, jax.tree.map(jnp.asarray, batch), jcfg)))(
            jax.tree.map(jnp.asarray, p))
    tp = params_from_numpy(p, tcfg, device="cpu", dtype=torch.float32)
    leaves = _leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tt.lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                      tcfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    want = float(jloss)
    assert abs(float(loss.detach()) - want) <= 1e-5 * abs(want)
    jl = _leaves(jax.tree.map(np.asarray, jgrads))
    assert set(leaves) == set(jl)
    for name, g in zip(leaves, grads):
        assert rel_l2(_np(g), jl[name]) <= 1e-5, name


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy,replays_flash,replays_dots", [
    ("none", False, False), ("full", True, True),
    ("save_nothing", True, True), ("dots_saveable", True, False),
    ("dots_and_attn", False, False)])
def test_remat_policy_replays(policy, replays_flash, replays_dots,
                              monkeypatch):
    """Which work each policy redoes in the backward: the flash forward
    (B1, counted through its wrapper) and the layer matmuls (aten.mm)."""
    calls = []
    fwd = port_flash.flash_attention_fwd

    def counting(*a, **k):
        calls.append(1)
        return fwd(*a, **k)
    monkeypatch.setattr(port_flash, "flash_attention_fwd", counting)
    jcfg, tcfg = _cfgs()
    cfg = dataclasses.replace(tcfg, remat=policy != "none",
                              remat_policy=policy)
    tp = params_from_numpy(_jax_params(jcfg), cfg, device="cpu",
                           dtype=torch.float32)
    leaves = list(_leaves(tp).values())
    for t in leaves:
        t.requires_grad_(True)
    loss = tt.lm_loss(tp, {"input_ids": torch.from_numpy(_ids(3))}, cfg)
    L = cfg.num_layers
    assert len(calls) == L
    with _CountMM() as counter:
        torch.autograd.grad(loss, leaves)
    assert len(calls) == (2 * L if replays_flash else L)
    # per layer: 7 weight matmuls (q, k, v, o, in, gate, out) and their
    # 2 grad matmuls each; the head's matmul and its 2 grads. A replay
    # stops once the saved values the backward needs exist again, so it
    # never re-runs w_out, whose output nothing saves.
    plain = L * 7 * 2 + 2
    assert counter.mm == plain + (L * 6 if replays_dots else 0)


def test_dropout_and_jax_only_policies_raise():
    with pytest.raises(NotImplementedError, match="A12"):
        tt.llama_config("tiny", dropout_rate=0.1)
    with pytest.raises(NotImplementedError, match="A5"):
        tt.llama_config("tiny", remat_policy="offload_dots")


def test_flops_per_token_matches_jax():
    jcfg, tcfg = _cfgs(remat=True)
    assert tt.make_model(tcfg).flops_per_token() == \
        jt.make_model(jcfg).flops_per_token()


# ---------------------------------------------------------------------------
# (c) optimizers and LR schedules
# ---------------------------------------------------------------------------

def _opt_tree(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 8, 16), "layers": {"a": (4, 16), "b": (4, 16, 8)}}

    def make(shape):
        return rng.standard_normal(shape).astype(np.float32)
    tree = {"w": make(shapes["w"]),
            "layers": {k: make(v) for k, v in shapes["layers"].items()}}
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


OPT_CASES = [
    ("adam", dict(lr=1e-2, weight_decay=0.01), "bfloat16", 0.0),
    ("adamw", dict(lr=3e-3, weight_decay=0.1), "float32", 0.0),
    ("adamw", dict(lr=1e-2, use_master_weights=False), "float32", 0.5),
    ("fusedadam", dict(lr=2e-3, amsgrad=True, betas=(0.8, 0.95)),
     "float32", 0.0),
    ("adamw", dict(lr="warmup", bias_correction=False), "bfloat16", 1.0),
]


@pytest.mark.parametrize("name,kw,dtype,clip", OPT_CASES)
def test_optimizer_state_matches_jax(name, kw, dtype, clip):
    """5 updates on fixed grads: every state leaf and the params, leaf for
    leaf (step, exp_avg, exp_avg_sq, master, max_exp_avg_sq)."""
    kw = dict(kw)
    jkw, tkw = dict(kw), dict(kw)
    if kw["lr"] == "warmup":
        sched = dict(warmup_max_lr=1e-2, warmup_num_steps=3)
        jkw["lr"] = jax_lr.warmup_lr(**sched)
        tkw["lr"] = port_lr.warmup_lr(**sched)
    jbuild = {"adam": jax_adam, "adamw": jax_adamw,
              "fusedadam": jax_adam}[name]
    jopt, topt = jbuild(**jkw), get_optimizer_builder(name)(**tkw)
    if clip:
        jopt = jax_opt.chain_clip_by_global_norm(jopt, clip)
        topt = port_opt.chain_clip_by_global_norm(topt, clip)
    p = _opt_tree(0, dtype)
    grads = [_opt_tree(s, "float32") for s in range(1, 6)]
    jp, tp = _to_jax(p, dtype), _to_torch(p, dtype)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    for g in grads:
        jp, jstate = jopt.update(_to_jax(g, "float32"), jstate, jp)
        tp, tstate = topt.update(_to_torch(g, "float32"), tstate, tp)
    assert int(np.asarray(jstate["step"])[0]) == tstate["step"] == 5
    for key in ("exp_avg", "exp_avg_sq", "master", "max_exp_avg_sq"):
        if jstate.get(key) is None:
            assert tstate.get(key) is None, key
            continue
        jl, tl = _leaves(jstate[key]), _leaves(tstate[key])
        for leaf in jl:
            assert tl[leaf].dtype == torch.float32
            assert rel_l2(_np(tl[leaf]), _np(jl[leaf])) <= 1e-5, (key, leaf)
    jl, tl = _leaves(jp), _leaves(tp)
    for leaf in jl:
        tol = 2e-2 if dtype == "bfloat16" else 1e-5
        assert rel_l2(_np(tl[leaf]), _np(jl[leaf])) <= tol, leaf


SCHEDULES = [
    ("LRRangeTest", dict(lr_range_test_min_lr=1e-4,
                         lr_range_test_step_size=7,
                         lr_range_test_staircase=True)),
    ("OneCycle", dict(cycle_min_lr=1e-4, cycle_max_lr=1e-2,
                      cycle_first_step_size=10, cycle_second_step_size=15,
                      decay_step_size=5, decay_lr_rate=0.1)),
    ("WarmupLR", dict(warmup_min_lr=1e-5, warmup_max_lr=1e-3,
                      warmup_num_steps=20)),
    ("WarmupLR", dict(warmup_max_lr=1e-3, warmup_num_steps=20,
                      warmup_type="linear")),
    ("WarmupDecayLR", dict(total_num_steps=40, warmup_max_lr=1e-3,
                           warmup_num_steps=10)),
    ("CosineAnnealing", dict(max_lr=1e-3, total_num_steps=45,
                             warmup_num_steps=5, min_lr=1e-5)),
]


@pytest.mark.parametrize("name,params", SCHEDULES)
def test_lr_schedule_matches_jax(name, params):
    """50 steps: the port's host schedule equals the JAX schedule on host
    ints exactly, and its in-graph (jnp) values to f32 rounding."""
    js = jax_lr.get_scheduler(name, params)
    ts = port_lr.get_scheduler(name, params)
    for step in range(50):
        want = float(js(step))
        assert float(ts(step)) == want, step
        traced = float(js(jnp.asarray(step, jnp.int32)))
        assert abs(float(ts(step)) - traced) <= 1e-6 * max(abs(traced), 1e-8)
    assert port_lr.get_scheduler(None, {}) is None
    with pytest.raises(ValueError):
        port_lr.get_scheduler("Nope", {})


def test_registry_names_its_roadmap_item():
    for name in ("lamb", "lion", "sgd", "onebitadam", "cpuadam"):
        with pytest.raises(NotImplementedError, match="A3"):
            get_optimizer_builder(name)
    with pytest.raises(ValueError):
        get_optimizer_builder("nope")


# ---------------------------------------------------------------------------
# (f) config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("triad", [dict(train_batch_size=8,
                                        train_micro_batch_size_per_gpu=3,
                                        gradient_accumulation_steps=2),
                                   dict(train_batch_size=10,
                                        train_micro_batch_size_per_gpu=4),
                                   dict(train_batch_size=2,
                                        gradient_accumulation_steps=4)])
def test_bad_batch_triad_raises(triad):
    cfg = Config.load(triad)
    with pytest.raises(ConfigError):
        cfg.resolve_batch_size(1)


def test_batch_triad_solves_as_jax():
    from deepspeed_tpu.config import Config as JaxConfig
    for triad in (dict(train_batch_size=16, gradient_accumulation_steps=4),
                  dict(train_micro_batch_size_per_gpu=2,
                       gradient_accumulation_steps=3),
                  dict(train_batch_size=12), {}):
        a, b = Config.load(dict(triad)), JaxConfig.load(dict(triad))
        a.resolve_batch_size(1)
        b.resolve_batch_size(1)
        assert (a.train_batch_size, a.train_micro_batch_size_per_gpu,
                a.gradient_accumulation_steps) == (
                    b.train_batch_size, b.train_micro_batch_size_per_gpu,
                    b.gradient_accumulation_steps)


@pytest.mark.parametrize("section,item", [
    ({"fp16": {"enabled": True}}, "A3"),
    ({"zero_optimization": {"stage": 3,
                            "offload_optimizer": {"device": "cpu"}}}, "A8"),
    ({"pipeline": {"stages": 2}}, "A4"),
    ({"tensor_parallel": {"tp_size": 2}}, "A9"),
    ({"comm": {"deferred_grad_sync": True}}, "A4"),
    ({"telemetry": {"enabled": True}}, "A11"),
    ({"moe": {"enabled": True}}, "A9"),
    ({"transformer": {"tp_overlap_chunks": 4}}, "A9"),
])
def test_out_of_slice_sections_raise(section, item):
    with pytest.raises(NotImplementedError, match=item):
        Config.load(section)


def test_config_keys_of_the_slice(caplog):
    with caplog.at_level(logging.WARNING, logger="deepspeed_tpu_torch"):
        cfg = Config.load({
            "train_batch_size": 8, "optimizer": {"type": "AdamW",
                                                 "params": {"lr": 1e-4}},
            "scheduler": {"type": "WarmupLR", "params": {}},
            "bf16": {"enabled": False}, "zero_optimization": {"stage": 2},
            "gradient_clipping": 1.0, "steps_per_print": 5,
            "transformer": {"fused_backward": True},
            "pipeline": {"stages": 1}, "telemetry": {"enabled": False},
            "fp16": {"enabled": False, "loss_scale": 0},
            "no_such_key": 1})
    assert "no_such_key" in caplog.text and "fp16.loss_scale" in caplog.text
    assert cfg.compute_dtype == torch.float32
    assert cfg.optimizer.name == "AdamW" and cfg.transformer.fused_backward
    assert Config.load({}).compute_dtype == torch.bfloat16   # JAX default
    with pytest.raises(ConfigError):
        Config.load({"optimizer": {"type": "nope"}})
    with pytest.raises(ConfigError):
        Config.load({"zero_optimization": {"stage": 4}})


# ---------------------------------------------------------------------------
# (d) the whole slice: initialize -> train_batch, engine against engine
# ---------------------------------------------------------------------------

ENGINE_CONFIG = {
    "train_batch_size": 8, "gradient_accumulation_steps": 2,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-3,
                                              "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 0.0, "warmup_max_lr": 1e-3, "warmup_num_steps": 3}},
    "gradient_clipping": 1.0, "zero_optimization": {"stage": 1},
    "transformer": {"fused_backward": True}}


def _engines(dtype):
    jcfg = jt.llama_config("tiny", vocab_size=512, num_layers=2, max_seq_len=S,
                           **({"dtype": jnp.float32} if dtype == "float32"
                              else {}))
    tcfg = tt.llama_config("tiny", vocab_size=512, num_layers=2, max_seq_len=S,
                           **({"dtype": torch.float32} if dtype == "float32"
                              else {}))
    conf = dict(ENGINE_CONFIG, bf16={"enabled": dtype == "bfloat16"})
    je, *_ = deepspeed_tpu.initialize(model=jt.make_model(jcfg),
                                      config=dict(conf),
                                      devices=jax.devices()[:1])
    # the JAX engine's own initial f32 params (its init at PRNGKey(seed))
    p0 = jax.tree.map(np.asarray,
                      jt.make_model(jcfg).init(jax.random.PRNGKey(42)))
    te, opt, loader, sched = deepspeed_tpu_torch.initialize(
        model=tt.make_model(tcfg), config=dict(conf), params=p0,
        device="cpu")
    assert loader is None and sched is te.lr_scheduler and opt is te.optimizer
    return je, te


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_matches_jax_engine(dtype):
    je, te = _engines(dtype)
    assert te.config.gradient_accumulation_steps == 2
    assert te.config.train_micro_batch_size_per_gpu == 4
    assert te.model.config.fused_backward
    rng = np.random.default_rng(0)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for step in range(5):
        batch = {"input_ids": rng.integers(0, 512, (8, S), dtype=np.int32)}
        jm = je.train_batch(batch)
        tm = te.train_batch(batch)
        assert isinstance(tm["loss"], torch.Tensor) and tm["loss"].dim() == 0
        jl, tl = float(jm["loss"]), float(tm["loss"])
        assert abs(tl - jl) <= tol * abs(jl), step
        assert te.get_lr() == je.get_lr(), step
    assert te.global_steps == je.global_steps == 5
    assert te.micro_steps == 10
    if dtype == "bfloat16":
        assert te.state["opt"]["master"] is not None
        return
    jp, tp = _leaves(jax.tree.map(np.asarray, je.params)), _leaves(te.params)
    for name, a in jp.items():
        assert tp[name].dtype == torch.float32
        assert rel_l2(_np(tp[name]), a) <= 1e-4, name
    ev = {"input_ids": _ids(9, 3, S)}
    assert abs(float(te.eval_batch(ev)) - float(je.eval_batch(ev))) \
        <= 1e-5 * float(je.eval_batch(ev))


def test_engine_surface_outside_the_slice():
    _, tcfg = _cfgs()
    model = tt.make_model(tcfg)
    conf = {"train_batch_size": 2, "bf16": {"enabled": False}}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            deepspeed_tpu_torch.initialize(model=model, config=dict(conf))
    eng, *_ = deepspeed_tpu_torch.initialize(model=model, config=dict(conf),
                                             device="cpu")
    assert eng.get_lr() == 0.0 and eng.state["opt"]["master"] is None
    for call, item in ((lambda: eng.train_batches(iter([]), 1), "A4"),
                       (lambda: eng.forward({}), "A4"),
                       (lambda: eng.save_checkpoint("x"), "A5"),
                       (lambda: eng.load_checkpoint("x"), "A5")):
        with pytest.raises(NotImplementedError, match=item):
            call()
    with pytest.raises(NotImplementedError, match="A4"):
        deepspeed_tpu_torch.initialize(model=model, config=dict(conf),
                                       device="cpu", training_data=[1])
    with pytest.raises(ValueError, match="global batch"):
        eng.train_batch({"input_ids": _ids(0, 3, 8)})
    m = eng.train_batch({"input_ids": _ids(0, 2, 8)})
    assert m["loss"].dtype == torch.float32 and not bool(m["overflow"])
    assert eng.global_steps == 1


def test_engine_client_optimizer_and_schedule(monkeypatch):
    """A client init/update optimizer and schedule are used as given (the
    schedule is what get_lr reports, as in JAX); anything else, or more
    than one rank, raises."""
    _, tcfg = _cfgs()
    model = tt.make_model(tcfg)
    conf = {"train_batch_size": 2, "bf16": {"enabled": False}}
    opt = get_optimizer_builder("adamw")(lr=0.25)
    eng, got_opt, _, sched = deepspeed_tpu_torch.initialize(
        model=model, config=dict(conf), optimizer=opt,
        lr_scheduler=lambda step: 0.5, device="cpu")
    assert got_opt is opt and sched(7) == 0.5 and eng.get_lr() == 0.5
    eng.train_batch({"input_ids": _ids(0, 2, 8)})
    assert eng.state["opt"]["step"] == 1
    with pytest.raises(TypeError):
        deepspeed_tpu_torch.initialize(model=model, config=dict(conf),
                                       optimizer=object(), device="cpu")
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="A4"):
        deepspeed_tpu_torch.initialize(model=model, config=dict(conf),
                                       device="cpu")
