"""The layer executor's compositions at one rank (``runtime/infinity.py``)
against JAX's ``InfinityExecutor`` on the same numpy weights: the model
families, the training extras JAX's executor applies inside each streamed
layer (compression, MoQ) or before it (the seqlen curriculum), the live
param cache, a JAX executor checkpoint loaded into the port, and what
stays refused, each with the test of what JAX's executor computes there
(ROADMAP C19, C20).

Everything runs on the CPU, hidden-64 models, one JAX engine a case. Both
executors start from one seeded tree whose biases and norms are nonzero
(JAX's init makes them 0 and 1, which would hide a dropped leaf): JAX's
store and embedding / head state are overwritten with it, the port takes
it as ``params=``. Bars as in ``test_torch_infinity.py``: losses within
1e-5 (relative), masters within 1e-6 relative L2; the cached and
uncached runs bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import transformer as tt

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

V, S, B, GAS, STEPS = 256, 32, 4, 2, 3
BASE = dict(vocab_size=V, num_layers=2, max_seq_len=S, hidden_size=64,
            num_heads=4, num_kv_heads=4, intermediate_size=128)
FAMILIES = {
    "gpt2": dict(position_type="learned", activation="gelu",
                 norm_type="layernorm", tie_embeddings=True),
    "bloom": dict(position_type="alibi", activation="gelu",
                  norm_type="layernorm", embed_norm=True,
                  tie_embeddings=True),
    "gptj": dict(position_type="rotary", rotary_dim=8,
                 rotary_interleaved=True, parallel_block=True,
                 activation="gelu", norm_type="layernorm", qkv_bias=False,
                 tie_embeddings=False),
    # BERT's blocks without the leaves JAX's executor drops (token types,
    # final_norm=False): post-LN, bidirectional, masked keys
    "post_ln": dict(position_type="learned", activation="gelu",
                    norm_type="layernorm", causal=False, norm_style="post",
                    embed_norm=True, tie_embeddings=True),
    "llama": dict(),
}


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def cfgs(family, **over):
    kw = {**BASE, **FAMILIES[family], **over}
    return (jt.TransformerConfig(**kw, dtype=jnp.float32),
            tt.TransformerConfig(**kw, dtype=torch.float32))


def conf(path, **extra):
    c = {"train_batch_size": B * GAS, "train_micro_batch_size_per_gpu": B,
         "gradient_accumulation_steps": GAS,
         "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "eps": 1e-3}},
         "bf16": {"enabled": False}, "gradient_clipping": 0.5,
         "zero_optimization": {
             "stage": 3,
             "offload_param": {"device": "cpu"},
             "offload_optimizer": {"device": "cpu"}},
         "steps_per_print": 10 ** 6}
    c.update(extra)
    return c


def seeded_tree(jcfg, seed=0):
    """JAX's init with every bias and norm leaf drawn nonzero."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed),
                                                   jcfg))

    def draw(name, a):
        a = np.array(a, np.float32)
        if "scale" in name:
            return (1.0 + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        if name.startswith("b") or "bias" in name:
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    out = {k: draw(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: draw(k, v) for k, v in tree["layers"].items()}
    return out


def seed_jax_executor(ex, tree):
    """Overwrite a JAX executor's layer chunks and embedding / head state
    with ``tree`` (bf16 chunks, as its init writes them)."""
    names = sorted(tree["layers"])
    for i in range(ex.cfg.num_layers):
        flat = np.concatenate([tree["layers"][n][i].reshape(-1)
                               for n in names]).astype(ml_dtypes.bfloat16)
        flat = np.pad(flat, (0, ex.chunk - flat.size))
        ex.store.write_param(i, flat.view(np.uint16))
    ex._param_cache.clear()
    ex._hbm_cache.clear()
    nl = {k: v for k, v in tree.items() if k != "layers"}
    ex.nl_params = jax.device_put(
        {k: jnp.asarray(v).astype(ex.cfg.dtype) for k, v in nl.items()},
        ex._repl_dev_sh)
    ex.nl_opt = jax.device_put(
        {k: {"master": jnp.asarray(v, jnp.float32),
             "m": jnp.zeros(v.shape, jnp.float32),
             "v": jnp.zeros(v.shape, jnp.float32)} for k, v in nl.items()},
        ex._repl_dev_sh)


def batches(n=STEPS, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"input_ids": rng.integers(0, V, (B * GAS, S), dtype=np.int32)}
        if masked:
            mask = np.ones((B * GAS, S), np.int32)
            for r in range(B * GAS):
                mask[r, S - r % 4:] = 0
            b["attention_mask"] = mask
        out.append(b)
    return out


def jax_run(jcfg, c, tree, data):
    """JAX's executor from ``tree``: each step's loss, each layer's
    optimizer chunk and the embedding / head masters."""
    je, *_ = deepspeed_tpu.initialize(model=jt.make_model(jcfg),
                                      config=dict(c),
                                      devices=jax.devices()[:1])
    ex = je._infinity_exec
    seed_jax_executor(ex, tree)
    losses = [float(je.train_batch(b)["loss"]) for b in data]
    out = {"losses": losses,
           "opt": [np.array(ex.store.read_opt(i))
                   for i in range(jcfg.num_layers)],
           "nl_master": {k: np.asarray(o["master"]) for k, o in
                         jax.device_get(ex.nl_opt).items()}}
    return je, out


def port(tcfg, c, tree):
    return deepspeed_tpu_torch.initialize(
        model=tt.make_model(tcfg), config=dict(c), params=tree,
        device="cpu")[0]


def assert_matches(te, want, data, mtol=1e-6):
    losses = [float(te.train_batch(b)["loss"]) for b in data]
    for got, ref in zip(losses, want["losses"]):
        assert abs(got - ref) <= 1e-5 * abs(ref), (losses, want["losses"])
    ex = te._infinity
    for i, ref in enumerate(want["opt"]):
        got = ex.store.read("opt", i).numpy()
        assert rel_l2(got[0], ref[0]) <= mtol, i
    for k, ref in want["nl_master"].items():
        assert rel_l2(ex.nl_opt[k]["master"], ref) <= mtol, k
    return losses


@pytest.mark.parametrize("family", ["gpt2", "bloom", "gptj", "post_ln"])
def test_family_under_the_executor_matches_jax(family, tmp_path):
    """A family's leaves through the executor: the learned positions and
    the embedding norm in the embedding's forward and backward, the
    layer's biases, post-LN, ALiBi, the parallel block, partial
    interleaved rotary and bidirectional masked attention in the streamed
    layer, and the final norm's bias, against JAX's executor."""
    jcfg, tcfg = cfgs(family)
    tree = seeded_tree(jcfg)
    data = batches(masked=family == "post_ln")
    je, want = jax_run(jcfg, conf(tmp_path / "j"), tree, data)
    te = port(tcfg, conf(tmp_path / "t"), tree)
    assert assert_matches(te, want, data)
    te.close()


COMPRESSION = {
    "weight_quantization": {
        "shared_parameters": {"enabled": True, "schedule_offset": 1},
        "different_groups": {"g": {"params": {"target_bits": 8},
                                   "modules": ["w_in"]}}},
    "sparse_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 0},
        "different_groups": {"g": {"params": {"dense_ratio": 0.5},
                                   "modules": ["w_out"]}}},
    "row_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 1},
        "different_groups": {"g": {"params": {"dense_ratio": 0.75},
                                   "modules": ["layers/wq"]}}},
}
MOQ = {"enabled": True, "quantize_bits": {"start_bits": 12, "target_bits": 6},
       "quantize_schedule": {"quantize_period": 1, "schedule_offset": 0}}
CURRICULUM = {"enabled": True, "curriculum_type": "seqlen",
              "min_difficulty": 16, "max_difficulty": 32,
              "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 2,
                                  "difficulty_step": 8}}
EXTRAS = {"compression": {"compression_training": COMPRESSION},
          "moq": {"quantize_training": MOQ},
          "curriculum": {"curriculum_learning": CURRICULUM},
          "act_quant": {"compression_training": {
              "activation_quantization": {
                  "shared_parameters": {"enabled": True,
                                        "schedule_offset": 0},
                  "different_groups": {"g": {"params": {"bits": 8}}}}}}}


@pytest.mark.parametrize("extra", sorted(EXTRAS))
def test_extra_under_the_executor_matches_jax(extra, tmp_path):
    """Compression (per-layer masks on the one-layer tree, each rule from
    its offset on the executor's step), MoQ (each layer's leaves of 2 or
    more dims at the step's bits), the curriculum (the batch cut to 24,
    32, 32 before the executor) and activation quantization from step 0
    (JAX rebuilds its model before the executor), against JAX's
    executor."""
    jcfg, tcfg = cfgs("llama")
    tree = seeded_tree(jcfg, seed=1)
    data = batches(seed=2)
    c = conf(tmp_path, **EXTRAS[extra])
    je, want = jax_run(jcfg, c, tree, data)
    te = port(tcfg, c, tree)
    if extra == "act_quant":
        assert te._infinity.cfg.activation_quant_bits == 8
    seen = []
    orig = te._infinity.train_batch

    def spy(batch, **kw):
        seen.append(np.asarray(batch["input_ids"]).shape[1])
        return orig(batch, **kw)
    te._infinity.train_batch = spy
    assert_matches(te, want, data)
    if extra == "curriculum":
        assert seen == [24, 32, 32]     # the difficulty of steps 1, 2, 3
    te.close()


def test_moq_probe_is_off_under_the_executor(tmp_path, caplog):
    """MoQ's eigenvalue probe needs the resident params: under the
    executor JAX warns and keeps the uniform period; so does the port."""
    _, tcfg = cfgs("llama")
    moq = dict(MOQ, eigenvalue={"enabled": True, "max_iter": 2})
    with caplog.at_level("WARNING", logger="deepspeed_tpu_torch"):
        te = deepspeed_tpu_torch.initialize(
            model=tt.make_model(tcfg),
            config=conf(tmp_path, quantize_training=moq), device="cpu")[0]
    assert "uniform quantize_period" in caplog.text
    te.train_batch(batches(1)[0])
    assert te._moq._last_ev_step < 0
    assert np.all(te._moq._period_scale == 1.0)
    te.close()


@pytest.mark.parametrize("backend", ["cpu", "nvme"])
def test_live_cache_is_bit_for_bit_and_skips_the_reads(backend, tmp_path):
    """``stage3_max_live_parameters`` of 1.5 layers keeps one layer's
    chunk on the card: losses, every chunk and the masters equal the
    uncached run's bit for bit; the cached run's param reads are the
    uncached run's less one a sweep after the layer is cached (the first
    forward reads it); without the key there is no cache."""
    jcfg, tcfg = cfgs("llama")
    tree = seeded_tree(jcfg, seed=3)
    data = batches(seed=4)
    dev = {"device": backend, "nvme_path": str(tmp_path)}
    base = conf(tmp_path, zero_optimization={
        "stage": 3, "offload_param": dev, "offload_optimizer": dev})
    runs = []
    for live in (None, "set"):
        c = dict(base, zero_optimization=dict(base["zero_optimization"]))
        if live == "set":
            numel = port_layer_numel(tcfg)
            c["zero_optimization"]["stage3_max_live_parameters"] = \
                int(1.5 * numel)
        te = port(tcfg, c, tree)
        ex = te._infinity
        reads = []
        losses = []
        for b in data:
            before = ex.param_reads
            losses.append(float(te.train_batch(b)["loss"]))
            reads.append(ex.param_reads - before)
        chunks = [[ex.store.read(k, i).clone() for k in ("param", "opt")]
                  for i in range(tcfg.num_layers)]
        masters = {k: o["master"].clone() for k, o in ex.nl_opt.items()}
        runs.append((losses, reads, chunks, masters, ex.live_layers))
        te.close()
    plain, cached = runs
    assert plain[4] == 0 and cached[4] == 1
    assert cached[0] == plain[0]
    for (a, b), (c, d) in zip(cached[2], plain[2]):
        assert torch.equal(a.view(torch.int16), c.view(torch.int16))
        assert torch.equal(b, d)
    for k in plain[3]:
        assert torch.equal(cached[3][k], plain[3][k])
    L = tcfg.num_layers
    # step 1: the forward reads every layer (and the lazy init its
    # uncached ones); then each sweep skips the cached layer
    assert plain[1] == [2 * GAS * L + L] + [2 * GAS * L] * (STEPS - 1)
    assert cached[1] == [2 * GAS * L + L - (2 * GAS - 1) - 1] + \
        [2 * GAS * (L - 1)] * (STEPS - 1)


def port_layer_numel(tcfg):
    from deepspeed_tpu_torch.runtime.infinity import layer_template
    return sum(int(np.prod(s)) for _, s in layer_template(tcfg))


def test_jax_executor_checkpoint_loads_into_the_port(tmp_path):
    """A tag JAX's executor saved (its chunks, ``infinity_shapes.json``
    and small state) loads into the port's executor, which then takes
    the same next step as JAX's."""
    jcfg, tcfg = cfgs("gpt2")
    tree = seeded_tree(jcfg, seed=5)
    data = batches(seed=6)
    c = conf(tmp_path / "j", zero_optimization={
        "stage": 3,
        "offload_param": {"device": "nvme", "nvme_path": str(tmp_path)},
        "offload_optimizer": {"device": "nvme",
                              "nvme_path": str(tmp_path)}})
    je, *_ = deepspeed_tpu.initialize(model=jt.make_model(jcfg),
                                      config=dict(c),
                                      devices=jax.devices()[:1])
    seed_jax_executor(je._infinity_exec, tree)
    for b in data[:2]:
        je.train_batch(b)
    je.save_checkpoint(str(tmp_path / "ck"), tag="t")
    want = float(je.train_batch(data[2])["loss"])
    te = port(tcfg, c, None)
    te.load_checkpoint(str(tmp_path / "ck"), tag="t")
    assert te.global_steps == 2 and te._infinity.applied_steps == 2
    got = float(te.train_batch(data[2])["loss"])
    assert abs(got - want) <= 1e-5 * abs(want)
    te.close()


DROPPED = {
    "tok_type_embed": dict(type_vocab_size=2),
    "lm_head_bias": dict(tie_embeddings=False, head_bias=True),
    "final_norm=False": dict(final_norm=False),
}


@pytest.mark.parametrize("leaf", sorted(DROPPED))
def test_jax_executor_drops_what_the_port_refuses(leaf, tmp_path):
    """ROADMAP C19: JAX's executor computes another model where the config
    has token types or a head bias (its loss is the loss of the model
    without them) and raises a KeyError without a final norm; the port
    refuses each, naming A11 (the leaves JAX's executor drops)."""
    jcfg, tcfg = cfgs("gpt2", **DROPPED[leaf])
    with pytest.raises(NotImplementedError,
                       match=r"A11 \(the leaves JAX's executor drops\)"):
        port(tcfg, conf(tmp_path), None)
    data = batches(1, seed=7)
    if leaf == "final_norm=False":
        with pytest.raises(KeyError, match="final_norm_scale"):
            jax_run(jcfg, conf(tmp_path / "j"), seeded_tree(jcfg), data)
        return
    tree = seeded_tree(jcfg, seed=8)
    _, got = jax_run(jcfg, conf(tmp_path / "j"), tree, data)
    key = leaf
    plain_cfg = dataclasses.replace(jcfg, type_vocab_size=0,
                                    head_bias=False)
    plain = {k: v for k, v in tree.items() if k != key}
    _, want = jax_run(plain_cfg, conf(tmp_path / "p"), plain, data)
    assert got["losses"] == want["losses"]


IGNORED = {
    "progressive_layer_drop": {"progressive_layer_drop": {
        "enabled": True, "theta": 0.5, "gamma": 0.1}},
    "random_ltd": {"data_efficiency": {"enabled": True, "data_routing": {
        "random_ltd": {"enabled": True, "layer_token_lr_schedule": None,
                       "random_ltd_schedule": {
                           "min_value": 16, "max_value": 32,
                           "schedule_type": "fixed_linear",
                           "schedule_config": {"require_steps": 4,
                                               "seq_per_step": 16}}}}}},
    "act_quant_offset": {"compression_training": {
        "activation_quantization": {
            "shared_parameters": {"enabled": True, "schedule_offset": 2},
            "different_groups": {"g": {"params": {"bits": 8}}}}}},
}


@pytest.mark.parametrize("extra", sorted(IGNORED))
def test_jax_executor_ignores_what_the_port_refuses(extra, tmp_path):
    """ROADMAP C20: JAX's executor never reads PLD or random-LTD, nor
    activation quantization switched on after step 0 (JAX rebuilds its
    model at the offset; the executor keeps its own): its losses are the
    losses without them; the port refuses each under the executor,
    naming A11 (the extras JAX's executor ignores)."""
    jcfg, tcfg = cfgs("llama")
    with pytest.raises(NotImplementedError,
                       match=r"A11 \(the extras JAX's executor ignores\)"):
        port(tcfg, conf(tmp_path, **IGNORED[extra]), None)
    tree = seeded_tree(jcfg, seed=9)
    with_cfg = dataclasses.replace(
        jcfg, progressive_layer_drop=extra == "progressive_layer_drop")
    data = batches(3 if extra == "act_quant_offset" else 1, seed=10)
    _, got = jax_run(with_cfg, conf(tmp_path / "j", **IGNORED[extra]),
                     tree, data)
    _, want = jax_run(jcfg, conf(tmp_path / "p"), tree, data)
    assert got["losses"] == want["losses"]


@pytest.mark.parametrize("what", ["windows", "moe"])
def test_refusals_that_stay(what, tmp_path):
    """Per-layer windows and MoE experts are not streamed (JAX's
    refusals; the mesh axes JAX refuses are held in
    ``test_torch_infinity_mesh.py``)."""
    _, tcfg = cfgs("llama")
    c = conf(tmp_path)
    err = ValueError
    if what == "windows":
        tcfg = dataclasses.replace(tcfg, attn_windows=(8, 0))
    elif what == "moe":
        tcfg = dataclasses.replace(tcfg, num_experts=4, top_k=2)
    with pytest.raises(err):
        port(tcfg, c, None)
