"""The model families on a mesh against the JAX package, at f32, hidden 64
and 2 layers, on gloo groups of 2 and 4 ranks
(``_torch_families_mesh_workers``), each held against JAX's engine on
the same mesh of the conftest's virtual devices and the same
numpy-seeded weights (every bias and norm leaf redrawn nonzero: JAX's
init makes them 0 / 1, where a dropped bias would pass):

- training, 2 steps of SGD with momentum: GPT-2 (tied head, learned
  positions) on tensor=2, with the row-parallel sum in 2 chunks, and on
  data=2 x fsdp=2 at ZeRO-3; BLOOM (ALiBi, embedding norm) on tensor=2;
  BERT (bidirectional, token types, post-LN, a padded batch) on tensor=2
  and data=2; GPT-J (head bias, parallel block, interleaved partial
  rotary) on tensor=2 through the chunked loss (held to JAX's full loss:
  JAX's chunked loss leaves the head bias out); a layernorm PR-MoE
  family on expert=2; GPT-Neo (a local window) and GPT-2 on seq=2; BLOOM
  on seq=2 (JAX's ring, without the bias: ROADMAP C11); GPT-2, GPT-J and
  an ALiBi model with a head bias on pipe=2. Losses within 1e-5
  (relative), params by relative L2 <= 1e-5 per leaf;
- serving: BLOOM (the paged decode at ALiBi's rank offset) and GPT-J
  (the vocab-sharded head bias) at tensor=2, BLOOM's one-shot generate
  at tensor=2: greedy f32 streams token-identical to JAX's; BERT's
  logits with a key mask and token types at tensor=2 and data=2 within
  1e-5 relative L2;
- each rank's leaves: column biases halved with their columns, row
  biases and norms whole, vocab leaves halved;
- the reference defects this slice records: JAX's ring drops ALiBi's
  bias (C11), JAX's sparse branch drops it (C12), and JAX's pipeline
  drops token types, the embedding norm and the windows (C13); the
  port refuses the last three over ``pipe`` naming its label.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel import MeshPlan as JaxPlan
from deepspeed_tpu.parallel import build_mesh as jax_build_mesh
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as pt
from deepspeed_tpu_torch.parallel import Mesh, MeshPlan
from deepspeed_tpu_torch.parallel.launch import run_group

from tests import _torch_families_mesh_workers as W
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

TOL = 1e-5


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jcfg(name, **over):
    return jt.TransformerConfig(**{**W.BASE, **W.FAMILIES[name], **over},
                                dtype=jnp.float32, attention_impl="xla")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def _seeded(name, seed=0, **over):
    """JAX's init of the family as numpy, every bias and norm leaf
    redrawn from ``seed``: biases N(0, 0.1), norm scales 1 + N(0, 0.1)."""
    tree = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(seed),
                                                   _jcfg(name, **over)))
    rng = np.random.default_rng(seed + 1)

    def draw(path, a):
        a = np.asarray(a, np.float32)
        leaf = path.rsplit("/", 1)[-1]
        if leaf.endswith("_scale"):
            return (1.0 + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
        if leaf.startswith("b") or leaf.endswith("_bias"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return a

    out = {k: draw(k, v) for k, v in tree.items() if k != "layers"}
    out["layers"] = {k: draw("layers/" + k, v)
                     for k, v in tree["layers"].items()}
    return out


def _sharp(tree):
    """``tree`` with sharper and louder attention (wq, wk, wv, wo times
    8), the embedding and head times 30 and token-type rows times 50: the
    defect tests tell a dropped bias, band or table from float noise,
    where a random init's near-uniform softmax, small attention output
    and flat logits hide it."""
    layers = dict(tree["layers"], **{k: tree["layers"][k] * 8
                                     for k in ("wq", "wk", "wv", "wo")})
    out = dict(tree, layers=layers)
    for k, f in (("tok_embed", 30), ("lm_head", 30), ("tok_type_embed", 50)):
        if k in tree:
            out[k] = tree[k] * f
    return out


def _mesh(n, **axes):
    return jax_build_mesh(JaxPlan(**axes), devices=jax.devices()[:n])


def _jax_train(name, config, n_dev, tree):
    """JAX's engine on ``n_dev`` devices, its params replaced by ``tree``
    (each leaf put where the engine laid it out), ``STEPS`` steps."""
    e, *_ = deepspeed_tpu.initialize(model=jt.make_model(_jcfg(name)),
                                     config=config,
                                     devices=jax.devices()[:n_dev])
    e.state["params"] = jax.tree.map(
        lambda old, new: jax.device_put(jnp.asarray(new, old.dtype),
                                        old.sharding),
        e.state["params"], tree)
    losses = [float(e.train_batch(b)["loss"]) for b in W.batches(name)]
    return {"losses": losses, "plan": e.plan.describe(),
            "params": {k: np.asarray(v, np.float32)
                       for k, v in _flat(e.state["params"]).items()}}


def _jax_serving_streams(name, tree, mesh):
    srv = deepspeed_tpu.init_serving(
        jt.make_model(_jcfg(name)), config={"kv_cache_bits": 0},
        serving=W.SERVING, dtype=jnp.float32, params=tree, mesh=mesh)
    outs = srv.run(W.load())
    return [np.asarray(outs[k]) for k in sorted(outs)]


def _jax_side(trees):
    out = {}
    for n, (fam, config, _) in {**W.TRAIN2, **W.TRAIN4}.items():
        if n == "gpt2_tp2_chunks2":
            continue                    # held to gpt2_tp2's run
        out[n] = _jax_train(fam, config, 4 if n in W.TRAIN4 else 2,
                            trees[fam])
    tp2 = _mesh(2, tensor=2)
    for fam in W.SERVED:
        out[f"serve_{fam}"] = _jax_serving_streams(fam, trees[fam], tp2)
    eng = deepspeed_tpu.init_inference(
        jt.make_model(_jcfg("bloom")), config={"kv_cache_bits": 0},
        dtype=jnp.float32, params=trees["bloom"])
    ids = np.stack([p[:7] for p, _ in W.load(1)[:2]])
    out["generate_bloom"] = np.asarray(eng.generate(ids, max_new_tokens=8))
    ids, mask, types = W.encoder_inputs()
    out["bert_fwd"] = np.asarray(jax.jit(
        lambda p: jt.forward(p, ids, _jcfg("bert"), attention_mask=mask,
                             token_type_ids=types))(trees["bert"]))
    return out


@pytest.fixture(scope="module")
def runs():
    trees = {n: _seeded(n) for n in W.FAMILIES}
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        fut2 = ex.submit(run_group, W.group2, 2, trees, threads=1,
                         timeout_s=900)
        fut4 = ex.submit(run_group, W.group4, 4, trees, threads=1,
                         timeout_s=900)
        jax_side = _jax_side(trees)
        two, four = fut2.result(), fut4.result()
    return {"jax": jax_side, "two": two, "four": four, "trees": trees}


def _matches(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL,
                               atol=1e-7)
    assert set(got["params"]) == set(want["params"])
    for k in want["params"]:
        assert rel_l2(got["params"][k], want["params"][k]) <= TOL, k


TRAINED = [n for n in W.TRAIN2 if n != "gpt2_tp2_chunks2"]


@pytest.mark.parametrize("scenario", TRAINED + list(W.TRAIN4))
def test_training_matches_jax_on_the_same_mesh(runs, scenario):
    """Losses and params after 2 steps on every rank, against JAX's
    engine on the same mesh (C11's ring for BLOOM on seq=2)."""
    want = runs["jax"][scenario]
    ranks = runs["four"] if scenario in W.TRAIN4 else runs["two"]
    for r in ranks:
        got = r[scenario]
        assert got["plan"] == want["plan"]
        _matches(got, want)


def test_row_biases_are_added_once_after_the_sum(runs):
    """``tp_overlap_chunks`` 2 cuts the row-parallel sum in two pieces;
    ``bo`` and ``b_out`` join after it: the run equals the one-piece run
    bit for bit, and JAX's."""
    for r in runs["two"]:
        got, one = r["gpt2_tp2_chunks2"], r["gpt2_tp2"]
        assert got["losses"] == one["losses"]
        for k in one["params"]:
            assert np.array_equal(got["params"][k], one["params"][k]), k
        _matches(got, runs["jax"]["gpt2_tp2"])


@pytest.mark.parametrize("scenario", ["gpt2_tp2", "gptj_tp2", "bloom_tp2"])
def test_each_rank_holds_the_law_of_its_leaves(runs, scenario):
    """At tensor=2 a rank holds half of every column leaf with its bias
    (wq / wk / wv with bq / bk / bv, w_in with b_in), of every row leaf
    (wo, w_out) and vocab leaf (tok_embed, lm_head, lm_head_bias), and
    the row biases, norms and position table whole."""
    fam = scenario.split("_")[0]
    whole = _flat(runs["trees"][fam])
    halved = {"tok_embed": 0, "lm_head": 1, "lm_head_bias": 0,
              "layers/wo": 1, "layers/w_out": 1}
    halved.update({f"layers/{k}": -1 for k in (
        "wq", "wk", "wv", "bq", "bk", "bv", "w_in", "b_in")})
    for r in runs["two"]:
        shapes = r[scenario]["shapes"]
        assert set(shapes) == set(whole)
        for k, a in whole.items():
            want = list(a.shape)
            if k in halved:
                want[halved[k]] //= 2
            assert tuple(shapes[k]) == tuple(want), k


@pytest.mark.parametrize("fam", W.SERVED)
def test_served_at_tensor2_matches_jax(runs, fam):
    """Greedy f32 streams at tensor=2 (BLOOM: the paged decode's ALiBi at
    the rank's head offset; GPT-J: the vocab-sharded head bias) are
    JAX's tensor=2 engine's, token for token."""
    got, want = runs["two"][0][f"serve_{fam}"], runs["jax"][f"serve_{fam}"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_generate_at_tensor2_matches_jax(runs):
    for r in runs["two"]:
        np.testing.assert_array_equal(r["generate_bloom"],
                                      runs["jax"]["generate_bloom"])


@pytest.mark.parametrize("mesh", ["tp2", "dp2"])
def test_encoder_forward_on_a_mesh_matches_jax(runs, mesh):
    """BERT's logits with a key mask and token types: at tensor=2 (the
    vocab assembly, the row biases), and at data=2 (each rank's rows of
    the ids, the mask and the token types)."""
    for r in runs["two"]:
        assert rel_l2(r[f"bert_fwd_{mesh}"], runs["jax"]["bert_fwd"]) <= TOL


# ---------------------------------------------------------------------------
# the reference defects: C11 (ring), C12 (sparse), C13 (pipeline)
# ---------------------------------------------------------------------------

def test_jax_ring_drops_the_alibi_bias():
    """ROADMAP C11. JAX's ring branch runs before ALiBi's bias is added,
    so BLOOM's loss on seq=2 is the loss of the same weights without
    positions (``position_type="none"``) on one device, and not its own
    one-device loss; the port follows JAX's ring
    (``test_training_matches_jax_on_the_same_mesh[bloom_sp2]``)."""
    tree = _sharp(_seeded("bloom"))
    batch = W.batches("bloom", 1)[0]

    def eval_loss(cfg_over, config, n):
        e, *_ = deepspeed_tpu.initialize(
            model=jt.make_model(_jcfg("bloom", **cfg_over)), config=config,
            devices=jax.devices()[:n])
        e.state["params"] = jax.tree.map(
            lambda old, new: jax.device_put(jnp.asarray(new, old.dtype),
                                            old.sharding),
            e.state["params"], tree)
        return float(e.eval_batch(batch))

    ring = eval_loss({}, W.conf(0, **W.SP), 2)
    none = eval_loss({"position_type": "none"}, W.conf(0), 1)
    own = eval_loss({}, W.conf(0), 1)
    assert abs(ring - none) <= 1e-6 * abs(none)
    assert abs(ring - own) > 1e-3 * abs(own)


SPARSE = {"mode": "fixed", "block": 16, "num_local_blocks": 1,
          "num_global_blocks": 1}


@pytest.mark.parametrize("variant", ["alibi", "windows"])
def test_sparse_model_with_alibi_or_windows_routes_as_jax(variant):
    """ROADMAP C12. JAX builds a block-sparse model with ALiBi or windows:
    its sparse branch runs before ALiBi's bias is added (the loss is that
    of the model without positions, not the dense ALiBi model's), and a
    windowed layer leaves the
    sparse branch for the dense band. The port routes both the same way:
    loss and grads against JAX's (its sparse kernel in interpret mode)."""
    over = (dict(position_type="alibi") if variant == "alibi"
            else dict(attn_windows=(8, 0)))
    over["sparse_attention"] = SPARSE
    name = "gpt2" if variant == "windows" else "bloom"
    jcfg = _jcfg(name, **over)
    tcfg = W.pcfg(name, **over)
    tree = _sharp(_seeded(name))
    ids = W.batches(name, 1)[0]["input_ids"][:2]

    def jloss(cfg):
        return jax.jit(jax.value_and_grad(
            lambda p: jt.lm_loss(p, {"input_ids": jnp.asarray(ids)},
                                 cfg)))(tree)

    want, wgrads = jloss(jcfg)
    params = convert.params_from_numpy(tree, tcfg, device="cpu",
                                       dtype=torch.float32)
    leaves = {k: v.requires_grad_() for k, v in _flat(params).items()}
    got = pt.lm_loss(params, {"input_ids": torch.as_tensor(ids).long()},
                     tcfg)
    got.backward()
    assert abs(float(got) - float(want)) <= TOL * abs(float(want))
    wflat = _flat(jax.tree.map(np.asarray, wgrads))
    scale = max(np.abs(g).max() for g in wflat.values())
    for k, t in leaves.items():
        err = np.abs(t.grad.numpy() - wflat[k]).max()
        assert err <= 1e-4 * max(np.abs(wflat[k]).max(), 1e-3 * scale), k
    if variant == "alibi":
        none, _ = jloss(_jcfg(name, **{**over, "position_type": "none"}))
        dense, _ = jloss(_jcfg(name, position_type="alibi"))
        assert abs(float(none) - float(want)) <= 1e-6 * abs(float(want))
        assert abs(float(dense) - float(want)) > 1e-3 * abs(float(want))


@pytest.mark.parametrize("name,over,field", [
    ("gpt2", dict(type_vocab_size=2), "tok_type_embed"),
    ("gpt2", dict(embed_norm=True), "embed_norm"),
    ("neo", {}, "attn_windows"),
    ("bert", {}, "final_norm=False")])
def test_jax_pipeline_drops_what_the_port_refuses(name, over, field):
    """ROADMAP C13. JAX's pipeline embeds the token and position rows
    only and passes no window (``deepspeed_tpu/models/
    pipeline_wrapper.py``): its pipe=2 loss of a model with token types,
    an embedding norm or windows is the loss of the model without them,
    and a model with ``final_norm=False`` fails on the missing
    ``final_norm_scale``. The port raises ``NotImplementedError`` naming
    its label for each, before any process group is touched."""
    with pytest.raises(NotImplementedError,
                       match="A11 \\(the leaves JAX's pipeline drops\\)"):
        deepspeed_tpu_torch.initialize(
            model=pt.make_model(W.pcfg(name, **over)),
            mesh=Mesh(MeshPlan(pipe=2)), config=W.conf(0, **W.PP),
            device="cpu")
    from deepspeed_tpu.models.pipeline_wrapper import make_pipelined_model
    tree = _sharp(_seeded(name, **over))
    ids = jnp.asarray(W.batches(name, 1)[0]["input_ids"])
    mesh = _mesh(2, pipe=2)
    pmodel = make_pipelined_model(_jcfg(name, **over), mesh,
                                  num_microbatches=2)

    def piped_loss():
        with mesh:
            return float(jax.jit(lambda p: pmodel.loss_fn(
                p, {"input_ids": ids}))(tree))

    if field == "final_norm=False":
        with pytest.raises(KeyError, match="final_norm_scale"):
            piped_loss()
        return
    piped = piped_loss()
    without = {"tok_type_embed": dict(type_vocab_size=0),
               "embed_norm": dict(embed_norm=False),
               "attn_windows": dict(attn_windows=None)}[field]
    mbs = ids.reshape(2, -1, ids.shape[1])

    def mean_loss(cfg, p):
        return float(jax.jit(lambda p: sum(
            jt.lm_loss(p, {"input_ids": mbs[i]}, cfg)
            for i in range(2)) / 2)(p))

    cfg = _jcfg(name, **{**over, **without})
    axes = jt.logical_axes(cfg)
    plain = mean_loss(cfg, {k: v for k, v in tree.items() if k in axes})
    own = mean_loss(_jcfg(name, **over), tree)
    assert abs(piped - plain) <= 1e-5 * abs(plain)
    assert abs(piped - own) > 1e-3 * abs(own)


def test_hf_import_loads_onto_a_mesh():
    """An imported family goes straight onto a mesh: a GPT-2 HF state dict
    (the seeded tree exported by JAX's ``export_hf_state_dict``) through
    the port's ``load_hf_params``, then ``params_from_numpy(mesh=)`` at
    tensor=2 gives the rank its slice of every leaf of the whole tree, by
    JAX's rules."""
    from deepspeed_tpu.models import hf_import as jh
    from deepspeed_tpu_torch.models import hf_import as ph
    from deepspeed_tpu_torch.parallel.partitioning import (own_shard,
                                                           spec_tree)
    tree = _seeded("gpt2")
    sd = jh.export_hf_state_dict(tree, _jcfg("gpt2"))
    cfg = W.pcfg("gpt2")
    whole = ph.load_hf_params(sd, cfg, family="gpt2")
    mesh = Mesh(MeshPlan(tensor=2))
    got = _flat(convert.params_from_numpy(whole, cfg, device="cpu",
                                          dtype=torch.float32, mesh=mesh))
    specs = _flat(spec_tree(pt.logical_axes(cfg)))
    for k, a in _flat(whole).items():
        np.testing.assert_array_equal(got[k].numpy(),
                                      own_shard(np.asarray(a), specs[k],
                                                mesh, k))
        np.testing.assert_array_equal(np.asarray(a), _flat(tree)[k])
    assert tuple(got["tok_embed"].shape) == (W.BASE["vocab_size"] // 2,
                                             W.BASE["hidden_size"])
