"""MoE training against JAX: at one rank and over the expert axis.

The one-rank engines (f32, AdamW, clipping 1.0, 3 steps through the
3-call API so each step's grads can be read) run the tiny MoE of the
serving tests (hidden 64, 2 layers, 4 experts, top-2) beside JAX's
engine on one of the conftest's virtual devices, from the JAX engine's
own init (its seed, 42). One
f32 run mixes PR-MoE's residual (``use_residual``), a capacity at which
tokens drop and the chunked loss; another routes with
``drop_tokens=False``; a bf16 run (f32 masters) holds at 2e-2. Bars:
losses and every leaf's grads by relative L2 <= 1e-5 at f32.

Over the expert axis a 2-rank gloo group (``_torch_mp_workers.
group_ep2``, started on a thread while this process runs the JAX
engines) trains with SGD and momentum against JAX's ``{"expert": 2}``
engine on 2 devices: losses, and each rank's expert shards against
JAX's shard on the device at the rank's coordinates. The same run where
tokens drop equals the port's one-rank run: the gate sees the whole
micro-batch (T, the capacity and the cumsum order are the global
batch's), as JAX's does. Universal checkpoints go from one rank to
expert=2 and back.
"""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.moe import sharded_moe as pmoe
from deepspeed_tpu_torch.parallel.launch import run_group
from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod

from tests import _torch_mp_workers as M
from tests import _torch_zero_workers as W
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

VARIANTS = {
    "mix": (dict(use_residual=True, capacity_factor=0.5, loss_chunk=16),
            False),
    "no_drop": (dict(drop_tokens=False), False),
    "bf16": ({}, True),
}


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jcfg(**over):
    return jt.llama_config("tiny", dtype=jnp.float32,
                           **{**W.DIMS, **M.MOE, **over})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def _three_call(e, leaf, bs):
    """(loss, {path: grad}) of each step through forward / backward /
    step; ``leaf(e)`` reads the pending grads as {path: numpy}."""
    out = []
    for b in bs:
        loss = float(e.forward(b))
        grads = leaf(e)
        e.backward()
        e.step()
        out.append((loss, grads))
    return out


def _jax_grads(e):
    return {k: np.asarray(v, np.float32)
            for k, v in _flat(e._pending[1]).items()}


def _port_grads(e):
    paths = sorted(_flat(e.state["params"]))
    return {k: g.detach().float().numpy()
            for k, g in zip(paths, e._pending[1])}


def _conf(bf16):
    return W.conf(0, bf16={"enabled": bf16})


def _jax_ep2(pm, bs):
    e, *_ = deepspeed_tpu.initialize(
        model=jt.make_model(_jcfg()), config=M.conf(0, **M.EP),
        devices=jax.devices()[:2])
    losses = [float(e.train_batch(b)["loss"]) for b in bs]
    shards = {}
    for k, v in _flat(e.state["params"]["layers"]).items():
        if k.startswith("moe_"):
            by_dev = {s.device.id: np.asarray(s.data)
                      for s in v.addressable_shards}
            shards["layers/" + k] = [by_dev[d.id] for d in jax.devices()[:2]]
    return {"losses": losses, "shards": shards, "plan": e.plan}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("moe_training"))
    dirs = {k: os.path.join(tmp, k) for k in ("moe", "ep2")}
    pm = jax.tree.map(np.asarray, jt.make_model(_jcfg()).init(
        jax.random.PRNGKey(42)))
    one = M.engine(pm, M.conf(0), moe=True)
    W.losses(one, W.batches(3))
    one.save_checkpoint(dirs["moe"])
    after_save = W.losses(one, W.batches(5)[3:5])
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_group, M.group_ep2, 2, pm, dirs, threads=1,
                        timeout_s=600)
        bs = W.batches(3)
        jax_side = {"ep2": _jax_ep2(pm, bs)}
        port_side = {}
        for name, (over, bf16) in VARIANTS.items():
            p = jax.tree.map(np.asarray, jt.make_model(_jcfg(**over)).init(
                jax.random.PRNGKey(42)))
            je, *_ = deepspeed_tpu.initialize(
                model=jt.make_model(_jcfg(**over)), config=_conf(bf16),
                devices=jax.devices()[:1])
            jax_side[name] = _three_call(je, _jax_grads, bs)
            pe = M.engine(p, _conf(bf16), moe=True, **over)
            port_side[name] = _three_call(pe, _port_grads, bs)
        ep2 = fut.result()
    drop_one = M.run(pm, M.conf(0), moe=True, **M.DROP)
    # the one-rank continuation of the group's expert=2 save
    back = M.engine(pm, M.conf(0), moe=True)
    back.load_checkpoint(dirs["ep2"])
    return {"jax": jax_side, "port": port_side, "ep2": ep2,
            "drop_one": drop_one, "after_save": after_save,
            "back_state": M.whole_state(back),
            "back_losses": W.losses(back, W.batches(5)[3:5])}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_one_rank_moe_training_matches_jax_engine(runs, name):
    """Each step's loss and every leaf's grad against JAX's engine: the
    aux loss enters with JAX's weight, the expert backward runs through
    the scatter, the bmm's and the f32 combine."""
    tol = 2e-2 if VARIANTS[name][1] else 1e-5
    jax_steps, port_steps = runs["jax"][name], runs["port"][name]
    for step, ((jl, jg), (pl, pg)) in enumerate(zip(jax_steps, port_steps)):
        assert abs(pl - jl) <= tol * abs(jl), (name, step, pl, jl)
        assert set(pg) == set(jg)
        for k in jg:
            assert rel_l2(pg[k], jg[k]) <= tol, (name, step, k)


def test_mix_run_drops_tokens_and_carries_the_aux_loss():
    """The mixed variant's capacity drops tokens (so the parity above
    covers drops), and the loss is the CE plus 0.01 x the layers' aux."""
    over = VARIANTS["mix"][0]
    cfg = tt.llama_config("tiny", dtype=torch.float32,
                          **{**W.DIMS, **M.MOE, **over})
    p = deepspeed_tpu_torch.models.params_from_numpy(
        jax.tree.map(np.asarray, jt.make_model(_jcfg(**over)).init(
            jax.random.PRNGKey(42))), cfg, device="cpu", dtype=torch.float32)
    batch = {"input_ids": torch.from_numpy(W.batches(1)[0]["input_ids"])}
    with torch.no_grad(), pmoe.record_routing() as rec:
        loss = tt.lm_loss(p, batch, cfg, train=True)
    assert len(rec) == 2
    assert all(float(r["dropped_fraction"]) > 0.3 for r in rec)
    aux = sum(float(r["aux"]) for r in rec)
    with torch.no_grad():
        ce = tt.lm_loss(p, batch, dataclasses.replace(
            cfg, moe_aux_loss_weight=0.0), train=True)
    assert abs(float(loss) - (float(ce) + 0.01 * aux)) <= 1e-6


def test_expert_parallel_matches_jax_and_shards(runs):
    """expert=2 (``moe.expert_parallel_size``) against JAX's
    ``{"expert": 2}`` engine: the plan, the losses, and each rank's
    expert shards (2 of the 4 experts) against JAX's on the device at
    its coordinates."""
    want = runs["jax"]["ep2"]
    assert want["plan"].expert == 2
    for rank, r in enumerate(runs["ep2"]):
        got = r["ep2"]
        assert got["plan"] == "expert=2"
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5, atol=1e-6)
        assert set(want["shards"]) == {k for k in got["local"]
                                       if k.startswith("layers/moe_")}
        for k, shards in want["shards"].items():
            assert got["local"][k].shape == shards[rank].shape
            assert got["local"][k].shape[1] == 2
            assert rel_l2(got["local"][k], shards[rank]) <= 1e-5, (rank, k)


def test_expert_parallel_equals_one_rank_where_tokens_drop(runs):
    """Capacity 0.5: tokens drop. expert=2 gathers the micro-batch before
    the gate, so its drops are the one-rank run's: losses and params
    agree (a port that gated each rank's rows would drop others)."""
    want = runs["drop_one"]
    for r in runs["ep2"]:
        got = r["ep2_drop"]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=1e-5, atol=1e-6)
        for k in want["params"]:
            assert rel_l2(got["params"][k], want["params"][k]) <= 1e-5, k


def test_universal_checkpoint_world1_and_expert2(runs):
    """A tag saved at one rank loads at expert=2 and the run goes on as
    the one-rank run does; a tag saved at expert=2 loads at one rank with
    every leaf of the state bit for bit the expert=2 run's, and goes on
    as it does."""
    for r in runs["ep2"]:
        np.testing.assert_allclose(r["ep2_ckpt"]["loaded"]["losses"],
                                   runs["after_save"], rtol=1e-5, atol=1e-6)
    saved = runs["ep2"][0]["ep2_ckpt"]["saved"]
    back = runs["back_state"]
    assert set(back) == set(saved)
    for k in saved:
        np.testing.assert_array_equal(back[k], saved[k], err_msg=k)
    np.testing.assert_allclose(runs["back_losses"],
                               runs["ep2"][0]["ep2_ckpt"]["after_save"],
                               rtol=1e-5, atol=1e-6)


def _noise_cfg(policy, **over):
    return tt.llama_config("tiny", dtype=torch.float32,
                           noisy_gate_policy=policy,
                           **{**W.DIMS, **M.MOE, **over})


def _noise_params(cfg):
    gen = torch.Generator().manual_seed(0)
    p = tt.init_params(cfg, gen, "cpu")
    for v in ckpt_mod.flatten(p).values():
        v.requires_grad_(True)
    return p


def test_gate_noise_seeded_training_only_and_replayed():
    """The gate noise: repeatable from its seed and changed by another;
    drawn in training only (eval and a seedless call route without it);
    Jitter's factors stay within [0.99, 1.01]; and the remat replay
    redraws the same noise, so the grads under "full" remat equal those
    without remat bit for bit. That the noise is drawn shows in the
    grads: Jitter at seed 5 moves this model's loss by less than one f32
    ulp, so the loss alone can round to the seedless one (ROADMAP C17,
    ``test_jitter_noise_routes_as_jax_top_k_gating``)."""
    ids = {"input_ids": torch.from_numpy(
        W.batches(1)[0]["input_ids"][:2, :16])}
    for policy in ("Jitter", "RSample"):
        cfg = _noise_cfg(policy)
        p = _noise_params(cfg)
        with torch.no_grad():
            a = tt.lm_loss(p, ids, cfg, train=True, dropout_seed=5)
            b = tt.lm_loss(p, ids, cfg, train=True, dropout_seed=5)
            c = tt.lm_loss(p, ids, cfg, train=True, dropout_seed=6)
            plain = tt.lm_loss(p, ids, cfg, train=True)
            ev = tt.lm_loss(p, ids, cfg, dropout_seed=5)
            ev_plain = tt.lm_loss(p, ids, cfg)
        assert float(a) == float(b) and float(a) != float(c)
        if policy == "Jitter":
            assert abs(float(a) - float(plain)) <= \
                np.spacing(np.float32(plain))
        else:
            assert float(a) != float(plain)
        assert float(ev) == float(ev_plain)
        leaves = list(ckpt_mod.flatten(p).values())
        grads = []
        for remat in ("none", "full"):
            rc = _noise_cfg(policy, remat=remat != "none",
                            remat_policy=remat)
            loss = tt.lm_loss(p, ids, rc, train=True, dropout_seed=5)
            grads.append(torch.autograd.grad(loss, leaves))
        for g0, g1 in zip(*grads):
            assert torch.equal(g0, g1)
        seedless = torch.autograd.grad(
            tt.lm_loss(p, ids, cfg, train=True), leaves)
        assert not all(torch.equal(g0, g1)
                       for g0, g1 in zip(grads[0], seedless))
    u = pmoe._noisy(torch.ones(64, 8), "Jitter", True,
                    torch.Generator().manual_seed(1))
    assert float(u.min()) >= 0.99 and float(u.max()) <= 1.01
    assert float(u.std()) > 0


def test_jitter_noise_routes_as_jax_top_k_gating():
    """ROADMAP C17: the port's Jitter draws u in [0.99, 1.01] from its
    generator and routes ``logits * u``; JAX's ``top_k_gating`` on the
    same noisy logits gives the same dispatch and combine (1e-6). At the
    gate logits of the tiny model's layer 0 the noise moves the combine
    weights by up to ~6e-4 without changing a choice, and moves the loss
    by less than one f32 ulp."""
    from deepspeed_tpu.moe import sharded_moe as jmoe
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((32, 4)).astype(
        np.float32) * 0.05)
    u = torch.empty(logits.shape).uniform_(
        0.99, 1.01, generator=torch.Generator().manual_seed(5))
    comb, disp, aux, _ = pmoe.top_k_gating(
        logits, 2, 10, generator=torch.Generator().manual_seed(5),
        noise_policy="Jitter")
    jc, jd, jaux, _ = jmoe.top_k_gating(jnp.asarray((logits * u).numpy()),
                                        2, 10)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jd))
    assert rel_l2(comb.numpy(), np.asarray(jc)) <= 1e-6
    assert abs(float(aux) - float(jaux)) <= 1e-6
    plain, *_ = pmoe.top_k_gating(logits, 2, 10)
    assert float((comb - plain).abs().max()) > 0


def test_moe_engine_trains_with_noise_repeatably():
    """A MoE engine with Jitter noise: two runs from one seed take the
    same steps (the noise's generator is seeded by seed, step,
    micro-batch and layer, the same in the replay), and eval routes
    without noise."""
    b = {"input_ids": W.batches(1)[0]["input_ids"][:2, :16]}
    runs = []
    for _ in range(2):
        e, *_ = deepspeed_tpu_torch.initialize(
            model=tt.make_model(_noise_cfg(
                "Jitter", remat=True, remat_policy="dots_saveable")),
            config=W.conf(0, train_batch_size=2), device="cpu")
        runs.append(W.losses(e, [b, b]))
    assert runs[0] == runs[1] and runs[0][0] != runs[0][1]
    assert float(e.eval_batch(b)) == float(e.eval_batch(b))
