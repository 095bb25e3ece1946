"""Tensor-parallel training against JAX, and the model axes combined with
the batch axes.

A 2-rank gloo group (``_torch_mp_workers.group_tp2``) trains the tiny
llama of the ZeRO tests (hidden 64, 2 layers, 4/2 heads) with SGD and
momentum over ``tensor_parallel.tp_size`` 2, against JAX's ``{"tensor":
2}`` engine on 2 of the conftest's virtual devices: losses and params
after 3 steps. The first step's grads of every leaf (the norm scales
and the embedding among them: without ``copy_to_tensor`` they come out
wrong while the loss looks right) equal the one-rank run's, and
``transformer.tp_overlap_chunks`` 2 gives the run without chunks bit for
bit. Universal checkpoints go from one rank to tensor=2 and back.

A 4-rank group (``group_mp4``) plays data=2 x tensor=2 at ZeRO-1
(dense), expert=2 x tensor=2 (MoE inside a tensor-parallel region, JAX's
``test_moe_with_tensor_parallel``) and fsdp=2 x expert=2 at ZeRO-3 (MoE),
each against JAX on 4 devices, and fsdp=2 x tensor=2 at ZeRO-3 against
the one-rank run. Bars: losses at rtol 1e-5, params by
relative L2 <= 1e-5.

Then the pieces: ``row_parallel_matmul`` and ``drop_tokens`` /
``gather_tokens`` (values and grads, inside the 2-rank group),
``plan_from_config`` against JAX's, and the rest of A9 at world 1.
"""

import concurrent.futures
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config import Config as JaxConfig
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel import mesh as jax_mesh
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.models import convert
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.parallel import Mesh, MeshPlan
from deepspeed_tpu_torch.parallel import mesh as port_mesh
from deepspeed_tpu_torch.parallel.launch import run_group
from deepspeed_tpu_torch.parallel.partitioning import make_rules

from tests import _torch_mp_workers as M
from tests import _torch_zero_workers as W
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jcfg(moe=False):
    return jt.llama_config("tiny", dtype=jnp.float32,
                           **{**W.DIMS, **(M.MOE if moe else {})})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def _init(moe):
    """JAX's engine init (its seed, 42) as numpy: the port starts there."""
    return jax.tree.map(np.asarray, jt.make_model(_jcfg(moe)).init(
        jax.random.PRNGKey(42)))


def _jax_run(moe, config, n):
    e, *_ = deepspeed_tpu.initialize(model=jt.make_model(_jcfg(moe)),
                                     config=config,
                                     devices=jax.devices()[:n])
    losses = [float(e.train_batch(b)["loss"]) for b in W.batches(3)]
    return {"losses": losses, "plan": e.plan.describe(),
            "params": {k: np.asarray(v, np.float32)
                       for k, v in _flat(e.state["params"]).items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("tp_training"))
    dirs = {k: os.path.join(tmp, k) for k in ("dense", "tp2")}
    pd, pm = _init(False), _init(True)
    one = M.engine(pd, M.conf(0))
    W.losses(one, W.batches(3))
    one.save_checkpoint(dirs["dense"])
    after_save = W.losses(one, W.batches(5)[3:5])

    def groups():
        return (run_group(M.group_tp2, 2, pd, dirs, threads=1,
                          timeout_s=600),
                run_group(M.group_mp4, 4, pd, pm, threads=1,
                          timeout_s=600))

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(groups)
        jax_side = {"tp2": _jax_run(False, M.conf(0, **M.TP), 2)}
        for name, (moe, config) in M.FOUR.items():
            jax_side[name] = _jax_run(moe, config, 4)
        tp2, four = fut.result()
    back = M.engine(pd, M.conf(0))
    back.load_checkpoint(dirs["tp2"])
    return {"jax": jax_side, "tp2": tp2, "four": four,
            "one": M.run(pd, M.conf(0)),
            "one_grads": M.first_grads(pd, M.conf(0)),
            "after_save": after_save, "back_state": M.whole_state(back),
            "back_losses": W.losses(back, W.batches(5)[3:5])}


def _matches(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                               atol=1e-6)
    assert set(got["params"]) == set(want["params"])
    for k in want["params"]:
        assert rel_l2(got["params"][k], want["params"][k]) <= 1e-5, k


def test_tensor_parallel_matches_jax(runs):
    """tensor=2 (``tensor_parallel.tp_size``) against JAX's ``{"tensor":
    2}`` engine: losses and whole params after 3 steps; each rank holds
    half of every column, row and vocab leaf, the norms whole."""
    want = runs["jax"]["tp2"]
    assert want["plan"] == "tensor=2"
    whole = runs["one"]["params"]
    for r in runs["tp2"]:
        got = r["tp2"]
        assert got["plan"] == "tensor=2"
        _matches(got, want)
        for k, v in got["local"].items():
            halved = "norm" not in k and "ln" not in k
            assert v.size * (2 if halved else 1) == whole[k].size, k


def test_tensor_parallel_grads_equal_tensor1(runs):
    """The first step's grad of every leaf at tensor=2 equals the
    one-rank run's: the norm scales' and the embedding's too, which
    depend on the column projections' inputs entering through
    ``copy_to_tensor`` (their grads summed over the tensor group)."""
    want = runs["one_grads"]
    for r in runs["tp2"]:
        got = r["tp2_grads"]
        assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
        assert set(got["grads"]) == set(want["grads"])
        for k in want["grads"]:
            assert rel_l2(got["grads"][k], want["grads"][k]) <= 1e-5, k
        for k in ("final_norm_scale", "layers/ln1_scale", "layers/ln2_scale",
                  "tok_embed"):
            assert np.abs(want["grads"][k]).max() > 0, k


def test_tp_overlap_chunks_equal_unchunked_bit_for_bit(runs):
    """``transformer.tp_overlap_chunks`` 2: the row-parallel sum in two
    all_reduce calls along the sequence, the backward the plain
    matmul's; losses and params equal the unchunked run's bit for bit."""
    for r in runs["tp2"]:
        a, b = r["tp2"], r["tp2_chunks2"]
        assert a["losses"] == b["losses"]
        for k in a["params"]:
            np.testing.assert_array_equal(a["params"][k], b["params"][k],
                                          err_msg=k)


@pytest.mark.parametrize("name", list(M.FOUR))
def test_four_rank_meshes_match_jax(runs, name):
    """data=2 x tensor=2 at ZeRO-1, expert=2 x tensor=2 (MoE inside a
    tensor-parallel region: the tokens of the expert group routed whole
    on each tensor rank) and fsdp=2 x expert=2 at ZeRO-3, each against
    JAX's engine on 4 devices with the same plan."""
    want = runs["jax"][name]
    for r in runs["four"]:
        assert r[name]["plan"] == want["plan"]
        _matches(r[name], want)


def test_zero3_over_fsdp_and_tensor_equals_one_rank(runs):
    """fsdp=2 x tensor=2 at ZeRO-3: each layer gathers its fsdp shards and
    keeps its tensor slice; the vocab leaves, split over (fsdp, tensor)
    together, are gathered over both and cut to the rank's contiguous
    tensor slice. Losses and params equal the one-rank run's."""
    for r in runs["four"]:
        assert r["fsdp2_tensor2"]["plan"] == "fsdp=2xtensor=2"
        _matches(r["fsdp2_tensor2"], runs["one"])
        assert r["fsdp2_tensor2"]["local"]["tok_embed"].shape == (32, 64)


def test_universal_checkpoint_world1_and_tensor2(runs):
    """A tag saved at one rank loads at tensor=2 and goes on as the
    one-rank run does; a tag saved at tensor=2 loads at one rank with
    every leaf of the state bit for bit the tensor=2 run's (gathered
    from the two shards), and goes on as it does."""
    for r in runs["tp2"]:
        np.testing.assert_allclose(r["tp2_ckpt"]["loaded"]["losses"],
                                   runs["after_save"], rtol=1e-5, atol=1e-6)
    saved = runs["tp2"][0]["tp2_ckpt"]["saved"]
    back = runs["back_state"]
    assert set(back) == set(saved)
    for k in saved:
        np.testing.assert_array_equal(back[k], saved[k], err_msg=k)
    np.testing.assert_allclose(runs["back_losses"],
                               runs["tp2"][0]["tp2_ckpt"]["after_save"],
                               rtol=1e-5, atol=1e-6)


def test_row_parallel_matmul_and_token_mappings(runs):
    """``row_parallel_matmul`` over each rank's half of the contraction:
    the value is the whole product, at 0 chunks (one all_reduce), 3
    (the largest divisor of 8 at most 3: 2 calls) and 4 (4 calls), bit
    for bit alike, and the grads are the whole product's slices.
    ``drop_tokens`` keeps the rank's piece of the sequence and gathers
    the pieces' grads; ``gather_tokens`` is its inverse."""
    rng = np.random.default_rng(0)
    x, w, g, h, gh = (rng.standard_normal(s).astype(np.float32)
                      for s in ((2, 8, 16), (16, 12), (2, 8, 12), (2, 8, 4),
                                (2, 2, 8, 4)))
    whole = x @ w
    for rank, r in enumerate(runs["tp2"]):
        p = r["pieces"]
        sl = slice(rank * 8, (rank + 1) * 8)
        for c, calls in ((0, 1), (3, 2), (4, 4)):
            y, gx, gw, n = p[f"rpm{c}"]
            assert n == calls
            np.testing.assert_allclose(y, whole, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(y, p["rpm0"][0])
            np.testing.assert_allclose(gx, (g @ w.T)[..., sl], rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(
                gw, (x.reshape(-1, 16).T @ g.reshape(-1, 12))[sl],
                rtol=1e-5, atol=1e-5)
        d, gd = p["drop"]
        np.testing.assert_array_equal(d, h[:, rank * 4:(rank + 1) * 4])
        np.testing.assert_array_equal(gd, np.concatenate(
            [gh[i, :, i * 4:(i + 1) * 4] for i in range(2)], 1))
        gt, gg = p["gather"]
        np.testing.assert_array_equal(gt, h)
        np.testing.assert_array_equal(gg, gh[0][:, rank * 4:(rank + 1) * 4])


PLANS = [
    ({"tensor_parallel": {"tp_size": 2}}, 4),
    ({"tensor_parallel": {"size": 2}, "zero_optimization": {"stage": 3}},
     8),
    ({"moe": {"enabled": True, "expert_parallel_size": 2}}, 4),
    ({"moe": {"enabled": True, "expert_parallel_size": 2},
      "tensor_parallel": {"tp": 2}, "zero_optimization": {"stage": 3}}, 8),
    ({"moe": {"enabled": False, "expert_parallel_size": 2}}, 2),
    ({"moe": {"enabled": True, "expert_parallel_size": 2},
      "mesh": {"axes": {"data": 2, "tensor": 2}}}, 8),
    ({"mesh": {"axes": {"data": 2, "tensor": 2}},
      "tensor_parallel": {"tp_size": 4}}, 4),
    ({"tensor_parallel": {"tp_size": 3}}, 4),
    ({"moe": {"enabled": True, "expert_parallel_size": 3}}, 4),
    ({"mesh": {"axes": {"data": 3}}}, 4),
]


@pytest.mark.parametrize("config,world", PLANS)
def test_plan_from_config_matches_jax(config, world):
    """The port's plan against JAX's on the same config and world size:
    the degrees, or the same error."""
    try:
        want = jax_mesh.plan_from_config(JaxConfig.load(config), world)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_mesh.plan_from_config(Config.load(config), world)
        assert str(got.value).split(" ")[:3] == str(e).split(" ")[:3]
        return
    got = port_mesh.plan_from_config(Config.load(config), world)
    assert got.axis_sizes() == {a: getattr(want, a)
                                for a in port_mesh.AXIS_ORDER}


def test_params_from_numpy_cuts_the_training_tables():
    """``params_from_numpy(mesh=, rules=)`` cuts each leaf as the training
    tables do: stage <= 2 with a tensor axis (columns, rows and vocab
    halved), stage 3 (embed over fsdp, vocab over (fsdp, tensor)) and the
    expert stacks over ``expert``."""
    pd, pm = _init(False), _init(True)
    cfg = tt.llama_config("tiny", dtype=torch.float32, **W.DIMS)
    mcfg = tt.llama_config("tiny", dtype=torch.float32,
                           **{**W.DIMS, **M.MOE})
    tp = convert.params_from_numpy(pd, cfg, device="cpu",
                                   dtype=torch.float32,
                                   mesh=Mesh(MeshPlan(tensor=2), rank=1),
                                   rules=make_rules(0, tp=True))
    assert tuple(tp["tok_embed"].shape) == (64, 64)
    np.testing.assert_array_equal(tp["layers"]["wo"].numpy(),
                                  pd["layers"]["wo"][:, 32:])
    s3 = convert.params_from_numpy(pd, cfg, device="cpu",
                                   dtype=torch.float32,
                                   mesh=Mesh(MeshPlan(fsdp=2, tensor=2),
                                             rank=1),
                                   rules=make_rules(3, tp=True))
    # vocab over (fsdp, tensor): rank (0, 1) holds the second quarter
    np.testing.assert_array_equal(s3["tok_embed"].numpy(),
                                  pd["tok_embed"][32:64])
    assert tuple(s3["layers"]["wq"].shape) == (2, 32, 32)
    ep = convert.params_from_numpy(pm, mcfg, device="cpu",
                                   dtype=torch.float32,
                                   mesh=Mesh(MeshPlan(expert=2), rank=1),
                                   rules=make_rules(0, tp=False))
    np.testing.assert_array_equal(ep["layers"]["moe_w_in"].numpy(),
                                  pm["layers"]["moe_w_in"][:, 2:])


@pytest.mark.parametrize("what", ["pipeline", "sequence_parallel",
                                  "seq_parallel", "comms_logger",
                                  "serving_data_mesh", "offload"])
def test_the_rest_of_a9_still_raises(what):
    """The rest of A9 runs since it was ported: at world 1 the pipeline,
    sequence and tensor degrees raise JAX's plan error (the degree does
    not divide the world; the multi-rank runs are in
    ``test_torch_pipeline.py`` and ``test_torch_ring_attention.py``), the
    comms logger section switches the logger on, and serving on a data
    mesh raises naming JAX's ServingEngine, which has no data-split path;
    offload on a mesh of ``tensor`` alone at world 1 raises JAX's plan
    error (the executor over ranks is in ``test_torch_infinity_mesh.py``,
    A8d)."""
    from deepspeed_tpu_torch.comm import comm
    model = tt.make_model(tt.llama_config("tiny", dtype=torch.float32,
                                          **W.DIMS))
    bad = {"pipeline": {"pipeline": {"stages": 2}},
           "sequence_parallel": {"sequence_parallel": {"sp_size": 2}},
           "seq_parallel": {"tensor_parallel": {"tp_size": 2,
                                                "seq_parallel": True}},
           "comms_logger": {"comms_logger": {"enabled": True}},
           "offload": {"zero_optimization": {
               "stage": 3, "offload_param": {"device": "cpu"}},
               "mesh": {"axes": {"tensor": 2}}}}
    if what == "serving_data_mesh":
        with pytest.raises(NotImplementedError, match="serving.py:440-457"):
            deepspeed_tpu_torch.init_serving(
                model, mesh=Mesh(MeshPlan(data=2)), device="cpu")
        return
    if what == "offload":
        with pytest.raises(ValueError, match=re.escape(
                "mesh.axes product 2 != world size 1")):
            deepspeed_tpu_torch.initialize(model=model, config=bad[what],
                                           device="cpu")
        return
    if what == "comms_logger":
        try:
            deepspeed_tpu_torch.initialize(model=model, config=bad[what],
                                           device="cpu")
            assert comm.comms_logger.enabled
        finally:
            comm.configure(enabled=False)
        return
    degree = {"pipeline": "pipe(2)", "sequence_parallel": "seq(2)",
              "seq_parallel": "tensor(2)"}[what]
    with pytest.raises(ValueError, match=re.escape(degree)):
        deepspeed_tpu_torch.initialize(model=model, config=bad[what],
                                       device="cpu")