"""Pipeline parallelism (1F1B over ``pipe``) against JAX and against the
one-stage run.

A 2-rank gloo group (``_torch_pp_workers.group_pp2``) and a 4-rank one
(``group_pp4``) train the tiny llama of the ZeRO tests at 4 layers
(hidden 64, 4/2 heads, S=32, 8 rows in 4 micro-batches) while this
process runs the JAX engines:

- pipe=2 and pipe=4 against JAX's non-pipelined engine (one device, the
  same 4 micro-batches): 5 AdamW steps' losses at JAX's own bar (rtol
  2e-4, atol 1e-5: ``tests/unit/test_pipeline.py:50, 60``);
- the 1F1B step's grads of every leaf against JAX's per-micro-batch mean
  reference (rtol 5e-4, atol 1e-5: ``test_pipeline.py:85-110``), and
  the loss of JAX's own ``make_pipelined_model`` on a pipe=2 mesh;
- pipe=2 with MoE, with uneven labels and with dropout, and
  pipe=2 x data=2 (ZeRO-1), pipe=2 x tensor=2 and pipe=2 x fsdp=2
  (ZeRO-3), against the port's one-stage run (SGD with momentum, 3
  steps: losses and params within 5e-4, dropout equal);
- a one-rank (GSPMD-layout) checkpoint resumed at pipe=2, and a pipe=2
  one at one rank;
- ``apply``'s GPipe logits, the comms logger of a step, the bubble, and
  the errors (indivisible layers, pipe x seq, a non-transformer model);
  plans and topologies with ``pipe`` and ``seq`` against JAX's.
"""

import concurrent.futures
import os
import types

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
from deepspeed_tpu.parallel.pipeline import \
    bubble_fraction as jax_bubble_fraction
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.parallel import Mesh, MeshPlan
from deepspeed_tpu_torch.parallel import mesh as port_mesh
from deepspeed_tpu_torch.parallel.launch import run_group
from deepspeed_tpu_torch.parallel.pipeline import bubble_fraction

from tests import _torch_pp_workers as P
from tests import _torch_zero_workers as W
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jcfg(**over):
    return jt.llama_config("tiny", dtype=jnp.float32, **{**P.DIMS, **over})


def _init(**over):
    """JAX's engine init (its seed, 42) as numpy: the port starts there."""
    return jax.tree.map(np.asarray, jt.make_model(_jcfg(**over)).init(
        jax.random.PRNGKey(42)))


def _jax_side(p0):
    """JAX's non-pipelined engine (5 steps), its per-micro-batch mean grads
    at p0, and its pipelined model's loss on a pipe=2 mesh."""
    e, *_ = deepspeed_tpu.initialize(model=jt.make_model(_jcfg()),
                                     config=P.conf(),
                                     devices=jax.devices()[:1])
    out = {"losses": [float(e.train_batch(b)["loss"])
                      for b in W.batches(P.STEPS)]}
    cfg = _jcfg()
    ids = jnp.asarray(W.batches(1)[0]["input_ids"])
    mbs = ids.reshape(P.GAS, -1, ids.shape[1])
    params = jax.tree.map(jnp.asarray, p0)

    def ref_loss(p):
        return sum(jt.lm_loss(p, {"input_ids": mbs[i]}, cfg)
                   for i in range(P.GAS)) / P.GAS
    loss, grads = jax.jit(jax.value_and_grad(ref_loss))(params)
    out["ref_loss"] = float(loss)
    out["ref_grads"] = {k: np.asarray(v) for k, v in _flat(grads).items()}
    from deepspeed_tpu.models.pipeline_wrapper import make_pipelined_model
    mesh = jax_mesh.build_mesh(jax_mesh.MeshPlan(pipe=2),
                               devices=jax.devices()[:2])
    pmodel = make_pipelined_model(cfg, mesh, num_microbatches=P.GAS)
    with mesh:
        out["pipelined_loss"] = float(jax.jit(
            lambda p: pmodel.loss_fn(p, {"input_ids": ids}))(params))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    dirs = {k: os.path.join(tmp, k) for k in ("one", "pp2")}
    p0, pm = _init(), _init(**P.MOE)
    sgd = P.conf(optimizer=W.SGD)
    one = P.engine(p0, sgd)
    W.losses(one, W.batches(3))
    one.save_checkpoint(dirs["one"])
    after_save = W.losses(one, W.batches(5)[3:5])

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        fut2 = ex.submit(run_group, P.group_pp2, 2, p0, pm, dirs, threads=1,
                         timeout_s=600)
        fut4 = ex.submit(run_group, P.group_pp4, 4, p0, threads=1,
                         timeout_s=600)
        jax_side = _jax_side(p0)
        one_rank = {
            "sgd": P.run(p0, sgd, W.batches(3)),
            "moe": P.run(pm, sgd, W.batches(3), **P.MOE),
            "labels": P.run(p0, sgd, W.masked_batches(3)),
            "dropout": P.run(p0, sgd, W.batches(3), **P.DROPOUT)}
        e = P.engine(p0, sgd)
        ids = torch.as_tensor(W.batches(1, seed=4)[0]["input_ids"]).long()
        with torch.no_grad():
            one_rank["logits"] = e.model.apply(e.state["params"],
                                               ids).numpy()
        pp2, pp4 = fut2.result(), fut4.result()
    back = P.engine(p0, sgd)
    back.load_checkpoint(dirs["pp2"])
    return {"jax": jax_side, "pp2": pp2, "pp4": pp4, "one": one_rank,
            "after_save": after_save,
            "back": W.losses(back, W.batches(5)[3:5]),
            "back_params": W.whole_params(back)}


def _close(got, want, tol=5e-4):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=tol,
                               atol=1e-5)
    assert set(got["params"]) == set(want["params"])
    for k in want["params"]:
        assert rel_l2(got["params"][k], want["params"][k]) <= tol, k


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_matches_jax_engine(runs, stages):
    """pipe=2 and pipe=4 against JAX's non-pipelined engine on the same 4
    micro-batches: 5 AdamW steps' losses at JAX's bar; each stage holds
    its 4 / P layers."""
    want = runs["jax"]["losses"]
    for r in runs[f"pp{stages}"]:
        got = r[f"pp{stages}"]
        assert got["plan"] == f"pipe={stages}"
        np.testing.assert_allclose(got["losses"], want, rtol=2e-4,
                                   atol=1e-5)
    assert runs["pp2"][0]["layers_local"] == 2


def test_1f1b_grads_match_jax_micro_batch_mean(runs):
    """The 1F1B step's loss and the grad of every leaf (the embedding and
    the final norm included: they meet in the pipe all-reduce) against
    JAX's per-micro-batch mean reference; JAX's own pipelined model gives
    the same loss."""
    want = runs["jax"]
    for r in runs["pp2"]:
        got = r["grads"]
        np.testing.assert_allclose(got["loss"], want["ref_loss"], rtol=1e-5)
        assert set(got["grads"]) == set(want["ref_grads"])
        for k, g in want["ref_grads"].items():
            np.testing.assert_allclose(got["grads"][k], g, rtol=5e-4,
                                       atol=1e-5, err_msg=k)
    np.testing.assert_allclose(want["pipelined_loss"], want["ref_loss"],
                               rtol=1e-5)


@pytest.mark.parametrize("what", ["moe", "labels", "dropout"])
def test_pipe2_matches_one_stage(runs, what):
    """pipe=2 against the port's one-stage run (gas 4): a MoE model (its
    aux losses ride the backward seeds), explicit labels with uneven -100
    counts (each micro-batch's CE over its own count), and dropout (the
    masks salted by micro-batch and model layer: the recompute and the
    one-stage run draw the same)."""
    want = runs["one"][what]
    for r in runs["pp2"]:
        _close(r[what], want)
    if what == "dropout":
        np.testing.assert_allclose(runs["pp2"][0][what]["losses"],
                                   want["losses"], rtol=1e-6)


@pytest.mark.parametrize("what", ["zero1", "tp2", "zero3"])
def test_pipe2_with_model_axes(runs, what):
    """pipe=2 x data=2 at ZeRO-1 (the optimizer state cut over data inside
    each stage's slice), pipe=2 x tensor=2 and pipe=2 x fsdp=2 at ZeRO-3
    (the layers gathered inside the stage and its recompute) against the
    one-stage run."""
    want = runs["one"]["sgd"]
    plans = {"zero1": "pipe=2xdata=2", "tp2": "pipe=2xtensor=2",
             "zero3": "pipe=2xfsdp=2"}
    for r in runs["pp4"]:
        assert r[what]["plan"] == plans[what]
        _close(r[what], want)


def test_checkpoints_cross_the_pipe(runs):
    """A one-rank (GSPMD-layout) checkpoint resumes at pipe=2 and goes on
    as the one-rank run does; a pipe=2 checkpoint (its layer slices saved
    as whole leaves) resumes at one rank."""
    for r in runs["pp2"]:
        np.testing.assert_allclose(r["resumed"], runs["after_save"],
                                   rtol=5e-4, atol=1e-5)
    np.testing.assert_allclose(runs["back"], runs["after_save"], rtol=5e-4,
                               atol=1e-5)


def test_apply_eval_logger_and_bubble(runs):
    """The GPipe ``apply`` gives the one-stage logits on every rank; eval
    matches; the comms logger saw every facade call of a pipe=2 step (its
    bytes the facade's counts: the ppermutes down and up the pipe, the
    one all-reduce of the loss and the whole leaves' grads); the bubble
    is JAX's (P - 1) / (M + P - 1)."""
    for r in runs["pp2"]:
        np.testing.assert_allclose(r["logits"], runs["one"]["logits"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["labels"]["eval"],
                                   runs["one"]["labels"]["eval"], rtol=1e-5)
        lg = r["logger"]
        flat = {f"{op}[{axis}]": v for op, d in lg["facade"].items()
                for axis, v in d.items()}
        assert set(lg["counts"]) == set(flat)
        for key, v in flat.items():
            assert lg["counts"][key] == v["calls"], key
            assert lg["bytes"][key] == v["bytes"], key
        # T = 4 + 2 ticks, each one ppermute down and one up; over pipe
        # one sum of the loss and the whole leaves' grads, and one of the
        # layer leaves' squares for the global norm (clipping)
        assert lg["counts"]["ppermute[pipe]"] == 2 * (P.GAS + 2)
        assert lg["counts"]["all_reduce[pipe]"] == 2
        assert r["bubble"] == bubble_fraction(P.GAS, 2) \
            == jax_bubble_fraction(P.GAS, 2) == 1 / 5


def test_pipeline_errors():
    """JAX's errors, raised before any collective: layers the stages do
    not divide, pipe with seq, a model that is not a transformer."""
    conf = P.conf(**P.PP2)
    with pytest.raises(ValueError, match="not divisible by pipeline"):
        deepspeed_tpu_torch.initialize(
            model=P.model(num_layers=3), config=conf, device="cpu",
            mesh=Mesh(MeshPlan(pipe=2)))
    with pytest.raises(ValueError, match="pipe>1 with seq>1"):
        deepspeed_tpu_torch.initialize(
            model=P.model(), config=P.conf(), device="cpu",
            mesh=Mesh(MeshPlan(pipe=2, seq=2)))
    spec = types.SimpleNamespace(config=None, name="mlp")
    with pytest.raises(ValueError, match="requires a transformer"):
        deepspeed_tpu_torch.initialize(model=spec, config=P.conf(),
                                       device="cpu",
                                       mesh=Mesh(MeshPlan(pipe=2)))
    with pytest.raises(ValueError, match="pipe/seq/expert must be 1"):
        deepspeed_tpu_torch.initialize(
            model=P.model(), config=P.conf(3, zero_optimization={
                "stage": 3, "offload_param": {"device": "cpu"}}),
            device="cpu", mesh=Mesh(MeshPlan(pipe=2)))


@pytest.mark.parametrize("conf,world", [
    ({"pipeline": {"stages": 2}}, 8),
    ({"pipeline": {"stages": 2}, "zero_optimization": {"stage": 3}}, 8),
    ({"sequence_parallel": {"size": 2}, "tensor_parallel": {"tp": 2}}, 8),
    ({"mesh": {"axes": {"pipe": 2, "seq": 2, "data": 2}}}, 8),
    ({"pipeline": {"stages": 3}}, 8)])
def test_plan_and_topology_match_jax(conf, world):
    """``plan_from_config`` with ``pipeline.stages`` and
    ``sequence_parallel.size`` against JAX's (the degrees, or the same
    error), and the pipe-major topology's groups and coordinates."""
    try:
        b = jax_mesh.plan_from_config(JaxConfig.load(conf), world)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_mesh.plan_from_config(Config.load(conf), world)
        assert str(got.value).split(" ")[:3] == str(e).split(" ")[:3]
        return
    a = port_mesh.plan_from_config(Config.load(conf), world)
    assert a.axis_sizes() == b.axis_sizes()
    assert (a.world_size, a.dp_world_size, a.describe()) == \
        (b.world_size, b.dp_world_size, b.describe())
    ta, tb = port_mesh.Topology(a), jax_mesh.Topology(b)
    for axis in port_mesh.AXIS_ORDER:
        assert ta.get_axis_comm_lists(axis) == tb.get_axis_comm_lists(axis)
    for r in range(world):
        assert ta.get_coord(r) == tb.get_coord(r)
