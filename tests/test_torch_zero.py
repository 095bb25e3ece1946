"""Multi-rank training against JAX: ZeRO stages 0-3, the gradient
schedule (deferred, hierarchical), universal checkpoints across world
size and stage, fp16's overflow skip and dropout over ranks.

The port's engines run on spawned gloo groups of 2 and 4 CPU processes
(``parallel/launch.run_group``, one thread a rank; the rank programs are
in ``_torch_zero_workers.py``, which imports no jax), started on a thread
while this process runs the JAX engines on 2 and 4 of the conftest's
virtual devices (``deepspeed_tpu.initialize(..., devices=...)``). Both
packages start from the same numpy weights (JAX's init) and batches.
Model: a tiny llama at f32 (2 layers, hidden 64). Bars: losses at JAX's
own stage-parity bar (rtol 2e-4, atol 1e-5,
``tests/unit/test_engine.py:113``), params and optimizer shards by
relative L2 <= 1e-5.
"""

import concurrent.futures
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.config import Config as JaxConfig
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel import mesh as jax_mesh
from deepspeed_tpu.parallel.partitioning import make_rules as jax_rules
from deepspeed_tpu.parallel.partitioning import spec_tree as jax_spec_tree
from deepspeed_tpu.runtime import zero as jax_zero
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.parallel import mesh as port_mesh
from deepspeed_tpu_torch.parallel.launch import run_group
from deepspeed_tpu_torch.parallel.partitioning import make_rules, spec_tree
from deepspeed_tpu_torch.runtime import zero as port_zero

from tests import _torch_zero_workers as W
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

RTOL, ATOL = 2e-4, 1e-5


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jcfg(**over):
    return jt.llama_config("tiny", dtype=jnp.float32, **{**W.DIMS, **over})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def _jax_engine(config, n):
    e, *_ = deepspeed_tpu.initialize(model=jt.make_model(_jcfg()),
                                     config=config,
                                     devices=jax.devices()[:n])
    return e


def _jax_run(config, n, bs):
    """Losses, whole params and each device's optimizer shards."""
    e = _jax_engine(config, n)
    losses = [float(e.train_batch(b)["loss"]) for b in bs]
    shards = {}
    for name in ("exp_avg", "exp_avg_sq"):
        for k, v in _flat(e.state["opt"].get(name, {})).items():
            by_dev = {s.device.id: np.asarray(s.data)
                      for s in v.addressable_shards}
            shards[f"{name}/{k}"] = [by_dev[d.id]
                                     for d in jax.devices()[:n]]
    return {"losses": losses,
            "params": {k: np.asarray(v, np.float32)
                       for k, v in _flat(e.state["params"]).items()},
            "shards": shards}


def _port_one_rank(p0, config, steps, save=None, load=None):
    e = W.engine(p0, config)
    if load is not None:
        e.load_checkpoint(load)
    bs = W.batches(5)
    out = [float(e.train_batch(b)["loss"]) for b in steps(bs)]
    if save is not None:
        e.save_checkpoint(save)
        out = [float(e.train_batch(b)["loss"]) for b in bs[3:5]]
    return out, e


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("zero"))
    dir_a, dir_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    p0 = jax.tree.map(np.asarray, jt.make_model(_jcfg()).init(
        jax.random.PRNGKey(42)))
    # the one-rank side of the round trips first: the group loads dir_a
    after_a, _ = _port_one_rank(p0, W.conf(0), lambda bs: bs[:3], save=dir_a)

    def groups():
        return (run_group(W.group_zero, 2, p0, dir_a, dir_b, threads=1,
                          timeout_s=600),
                run_group(W.group_hierarchical, 4, p0, threads=1,
                          timeout_s=600))

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(groups)
        bs = W.batches(3)
        jax_side = {f"stage{s}": _jax_run(W.conf(s), 2, bs)
                    for s in range(4)}
        jax_side["gas2"] = _jax_run(
            W.conf(2, gradient_accumulation_steps=2), 2, bs)
        for name, args in W.MASKED.items():
            jax_side[f"masked_{name}"] = _jax_run(
                W.masked_conf(*args), 2, W.masked_batches())
        jax_side["hier"] = _jax_run(
            W.conf(2, gradient_accumulation_steps=2,
                   mesh={"axes": {"data": 2, "fsdp": 2}},
                   comm={"hierarchical_grad_reduce": True}), 4, bs)
        zero, hier = fut.result()
    # the one-rank side of the reverse trip and of dropout
    load_b, _ = _port_one_rank(p0, W.conf(0), lambda bs: bs[3:5],
                               load=dir_b)
    de = W.engine(p0, W.dropout_conf(), dropout_rate=0.1)
    drop = {"losses": W.losses(de, W.batches(2)),
            "params": W.whole_params(de)}
    masked = {}
    for name, (stage, gas, deferred) in W.MASKED.items():
        if not deferred:
            me = W.engine(p0, W.masked_conf(0, gas, False))
            masked[name] = {"losses": W.losses(me, W.masked_batches()),
                            "params": W.whole_params(me)}
    return {"zero": zero, "hier": hier, "jax": jax_side, "after_a": after_a,
            "load_b": load_b, "dropout_one_rank": drop,
            "masked_one_rank": masked}


def _same_losses(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _params_close(got, want, bar=1e-5):
    assert set(got) == set(want)
    for k in want:
        assert rel_l2(got[k], want[k]) <= bar, k


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_stage_matches_jax(runs, stage):
    """Losses per step, final params, and each rank's moment shards equal
    to JAX's shard on the device at the same mesh coordinates."""
    want = runs["jax"][f"stage{stage}"]
    ranks = [r[f"stage{stage}"] for r in runs["zero"]]
    for r in ranks:
        _same_losses(r["losses"], want["losses"])
        _params_close(r["params"], want["params"])
    for rank, r in enumerate(ranks):
        for name in ("exp_avg", "exp_avg_sq"):
            for k, got in r[name].items():
                jshard = want["shards"][f"{name}/{k}"][rank]
                assert got.shape == jshard.shape, (stage, rank, name, k)
                assert rel_l2(got, jshard) <= 1e-5, (stage, rank, name, k)


def test_stage_shards_follow_the_memory_laws(runs):
    """Stage 1 and 2 halve the moments of every leaf (data divides a dim
    of each); stage 3 halves the params of the leaves its rules shard
    (threshold 0: all but the norms), and their moments with them; stage
    0 holds everything whole."""
    z = runs["zero"][0]
    full = {k: v.size for k, v in z["stage0"]["exp_avg"].items()}
    for s in (1, 2):
        got = {k: v.size for k, v in z[f"stage{s}"]["exp_avg"].items()}
        assert all(got[k] * 2 == full[k] for k in full), s
    p0 = z["stage0"]["param_shapes"]
    p3 = z["stage3"]["param_shapes"]
    sharded = {k for k in p0 if np.prod(p3[k]) * 2 == np.prod(p0[k])}
    assert sharded == {k for k in p0 if "norm" not in k and "ln" not in k}
    assert all(p3[k] == p0[k] for k in p0 if k not in sharded)
    m3 = {k: v.size for k, v in z["stage3"]["exp_avg"].items()}
    assert all(m3[k] * (2 if k in sharded else 1) == full[k] for k in full)


def test_stage_collectives(runs):
    """What each stage puts on the wire over 3 steps of the 12 leaves
    (data divides a dim of each): stage 0 and 1 all-reduce every grad
    and the loss, stage 1 then gathers the updated params, stage 2
    reduce-scatters the grads instead (and all-reduces the loss and the
    norm's shard sums), stage 3 gathers over fsdp at each use and
    reduce-scatters the grads there."""
    c = {s: runs["zero"][0][f"stage{s}"]["counts"] for s in range(4)}
    assert c[0] == {"all_reduce data": 3 * (12 + 1)}
    assert c[1] == {"all_reduce data": 3 * (12 + 1),
                    "all_gather data": 3 * 12}
    assert c[2] == {"reduce_scatter data": 3 * 12,
                    "all_reduce data": 3 * 2,
                    "all_gather data": 3 * 12}
    assert c[3]["all_gather fsdp"] == c[3]["reduce_scatter fsdp"] > 0


def test_stage3_persistence_threshold_keeps_small_leaves_whole(runs):
    """Threshold 4096 at stage 3: leaves of at most 4096 values stay whole
    on every rank, the rest are cut as JAX's ``zero_param_spec`` cuts
    them."""
    got = runs["zero"][0]["threshold"]["param_shapes"]
    jcfg = _jcfg()
    plan = jax_mesh.MeshPlan(fsdp=2)
    zc = JaxConfig.load({"zero_optimization": {
        "stage": 3, "stage3_param_persistence_threshold": 4096}}
    ).zero_optimization
    specs = _flat(jax_spec_tree(jt.logical_axes(jcfg), jax_rules(3, tp=False)))
    shapes = {k: v.shape for k, v in _flat(jax.tree.map(
        np.asarray, jt.make_model(jcfg).init(jax.random.PRNGKey(0)))).items()}
    for k, shape in shapes.items():
        spec = jax_zero.zero_param_spec(specs[k], shape, plan, zc)
        want = tuple(n // 2 if i < len(spec) and spec[i] else n
                     for i, n in enumerate(shape))
        assert got[k] == want, (k, spec)
        if np.prod(shape) <= 4096:
            assert got[k] == shape, k
    assert any(got[k] != shapes[k] for k in shapes)


def test_bf16_masters_equal_bit_for_bit_at_every_stage(runs):
    """bf16 compute with f32 masters at 2 ranks: after 2 AdamW steps the
    masters of stage 3 equal stage 0's bit for bit on every leaf and
    rank. Stage 3's gather backward hands a sharded leaf its summed grad
    cast to bf16, and stages 0-2 round their reduced grads to the param's
    dtype as JAX does (ROADMAP C6: before that, stage 0 kept the f32 sum
    and its masters moved apart; stages 1-2 reduce as stage 0 does,
    which the card's phase 16 holds too)."""
    for rank in runs["zero"]:
        got = rank["bf16_masters"]
        for stage in (3,):
            assert set(got[stage]) == set(got[0])
            for k, want in got[0].items():
                assert want.dtype == np.float32
                np.testing.assert_array_equal(got[stage][k], want,
                                              err_msg=f"stage {stage} {k}")


def test_gas2_eager_and_deferred_match_jax(runs):
    want = runs["jax"]["gas2"]
    for r in runs["zero"]:
        for mode in ("eager", "deferred"):
            got = r[f"gas2_{mode}"]
            _same_losses(got["losses"], want["losses"])
            _params_close(got["params"], want["params"])
    assert runs["zero"][0]["gas2_deferred"]["deferred"]
    assert not runs["zero"][0]["gas2_eager"]["deferred"]


def test_deferred_collective_count_independent_of_gas(runs):
    """JAX's TestDeferredCensus law: with deferral the data-parallel
    collectives of a step do not depend on gas; without it the gradient
    reductions scale by gas."""
    z = runs["zero"][0]
    d1 = z["gas1_deferred"]["counts_one_step"]
    d2 = z["gas2_deferred"]["counts_one_step"]
    e1 = z["gas1_eager"]["counts_one_step"]
    e2 = z["gas2_eager"]["counts_one_step"]
    assert d1 == d2 == e1
    assert e2["reduce_scatter data"] == 2 * e1["reduce_scatter data"]


def test_hierarchical_data2_fsdp2_matches_jax(runs):
    """data=2 x fsdp=2 at stage 2, gas 2: the hierarchical reduction
    (reduce-scatter over fsdp, all-reduce of the shard over data) and the
    flat one against JAX's hierarchical engine on 4 devices; each rank's
    moment shard equal to JAX's on the matching device."""
    want = runs["jax"]["hier"]
    for rank, r in enumerate(runs["hier"]):
        for mode in (True, False):
            got = r[f"hier_{mode}"]
            _same_losses(got["losses"], want["losses"])
            _params_close(got["params"], want["params"])
        for k, got in r["hier_True"]["exp_avg"].items():
            jshard = want["shards"][f"exp_avg/{k}"][rank]
            assert got.shape == jshard.shape and \
                rel_l2(got, jshard) <= 1e-5, (rank, k)
    hc = runs["hier"][0]["hier_True"]["counts"]
    fc = runs["hier"][0]["hier_False"]["counts"]
    assert hc["reduce_scatter fsdp"] > 0 and hc["all_reduce data"] > 0
    assert "reduce_scatter fsdp" not in fc and fc["reduce_scatter data"] > 0


def test_checkpoint_world1_stage0_loads_at_world2_stage3(runs):
    for r in runs["zero"]:
        assert r["ckpt"]["loaded"]["global_steps"] == 3
        _same_losses(r["ckpt"]["loaded"]["losses"], runs["after_a"])


def test_checkpoint_world2_stage3_loads_at_world1_stage0(runs):
    _same_losses(runs["load_b"], runs["zero"][0]["ckpt"]["after_save"])


def test_fp16_overflow_skips_on_every_rank(runs):
    """An inf in one rank's grads skips the step on both: params bit for
    bit unchanged, the applied-update count held, the hysteresis used,
    and the ranks' params still equal afterwards."""
    ranks = [r["fp16"] for r in runs["zero"]]
    for f in ranks:
        assert f["overflow"] and f["unchanged"]
        assert f["hysteresis"] == (2, 1)
        assert (f["step"], f["skipped"], f["global_steps"]) == (2, 1, 3)
    for k in ranks[0]["params"]:
        np.testing.assert_array_equal(ranks[0]["params"][k],
                                      ranks[1]["params"][k])


def test_dropout_world2_equals_world1(runs):
    """Dropout 0.1, gas 2, SGD: each rank draws the one-rank run's masks
    for its global rows, so two ranks train as one."""
    want = runs["dropout_one_rank"]
    for r in runs["zero"]:
        _same_losses(r["dropout"]["losses"], want["losses"])
        _params_close(r["dropout"]["params"], want["params"])


@pytest.mark.parametrize("name", list(W.MASKED))
def test_uneven_labels_match_jax_and_world1(runs, name):
    """Rows with masked prompts of different lengths (explicit -100
    labels), so the two ranks' label counts differ: on the eager
    schedule each rank divides by the whole micro-batch's count, and the
    run equals JAX's engine on 2 devices and the port's one-rank run;
    under deferred_grad_sync each rank takes its own rows' mean, as JAX's
    manual-over-data region does, and equals JAX's deferred engine."""
    want = runs["jax"][f"masked_{name}"]
    one = runs["masked_one_rank"].get(name)
    for r in runs["zero"]:
        got = r[f"masked_{name}"]
        _same_losses(got["losses"], want["losses"])
        _params_close(got["params"], want["params"])
        if one is not None:
            _same_losses(got["losses"], one["losses"])
            _params_close(got["params"], one["params"])
    counts = [(b["labels"][:W.B // 2] != -100).sum()
              for b in W.masked_batches()]
    assert all(c < (b["labels"][W.B // 2:] != -100).sum()
               for c, b in zip(counts, W.masked_batches()))


def test_three_call_api_uneven_labels_equals_world1(runs):
    """``forward`` / ``backward`` / ``step`` at two ranks, each rank's
    ``forward`` on its rows of the masked micro-batches: the loss divided
    by every rank's label count together, as the one-rank run's
    ``train_batch`` of the same micro-batches."""
    want = runs["masked_one_rank"]["s3_gas2"]
    for r in runs["zero"]:
        got = r["masked_three_call"]
        _same_losses(got["losses"], want["losses"])
        _params_close(got["params"], want["params"])


def test_comm_facade_collectives(runs):
    f0, f1 = (r["facade"] for r in runs["zero"])
    x = [np.arange(12, dtype=np.float32).reshape(2, 6) + 100 * r
         for r in range(2)]
    for r, f in enumerate((f0, f1)):
        np.testing.assert_array_equal(f["gathered"], np.concatenate(x, 1))
        np.testing.assert_array_equal(
            f["scattered"], (x[0] + x[1])[:, 3 * r:3 * r + 3])
        assert (f["max"], f["mean"], f["bcast"]) == (1.0, 0.5, 8.0)
    assert f0["counts"]["all_gather"]["data"] == {"calls": 1,
                                                  "bytes": 48}
    assert f0["counts"]["reduce_scatter"]["data"]["calls"] == 1


# ---------------------------------------------------------------------------
# the specs and plans, against JAX's functions (no engine)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1, 2, 3])
@pytest.mark.parametrize("axes", [{"data": 2}, {"fsdp": 2},
                                  {"data": 2, "fsdp": 2}, {"data": 4}])
def test_zero_specs_match_jax(stage, axes):
    """zero_param_spec, opt_state_spec, grad_spec and the hierarchical
    spec of every llama-1b leaf equal JAX's on the same plan."""
    from deepspeed_tpu.comm import schedule as jax_sched
    from deepspeed_tpu_torch.comm import schedule as port_sched
    jcfg = jt.llama_config("1b")
    tcfg = tt.llama_config("1b")
    zc_j = JaxConfig.load({"zero_optimization": {"stage": stage}}
                          ).zero_optimization
    zc_t = Config.load({"zero_optimization": {"stage": stage}}
                       ).zero_optimization
    jplan, tplan = jax_mesh.MeshPlan(**axes), port_mesh.MeshPlan(**axes)
    jspecs = _flat(jax_spec_tree(jt.logical_axes(jcfg),
                                 jax_rules(stage, tp=False)))
    tspecs = _flat(spec_tree(tt.logical_axes(tcfg), make_rules(stage,
                                                               tp=False)))
    shapes = {k: v.shape for k, v in _flat(jax.eval_shape(
        jt.make_model(jcfg).init, jax.random.PRNGKey(0))).items()}

    def same(t, j):
        return t == tuple(j)

    for k, shape in shapes.items():
        pj = jax_zero.zero_param_spec(jspecs[k], shape, jplan, zc_j)
        pt = port_zero.zero_param_spec(tspecs[k], shape, tplan, zc_t)
        assert same(pt, pj), (k, pt, pj)
        assert same(port_zero.opt_state_spec(pt, shape, tplan, zc_t),
                    jax_zero.opt_state_spec(pj, shape, jplan, zc_j)), k
        gt = port_zero.grad_spec(pt, shape, tplan, zc_t)
        gj = jax_zero.grad_spec(pj, shape, jplan, zc_j)
        assert same(gt, gj), k
        assert same(port_sched.hierarchical_spec(gt, shape, tplan),
                    jax_sched.hierarchical_spec(gj, shape, jplan)), k
    assert port_zero.describe(zc_t, tplan) == jax_zero.describe(zc_j, jplan)


@pytest.mark.parametrize("conf", [
    {"zero_optimization": {"stage": 1}},
    {"zero_optimization": {"stage": 3}},
    {"mesh": {"axes": {"data": 2, "fsdp": 4}}},
    {"mesh": {"axes": {"fsdp": 8}}, "zero_optimization": {"stage": 2}}])
def test_plan_and_topology_match_jax(conf):
    a = port_mesh.plan_from_config(Config.load(conf), 8)
    b = jax_mesh.plan_from_config(JaxConfig.load(conf), 8)
    assert (a.data, a.fsdp, a.expert, a.tensor, a.dp_world_size,
            a.describe()) == (b.data, b.fsdp, b.expert, b.tensor,
                              b.dp_world_size, b.describe())
    ta, tb = port_mesh.Topology(a), jax_mesh.Topology(b)
    for axis in port_mesh.AXIS_ORDER:
        assert ta.get_axis_comm_lists(axis) == tb.get_axis_comm_lists(axis)
    for r in range(8):
        assert ta.get_coord(r) == {k: v for k, v in tb.get_coord(r).items()
                                   if k in port_mesh.AXIS_ORDER}
        assert ta.get_rank(**ta.get_coord(r)) == r


def test_fused_k_steps_equal_one_step_at_a_time():
    """``pipeline.fuse_steps`` 2 over 5 steps is bit for bit the run of
    K = 1, as JAX's fused program is (the eager port accepts the key and
    runs the same loop)."""
    p0 = jax.tree.map(np.asarray, jt.make_model(_jcfg()).init(
        jax.random.PRNGKey(42)))
    bs = W.batches(5)
    out = {}
    for k in (1, 2):
        e = W.engine(p0, W.conf(0, pipeline={"fuse_steps": k}))
        m = e.train_batches(iter(bs), 5)
        out[k] = (float(m["loss"]), W.whole_params(e), e.global_steps)
    assert out[1][0] == out[2][0] and out[1][2] == out[2][2] == 5
    for name in out[1][1]:
        np.testing.assert_array_equal(out[1][1][name], out[2][1][name])
