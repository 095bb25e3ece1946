"""Sharded serving (tensor and expert parallel) against JAX, the port of
``tests/unit/test_tp_serving.py``'s scenarios.

The port's engines run on spawned gloo groups of 2 and 4 processes
(``parallel/launch.run_group``, a ``file://`` store), each group spawned
once for the module; the rank programs are in ``_torch_tp_workers.py``
(no jax there: a spawned child re-imports it). The JAX engines run here,
on ``_mesh(n, tensor=...)`` / ``_mesh(n, expert=...)`` of the conftest's
8 virtual devices with XLA attention, as JAX's own tests run them. f32,
greedy, token for token.

Not ported from that file: the collective-census pin and the
replicated-pool corpus (HLO analyzers, ROADMAP A11, last if at all) and
the failover ordering (the router's, held by ``tests/test_torch_router.py``).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.lora import make_random_adapter as jax_adapter
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.models import make_model as jax_make_model
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.parallel import MeshPlan as JaxPlan
from deepspeed_tpu.parallel import build_mesh as jax_build_mesh
from deepspeed_tpu.parallel.partitioning import make_rules as jax_rules
from deepspeed_tpu.parallel.partitioning import spec_tree as jax_spec_tree
from deepspeed_tpu_torch.models import TransformerConfig, make_model
from deepspeed_tpu_torch.models import convert, transformer as pt
from deepspeed_tpu_torch.parallel import Mesh, MeshPlan
from deepspeed_tpu_torch.parallel.launch import run_group
from deepspeed_tpu_torch.parallel.partitioning import spec_tree

from tests import _torch_tp_workers as W
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)


def _jcfg(**overrides):
    return JaxConfig(**{**W.CFG, **overrides}, dtype=jnp.float32,
                     attention_impl="xla")


def _mesh(n, **axes):
    return jax_build_mesh(JaxPlan(**axes), devices=jax.devices()[:n])


def _jax_serving(model, params, mesh=None, config=None, **serving):
    return deepspeed_tpu.init_serving(
        model, config=config or {}, serving={**W.SERVING, **serving},
        dtype=jnp.float32, params=params, mesh=mesh)


def _streams(outs):
    return [np.asarray(outs[k]) for k in sorted(outs)]


def _same(got, want, what):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: request {i}")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX engines' streams (tp=2, ep=4) and a drain directory
    written by JAX's tp=2 engine."""
    tmp = str(tmp_path_factory.mktemp("tp_serving"))
    model = jax_make_model(_jcfg())
    params = jax.tree.map(np.asarray,
                          jax.device_get(model.init(jax.random.PRNGKey(0))))
    moe = jax_make_model(_jcfg(num_experts=4, top_k=2))
    moe_params = jax.tree.map(np.asarray,
                              jax.device_get(moe.init(jax.random.PRNGKey(1))))
    tp2 = _mesh(2, tensor=2)
    out = {"params": params, "moe_params": moe_params, "tmp": tmp}
    out["basic"] = _streams(_jax_serving(model, params, tp2).run(W.reqs()))
    out["preempt_prefix"] = _streams(_jax_serving(
        model, params, tp2, max_seqs=2, num_blocks=9,
        enable_prefix_cache=True).run(W.shared_prefix_reqs()))
    out["spec_chunked"] = _streams(_jax_serving(
        model, params, tp2, spec_tokens=3, prefill_token_budget=48).run(
            W.reqs(seed=5, lens=(7, 33), news=(12, 10))))
    srv = _jax_serving(model, params, tp2, adapter_slots=3, lora_rank=4)
    for a in (1, 2, 3):
        srv.register_adapter(a, jax_adapter(srv.model.config, 4, seed=a,
                                            scale=0.2))
    out["lora"] = _streams(srv.run(W.lora_reqs()))
    drain_load = W.reqs(seed=7, lens=(9, 25), news=(12, 10))
    out["drain_base"] = _streams(_jax_serving(model, params, tp2)
                                 .run(drain_load))
    srv = _jax_serving(model, params, tp2)
    for p, n in drain_load:
        srv.add_request(p, n)
    srv.step()
    out["jax_drain"] = os.path.join(tmp, "jax_tp2_drain")
    srv.drain(out["jax_drain"])
    out["ep4"] = _streams(_jax_serving(moe, moe_params, _mesh(4, expert=4))
                          .run(W.reqs(seed=3)))
    return out


@pytest.fixture(scope="module")
def group2(jax_side):
    """Every 2-rank scenario, one spawned group."""
    return run_group(W.group2, 2, jax_side, threads=1, timeout_s=300)


@pytest.fixture(scope="module")
def group4(jax_side):
    """Every 4-rank scenario, one spawned group."""
    return run_group(W.group4, 4, jax_side, threads=1, timeout_s=300)


def _result(group, name):
    r = group[name]
    assert "error" not in r, r.get("error")
    return r


# ---------------------------------------------------------------------------
# tp = 2
# ---------------------------------------------------------------------------

def test_tp2_token_identical_and_pool_bytes_law(jax_side, group2):
    """A tp=2 engine's greedy streams equal JAX's tp=2 engine's and the
    port's tp=1 streams; each rank holds kv_heads / 2 heads, a column
    slice of wq and half the vocab rows, and pool_bytes prices the rank's
    shard: pool_bytes * 2 == pool_bytes_logical, mesh-independent."""
    r = _result(group2, "basic")
    _same(r["streams"], jax_side["basic"], "port tp=2 vs JAX tp=2")
    _same(r["streams"], r["tp1"], "port tp=2 vs port tp=1")
    assert r["degrees"] == (2, 1) and r["mesh_desc"] == "tensor=2"
    assert r["pool_shape"][2] * 2 == W.CFG["num_kv_heads"]
    assert r["wq_shape"][-1] * 2 == W.CFG["num_heads"] * 16
    assert r["embed_rows"] * 2 == W.CFG["vocab_size"]
    st, st1 = r["stats"], r["stats1"]
    assert st["pool_bytes"] * 2 == st["pool_bytes_logical"]
    assert st["pool_bytes_logical"] == st1["pool_bytes_logical"]
    assert st1["pool_bytes"] == st1["pool_bytes_logical"]
    assert (st["tp"], st["ep"]) == (2.0, 1.0)
    assert (st1["tp"], st1["ep"]) == (1.0, 1.0)


def test_tp2_parity_under_preemption_and_prefix_cache(jax_side, group2):
    """A pool below full residency (preemption, re-prefill) and the CoW
    prefix cache: block ids are rank 0's host metadata, so tp=2 makes
    tp=1's decisions and its streams."""
    r = _result(group2, "preempt_prefix")
    for st in (r["stats"], r["stats1"]):
        assert st["preemptions"] >= 1 and st["prefix_hits"] >= 1
    assert r["stats"] == r["stats1"]
    _same(r["streams"], r["tp1"], "port tp=2 vs port tp=1")
    _same(r["streams"], jax_side["preempt_prefix"], "port vs JAX tp=2")


def test_tp2_latency_tier_composes_token_identical(jax_side, group2):
    """Speculative decoding and chunked prefill at tp=2 (the span path,
    head-sharded) against the plain tp=1 engine and JAX's tp=2."""
    r = _result(group2, "spec_chunked")
    assert r["stats"]["spec_steps"] >= 1 and r["stats"]["prefill_chunks"] >= 1
    _same(r["streams"], r["tp1"], "tp=2 spec + chunks vs plain tp=1")
    _same(r["streams"], jax_side["spec_chunked"], "port vs JAX tp=2")


def test_drain_records_mesh_and_tp1_refuses(group2):
    """The drain's engine record carries tp=2 / ep=1; a tp=1 engine
    refuses it (resume and per-request migration) with
    ResumeIncompatible, records without the fields pass, and a tp=2
    engine picks it up."""
    r = _result(group2, "drain")
    assert r["engine_record"]["tp"] == 2 and r["engine_record"]["ep"] == 1
    for why in r["tp1_refusals"]:
        assert why is not None and "tp=2" in why, why
    assert r["legacy_accepted"]
    assert len(r["resumed"]["rids"]) == 2


def test_tp2_drain_resume_continues_byte_identical(jax_side, group2):
    """tp=2 drained after one round and resumed on a fresh tp=2 engine
    continues exactly as the uninterrupted tp=2 run (and JAX's)."""
    r = _result(group2, "drain")
    _same(r["resumed"]["streams"], r["base"], "resumed vs uninterrupted")
    _same(r["base"], jax_side["drain_base"], "port vs JAX tp=2")


def test_jax_tp2_drain_accepted_by_port_tp2(jax_side, group2):
    """A drain directory written by JAX's tp=2 engine resumes unchanged on
    the port's tp=2 engine and finishes JAX's uninterrupted streams."""
    with open(os.path.join(jax_side["jax_drain"], "serving_drain",
                           "state.json")) as f:
        assert json.load(f)["engine"]["tp"] == 2
    r = _result(group2, "drain")
    _same(r["jax_resumed"]["streams"], jax_side["drain_base"],
          "JAX drain resumed by the port")


def test_tp2_multi_lora_matches_tp1(jax_side, group2):
    """Multi-LoRA at tp=2: o's A is sharded on heads (its partial sums
    join wo's reduction), q/k/v's B on their columns; streams equal
    tp=1's and JAX's tp=2, with the same page-ins and evictions."""
    r = _result(group2, "lora")
    _same(r["streams"], r["tp1"], "LoRA tp=2 vs tp=1")
    _same(r["streams"], jax_side["lora"], "LoRA port vs JAX tp=2")
    H, nh_hd = W.CFG["hidden_size"], W.CFG["num_heads"] * 16
    assert r["o_a"] == (2, 3, nh_hd // 2, 4)
    assert r["q_b"] == (2, 3, 4, nh_hd // 2)
    for k in ("adapter_page_ins", "adapter_evictions"):
        assert r["stats"][k] == r["stats1"][k] and r["stats"][k] >= 1
    assert r["stats"]["pool_bytes_logical"] == r["stats1"]["pool_bytes"]
    assert H


def test_tp2_int8_pool_matches_tp1(group2):
    """The int8 KV pool at tp=2: payloads and their scales shard with
    their heads; streams equal tp=1's int8 pool."""
    r = _result(group2, "int8")
    _same(r["streams"], r["tp1"], "int8 tp=2 vs tp=1")
    assert r["scale_shape"][2] * 2 == W.CFG["num_kv_heads"]
    assert r["stats"]["pool_bytes"] * 2 == r["stats"]["pool_bytes_logical"]


def test_tp2_weight_bits_matches_tp1(group2):
    """weight_bits=8 at tp=2: wq's scales shard with its columns, wo's
    (row-parallel: its out columns whole) are replicated and multiply
    after the reduction; streams equal tp=1's int8-weight engine."""
    r = _result(group2, "weight_bits")
    _same(r["streams"], r["tp1"], "weight_bits tp=2 vs tp=1")
    assert r["wq_scale"] == (2, 1, W.CFG["num_heads"] * 16 // 2)
    assert r["wo_scale"] == (2, 1, W.CFG["hidden_size"])


def test_tp2_kv_handoff_carries_all_heads(group2):
    """export_kv at tp=2 ships all kv heads (JAX's logical payload); it
    imports into a tp=1 engine, and a tp=1 payload into a tp=2 engine,
    each continuing as the uninterrupted run."""
    r = _result(group2, "handoff")
    for heads in r["payload_heads"].values():
        assert heads == W.CFG["num_kv_heads"]
    for shape in r["payload_shape"].values():
        assert shape[2] == W.CFG["num_kv_heads"]
    assert r["tp2_to_tp1_handoffs"] == 2 and r["tp1_to_tp2_handoffs"] == 2
    _same(r["tp2_to_tp1"], r["base"], "tp=2 -> tp=1 handoff")
    _same(r["tp1_to_tp2"], r["base"], "tp=1 -> tp=2 handoff")


def test_close_after_a_hung_round_stops_the_other_ranks(group2):
    """After DecodeDispatchHang, rank 0's close() does not wait for the
    round thread, yet the other rank's run_worker returns: the thread
    sends the stop once its current call ends, and makes no other."""
    r = _result(group2, "close_after_hang")
    assert r["hang"] is not None and "dispatch_timeout_s" in r["hang"]
    assert r["joined"] is True


# ---------------------------------------------------------------------------
# 4 ranks: expert parallel
# ---------------------------------------------------------------------------

def test_ep4_moe_matches_jax_and_unsharded(jax_side, group4):
    """expert_parallel=4: each rank holds E / 4 experts; streams equal
    JAX's ep=4 engine and the unsharded port."""
    r = _result(group4, "ep4")
    assert r["degrees"] == (1, 4) and r["mesh_desc"] == "expert=4"
    assert r["moe_w_in"][1] * 4 == 4
    _same(r["streams"], jax_side["ep4"], "port ep=4 vs JAX ep=4")
    _same(r["streams"], r["ep1"], "port ep=4 vs unsharded")


def test_tp2_ep2_moe_matches_unsharded(group4):
    """Both axes at once (2 x 2 ranks): experts over expert, their FFN
    columns and the heads over tensor; the combine reduces over both."""
    r = _result(group4, "tp2ep2")
    ep1 = _result(group4, "ep4")["ep1"]
    assert r["degrees"] == (2, 2) and r["mesh_desc"] == "expert=2xtensor=2"
    ffn = TransformerConfig(**W.MOE).ffn_dim
    assert r["moe_w_in"][1] == 2 and r["moe_w_in"][3] * 2 == ffn
    _same(r["streams"], ep1, "tp=2 x ep=2 vs unsharded")


def test_dense_model_on_expert_mesh_degrades_not_crashes(group2, group4):
    """A dense model on a mesh with an expert axis serves at ep = 1 (every
    rank a replica), and a tp=1 ep=1 geometry migrates to it."""
    r = _result(group4, "dense_expert_mesh")
    assert r["degrees"] == (1, 1, 1)
    assert r["migration"] == []
    _same(r["streams"], _result(group2, "basic")["tp1"], "replicas vs tp=1")


# ---------------------------------------------------------------------------
# validations (before any process group is touched) and the rules
# ---------------------------------------------------------------------------

def _port(cfg=None):
    return make_model(TransformerConfig(**(cfg or W.CFG),
                                        dtype=torch.float32))


def test_kv_heads_must_divide_tp():
    model = _port(dict(W.CFG, num_heads=6, num_kv_heads=3))
    with pytest.raises(ValueError, match="kv_heads"):
        deepspeed_tpu_torch.init_serving(model, serving=W.SERVING,
                                         dtype=torch.float32, device="cpu",
                                         mesh=MeshPlan(tensor=2))


def test_expert_parallel_needs_divisible_moe():
    with pytest.raises(ValueError, match="MoE"):
        deepspeed_tpu_torch.init_inference(
            _port(), config={"expert_parallel": 4}, dtype=torch.float32,
            device="cpu")
    with pytest.raises(ValueError, match="num_experts"):
        deepspeed_tpu_torch.init_inference(
            _port(W.MOE), config={"expert_parallel": 3},
            dtype=torch.float32, device="cpu", mesh=MeshPlan(expert=3))


def test_int8_tree_needs_a_quantized_engine(group2):
    """An int8 {q, scale} tree served with neither quantize_bits nor
    weight_bits raises ValueError at tp=1 and at tp=2 alike (one
    parameter builder for every mesh), on every rank."""
    r = _result(group2, "int8_tree")
    for what in ("tp1", "tp2"):
        assert r[what] is not None and "quantize_bits" in r[what], r


def test_mesh_contradicting_config_degree_refused():
    with pytest.raises(ValueError, match="tensor"):
        deepspeed_tpu_torch.init_inference(
            _port(), config={"tensor_parallel": 4}, dtype=torch.float32,
            device="cpu", mesh=MeshPlan(tensor=2))
    with pytest.raises(ValueError, match="expert"):
        deepspeed_tpu_torch.init_inference(
            _port(W.MOE), config={"expert_parallel": 4},
            dtype=torch.float32, device="cpu", mesh=MeshPlan(expert=2))


def _spec(p):
    return tuple(p) if p is not None else ()


def _on_plan(spec, plan):
    """A spec as it cuts on ``plan``: an axis of size 1 cuts nothing."""
    sizes = plan.axis_sizes()
    out = [a if a is not None and sizes[a] > 1 else None for a in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("tp", [False, True])
@pytest.mark.parametrize("kind", ["dense", "moe", "moe_quantized"])
def test_rules_match_jax(tp, kind):
    """The port's one rules table cuts what JAX's ``make_rules(0, tp=)``
    gives every leaf (dense, MoE, and the int8 structure whose scales
    shard with their out columns): with a tensor axis, spec for spec;
    without one (tp=False), on a mesh whose tensor axis has size 1."""
    over = {} if kind == "dense" else dict(num_experts=4, top_k=2)
    jcfg = _jcfg(**over)
    cfg = TransformerConfig(**{**W.CFG, **over}, dtype=torch.float32)
    if kind == "moe_quantized":
        jaxes, axes = jt.quantized_logical_axes(jcfg), \
            pt.quantized_logical_axes(cfg)
    else:
        jaxes, axes = jt.logical_axes(jcfg), pt.logical_axes(cfg)
    want = jax_spec_tree(jaxes, jax_rules(0, tp=tp))
    plan = MeshPlan(expert=2, tensor=2 if tp else 1)
    got = jax.tree_util.tree_map(lambda s: _on_plan(s, plan),
                                 spec_tree(axes),
                                 is_leaf=lambda x: isinstance(x, tuple))
    flat_w = {jax.tree_util.keystr(k): _spec(v) for k, v in
              jax.tree_util.tree_flatten_with_path(
                  want, is_leaf=lambda x: isinstance(x, jax.sharding
                                                     .PartitionSpec))[0]}
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(
                  got, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert flat_g == flat_w


@pytest.mark.parametrize("axes", [dict(tensor=2), dict(expert=4),
                                  dict(expert=2, tensor=2)])
def test_rank_slices_are_jax_shards(axes):
    """params_from_numpy(mesh=) gives rank r exactly the shard JAX's
    engine places on device r of the same mesh."""
    over = dict(num_experts=4, top_k=2)
    jmodel = jax_make_model(_jcfg(**over))
    params = jax.tree.map(np.asarray, jax.device_get(
        jmodel.init(jax.random.PRNGKey(2))))
    plan = MeshPlan(**axes)
    jeng = deepspeed_tpu.init_inference(
        jmodel, config={"fuse_gemms": False}, dtype=jnp.float32,
        params=params, mesh=_mesh(plan.world_size, **axes))
    cfg = TransformerConfig(**W.MOE, dtype=torch.float32)
    devices = list(jeng.mesh.devices.flat)
    for rank in range(plan.world_size):
        mine = convert.params_from_numpy(params, cfg, device="cpu",
                                         dtype=torch.float32,
                                         mesh=Mesh(plan, rank=rank))
        dev = devices[rank]
        flat_j = jax.tree_util.tree_flatten_with_path(jeng.params)[0]
        flat_p = dict(jax.tree_util.tree_flatten_with_path(
            jax.tree.map(lambda t: t.numpy(), mine))[0])
        for path, leaf in flat_j:
            shard = next(s for s in leaf.addressable_shards
                         if s.device == dev)
            np.testing.assert_array_equal(flat_p[path],
                                          np.asarray(shard.data),
                                          err_msg=f"rank {rank} {path}")


def test_parallel_context_and_plan():
    """The ambient mesh: published and restored by parallel_context (and
    set_parallel_context, JAX's name), read by the model's collectives;
    without one every axis has size 1 and nothing is reduced. A plan's
    label is JAX's; the data, pipe and seq axes (training's) are a
    plan's too."""
    from deepspeed_tpu_torch.parallel import context
    assert context.axis_size("tensor") == 1 and context.current_plan() is None
    x = torch.ones(3)
    assert context.all_reduce(x, "tensor", "expert") is x
    mesh = Mesh(MeshPlan(expert=2, tensor=2), rank=3)
    with context.parallel_context(mesh):
        assert context.current_plan() == MeshPlan(expert=2, tensor=2)
        assert (context.axis_size("tensor"), context.axis_index("tensor"),
                context.axis_index("expert")) == (2, 1, 1)
    assert context.current_plan() is None
    context.set_parallel_context(mesh)
    try:
        assert context.axis_size("expert") == 2
    finally:
        context.set_parallel_context(None)
    assert MeshPlan(expert=2, tensor=2).describe() == "expert=2xtensor=2"
    assert MeshPlan().describe() == "single"
    assert MeshPlan(data=2, fsdp=2).dp_world_size == 4
    assert MeshPlan(data=2).describe() == "data=2"
    assert (MeshPlan(pipe=2, seq=2).describe(),
            MeshPlan(pipe=2, seq=2).world_size) == ("pipe=2xseq=2", 4)
    with pytest.raises(ValueError, match="degrees are >= 1"):
        MeshPlan(pipe=0)
