"""The port's quantizer and compression against the JAX package's
(``tests/unit/test_compression.py``): quantize / dequantize and int4
packing bit for bit, each pruning mask equal to JAX's on the same numpy
leaf (and JAX's quantile past 2^24 values), the leaves each rule hits,
and engines against engines at f32 over 3 steps (losses within 1e-5):
QAT with every pruning kind, activation quantization after its offset
with layer reduction, and a layer-reduced student distilled from its
teacher."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.compression import compress as jc
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.compression import compress as pc
from deepspeed_tpu_torch.models import params_from_numpy
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import quantizer as pq

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)
from tests._torch_extras_common import (assert_losses, assert_params,
                                        base_conf, cfgs, engines, ids,
                                        init_np, leaves, np_tree, rel_l2,
                                        train_both)


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# the quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,symmetric", [(8, True), (8, False),
                                            (4, True), (4, False)])
def test_quantize_round_trip_bit_for_bit(bits, symmetric):
    x = _normal(0, (64, 128))
    want = jq.quantize(jnp.asarray(x), bits=bits, symmetric=symmetric,
                       num_groups=64)
    got = pq.quantize(torch.from_numpy(x), bits=bits, symmetric=symmetric,
                      num_groups=64)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    if symmetric:
        assert got.zero is None and want.zero is None
    else:
        np.testing.assert_array_equal(got.zero.numpy(),
                                      np.asarray(want.zero))
    np.testing.assert_array_equal(pq.dequantize(got).numpy(),
                                  np.asarray(jq.dequantize(want)))
    assert got.q.dtype == (torch.uint8 if bits == 4 else torch.int8)


def test_int4_packing_and_fake_quant():
    q = np.random.default_rng(1).integers(-8, 8, (4, 64)).astype(np.int8)
    packed = pq.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jq.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(pq.unpack_int4(packed).numpy(), q)
    with pytest.raises(ValueError, match="even"):
        pq.pack_int4(torch.zeros((2, 3), dtype=torch.int8))
    x = _normal(2, (32, 32))
    for bits in (8, 4):
        t = torch.from_numpy(x).requires_grad_(True)
        y = pq.fake_quant(t, bits=bits)
        np.testing.assert_array_equal(
            y.detach().numpy(), np.asarray(jq.fake_quant(jnp.asarray(x),
                                                         bits=bits)))
        (y * 3.0).sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), 3.0)   # STE


def test_quantize_tree_matches_jax():
    tree = {"big": _normal(3, (128, 128)), "small": _normal(4, (4,)),
            "odd": _normal(5, (3, 4099))}
    want = jq.quantize_tree(jax.tree.map(jnp.asarray, tree), bits=8,
                            min_size=1000)
    got = pq.quantize_tree({k: torch.from_numpy(v) for k, v in tree.items()},
                           bits=8, min_size=1000)
    assert isinstance(got["big"], pq.QuantizedTensor)
    assert not isinstance(got["small"], pq.QuantizedTensor)
    for k in ("big", "odd"):
        np.testing.assert_array_equal(got[k].q.numpy(), np.asarray(want[k].q))
    back, jback = pq.dequantize_tree(got), jq.dequantize_tree(want)
    for k in tree:
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]))


# ---------------------------------------------------------------------------
# the masks and the rules
# ---------------------------------------------------------------------------

MASKS = {
    "sparse": (jc._topk_mask, pc._topk_mask, {}),
    "row": (jc._row_mask, pc._row_mask, {}),
    "channel": (jc._channel_mask, pc._channel_mask, {}),
    "head": (jc._head_mask, pc._head_mask, {"num_heads": 4}),
}


@pytest.mark.parametrize("kind", list(MASKS))
@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48)])
@pytest.mark.parametrize("ratio", [0.5, 0.3])
def test_mask_matches_jax(kind, shape, ratio):
    """The same numpy leaf (a stacked [L, in, out] one too: one threshold
    over every layer, the head mask one a layer) gives JAX's mask."""
    jf, pf, kw = MASKS[kind]
    w = _normal(hash((kind, shape, ratio)) % 2 ** 31, shape)
    want = np.asarray(jf(jnp.asarray(w), ratio, **kw))
    got = pf(torch.from_numpy(w), ratio, **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_quantile_past_2_pow_24_matches_jax():
    """Past 2^24 values n - 1 rounds in f32: the port takes JAX's
    position, not the exact one (torch.quantile refuses such inputs)."""
    # sorted already: XLA's CPU sort of 2^24 values is then quick
    a = np.sort(np.random.default_rng(6).random(2 ** 24 + 3,
                                                dtype=np.float32))
    want = float(jnp.quantile(jnp.asarray(a), 0.3))
    got = float(pc.quantile(torch.from_numpy(a), 0.3))
    assert got == want


def _rules():
    def grp(params, modules, offset=1):
        return {"shared_parameters": {"enabled": True,
                                      "schedule_offset": offset},
                "different_groups": {"g": {"params": params,
                                           "modules": modules}}}
    return {
        "weight_quantization": grp({"target_bits": 8},
                                   ["layers/w_in", "*w_gate"]),
        "sparse_pruning": grp({"dense_ratio": 0.5}, ["w_out", "tok_embed"]),
        "row_pruning": grp({"dense_ratio": 0.75}, ["layers/wq"]),
        "head_pruning": grp({"dense_ratio": 0.5, "num_heads": 4},
                            ["layers/wo"]),
        "channel_pruning": grp({"dense_ratio": 0.5}, ["layers/wk"], 2),
    }


def test_rules_hit_jax_leaves_and_transform_matches():
    """Every rule hits the leaves JAX's hits (fnmatch or substring over
    the same leaf names), and the transformed tree equals JAX's before
    and after the offsets."""
    jcfg, tcfg = cfgs(layers=3)
    p = init_np(jcfg)
    rules = _rules()
    jt_ = jc.CompressionTransform(rules)
    pt = pc.CompressionTransform(rules)
    flat = leaves(p)
    want_hits = {path: [r.kind for r in jt_._leaf_ops(path, jnp.asarray(v))]
                 for path, v in flat.items()}
    want_hits = {k: v for k, v in want_hits.items() if v}
    tp = params_from_numpy(p, tcfg, device="cpu", dtype=torch.float32)
    got_hits = {path: [r.kind for r in pt._leaf_ops(path, v)]
                for path, v in leaves(tp).items()}
    assert {k: v for k, v in got_hits.items() if v} == want_hits
    assert set(want_hits) == {"layers/w_in", "layers/w_gate", "layers/w_out",
                              "tok_embed", "layers/wq", "layers/wo",
                              "layers/wk"}
    for step in (0, 1, 2):
        want = leaves(np_tree(jt_.apply(jax.tree.map(jnp.asarray, p), step)))
        got = leaves(np_tree(pt.apply(tp, step)))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    clean = leaves(np_tree(pc.redundancy_clean(tp, rules)))
    jclean = leaves(np_tree(jc.redundancy_clean(
        jax.tree.map(jnp.asarray, p), rules)))
    for k in jclean:
        np.testing.assert_array_equal(clean[k], jclean[k], err_msg=k)


def test_no_enabled_section_raises():
    for mod in (jc, pc):
        with pytest.raises(ValueError, match="no enabled section"):
            mod.CompressionTransform({"sparse_pruning": {}})


# ---------------------------------------------------------------------------
# engines against engines (f32, 3 steps)
# ---------------------------------------------------------------------------

def _batches(n, rows=4, seed=0):
    return [{"input_ids": ids(seed + i, rows)} for i in range(n)]


def test_qat_engine_matches_jax_engine():
    """Weight fake-quant and the sparse, row, head and channel masks from
    their offsets on, applied inside each micro-batch's loss (gas 2); the
    masters stay full precision. SGD: its update is linear in the grads,
    where Adam's first steps are near sign(g) and turn a grad that sums to
    within rounding of 0 (a thread count's summation order) into a full
    step."""
    jcfg, tcfg = cfgs(layers=3)
    conf = base_conf(rows=4, gradient_accumulation_steps=2,
                     compression_training=_rules(),
                     optimizer={"type": "sgd",
                                "params": {"lr": 0.5, "momentum": 0.9}})
    je, te = engines(jcfg, tcfg, conf)
    jl, tl = train_both(je, te, _batches(3))
    assert_losses(jl, tl)
    assert_params(je, te)
    # eval applies the transform at the applied-update count, as JAX's
    b = _batches(1, seed=9)[0]
    assert abs(float(je.eval_batch(b)) - float(te.eval_batch(b))) <= 1e-5


def test_activation_quant_and_layer_reduction_match_jax_engine():
    """activation_quantization switches on at its offset (the engine
    rebuilds the model), layer_reduction trains a 2-layer student of the
    3-layer model, both as JAX's engine does."""
    jcfg, tcfg = cfgs(layers=3)
    conf = base_conf(rows=4, compression_training={
        "activation_quantization": {
            "shared_parameters": {"enabled": True, "schedule_offset": 2},
            "different_groups": {"a8": {"params": {"bits": 8},
                                        "modules": ["*"]}}},
        "layer_reduction": {"enabled": True, "keep_number": 2}})
    je, *_ = deepspeed_tpu.initialize(
        model=jt.make_model(jcfg), config=dict(conf),
        devices=jax.devices()[:1])
    p0 = jax.tree.map(np.asarray, jax.device_get(je.state["params"]))
    te, *_ = deepspeed_tpu_torch.initialize(model=tt.make_model(tcfg),
                                            config=dict(conf), params=p0,
                                            device="cpu")
    assert te.model.config.num_layers == 2
    assert te.state["params"]["layers"]["w_in"].shape[0] == 2
    assert not te._act_quant_on
    jl, tl = train_both(je, te, _batches(3, seed=3))
    assert te._act_quant_on and te.model.config.activation_quant_bits == 8
    assert_losses(jl, tl)


def test_distillation_loss_and_engine_match_jax():
    """A student of 2 of the teacher's 4 layers (``student_params_from_
    teacher``) trained on JAX's distillation loss: the loss and grads at
    f32 within 1e-5, then 3 engine steps of both packages."""
    jtc, ttc = cfgs(layers=4)
    jsc, tsc = cfgs(layers=2)
    teacher = init_np(jtc, seed=7)
    student = jc.student_params_from_teacher(
        jax.tree.map(jnp.asarray, teacher), [0, 3])
    student = jax.tree.map(np.asarray, student)
    pstudent = pc.student_params_from_teacher(teacher, [0, 3])
    for k, v in leaves(student).items():
        np.testing.assert_array_equal(leaves(pstudent)[k], v)
    tteacher = params_from_numpy(teacher, ttc, device="cpu",
                                 dtype=torch.float32)
    jkd = jc.make_distillation_loss(jsc, jax.tree.map(jnp.asarray, teacher),
                                    jtc, alpha=0.5, temperature=2.0)
    pkd = pc.make_distillation_loss(tsc, tteacher, ttc, alpha=0.5,
                                    temperature=2.0)
    b = {"input_ids": ids(11, 4)}
    jl, jg = jax.value_and_grad(lambda p: jkd(p, {
        "input_ids": jnp.asarray(b["input_ids"])}))(
            jax.tree.map(jnp.asarray, student))
    tp = params_from_numpy(student, tsc, device="cpu", dtype=torch.float32)
    for v in leaves(tp).values():
        v.requires_grad_(True)
    tl = pkd(tp, {"input_ids": torch.from_numpy(b["input_ids"])})
    names = list(leaves(tp))
    tg = torch.autograd.grad(tl, [leaves(tp)[k] for k in names])
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * abs(float(jl))
    jgl = leaves(np_tree(jg))
    for k, g in zip(names, tg):
        assert rel_l2(g.numpy(), jgl[k]) <= 1e-4, k

    je, te = engines(jsc, tsc, base_conf(rows=4),
                     jmodel=dataclasses.replace(jt.make_model(jsc),
                                                loss_fn=jkd),
                     tmodel=dataclasses.replace(tt.make_model(tsc),
                                                loss_fn=pkd),
                     params=student)
    # the JAX engine starts from the student too (JAX's documented step:
    # assign the student's params to the engine's state)
    je.state = dict(je.state, params=jax.tree.map(
        lambda a, ref: jax.device_put(jnp.asarray(a), ref.sharding),
        student, je.state["params"]))
    jl, tl = train_both(je, te, _batches(3, seed=5))
    assert_losses(jl, tl)


def test_extras_refusals_at_one_rank():
    """JAX's ValueErrors: a model that is not a transformer under
    activation quantization, layer reduction, MoQ, PLD or random-LTD, and
    a curriculum other than seqlen."""
    import types
    spec = types.SimpleNamespace(config=None, name="not-a-transformer")
    sections = {
        "compression_training": {"layer_reduction": {
            "enabled": True, "keep_number": 1}},
        "quantize_training": {"enabled": True},
        "progressive_layer_drop": {"enabled": True},
        "data_efficiency": {"enabled": True, "data_routing": {
            "random_ltd": {"enabled": True}}},
    }
    for name, section in sections.items():
        with pytest.raises(ValueError, match="transformer"):
            deepspeed_tpu_torch.initialize(
                model=spec, config=base_conf(**{name: section}),
                device="cpu")
    _, tcfg = cfgs()
    with pytest.raises(ValueError, match="seqlen"):
        deepspeed_tpu_torch.initialize(
            model=tt.make_model(tcfg), device="cpu",
            config=base_conf(curriculum_learning={
                "enabled": True, "curriculum_type": "vocab"}))
