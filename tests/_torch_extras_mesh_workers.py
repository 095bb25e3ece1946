"""Rank programs of ``test_torch_extras_mesh.py``: the training extras on
the model-parallel axes and on the 1-bit compressed path, on gloo groups
of 2 and 4 ranks.

Each ``group*`` function runs on every rank of a spawned group
(``deepspeed_tpu_torch.parallel.launch.run_group``, one CPU thread a
rank), plays its scenarios in order and gathers every rank's results
onto rank 0, which returns them as a list indexed by rank. Rank 0 also
runs the one-rank references (``single_mesh``). Random-LTD's kept tokens
and MoQ's probe start are JAX's own draws, computed by the test and fed
to the port's engines (``feeds``). This module imports torch, numpy and
the port only: a spawned child re-imports it, and the port never loads
jax. The configs live here so that the test builds JAX's engines from
the same fields.
"""

import dataclasses

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.compression import compress as pc
from deepspeed_tpu_torch.models import params_from_numpy
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.parallel import MeshPlan, build_mesh, single_mesh
from deepspeed_tpu_torch.parallel.partitioning import make_rules
from deepspeed_tpu_torch.runtime.eigenvalue import random_direction

from tests._torch_zero_workers import _gather_ranks, _set_state, whole_params

DIMS = dict(vocab_size=128, hidden_size=64, num_heads=4, num_kv_heads=2,
            intermediate_size=128, max_seq_len=64)
MOE = dict(num_experts=4, top_k=2)
B, S = 8, 32
STEPS = 2
SGD = {"type": "sgd", "params": {"lr": 0.1, "momentum": 0.9}}
TP = {"tensor_parallel": {"tp_size": 2}}
EP = {"moe": {"enabled": True, "expert_parallel_size": 2}}
SP = {"sequence_parallel": {"sp_size": 2}}
PP = {"pipeline": {"stages": 2}, "gradient_accumulation_steps": 2}


def _grp(params, modules, offset=0):
    return {"shared_parameters": {"enabled": True, "schedule_offset": offset},
            "different_groups": {"g": {"params": params,
                                       "modules": modules}}}


# every rule kind: 8-bit weights on every layer matmul, then the sparse
# mask on the MLP (and the experts'), rows of wq, heads of wo, output
# channels of wk (each a leaf the tensor axis cuts)
COMP = {"compression_training": {
    "weight_quantization": _grp({"target_bits": 8}, ["layers/w"]),
    "sparse_pruning": _grp({"dense_ratio": 0.5}, ["w_in", "w_out"]),
    "row_pruning": _grp({"dense_ratio": 0.75}, ["layers/wq"]),
    "head_pruning": _grp({"dense_ratio": 0.5, "num_heads": 4},
                         ["layers/wo"]),
    "channel_pruning": _grp({"dense_ratio": 0.75}, ["layers/wk"])}}
# MoQ at 8 bits over a long period: the per-layer scales of the transform
# act from the first step, and the bits stay 8 whatever the probe finds,
# so the runs compare with JAX's step for step; the probe (from JAX's
# start vector) gives the period scales held to JAX's and to one rank's
MOQ = {"quantize_training": {
    "enabled": True, "quantize_bits": {"start_bits": 8, "target_bits": 4},
    "quantize_schedule": {"quantize_period": 100},
    "eigenvalue": {"enabled": True, "max_iter": 3}}}


def ltd(keep, step=16):
    return {"data_efficiency": {"enabled": True, "data_routing": {
        "random_ltd": {"enabled": True, "min_value": keep,
                       "max_value": keep, "seq_step": step}}}}


def conf(stage=0, **kw):
    """f32, SGD with momentum (linear in the grads, so two runs that sum
    their grads in another order agree to rounding), clipping at 1.0."""
    c = {"train_batch_size": B, "bf16": {"enabled": False},
         "gradient_clipping": 1.0, "optimizer": SGD, "seed": 3,
         "zero_optimization": {"stage": stage,
                               "stage3_param_persistence_threshold": 0}}
    c.update(kw)
    return c


# scenario -> (layers, MoE, engine config, key mask): held to JAX's engine
# on the same mesh (random-LTD on JAX's kept tokens, MoQ's probe from
# JAX's start vector)
JAX2 = {
    "comp_tp2": (2, False, conf(0, **TP, **COMP), False),
    "comp_ep2": (2, True, conf(0, **EP, **COMP), False),
    "comp_pp2": (4, False, conf(0, **PP, **COMP), False),
    "comp_sp2": (2, False, conf(0, **SP, **COMP), False),
    "moq_tp2": (2, False, conf(0, **TP, **MOQ), False),
    "moq_ep2": (2, True, conf(0, **EP, **MOQ), False),
    "moq_sp2": (2, False, conf(0, **SP, **MOQ), False),
    "ltd_sp2": (4, False, conf(0, **SP, **ltd(16)), False),
    "ltd_sp2_masked": (4, False, conf(0, **SP, **ltd(16)), "right"),
    "ltd_sp2_left": (4, False, conf(0, **SP, **ltd(16)), "left"),
}
JAX4 = {
    "comp_tp2_fsdp2": (2, False, conf(3, **TP, **COMP), False),
}
# also held to the port's own one-rank run on the same draws
WORLD1 = ("comp_tp2", "moq_tp2", "moq_ep2", "moq_sp2", "ltd_sp2",
          "ltd_sp2_masked", "ltd_sp2_left")
# the layer-reduced student (2 of the teacher's 4 layers) distilled at
# tensor=2, the teacher placed as the student
STUDENT = (0, 3)


def pcfg(layers, moe=False):
    return tt.llama_config("tiny", dtype=torch.float32, num_layers=layers,
                           **DIMS, **(MOE if moe else {}))


def batches(n=STEPS, masked=False, seed=0, rows=B):
    """Global batches of ids. ``masked`` "right": each row r's last r % 4
    keys padded (a key mask); "left": its first r % 4, with those
    positions' labels -100 (a query row that sees no key: JAX's XLA
    branch gives it the mean of V, the port O = 0, ROADMAP C2 and C7;
    with no label there it adds nothing to the loss or the grads)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, DIMS["vocab_size"], (rows, S), dtype=np.int32)
        b = {"input_ids": ids}
        if masked:
            mask = np.ones((rows, S), np.int32)
            for r in range(rows):
                if masked == "left":
                    mask[r, :r % 4] = 0
                else:
                    mask[r, S - r % 4:] = 0
            b["attention_mask"] = mask
        if masked == "left":
            labels = np.concatenate(
                [ids[:, 1:], np.full((rows, 1), -100, np.int32)], axis=1)
            b["labels"] = np.where(mask > 0, labels, -100).astype(np.int32)
        out.append(b)
    return out


def feed(e, draws):
    """JAX's draws into ``e``: ``draws["ltd"][t]`` {layer: [B, keep] kept
    tokens of the global rows} for step t's random-LTD, ``draws["v0"][t]``
    {leaf: whole numpy array} as step t's MoQ probe start (each rank its
    slice)."""
    if "ltd" in draws:
        def draw(rows, seq_len, keep, micro, row0):
            sel = draws["ltd"][e.global_steps]
            assert all(s.shape[1] == keep for s in sel.values())
            return {i: torch.from_numpy(s[row0:row0 + rows]).long()
                    for i, s in sel.items()}
        e._ltd_draw = draw
    if "v0" in draws:
        probe = e._moq.layer_eigenvalues

        def start(*a, splits=None, **kw):
            whole = draws["v0"][e.global_steps]
            kw["v"] = {k: torch.from_numpy(v) if not (splits or {}).get(k)
                       else splits[k].local(torch.from_numpy(v))
                       for k, v in whole.items()}
            return probe(*a, splits=splits, **kw)
        e._moq.layer_eigenvalues = start


def train(p0, layers, moe, config, masked, mesh=None, local_masks=False,
          draws=None):
    """Losses of ``STEPS`` steps, the whole params, the plan, the masks of
    the first step (by path and kind, this rank's slices), MoQ's period
    scales and bits. ``local_masks``: the masks computed from each
    rank's own slice (the fault the whole-leaf rule prevents);
    ``draws``: JAX's (``feed``)."""
    e, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(pcfg(layers, moe)), config=config, params=p0,
        device="cpu", mesh=mesh)
    if draws:
        feed(e, draws)
    if local_masks:
        e._model_split = lambda path: None
    losses = []
    for i, b in enumerate(batches(masked=masked)):
        e.mask_record = {} if i == 0 else None
        losses.append(float(e.train_batch(b)["loss"]))
        if i == 0:
            masks = {f"{k[0]}|{k[1]}": v.detach().numpy().copy()
                     for k, v in e.mask_record.items()}
    rec = {"losses": losses, "params": whole_params(e), "masks": masks,
           "plan": e.plan.describe(), "draws": e.step_draws}
    if e._moq is not None:
        rec["period_scale"] = e._moq._period_scale.tolist()
        rec["bits"] = e._moq.bits(STEPS).tolist()
    return rec


def slices(p0, layers, moe, config):
    """{path: this rank's slice (as a tuple of (start, stop) per dim)} of
    every leaf the model axes cut (None where the rank holds it whole),
    and under "direction" MoQ's probe start drawn from a generator at
    seed 0 (``random_direction``: this rank's leaves of the layers)."""
    e, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(pcfg(layers, moe)), config=config, params=p0,
        device="cpu")
    out = {}
    for path, lay in e._part.layouts.items():
        sp = e._model_split(path)
        out[path] = None if sp is None else [
            (s.start, s.stop) if s.start is not None else (0, n)
            for s, n in zip(sp.slices, sp.shape)]
    layer_tree = e.state["params"]["layers"]
    v = random_direction(layer_tree, torch.Generator().manual_seed(0),
                         splits=[e._model_split("layers/" + k)
                                 for k in sorted(layer_tree)])
    out["direction"] = {k: t.numpy().copy() for k, t in v.items()}
    return out


def distill(teacher, student, mesh=None):
    """The student (2 layers) trained on the distillation loss against
    the 4-layer teacher (every rank its slices of both)."""
    mesh = mesh or build_mesh(MeshPlan(tensor=2))
    tcfg, scfg = pcfg(4), pcfg(2)
    rules = make_rules(0, tp=mesh.size("tensor") > 1)
    t = params_from_numpy(teacher, tcfg, device="cpu", dtype=torch.float32,
                          mesh=mesh, rules=rules)
    spec = dataclasses.replace(tt.make_model(scfg), loss_fn=(
        pc.make_distillation_loss(scfg, t, tcfg, alpha=0.5,
                                  temperature=2.0)))
    config = conf(0, **(TP if mesh.size("tensor") > 1 else {}))
    e, *_ = deepspeed_tpu_torch.initialize(model=spec, config=config,
                                           params=student, device="cpu",
                                           mesh=mesh)
    losses = [float(e.train_batch(b)["loss"]) for b in batches(seed=5)]
    return {"losses": losses, "params": whole_params(e),
            "plan": e.plan.describe()}


# --------------------------------------------------------------------------
# the 1-bit compressed path at data=2 (JAX's tests/unit/test_onebit.py
# TestOnebitCompression / TestOnebitMoQ, on a model of their size)
# --------------------------------------------------------------------------

ONEBIT_DIMS = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
                   max_seq_len=64)
ONEBIT_EXTRAS = {
    "compression": {"compression_training": {"weight_quantization": _grp(
        {"target_bits": 8}, ["*"])}},
    "moq": {"quantize_training": {
        "enabled": True, "quantize_bits": {"start_bits": 6, "target_bits": 4},
        "quantize_schedule": {"quantize_period": 4}}},
}


def onebit_conf(opt, extras, **opt_params):
    """The engine config of JAX's ``test_onebit._engine`` on 2 ranks."""
    return {"train_batch_size": 16, "bf16": {"enabled": False},
            "steps_per_print": 1000,
            "optimizer": {"type": opt, "params": {"lr": 1e-2, **opt_params}},
            **extras}


# name -> (optimizer, extras, its params, batch seed, steps): the warm-up
# (freeze_step 100: dense Adam's update) and the compressed stage from
# step 3 under each transform, each held to JAX's engine at data=2; the
# dense Adam engine and the engine without the transform held to the
# warm-up within the port
ONEBIT_RUNS = {
    f"{name}_{run}": (opt, ext, kw, seed, steps)
    for name, ext in ONEBIT_EXTRAS.items()
    for run, (opt, ext, kw, seed, steps) in {
        "warm": ("onebitadam", ext, {"freeze_step": 100}, 4, 4),
        "compressed": ("onebitadam", ext, {"freeze_step": 3, "lr": 2e-3}, 5,
                       8),
        "dense": ("adam", ext, {"weight_decay": 0.0}, 4, 4),
        "plain": ("onebitadam", {}, {"freeze_step": 100}, 4, 1)}.items()}
JAX_ONEBIT = [n for n in ONEBIT_RUNS if n.endswith(("_warm", "_compressed"))]


def onebit_batch(seed):
    return {"input_ids": np.random.default_rng(seed).integers(
        0, ONEBIT_DIMS["vocab_size"], (16, 32), dtype=np.int32)}


def onebit(name, tree, replay=None):
    """One of ``ONEBIT_RUNS`` from ``tree``: its losses, the whole params
    after it, the 1-bit path's phase and MoQ's largest bits at its end.
    ``replay`` (JAX's whole state after each step, flattened): each step
    t > 0 run again from JAX's state after step t - 1, the whole params
    after each such step under "replayed"."""
    opt, extras, kw, seed, steps = ONEBIT_RUNS[name]

    def build():
        e, *_ = deepspeed_tpu_torch.initialize(
            model=tt.make_model(tt.TransformerConfig(**ONEBIT_DIMS,
                                                     dtype=torch.float32)),
            config=onebit_conf(opt, extras, **kw), params=tree,
            device="cpu")
        return e
    e, b = build(), onebit_batch(seed)
    rec = {"onebit": e._onebit,
           "losses": [float(e.train_batch(b)["loss"]) for _ in range(steps)],
           "params": whole_params(e)}
    if e._onebit:
        rec["phase"] = e.optimizer.phase_for(e._onebit_applied)
    if e._moq is not None:
        rec["bits_max"] = float(e._moq.bits(e.global_steps).max())
    if replay is not None:
        e, rec["replayed"] = build(), []
        for t in range(steps):
            if t:
                _set_state(e, replay[t - 1])
            e.train_batch(b)
            rec["replayed"].append(whole_params(e))
    return rec


# --------------------------------------------------------------------------
# the groups
# --------------------------------------------------------------------------

def _ltd_refusal(p0):
    """15 kept tokens over seq=2: the ValueError JAX's ring raises."""
    e, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(pcfg(4)), config=conf(0, **SP, **ltd(15, 1)),
        params=p0, device="cpu")
    try:
        e.train_batch(batches(1)[0])
    except ValueError as err:
        return f"ValueError: {err}"
    return "trained"


def group2(rank, world, trees, teacher, student, onebit_tree, draws):
    """Two ranks: every JAX2 scenario (``draws[scenario]``: JAX's draws),
    the control (tensor=2 with masks from each rank's slice), the
    distilled student at tensor=2, the 1-bit runs at data=2 (the warm-up
    also replayed from JAX's states, ``draws["onebit_*"]``), the slices
    of the tensor=2 leaves and LTD's non-dividing keep; rank 0 the
    one-rank references of ``WORLD1`` on the same draws."""
    rec = {}
    for n, (layers, moe, config, masked) in JAX2.items():
        rec[n] = train(trees[layers, moe], layers, moe, config, masked,
                       draws=draws.get(n))
    rec["comp_tp2_local"] = train(trees[2, False], 2, False,
                                  JAX2["comp_tp2"][2], False,
                                  local_masks=True)
    rec["slices_tp2"] = slices(trees[2, False], 2, False, conf(0, **TP))
    rec["distill_tp2"] = distill(teacher, student)
    for name in ONEBIT_RUNS:
        rec[f"onebit_{name}"] = onebit(name, onebit_tree,
                                       draws.get(f"onebit_{name}"))
    rec["ltd_refusal"] = _ltd_refusal(trees[4, False])
    if rank == 0:
        one = single_mesh()
        ref = {}
        for n in WORLD1:
            layers, moe, config, masked = JAX2[n]
            solo = {k: v for k, v in config.items() if k not in (
                "tensor_parallel", "moe", "sequence_parallel")}
            ref[n] = train(trees[layers, moe], layers, moe, solo, masked,
                           mesh=one, draws=draws.get(n))
        rec["world1"] = ref
    return _gather_ranks(rec)


def group4(rank, world, trees):
    """Four ranks: compression on tensor=2 x fsdp=2 at ZeRO-3."""
    rec = {n: train(trees[layers, moe], layers, moe, config, masked)
           for n, (layers, moe, config, masked) in JAX4.items()}
    return _gather_ranks(rec)
