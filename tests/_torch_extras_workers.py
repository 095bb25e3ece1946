"""Rank programs of the training extras' two-rank test
(``test_torch_data_efficiency.py``): each scenario trains the same
hidden-64 llama on every rank of a spawned gloo group and returns its
losses, its whole params and its draws, gathered onto rank 0. This module
imports torch, numpy and the port only: a spawned child re-imports it,
and the port never loads jax."""

import torch.distributed as dist

from tests._torch_zero_workers import (SGD, batches, conf, engine, losses,
                                       whole_params)

LAYERS = 4


def _grp(params, modules):
    return {"shared_parameters": {"enabled": True, "schedule_offset": 1},
            "different_groups": {"g": {"params": params,
                                       "modules": modules}}}


# (ZeRO stage, the extras): LTD with compression at ZeRO-2 (data=2),
# MoQ with its probe and a row mask at ZeRO-3 (whole leaves
# gathered for the masks and scales, the probe's grads averaged over the
# ranks), PLD with the curriculum at ZeRO-1
SCENARIOS = {
    "ltd_compression_z2": (2, {
        "data_efficiency": {"enabled": True, "data_routing": {"random_ltd": {
            "enabled": True, "min_value": 16, "max_value": 16,
            "seq_step": 16}}},
        "compression_training": {
            "weight_quantization": _grp({"target_bits": 8}, ["layers/w"]),
            "sparse_pruning": _grp({"dense_ratio": 0.5}, ["w_out"])}}),
    "moq_rows_z3": (3, {
        "quantize_training": {
            "enabled": True,
            "quantize_bits": {"start_bits": 8, "target_bits": 4},
            "quantize_schedule": {"quantize_period": 1},
            "eigenvalue": {"enabled": True, "max_iter": 2}},
        "compression_training": {
            "row_pruning": _grp({"dense_ratio": 0.75}, ["layers/wq"])}}),
    "pld_curriculum_z1": (1, {
        "progressive_layer_drop": {"enabled": True, "theta": 0.3,
                                   "gamma": 1.0},
        "curriculum_learning": {
            "enabled": True, "min_difficulty": 16, "max_difficulty": 32,
            "schedule_config": {"total_curriculum_step": 2,
                                "difficulty_step": 8}}}),
}


def scenario_conf(name):
    stage, extras = SCENARIOS[name]
    return conf(stage, optimizer=SGD, gradient_accumulation_steps=2,
                **extras)


def run(p0, name):
    """One scenario's record on this process's world."""
    e = engine(p0, scenario_conf(name), num_layers=LAYERS)
    out = {"losses": losses(e, batches(3)), "params": whole_params(e),
           "draws": e.step_draws}
    if e._moq is not None:
        out["period_scale"] = e._moq._period_scale.tolist()
    return out


REFUSED = {
    # JAX's ValueErrors under pipeline parallelism
    "moq_pipe": ({"pipeline": {"stages": 2},
                  "quantize_training": {"enabled": True}}, "ValueError"),
    "pld_pipe": ({"pipeline": {"stages": 2},
                  "progressive_layer_drop": {"enabled": True}}, "ValueError"),
    "ltd_pipe": ({"pipeline": {"stages": 2}, "data_efficiency": {
        "enabled": True, "data_routing": {"random_ltd": {"enabled": True}}}},
        "ValueError"),
    # once refused, now trained: compression on the 1-bit compressed path
    # (pure data parallel, stage 0) and MoQ over the tensor axis
    "compression_onebit": ({"optimizer": {"type": "onebitadam", "params": {
        "lr": 1e-3, "freeze_step": 2}}, "compression_training": {
        "sparse_pruning": _grp({"dense_ratio": 0.5}, ["w_out"])}},
        "trained"),
    "moq_tensor": ({"tensor_parallel": {"tp_size": 2},
                    "quantize_training": {"enabled": True}}, "trained"),
}


def refusal(p0, name):
    """The error a config raises at build, or "trained" after a step
    with a finite loss."""
    extra, _ = REFUSED[name]
    try:
        e = engine(p0, conf(0, **extra), num_layers=LAYERS)
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    loss = float(e.train_batch(batches(1)[0])["loss"])
    return "trained" if loss == loss and abs(loss) < 1e30 else f"{loss}"


def group_extras(rank, world, p0):
    rec = {name: run(p0, name) for name in SCENARIOS}
    rec["refused"] = {name: refusal(p0, name) for name in REFUSED}
    out = [None] * world
    dist.all_gather_object(out, rec)
    return out
