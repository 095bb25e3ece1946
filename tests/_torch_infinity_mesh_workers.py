"""Rank programs of ``test_torch_infinity_mesh.py``: the layer executor
and the optimizer swappers over ranks (gloo groups of 2 and 4).

``group`` runs on every rank of a spawned group
(``deepspeed_tpu_torch.parallel.launch.run_group``, one CPU thread a
rank), plays the named cases in order and returns, on rank 0, each
case's record: its losses, every rank's bytes by tier and param reads,
and the tag it saved at its end (``<root>/<case>/end``: whole chunks,
read back by the test). This module imports torch, numpy and the port
only: a spawned child re-imports it, and the port never loads jax. The
configs live here so that the test builds JAX's engines from the same
fields.
"""

import copy
import os

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tt

from tests._torch_zero_workers import _gather_ranks

DIMS = dict(vocab_size=256, num_layers=2, max_seq_len=32, hidden_size=64,
            num_heads=4, num_kv_heads=2, intermediate_size=128)
GPT2 = dict(position_type="learned", activation="gelu",
            norm_type="layernorm", tie_embeddings=True, num_kv_heads=4)
B, S, STEPS = 4, 32, 3
ADAM = {"type": "adamw", "params": {"lr": 1e-3, "eps": 1e-3}}
COMPRESSION = {
    "sparse_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 0},
        "different_groups": {"g": {"params": {"dense_ratio": 0.5},
                                   "modules": ["w_out"]}}},
    "row_pruning": {
        "shared_parameters": {"enabled": True, "schedule_offset": 1},
        "different_groups": {"g": {"params": {"dense_ratio": 0.75},
                                   "modules": ["layers/wq"]}}}}
MOQ = {"enabled": True, "quantize_bits": {"start_bits": 12, "target_bits": 6},
       "quantize_schedule": {"quantize_period": 1, "schedule_offset": 0}}
CURRICULUM = {"enabled": True, "curriculum_type": "seqlen",
              "min_difficulty": 16, "max_difficulty": 32,
              "schedule_type": "fixed_linear",
              "schedule_config": {"total_curriculum_step": 2,
                                  "difficulty_step": 8}}
# each case: (model fields, mesh axes, gas, extra config sections)
CASES = {
    "fsdp2": (GPT2, {"fsdp": 2}, 1,
              {"compression_training": COMPRESSION}),
    "data2": ({}, {"data": 2}, 2, {"quantize_training": MOQ,
                                   "curriculum_learning": CURRICULUM}),
    "fsdp2_tp2": (GPT2, {"fsdp": 2, "tensor": 2}, 1,
                  {"quantize_training": MOQ}),
}


def model_fields(case):
    return {**DIMS, **CASES[case][0]}


def tcfg(case):
    return tt.TransformerConfig(**model_fields(case), dtype=torch.float32)


def conf(case, path, world=True):
    """The executor's config of ``case`` (its mesh when ``world``; one
    rank otherwise)."""
    _, mesh, gas, extra = CASES[case]
    c = {"train_batch_size": B * gas, "gradient_accumulation_steps": gas,
         "optimizer": ADAM, "bf16": {"enabled": False},
         "gradient_clipping": 0.5, "steps_per_print": 10 ** 6,
         "zero_optimization": {
             "stage": 3,
             "offload_param": {"device": "nvme", "nvme_path": str(path)},
             "offload_optimizer": {"device": "nvme",
                                   "nvme_path": str(path)}}}
    if world:
        c["mesh"] = {"axes": dict(mesh)}
    c.update(copy.deepcopy(extra))
    return c


def swap_conf(path, world=True, cpu_adam=False):
    """The sharded NVMe optimizer swapper at data=2 (ZeRO stage 1), drained
    (JAX's pipelined swapper races on its read buffer, ROADMAP C10); with
    ``cpu_adam`` the host-Adam route instead."""
    off = {"device": "nvme", "nvme_path": str(path),
           "buffer_size": 4 * 4096, "pipeline_read": False,
           "pipeline_write": False}
    if cpu_adam:
        off = {"device": "cpu", "use_cpu_adam": True}
    c = {"train_batch_size": B * 2, "gradient_accumulation_steps": 2,
         "optimizer": ADAM, "bf16": {"enabled": False},
         "gradient_clipping": 0.5, "steps_per_print": 10 ** 6,
         "zero_optimization": {"stage": 1, "offload_optimizer": off}}
    if world:
        c["mesh"] = {"axes": {"data": 2}}
    return c


def batches(gas, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, DIMS["vocab_size"], (B * gas, S),
                                       dtype=np.int32)}
            for _ in range(n)]


def _engine(cfg, c, tree):
    return deepspeed_tpu_torch.initialize(
        model=tt.make_model(cfg), config=c, params=tree, device="cpu")[0]


def _run_case(case, tree, root):
    """``case`` on this group: STEPS steps, a tag after step 2 (``mid``)
    and at the end (``end``); every rank's bytes and reads."""
    gas = CASES[case][2]
    e = _engine(tcfg(case), conf(case, os.path.join(root, case, "swap")),
                tree)
    ex = e._infinity
    losses = []
    for t, b in enumerate(batches(gas)):
        losses.append(float(e.train_batch(b)["loss"]))
        if t == 1:
            e.save_checkpoint(os.path.join(root, case), tag="mid")
    e.save_checkpoint(os.path.join(root, case), tag="end")
    mine = {"bytes": e.offload_bytes(), "chunk": ex.chunk,
            "whole_chunk": ex.whole_chunk, "param_reads": ex.param_reads,
            "offset": ex.shard_offset}
    evaluated = float(e.eval_batch(batches(gas)[0]))
    e.close()
    return {"losses": losses, "eval": evaluated,
            "ranks": _gather_ranks(mine)}


def _resume(case, root, tag_dir):
    """A fresh engine of ``case`` loads a one-rank tag and takes the
    third step."""
    gas = CASES[case][2]
    e = _engine(tcfg(case), conf(case, os.path.join(root, case, "swap2")),
                None)
    e.load_checkpoint(tag_dir, tag="mid")
    loss = float(e.train_batch(batches(gas)[2])["loss"])
    e.close()
    return loss


def _host_adam_case(tree, root):
    """The host-Adam route over data=2: each rank's C++ update on its
    partition; the losses and each rank's values held."""
    e = _engine(tcfg("data2"), swap_conf(root, cpu_adam=True), tree)
    losses = [float(e.train_batch(b)["loss"]) for b in batches(2)]
    mine = {"held": e._swapper.n}
    e.close()
    return {"losses": losses, "ranks": _gather_ranks(mine)}


def _swap_case(tree, root):
    """The NVMe swapper over data=2: each rank swaps its partition; the
    losses, the saved whole state (``optswap.npz``, after step 2 and at
    the end), the bytes, and a fresh engine's third step from the step-2
    tag."""
    c = swap_conf(os.path.join(root, "swap_data2", "swap"))
    e = _engine(tcfg("data2"), c, tree)
    data = batches(2)
    losses = []
    for t, b in enumerate(data):
        losses.append(float(e.train_batch(b)["loss"]))
        if t == 1:
            e.save_checkpoint(os.path.join(root, "swap_data2"), tag="mid")
    e.save_checkpoint(os.path.join(root, "swap_data2"), tag="end")
    mine = {"held": e._swapper.num_params, "disk": e.offload_bytes()["disk"]}
    e.close()
    back = _engine(tcfg("data2"), c, None)
    back.load_checkpoint(os.path.join(root, "swap_data2"), tag="mid")
    resumed = float(back.train_batch(data[2])["loss"])
    back.close()
    return {"losses": losses, "resumed": resumed,
            "ranks": _gather_ranks(mine)}


def _refusals(root):
    """What stays refused over ranks: a pipe, seq or expert axis (JAX's
    ValueError) and an executor on more ranks without ``mesh.axes``."""
    out = {}
    cfg = tcfg("data2")
    for ax in ("pipe", "seq", "expert"):
        c = conf("fsdp2", root)
        c["mesh"] = {"axes": {ax: 2}}
        if ax == "expert":
            c["moe"] = {"enabled": True, "expert_parallel_size": 2}
        try:
            _engine(cfg, c, None)
            out[ax] = None
        except ValueError as err:
            out[ax] = str(err)
    c = conf("fsdp2", root, world=False)
    try:
        _engine(cfg, c, None)
        out["no_axes"] = None
    except ValueError as err:
        out["no_axes"] = str(err)
    return out


def group(rank, world, cases, trees, root, resume_tags):
    """Every named case on this group, in order; rank 0's records."""
    torch.manual_seed(0)
    out = {}
    for case in cases:
        if case == "swap_data2":
            out[case] = _swap_case(trees["data2"], root)
        elif case == "host_adam_data2":
            out[case] = _host_adam_case(trees["data2"], root)
        elif case == "refusals":
            out[case] = _refusals(root)
        elif case.startswith("resume_"):
            base = case[len("resume_"):]
            out[case] = _resume(base, root, resume_tags[base])
        else:
            out[case] = _run_case(case, trees[case], root)
    return out
