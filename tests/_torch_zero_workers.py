"""Rank programs of the multi-rank training tests (``test_torch_zero.py``,
``test_torch_onebit.py``).

Each ``group*`` function runs on every rank of a spawned gloo group
(``deepspeed_tpu_torch.parallel.launch.run_group``, one CPU thread a
rank), plays its scenarios in order, and gathers every rank's results
onto rank 0, which returns them as a list indexed by rank. This module
imports torch, numpy and the port only: a spawned child re-imports it,
and the port never loads jax.
"""

import numpy as np
import torch
import torch.distributed as dist

import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.parallel import MeshPlan, build_mesh
from deepspeed_tpu_torch.parallel import context as par_ctx
from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod

# a tiny llama at f32: 2 layers, hidden 64
DIMS = dict(vocab_size=128, num_layers=2, hidden_size=64, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_seq_len=32)
B, S = 8, 32


def model(**over):
    return tt.make_model(tt.llama_config("tiny", dtype=torch.float32,
                                         **{**DIMS, **over}))


def conf(stage=0, **kw):
    """The engine config of every scenario: stage ``stage``, AdamW,
    clipping at 1.0, f32 (``kw`` overrides)."""
    c = {"train_batch_size": B, "bf16": {"enabled": False},
         "gradient_clipping": 1.0,
         "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
         "zero_optimization": {"stage": stage,
                               "stage3_param_persistence_threshold": 0}}
    c.update(kw)
    return c


def batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, DIMS["vocab_size"], (B, S),
                                       dtype=np.int32)} for _ in range(n)]


def masked_batches(n=3, seed=5):
    """Batches with explicit labels: the ids shifted left, and in each row
    a masked prompt of its own length (-100), longer in the first half of
    the rows, so the ranks' label counts differ."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(0, DIMS["vocab_size"], (B, S), dtype=np.int32)
        labels = np.concatenate([ids[:, 1:], np.full((B, 1), -100,
                                                     np.int32)], 1)
        for r in range(B):
            hi = S - 2 if r < B // 2 else S // 4
            labels[r, :rng.integers(0, hi)] = -100
        out.append({"input_ids": ids, "labels": labels})
    return out


MASKED = {"s0_gas1": (0, 1, False), "s3_gas2": (3, 2, False),
          "s2_gas2_deferred": (2, 2, True)}


# SGD with momentum where two runs must agree that sum their grads in
# another order: its update is linear in the grads, so a rank's tokens
# weighted wrongly, or a wrong mask, show in the params, while Adam's
# first steps are nearly the grads' signs (blind to a scale) and flip an
# element whose grad sums to within rounding of 0
SGD = {"type": "sgd", "params": {"lr": 0.5, "momentum": 0.9}}


def masked_conf(stage, gas, deferred):
    return conf(stage, gradient_accumulation_steps=gas,
                comm={"deferred_grad_sync": deferred}, optimizer=SGD)


def dropout_conf():
    return conf(0, gradient_accumulation_steps=2, optimizer=SGD)


def engine(p0, config, **model_over):
    e, *_ = deepspeed_tpu_torch.initialize(model=model(**model_over),
                                           config=config, params=p0,
                                           device="cpu")
    return e


def losses(e, bs):
    return [float(e.train_batch(b)["loss"]) for b in bs]


def whole_params(e):
    """{path: numpy} of the params made whole (collective)."""
    out = {}
    with par_ctx.parallel_context(e.mesh):
        for k, t in ckpt_mod.flatten(e.state["params"]).items():
            if e._part is not None:
                t = e._part.whole(t.detach(), e._part.layouts[k].pspec)
            out[k] = t.detach().float().numpy().copy()
    return out


def local_tree(tree):
    """{path: numpy} of this rank's leaves."""
    return {k: v.detach().numpy().copy()
            for k, v in ckpt_mod.flatten(tree).items()
            if isinstance(v, torch.Tensor)}


def grad_counts():
    """The facade's calls per (op, axis) since the last reset."""
    return {f"{op} {axis}": v["calls"]
            for op, d in comm.counts().items() for axis, v in d.items()}


def _gather_ranks(rec):
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rec)
    return out


# --------------------------------------------------------------------------
# ZeRO stages, the schedule, checkpoints, fp16, dropout (2 ranks)
# --------------------------------------------------------------------------

def _stage(p0, stage, bs):
    e = engine(p0, conf(stage))
    comm.reset_counts()
    rec = {"losses": losses(e, bs), "counts": grad_counts(),
           "params": whole_params(e),
           "exp_avg": local_tree(e.state["opt"]["exp_avg"]),
           "exp_avg_sq": local_tree(e.state["opt"]["exp_avg_sq"]),
           "param_shapes": {k: tuple(v.shape) for k, v in
                            local_tree(e.state["params"]).items()}}
    return rec


def _bf16_masters(p0, bs):
    """bf16 compute, f32 masters, stages 0 and 3, two steps: each stage's
    masters made whole (collective). A bf16 param's reduced grad is bf16
    at every stage, so the two agree bit for bit."""
    out = {}
    for stage in (0, 3):
        e = engine(p0, conf(stage, bf16={"enabled": True}))
        losses(e, bs)
        with par_ctx.parallel_context(e.mesh):
            out[stage] = {
                k: e._part.whole(t.detach(), e._part.layouts[k].ospec)
                .numpy().copy()
                for k, t in ckpt_mod.flatten(
                    e.state["opt"]["master"]).items()}
    return out


def _threshold(p0, bs):
    c = conf(3)
    c["zero_optimization"]["stage3_param_persistence_threshold"] = 4096
    e = engine(p0, c)
    out = {"losses": losses(e, bs[:1]),
           "param_shapes": {k: tuple(v.shape) for k, v in
                            local_tree(e.state["params"]).items()}}
    return out


def _gas(p0, bs, gas, deferred):
    e = engine(p0, conf(2, gradient_accumulation_steps=gas,
                        comm={"deferred_grad_sync": deferred}))
    comm.reset_counts()
    first = losses(e, bs[:1])
    counts = grad_counts()
    rest = losses(e, bs[1:])
    return {"losses": first + rest, "counts_one_step": counts,
            "params": whole_params(e), "deferred": e._sched.deferred}


def _fp16_overflow(p0, bs, rank):
    """fp16 at stage 2; step 2's grads get an inf on rank 1 only."""
    e = engine(p0, conf(2, fp16={"enabled": True, "initial_scale_power": 8}))
    orig = e._micro_grads
    poison = {"on": False}

    def micro(*a, **k):
        loss, grads = orig(*a, **k)
        if poison["on"] and rank == 1:
            grads[-1].view(-1)[0] = float("inf")
        return loss, grads

    e._micro_grads = micro
    out = {"losses": [float(e.train_batch(bs[0])["loss"])]}
    before = whole_params(e)
    hyst = int(e.state["loss_scale"]["hysteresis"])
    poison["on"] = True
    m = e.train_batch(bs[1])
    poison["on"] = False
    after = whole_params(e)
    out.update(overflow=bool(m["overflow"]),
               unchanged=all(np.array_equal(before[k], after[k])
                             for k in before),
               hysteresis=(hyst, int(e.state["loss_scale"]["hysteresis"])),
               scale=float(e.state["loss_scale"]["scale"]))
    e.train_batch(bs[2])
    out.update(step=e.state["step"], skipped=e.skipped_steps,
               global_steps=e.global_steps, params=whole_params(e))
    return out


def _dropout(p0, bs):
    e = engine(p0, dropout_conf(), dropout_rate=0.1)
    return {"losses": losses(e, bs), "params": whole_params(e)}


def _masked(p0, name):
    e = engine(p0, masked_conf(*MASKED[name]))
    return {"losses": losses(e, masked_batches()), "params": whole_params(e)}


def _masked_three_call(p0, rank):
    """The 3-call API on the masked batches, gas 2: each rank's
    ``forward`` takes its 2 rows of each 4-row micro-batch of the
    one-rank run."""
    e = engine(p0, masked_conf(0, 2, False))
    out = []
    for b in masked_batches():
        for i in range(2):
            lo = i * 4 + rank * 2
            e.forward({k: v[lo:lo + 2] for k, v in b.items()})
            e.backward()
        out.append(float(e.step()["loss"]))
    return {"losses": out, "params": whole_params(e)}


def _ckpt(p0, bs, dir_a, dir_b):
    """Load the one-rank stage-0 save in ``dir_a`` at stage 3 and take two
    steps; then from ``p0`` three stage-3 steps, a save into ``dir_b``
    and two more steps."""
    e = engine(p0, conf(3))
    e.load_checkpoint(dir_a)
    loaded = {"global_steps": e.global_steps, "losses": losses(e, bs[3:5])}
    e = engine(p0, conf(3))
    losses(e, bs[:3])
    e.save_checkpoint(dir_b)
    return {"loaded": loaded, "after_save": losses(e, bs[3:5])}


def _facade(rank):
    """The facade's collectives on the data axis: a gather and a scatter
    along dim 1, a max, a mean and a broadcast."""
    mesh = build_mesh(MeshPlan(data=2))
    x = torch.arange(12, dtype=torch.float32).reshape(2, 6) + 100 * rank
    with par_ctx.parallel_context(mesh):
        comm.reset_counts()
        gathered = comm.all_gather(x, "data", dim=1)
        scattered = comm.reduce_scatter(x, "data", dim=1)
        mx = comm.all_reduce(torch.tensor([float(rank)]), "data", op="max")
        mean = comm.all_reduce(torch.tensor([float(rank)]), "data",
                               op="mean")
        b = comm.broadcast(torch.tensor([float(rank + 7)]), "data",
                           src_index=1)
        counts = comm.counts()
    return {"gathered": gathered.numpy(), "scattered": scattered.numpy(),
            "max": float(mx), "mean": float(mean), "bcast": float(b),
            "counts": counts}


def group_zero(rank, world, p0, dir_a, dir_b):
    bs = batches(5)
    rec = {f"stage{s}": _stage(p0, s, bs[:3]) for s in range(4)}
    rec["threshold"] = _threshold(p0, bs)
    rec["bf16_masters"] = _bf16_masters(p0, bs[:2])
    for gas, deferred in ((2, False), (2, True), (1, True), (1, False)):
        rec[f"gas{gas}_{'deferred' if deferred else 'eager'}"] = _gas(
            p0, bs[:3], gas, deferred)
    rec["fp16"] = _fp16_overflow(p0, bs, rank)
    rec["dropout"] = _dropout(p0, bs[:2])
    for name in MASKED:
        rec[f"masked_{name}"] = _masked(p0, name)
    rec["masked_three_call"] = _masked_three_call(p0, rank)
    rec["ckpt"] = _ckpt(p0, bs, dir_a, dir_b)
    rec["facade"] = _facade(rank)
    return _gather_ranks(rec)


def group_hierarchical(rank, world, p0):
    """data=2 x fsdp=2 at stage 2, gas 2: the hierarchical reduction (and
    the flat one, for the counts)."""
    bs = batches(3)
    rec = {}
    for hier in (True, False):
        e = engine(p0, conf(2, gradient_accumulation_steps=2,
                            mesh={"axes": {"data": 2, "fsdp": 2}},
                            comm={"hierarchical_grad_reduce": hier}))
        comm.reset_counts()
        rec[f"hier_{hier}"] = {"losses": losses(e, bs),
                               "counts": grad_counts(),
                               "params": whole_params(e),
                               "exp_avg": local_tree(
                                   e.state["opt"]["exp_avg"])}
    return _gather_ranks(rec)


# --------------------------------------------------------------------------
# the 1-bit optimizers (2 ranks)
# --------------------------------------------------------------------------

ONEBIT = {
    "onebitadam": {"lr": 2e-3, "freeze_step": 2},
    "onebitlamb": {"lr": 2e-3, "freeze_step": 2},
    "zerooneadam": {"lr": 2e-3, "var_freeze_step": 2,
                    "local_step_scaler": 1, "local_step_clipper": 2},
}
ONEBIT_STEPS = 6


def onebit_conf(name, stage=0):
    return conf(stage, gradient_clipping=0.0,
                optimizer={"type": name, "params": dict(ONEBIT[name])})


def _record_compress(log):
    """Wrap the 1-bit optimizers' per-leaf compression so each call
    appends (leaf index, momentum, error) before the sign is taken (their
    sum is the value whose sign crosses the wire)."""
    from deepspeed_tpu_torch.ops import onebit
    orig = onebit._compress

    def compress(i, m, err, axis):
        log.append((i, m.detach().numpy().copy(),
                    err.detach().numpy().copy()))
        return orig(i, m, err, axis)

    onebit._compress = compress
    return lambda: setattr(onebit, "_compress", orig)


def _onebit_record(e, paths, log):
    """A 1-bit engine's step as the tests read it: the whole params, this
    rank's momentum, variance and error, and each leaf's momentum and
    error before the sign where the step compressed."""
    opt = e.state["opt"]
    return {"params": whole_params(e),
            **{part: local_tree(opt[part])
               for part in ("exp_avg", "exp_avg_sq", "error")},
            "pre_sign": {paths[i]: (m, err) for i, m, err in log}}


def _set_state(e, flat):
    """Set every leaf of the engine's state from a whole one-program
    state (``flat``: {"opt/exp_avg/...": array}, rank-varying leaves with
    a leading [dp] dim, as JAX's engine holds them): this rank's slice."""
    with torch.no_grad():
        for key, leaf in ckpt_mod.flatten(e.state).items():
            if isinstance(leaf, torch.Tensor):
                leaf.copy_(torch.from_numpy(np.array(
                    e._local_of(key, flat[key], leaf))))
            else:
                *parents, last = key.split("/")
                tree = e.state
                for p in parents:
                    tree = tree[p]
                tree[last] = int(np.asarray(flat[key]).reshape(-1)[0])
    e._onebit_applied = e.state["opt"]["step"]


def group_onebit(rank, world, p0, replay):
    """Each 1-bit engine over ONEBIT_STEPS steps: every step's phase,
    loss and wire counts, and its state (``_onebit_record``). With
    ``replay`` ({name: [whole state after step t]}, JAX's), each step t
    > 0 starts from the state after step t - 1 given there, so every
    step is held on its own from identical inputs."""
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    bs = batches(ONEBIT_STEPS, seed=3)
    rec = {}
    log = []
    restore = _record_compress(log)
    try:
        for name in ONEBIT:
            e = engine(p0, onebit_conf(name))
            paths = tree_leaves(e._map_paths(e.state["params"],
                                             lambda k, _: k))
            per_step = []
            for t, b in enumerate(bs):
                if replay is not None and t:
                    _set_state(e, replay[name][t - 1])
                comm.reset_counts()
                log.clear()
                phase = e.optimizer.phase_for(e._onebit_applied)
                loss = float(e.train_batch(b)["loss"])
                per_step.append({"phase": phase, "loss": loss,
                                 "counts": comm.counts(),
                                 **_onebit_record(e, paths, log)})
            rec[name] = {"compressed": e._onebit, "steps": per_step}
    finally:
        restore()
    if replay is None:
        e = engine(p0, onebit_conf("onebitadam", stage=1))
        rec["fallback_stage1"] = {"compressed": e._onebit,
                                  "losses": losses(e, bs)}
    return _gather_ranks(rec)


def group_onebit_update(rank, world, params, grads, phases):
    """The three 1-bit updates alone (no model): every step's grads given
    per rank, the phase given; each rank's params and state after every
    step."""
    from deepspeed_tpu_torch.ops.registry import get_optimizer_builder
    mesh = build_mesh(MeshPlan(data=2))
    rec = {}
    for name, kw in ONEBIT.items():
        opt = get_optimizer_builder(name)(use_master_weights=False, **kw)
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        state = opt.init(p)
        steps = []
        with par_ctx.parallel_context(mesh):
            for g, phase in zip(grads, phases[name]):
                opt.update_phase({k: torch.from_numpy(v[rank].copy())
                                  for k, v in g.items()}, state, p,
                                 phase=phase, axis="data")
                steps.append({"params": local_tree(p),
                              **{k: local_tree(state[k])
                                 for k in ("exp_avg", "exp_avg_sq",
                                           "error")}})
        rec[name] = steps
    return _gather_ranks(rec)
