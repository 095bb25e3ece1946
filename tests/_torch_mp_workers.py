"""Rank programs of the model-parallel training tests
(``test_torch_moe_training.py``, ``test_torch_tp_training.py``).

Each ``group*`` function runs on every rank of a spawned gloo group
(``deepspeed_tpu_torch.parallel.launch.run_group``, one CPU thread a
rank), plays its scenarios in order and gathers every rank's results
onto rank 0, which returns them as a list indexed by rank. This module
imports torch, numpy and the port only: a spawned child re-imports it,
and the port never loads jax.
"""

import numpy as np
import torch

from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.parallel import context as par_ctx
from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod

from tests._torch_zero_workers import (DIMS, SGD, _gather_ranks, batches,
                                       conf as _conf, local_tree, losses,
                                       whole_params)

# the tiny MoE of the serving tests: 4 experts, top-2, on the dense dims
MOE = dict(num_experts=4, top_k=2)
STEPS = 3
EP = {"moe": {"enabled": True, "expert_parallel_size": 2}}
TP = {"tensor_parallel": {"tp_size": 2}}


def conf(stage=0, **kw):
    """The zero tests' config with SGD and momentum: its update is linear
    in the grads, so two runs that sum their grads in another order agree
    in the params to rounding, where Adam's first steps (nearly the
    grads' signs) flip an element whose grad sums to within rounding of
    0."""
    return _conf(stage, optimizer=SGD, **kw)


# the tensor=2 runs replay each layer in the backward, keeping the matmul
# outputs (the card's policy): the replay reuses what the forward saved
REMAT = dict(remat=True, remat_policy="dots_saveable")
# a capacity at which tokens drop: ceil(B * S / 4 * 0.5) = 32 slots an
# expert for 2 * 256 routed choices
DROP = dict(capacity_factor=0.5)


def model(moe=False, **over):
    dims = {**DIMS, **(MOE if moe else {}), **over}
    return tt.make_model(tt.llama_config("tiny", dtype=torch.float32,
                                         **dims))


def engine(p0, config, moe=False, **over):
    import deepspeed_tpu_torch
    e, *_ = deepspeed_tpu_torch.initialize(model=model(moe, **over),
                                           config=config, params=p0,
                                           device="cpu")
    return e


def whole_state(e):
    """{path: numpy} of every tensor of the training state made whole
    (params by their spec, optimizer leaves by theirs; collective)."""
    out = {}
    with par_ctx.parallel_context(e.mesh):
        for k, t in ckpt_mod.flatten(e.state).items():
            if not isinstance(t, torch.Tensor):
                continue
            if e._part is not None:
                leaf = k.split("/", 2)[-1] if k.startswith("opt/") \
                    else k.split("/", 1)[-1]
                lay = e._part.layouts.get(leaf)
                if lay is not None:
                    spec = lay.pspec if k.startswith("params/") \
                        else lay.ospec
                    t = e._part.whole(t.detach(), spec)
            out[k] = t.detach().float().numpy().copy()
    return out


def run(p0, config, moe=False, steps=STEPS, **over):
    """Losses of ``steps`` steps, the whole params, and this rank's local
    param leaves."""
    e = engine(p0, config, moe=moe, **over)
    rec = {"losses": losses(e, batches(steps)), "params": whole_params(e),
           "local": local_tree(e.state["params"]),
           "plan": e.plan.describe()}
    return rec


def first_grads(p0, config, moe=False, **over):
    """The loss and every leaf's grad of the first micro-batch (the
    3-call ``forward``), made whole and reduced as the step reduces
    them."""
    e = engine(p0, config, moe=moe, **over)
    b = batches(1)[0]
    rows = e._local_rows(e._device_batch(b))
    loss = e.forward(rows)
    e.backward()
    grads = e._grad_buffer
    if e._part is None:
        paths = sorted(ckpt_mod.flatten(e.state["params"]))
        return {"loss": float(loss),
                "grads": {k: g.numpy().copy() for k, g in zip(paths, grads)}}
    out = {}
    with par_ctx.parallel_context(e.mesh):
        for lay, g in zip(e._layouts(), grads):
            out[lay.path] = e._part.whole(g, lay.gspec).numpy().copy()
    return {"loss": float(loss), "grads": out}


def _ckpt(p0, moe, config, load_dir, save_dir):
    """Load the one-rank save in ``load_dir`` and take two steps; then
    from ``p0`` three steps, a save into ``save_dir``, the whole state
    there and two more steps."""
    bs = batches(5)
    e = engine(p0, config, moe=moe)
    e.load_checkpoint(load_dir)
    loaded = {"state": whole_state(e), "losses": losses(e, bs[3:5])}
    e = engine(p0, config, moe=moe)
    losses(e, bs[:3])
    e.save_checkpoint(save_dir)
    return {"loaded": loaded, "saved": whole_state(e),
            "after_save": losses(e, bs[3:5])}


def group_ep2(rank, world, pm, dirs):
    """Two ranks on the expert axis: the MoE run, the same where tokens
    drop, and universal checkpoints both ways."""
    rec = {"ep2": run(pm, conf(0, **EP), moe=True),
           "ep2_drop": run(pm, conf(0, **EP), moe=True, **DROP),
           "ep2_ckpt": _ckpt(pm, True, conf(0, **EP), dirs["moe"],
                             dirs["ep2"])}
    return _gather_ranks(rec)


def _pieces(rank):
    """``row_parallel_matmul`` over this rank's halves of x's last dim and
    w's first, at 0, 3 (-> 2) and 4 chunks, with its grads; then
    ``drop_tokens`` / ``gather_tokens`` values and grads."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.moe.mappings import drop_tokens, gather_tokens
    from deepspeed_tpu_torch.parallel import MeshPlan, build_mesh
    from deepspeed_tpu_torch.parallel.partitioning import row_parallel_matmul
    rng = np.random.default_rng(0)
    x, w, g, h, gh = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((2, 8, 16), (16, 12), (2, 8, 12), (2, 8, 4),
                               (2, 2, 8, 4)))
    out = {}
    with par_ctx.parallel_context(build_mesh(MeshPlan(tensor=2))):
        for c in (0, 3, 4):
            xs = x[..., rank * 8:(rank + 1) * 8].clone().requires_grad_()
            ws = w[rank * 8:(rank + 1) * 8].clone().requires_grad_()
            comm.reset_counts()
            y = row_parallel_matmul(xs, ws, chunks=c)
            calls = comm.counts()["all_reduce"]["tensor"]["calls"]
            gx, gw = torch.autograd.grad(y, (xs, ws), g)
            out[f"rpm{c}"] = [t.detach().numpy().copy()
                              for t in (y, gx, gw)] + [calls]
        hr = h.clone().requires_grad_()
        d = drop_tokens(hr, 1)
        (gd,) = torch.autograd.grad(d, hr, gh[rank, :, rank * 4:
                                               (rank + 1) * 4])
        hp = h[:, rank * 4:(rank + 1) * 4].clone().requires_grad_()
        gt = gather_tokens(hp, 1)
        (gg,) = torch.autograd.grad(gt, hp, gh[0])
        out["drop"] = [d.detach().numpy().copy(), gd.numpy().copy()]
        out["gather"] = [gt.detach().numpy().copy(), gg.numpy().copy()]
    return out


def group_tp2(rank, world, pd, dirs):
    """Two ranks on the tensor axis: the dense run, the same with the
    row-parallel sum in 2 chunks, the first step's grads, universal
    checkpoints both ways, and the pieces."""
    rec = {"tp2": run(pd, conf(0, **TP), **REMAT),
           "tp2_chunks2": run(pd, conf(0, transformer={
               "tp_overlap_chunks": 2}, **TP), **REMAT),
           "tp2_grads": first_grads(pd, conf(0, **TP)),
           "tp2_ckpt": _ckpt(pd, False, conf(0, **TP), dirs["dense"],
                             dirs["tp2"]),
           "pieces": _pieces(rank)}
    return _gather_ranks(rec)


FOUR = {
    "data2_tensor2": (False, conf(1, mesh={"axes": {"data": 2,
                                                    "tensor": 2}})),
    "expert2_tensor2": (True, conf(0, **EP, **TP)),
    "fsdp2_expert2": (True, conf(3, **EP)),
}


# held against the port's one-rank run: ZeRO-3 over fsdp x tensor, whose
# vocab leaves split over the (fsdp, tensor) pair
FOUR_VS_ONE = {
    "fsdp2_tensor2": (False, conf(3, mesh={"axes": {"fsdp": 2,
                                                    "tensor": 2}})),
}


def group_mp4(rank, world, pd, pm):
    """Four ranks: data=2 x tensor=2 at ZeRO-1 (dense), expert=2 x
    tensor=2 (MoE), fsdp=2 x expert=2 at ZeRO-3 (MoE) and fsdp=2 x
    tensor=2 at ZeRO-3 (dense)."""
    rec = {name: run(pm if moe else pd, config, moe=moe)
           for name, (moe, config) in {**FOUR, **FOUR_VS_ONE}.items()}
    return _gather_ranks(rec)

