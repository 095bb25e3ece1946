"""Rank programs of the pipeline, ring-attention, data-mesh serving and
comms-logger tests (``test_torch_pipeline.py``,
``test_torch_ring_attention.py``, ``test_torch_dp_serving.py``,
``test_torch_comms_logger.py``).

Each ``group*`` function runs on every rank of a spawned gloo group
(``deepspeed_tpu_torch.parallel.launch.run_group``, one CPU thread a
rank), plays its scenarios in order and gathers every rank's results
onto rank 0, which returns them as a list indexed by rank. This module
imports torch and the port only: a spawned child re-imports it,
and the port never loads jax.
"""

from unittest import mock

import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops.flash_attention import flash_attention
from deepspeed_tpu_torch.ops.ring_attention import (ring_attention,
                                                    ring_attention_local)
from deepspeed_tpu_torch.parallel import MeshPlan, build_mesh
from deepspeed_tpu_torch.parallel import context as par_ctx
from deepspeed_tpu_torch.parallel import mesh as par_mesh

from tests._torch_zero_workers import (DIMS as _DIMS, SGD, _gather_ranks,
                                       batches, losses, masked_batches,
                                       whole_params)

# the tiny llama of the ZeRO tests at 4 layers (hidden 64, 4/2 heads)
DIMS = {**_DIMS, "num_layers": 4}
MOE = dict(num_experts=4, top_k=2)
DROPOUT = dict(dropout_rate=0.1)
GAS = 4
STEPS = 5
ADAMW = {"type": "adamw", "params": {"lr": 1e-3}}
PP2 = {"pipeline": {"stages": 2}}
PP4 = {"pipeline": {"stages": 4}}
SP2 = {"sequence_parallel": {"sp_size": 2}}


def conf(stage=0, optimizer=ADAMW, gas=GAS, **kw):
    """f32, clipping at 1.0, ``gas`` micro-batches of the 8-row batch."""
    c = {"train_batch_size": 8, "gradient_accumulation_steps": gas,
         "bf16": {"enabled": False}, "gradient_clipping": 1.0,
         "optimizer": optimizer,
         "zero_optimization": {"stage": stage,
                               "stage3_param_persistence_threshold": 0}}
    c.update(kw)
    return c


def model(**over):
    return tt.make_model(tt.llama_config("tiny", dtype=torch.float32,
                                         **{**DIMS, **over}))


def engine(p0, config, **over):
    e, *_ = deepspeed_tpu_torch.initialize(model=model(**over),
                                           config=config, params=p0,
                                           device="cpu")
    return e


def run(p0, config, bs, **over):
    """Losses of the batches ``bs``, the whole params and the eval loss
    of a batch of 8 rows."""
    e = engine(p0, config, **over)
    out = {"losses": losses(e, bs), "params": whole_params(e),
           "plan": e.plan.describe()}
    out["eval"] = float(e.eval_batch(batches(1, seed=9)[0]))
    return out


def first_grads(p0, config, **over):
    """The loss and every leaf's grad (whole) of the first step through
    the 3-call API: in pipeline mode ``forward`` takes the global batch
    (its M micro-batches in one call)."""
    e = engine(p0, config, **over)
    b = batches(1)[0]
    loss = e.forward(b)
    e.backward()
    out = {}
    with par_ctx.parallel_context(e.mesh):
        for lay, g in zip(e._layouts(), e._grad_buffer):
            out[lay.path] = e._part.whole(g, lay.gspec).numpy().copy()
    return {"loss": float(loss), "grads": out}


# --------------------------------------------------------------------------
# pipeline (2 and 4 ranks)
# --------------------------------------------------------------------------

def group_pp2(rank, world, p0, pm, dirs):
    """pipe=2: the JAX bar's 5 AdamW steps, the first step's grads, MoE,
    uneven labels, dropout, the GSPMD checkpoint resumed, the logits of
    ``apply``, the comms logger over a step, and the bubble."""
    from deepspeed_tpu_torch.parallel.pipeline import bubble_fraction
    rec = {"pp2": run(p0, conf(**PP2), batches(STEPS)),
           "grads": first_grads(p0, conf(**PP2)),
           "moe": run(pm, conf(optimizer=SGD, **PP2), batches(3), **MOE),
           "labels": run(p0, conf(optimizer=SGD, **PP2), masked_batches(3)),
           "dropout": run(p0, conf(optimizer=SGD, **PP2), batches(3),
                          **DROPOUT)}
    # a one-rank (GSPMD-layout) save resumed at pipe=2, and a pipe=2 save
    e = engine(p0, conf(optimizer=SGD, **PP2))
    e.load_checkpoint(dirs["one"])
    rec["resumed"] = losses(e, batches(5)[3:5])
    e = engine(p0, conf(optimizer=SGD, **PP2))
    losses(e, batches(3))
    e.save_checkpoint(dirs["pp2"])
    # the GPipe forward's logits on every rank
    e = engine(p0, conf(optimizer=SGD, **PP2))
    ids = torch.as_tensor(batches(1, seed=4)[0]["input_ids"]).long()
    with torch.no_grad(), par_ctx.parallel_context(e.mesh):
        rec["logits"] = e.model.apply(e.state["params"], ids).numpy()
    # the comms logger of one step: every facade call recorded, its bytes
    # the facade's counts
    comm.configure(enabled=True)
    e = engine(p0, conf(comms_logger={"enabled": True}, **PP2))
    comm.comms_logger.reset()
    comm.reset_counts()
    e.train_batch(batches(1)[0])
    rec["logger"] = {"counts": dict(comm.comms_logger.counts),
                     "bytes": dict(comm.comms_logger.bytes),
                     "facade": comm.counts()}
    comm.configure(enabled=False)
    rec["bubble"] = bubble_fraction(GAS, e.plan.pipe)
    rec["layers_local"] = int(e.state["params"]["layers"]["wq"].shape[0])
    return _gather_ranks(rec)


def group_pp4(rank, world, p0):
    """pipe=4 (the JAX bar's 5 steps), pipe=2 x data=2 at ZeRO-1,
    pipe=2 x tensor=2 and pipe=2 x fsdp=2 at ZeRO-3 (SGD, 3 steps)."""
    rec = {"pp4": run(p0, conf(**PP4), batches(STEPS)),
           "zero1": run(p0, conf(1, optimizer=SGD, **PP2), batches(3)),
           "tp2": run(p0, conf(optimizer=SGD,
                               tensor_parallel={"tp_size": 2}, **PP2),
                      batches(3)),
           "zero3": run(p0, conf(3, optimizer=SGD, **PP2), batches(3))}
    return _gather_ranks(rec)


# --------------------------------------------------------------------------
# ring attention and sequence parallelism (2 and 4 ranks)
# --------------------------------------------------------------------------

def _ring_cases(mesh, qkv, sp):
    """The global ring (JAX's entry) causal and not, and the local ring's
    grads (every piece's, gathered whole) against autograd of the plain
    single-piece attention, GQA and a key mask included."""
    out = {}
    q, k, v = (torch.as_tensor(a) for a in qkv)
    for causal in (True, False):
        with torch.no_grad():
            out[f"fwd_causal{int(causal)}"] = ring_attention(
                q, k, v, mesh, causal=causal).numpy()
    g = torch.Generator().manual_seed(3)
    B, S, N, Nkv, D = 2, 64, 4, 2, 16
    qg = torch.randn(B, S, N, D, generator=g)
    kg, vg = (torch.randn(B, S, Nkv, D, generator=g) for _ in range(2))
    do = torch.randn(B, S, N, D, generator=g)
    mask = torch.ones(B, S, dtype=torch.bool)
    mask[1, :5] = False
    Sl, r = S // sp, mesh.index("seq")
    for name, causal, m in (("gqa_causal", True, None),
                            ("gqa_full", False, None),
                            ("gqa_masked", True, mask)):
        want = [t.clone().requires_grad_(True) for t in (qg, kg, vg)]
        o = flash_attention(*want, causal=causal, kv_mask=m, reference=True)
        o.backward(do)
        piece = [t[:, r * Sl:(r + 1) * Sl].clone().requires_grad_(True)
                 for t in (qg, kg, vg)]
        ol = ring_attention_local(
            *piece, causal=causal, mesh=mesh,
            kv_mask=None if m is None else m[:, r * Sl:(r + 1) * Sl])
        ol.backward(do[:, r * Sl:(r + 1) * Sl])
        got = [comm.all_gather(t.detach().contiguous(), "seq", dim=1,
                               mesh=mesh)
               for t in [ol] + [p.grad for p in piece]]
        out[name] = {"got": [t.numpy() for t in got],
                     "want": [o.detach().numpy()]
                     + [t.grad.numpy() for t in want]}
    return out


def _pairs_case(rec, mesh, qkv, sp):
    """The causal ring over the "pairs" transport (the one gloo takes on
    a machine with CUDA, forced here through ``mesh._transport``): its
    output and both meshes' transports into ``rec``."""
    with mock.patch.object(par_mesh, "_transport", lambda group: "pairs"):
        pairs = build_mesh(MeshPlan(seq=sp))
    q, k, v = (torch.as_tensor(a) for a in qkv)
    with torch.no_grad():
        rec["pairs_fwd"] = ring_attention(q, k, v, pairs).numpy()
    rec["transports"] = (mesh.p2p, pairs.p2p)


def group_seq2(rank, world, p0, qkv):
    """seq=2: the ring (both transports) and the sequence-parallel
    engine's 5 AdamW steps (gas 1)."""
    mesh = build_mesh(MeshPlan(seq=2))
    rec = {"ring": _ring_cases(mesh, qkv, 2)}
    _pairs_case(rec, mesh, qkv, 2)
    rec["sp2"] = run(p0, conf(gas=1, **SP2), batches(STEPS))
    rec["sp2_labels"] = run(p0, conf(optimizer=SGD, gas=1, **SP2),
                            masked_batches(3))
    return _gather_ranks(rec)


def group_seq4(rank, world, p0, qkv):
    """seq=4: the ring (both transports); seq=2 x fsdp=2 at ZeRO-3 (5
    AdamW steps)."""
    mesh = build_mesh(MeshPlan(seq=4))
    rec = {"ring": _ring_cases(mesh, qkv, 4)}
    _pairs_case(rec, mesh, qkv, 4)
    rec["sp2_zero3"] = run(p0, conf(3, gas=1, **SP2), batches(STEPS))
    return _gather_ranks(rec)


# --------------------------------------------------------------------------
# data-mesh generation (2 ranks)
# --------------------------------------------------------------------------

def group_dp2(rank, world, p0, prompts, n):
    """``InferenceEngine`` on data=2 at f32: ``generate`` of the 4 prompts
    (2 a rank) and of 3 (replicated), and ``forward``'s logits."""
    from deepspeed_tpu_torch.inference.engine import init_inference
    eng = init_inference(model(), config={"kv_cache_bits": 0},
                         dtype=torch.float32, params=p0, device="cpu",
                         mesh=MeshPlan(data=2))
    comm.reset_counts()
    rec = {"split": eng.generate(prompts, n).numpy(),
           "gathers": comm.counts().get("all_gather", {}),
           "odd": eng.generate(prompts[:3], n).numpy(),
           "logits": eng.forward(prompts).numpy(),
           "rows": eng._data_rows(len(prompts))}
    return _gather_ranks(rec)


# --------------------------------------------------------------------------
# the comms logger (2 ranks)
# --------------------------------------------------------------------------

def group_comm2(rank, world, path):
    """One call of each collective over a data=2 mesh with the logger on:
    its summary, counts and bytes, the facade's counts, and rank 0's
    ``log_summary`` into a JSONL monitor at ``path``."""
    from deepspeed_tpu_torch.monitor import JSONLMonitor, MonitorMaster
    mesh = build_mesh(MeshPlan(data=2))
    comm.configure(enabled=True)
    comm.comms_logger.reset()
    comm.reset_counts()
    x = torch.arange(8, dtype=torch.float32) + rank
    with par_ctx.parallel_context(mesh):
        comm.all_reduce(x.clone(), "data")
        comm.all_gather(x, "data")
        comm.reduce_scatter(x, "data")
        comm.broadcast(x.clone(), "data")
        got = comm.ppermute(x, "data", [(0, 1), (1, 0)])
    rec = {"counts": dict(comm.comms_logger.counts),
           "bytes": dict(comm.comms_logger.bytes),
           "summary": comm.comms_logger.summary(), "facade": comm.counts(),
           "ppermute": got.numpy()}
    if rank == 0:
        mon = MonitorMaster([JSONLMonitor(path)])
        rec["log_summary"] = comm.log_summary(monitor=mon, step=7)
        mon.flush()
    comm.configure(enabled=False)
    return _gather_ranks(rec)
