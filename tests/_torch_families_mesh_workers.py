"""Rank programs of ``test_torch_families_mesh.py``: the model families,
and a block-sparse model, on gloo groups of 2 and 4 ranks.

Each ``group*`` function runs on every rank of a spawned group
(``deepspeed_tpu_torch.parallel.launch.run_group``, one CPU thread a
rank), plays its scenarios in order and gathers every rank's results
onto rank 0, which returns them as a list indexed by rank. This module
imports torch, numpy and the port only: a spawned child re-imports it,
and the port never loads jax. The family configs live here so that the
test builds JAX's models from the same fields.
"""

import numpy as np
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.parallel import MeshPlan

from tests._torch_zero_workers import _gather_ranks, local_tree, whole_params

BASE = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
            max_seq_len=64)
FAMILIES = {
    "gpt2": dict(position_type="learned", activation="gelu",
                 norm_type="layernorm", tie_embeddings=True),
    "bloom": dict(position_type="alibi", activation="gelu",
                  norm_type="layernorm", embed_norm=True,
                  tie_embeddings=True),
    "bert": dict(position_type="learned", activation="gelu",
                 norm_type="layernorm", causal=False, norm_style="post",
                 embed_norm=True, final_norm=False, type_vocab_size=2,
                 norm_eps=1e-12, tie_embeddings=True),
    "gptj": dict(position_type="rotary", rotary_dim=8,
                 rotary_interleaved=True, parallel_block=True,
                 activation="gelu", norm_type="layernorm", qkv_bias=False,
                 tie_embeddings=False, head_bias=True),
    "neo": dict(position_type="learned", activation="gelu",
                norm_type="layernorm", qkv_bias=False, attn_out_bias=True,
                attn_windows=(0, 8), attn_scale=1.0, tie_embeddings=True),
    # a layernorm PR-MoE family: learned positions, every bias, the dense
    # residual branch (b_in / b_out) beside the experts
    "moe": dict(position_type="learned", activation="gelu",
                norm_type="layernorm", num_experts=4, top_k=2,
                use_residual=True, tie_embeddings=False),
    # ALiBi without BLOOM's embedding norm (JAX's pipeline drops that
    # norm), an untied head with its bias
    "alibi": dict(position_type="alibi", activation="gelu",
                  norm_type="layernorm", tie_embeddings=False,
                  head_bias=True),
}
B, S = 8, 32
STEPS = 2
GAS = 2
SGD = {"type": "sgd", "params": {"lr": 0.1, "momentum": 0.9}}
TP = {"tensor_parallel": {"tp_size": 2}}
EP = {"moe": {"enabled": True, "expert_parallel_size": 2}}
SP = {"sequence_parallel": {"sp_size": 2}}
PP = {"pipeline": {"stages": 2}, "gradient_accumulation_steps": GAS}
# the port's GPT-J runs its loss chunked; JAX's chunked loss leaves the
# head bias out, so JAX's side of that scenario runs the full loss
CHUNKED = {"loss_chunk": 8}


def conf(stage=0, **kw):
    """f32, SGD with momentum (linear in the grads, so two runs that sum
    their grads in another order agree to rounding), clipping at 1.0."""
    c = {"train_batch_size": B, "bf16": {"enabled": False},
         "gradient_clipping": 1.0, "optimizer": SGD,
         "zero_optimization": {"stage": stage,
                               "stage3_param_persistence_threshold": 0}}
    c.update(kw)
    return c


# scenario -> (family, engine config, the port model's extra fields)
TRAIN2 = {
    "gpt2_tp2": ("gpt2", conf(0, **TP), {}),
    "gpt2_tp2_chunks2": ("gpt2", conf(0, transformer={
        "tp_overlap_chunks": 2}, **TP), {}),
    "bloom_tp2": ("bloom", conf(0, **TP), {}),
    "bert_tp2": ("bert", conf(0, **TP), {}),
    "bert_dp2": ("bert", conf(1), {}),
    "gptj_tp2": ("gptj", conf(0, **TP), CHUNKED),
    "moe_ep2": ("moe", conf(0, **EP), {}),
    "neo_sp2": ("neo", conf(0, **SP), {}),
    "gpt2_sp2": ("gpt2", conf(0, **SP), {}),
    "bloom_sp2": ("bloom", conf(0, **SP), {}),
    "gpt2_pp2": ("gpt2", conf(0, **PP), {}),
    "gptj_pp2": ("gptj", conf(0, **PP), {}),
    "alibi_pp2": ("alibi", conf(0, **PP), {}),
}
TRAIN4 = {
    "gpt2_dp2_fsdp2": ("gpt2", conf(3, mesh={"axes": {"data": 2,
                                                      "fsdp": 2}}), {}),
}
SERVING = dict(max_seqs=2, block_size=16, max_model_len=64,
               decode_quantum=4, prompt_bucket=16)
SERVED = ("bloom", "gptj")


def pcfg(name, **over):
    return tt.TransformerConfig(**{**BASE, **FAMILIES[name], **over},
                                dtype=torch.float32)


def batches(name, n=STEPS, seed=0):
    """Global batches of ids; a bidirectional family's carry a key mask
    (each row's last ``r`` keys padded, r = row % 4)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"input_ids": rng.integers(0, BASE["vocab_size"], (B, S),
                                       dtype=np.int32)}
        if not FAMILIES[name].get("causal", True):
            mask = np.ones((B, S), np.int32)
            for r in range(B):
                mask[r, S - r % 4:] = 0
            b["attention_mask"] = mask
        out.append(b)
    return out


def encoder_inputs(seed=3):
    """ids, a key mask and token types for the encoder forward."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BASE["vocab_size"], (4, S)).astype(np.int32)
    mask = np.ones((4, S), np.int32)
    mask[1, S - 6:] = 0
    types = rng.integers(0, 2, (4, S)).astype(np.int32)
    return ids, mask, types


def load(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, BASE["vocab_size"], size=(n,)).astype(np.int32),
             k) for n, k in ((7, 9), (21, 6), (12, 8))]


def train(name, p0, config, **over):
    """Losses of ``STEPS`` steps, the whole params and this rank's leaf
    shapes."""
    e, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(pcfg(name, **over)), config=config, params=p0,
        device="cpu")
    losses = [float(e.train_batch(b)["loss"]) for b in batches(name)]
    return {"losses": losses, "params": whole_params(e),
            "shapes": {k: v.shape
                       for k, v in local_tree(e.state["params"]).items()},
            "plan": e.plan.describe()}


def serve(rank, name, params, plan):
    """Greedy f32 streams of ``load()`` on every rank of ``plan`` (rank 0
    drives, the others serve its device calls until its close())."""
    srv = deepspeed_tpu_torch.init_serving(
        tt.make_model(pcfg(name)), config={"kv_cache_bits": 0},
        serving=SERVING, params=params, dtype=torch.float32, device="cpu",
        mesh=plan)
    if rank:
        srv.run_worker()
        return None
    try:
        outs = srv.run(load())
        return [np.asarray(outs[k]) for k in sorted(outs)]
    finally:
        srv.close()


def encoder_forward(params, plan):
    """BERT's logits on the padded, typed batch (collective)."""
    eng = deepspeed_tpu_torch.init_inference(
        tt.make_model(pcfg("bert")), config={"kv_cache_bits": 0},
        params=params, dtype=torch.float32, device="cpu", mesh=plan)
    ids, mask, types = encoder_inputs()
    return eng.forward(ids, attention_mask=mask,
                       token_type_ids=types).numpy()


def generate(name, params, plan):
    """One-shot greedy generate (the contiguous cache; collective)."""
    eng = deepspeed_tpu_torch.init_inference(
        tt.make_model(pcfg(name)), config={"kv_cache_bits": 0},
        params=params, dtype=torch.float32, device="cpu", mesh=plan)
    ids = np.stack([p[:7] for p, _ in load(1)[:2]])
    return eng.generate(ids, max_new_tokens=8).numpy()


def group2(rank, world, trees):
    """Two ranks: every TRAIN2 scenario; BLOOM and GPT-J served at
    tensor=2; BLOOM's generate at tensor=2; BERT's forward at tensor=2
    and data=2."""
    rec = {n: train(fam, trees[fam], config, **over)
           for n, (fam, config, over) in TRAIN2.items()}
    tp2 = MeshPlan(tensor=2)
    for fam in SERVED:
        rec[f"serve_{fam}"] = serve(rank, fam, trees[fam], tp2)
    rec["generate_bloom"] = generate("bloom", trees["bloom"], tp2)
    rec["bert_fwd_tp2"] = encoder_forward(trees["bert"], tp2)
    rec["bert_fwd_dp2"] = encoder_forward(trees["bert"], MeshPlan(data=2))
    return _gather_ranks(rec)


def group_sparse(rank, world, cases):
    """Two ranks: each block-sparse model of ``cases`` ({key: (config
    fields, params, serving fields, load)}) served at tensor=2 (B5 on the
    rank's two heads) and at expert=2 (a dense model there: every rank a
    whole replica); rank 0 returns the streams."""
    out = {}
    for key, (fields, params, serving, reqs) in cases.items():
        cfg = tt.TransformerConfig(**fields, dtype=torch.float32)
        for plan in (MeshPlan(tensor=2), MeshPlan(expert=2)):
            srv = deepspeed_tpu_torch.init_serving(
                tt.make_model(cfg), config={"kv_cache_bits": 0},
                serving=serving, params=params, dtype=torch.float32,
                device="cpu", mesh=plan)
            if rank:
                srv.run_worker()
                continue
            try:
                outs = srv.run(list(reqs))
                out[key, plan.describe()] = [np.asarray(outs[k])
                                             for k in sorted(outs)]
            finally:
                srv.close()
    return out


def group4(rank, world, trees):
    """Four ranks: GPT-2 over data=2 x fsdp=2 at ZeRO-3."""
    rec = {n: train(fam, trees[fam], config, **over)
           for n, (fam, config, over) in TRAIN4.items()}
    return _gather_ranks(rec)

