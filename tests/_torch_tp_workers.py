"""Rank programs of the sharded-serving tests (``test_torch_tp_serving.py``).

Each ``group*`` function runs on every rank of a spawned gloo group
(``deepspeed_tpu_torch.parallel.launch.run_group``) and plays a list of
scenarios: every rank builds the same engine, rank 0 drives it and the
others ``run_worker()`` until its ``close()``. Rank 0 returns the
results. This module imports torch, numpy and the port only: a spawned
child re-imports it, and the port never loads jax.
"""

import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch import init_serving
from deepspeed_tpu_torch.inference.lora import make_random_adapter
from deepspeed_tpu_torch.inference.serving import (DecodeDispatchHang,
                                                   ResumeIncompatible,
                                                   load_drain_state)
from deepspeed_tpu_torch.models import TransformerConfig, make_model
from deepspeed_tpu_torch.parallel import MeshPlan

# tests/unit/test_tp_serving.py's _cfg and _serving defaults
CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=256, position_type="rotary",
           activation="silu_glu", norm_type="rmsnorm", tie_embeddings=False)
MOE = dict(CFG, num_experts=4, top_k=2)
SERVING = dict(max_seqs=2, block_size=16, max_model_len=128,
               decode_quantum=4, prompt_bucket=16)


def reqs(seed=0, vocab=128, lens=(7, 21), news=(9, 6)):
    """tests/unit/test_tp_serving.py's _reqs."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=(n,)).astype(np.int32), k)
            for n, k in zip(lens, news)]


def shared_prefix_reqs():
    """The preemption + prefix-cache load of JAX's tp=2 test."""
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 128, size=(17,)).astype(np.int32)
    out = []
    for i in range(4):
        tail = rng.integers(0, 128, size=(8 + i,)).astype(np.int32)
        out.append((np.concatenate([shared, tail]), 40))
    return out


def lora_reqs():
    rng = np.random.default_rng(11)
    return [(rng.integers(0, 128, size=(int(n),)).astype(np.int32), 10, a)
            for n, a in zip((9, 20, 14, 30, 6), (1, 0, 2, 3, 1))]


def engine(cfg, params, mesh=None, config=None, **serving):
    return init_serving(make_model(TransformerConfig(**cfg,
                                                     dtype=torch.float32)),
                        config=dict(config or {}),
                        serving={**SERVING, **serving}, params=params,
                        dtype=torch.float32, device="cpu", mesh=mesh)


def streams(outs):
    return [np.asarray(outs[k]) for k in sorted(outs)]


def on_mesh(rank, plan, drive, cfg, params, config=None, setup=None,
            **serving):
    """Build the engine on every rank; rank 0 drives it, the others serve
    its device calls until its close()."""
    srv = engine(cfg, params, mesh=plan, config=config, **serving)
    if setup is not None:
        setup(srv)
    if rank:
        srv.run_worker()
        return None
    try:
        return drive(srv)
    finally:
        srv.close()


def _stats(srv, *keys):
    st = srv.stats()
    return {k: st.get(k) for k in keys}


def _run(srv, load):
    return streams(srv.run(list(load)))


def _register(srv):
    for a in (1, 2, 3):
        srv.register_adapter(a, make_random_adapter(
            srv.model.config, 4, seed=a, scale=0.2))


def _first_round(srv, load):
    rids = [srv.add_request(*r) for r in load]
    srv.step()
    return rids


def _to_done(srv):
    outs = {}
    while not srv.scheduler.done:
        for r in srv.step():
            outs[r.rid] = np.asarray(r.output)
    return [outs[k] for k in sorted(outs)]


# ---------------------------------------------------------------------------
# two ranks: tensor parallel
# ---------------------------------------------------------------------------

def _tp2_basic(rank, d):
    load = reqs()
    tp2 = MeshPlan(tensor=2)

    def drive(srv):
        return {"streams": _run(srv, load),
                "stats": _stats(srv, "pool_bytes", "pool_bytes_logical",
                                "tp", "ep"),
                "degrees": (srv.tp, srv.ep), "mesh_desc": srv.mesh_desc,
                "pool_shape": tuple(srv.pools["k"].shape),
                "wq_shape": tuple(srv.engine.params["layers"]["wq"].shape),
                "embed_rows": srv.engine.params["tok_embed"].shape[0]}
    out = on_mesh(rank, tp2, drive, CFG, d["params"])
    if rank == 0:
        srv = engine(CFG, d["params"])
        out["tp1"] = _run(srv, load)
        out["stats1"] = _stats(srv, "pool_bytes", "pool_bytes_logical",
                               "tp", "ep")
    return out


def _tp2_preempt_prefix(rank, d):
    load = shared_prefix_reqs()
    serving = dict(max_seqs=2, num_blocks=9, enable_prefix_cache=True)
    keys = ("preemptions", "prefix_hits")

    def drive(srv):
        return {"streams": _run(srv, load), "stats": _stats(srv, *keys)}
    out = on_mesh(rank, MeshPlan(tensor=2), drive, CFG, d["params"],
                  **serving)
    if rank == 0:
        srv = engine(CFG, d["params"], **serving)
        out["tp1"] = _run(srv, load)
        out["stats1"] = _stats(srv, *keys)
    return out


def _tp2_spec_chunked(rank, d):
    load = reqs(seed=5, lens=(7, 33), news=(12, 10))

    def drive(srv):
        return {"streams": _run(srv, load),
                "stats": _stats(srv, "spec_steps", "prefill_chunks")}
    out = on_mesh(rank, MeshPlan(tensor=2), drive, CFG, d["params"],
                  spec_tokens=3, prefill_token_budget=48)
    if rank == 0:
        out["tp1"] = _run(engine(CFG, d["params"]), load)
    return out


def _tp2_drain_resume(rank, d):
    load = reqs(seed=7, lens=(9, 25), news=(12, 10))
    tp2 = MeshPlan(tensor=2)
    out = {"base": on_mesh(rank, tp2, lambda s: _run(s, load), CFG,
                           d["params"])}
    drain_dir = os.path.join(d["tmp"], "port_tp2_drain")

    def drain(srv):
        _first_round(srv, load)
        return srv.drain(drain_dir)
    out["tag_dir"] = on_mesh(rank, tp2, drain, CFG, d["params"])
    if rank == 0:
        state = load_drain_state(drain_dir)
        out["engine_record"] = state["engine"]
        srv1 = engine(CFG, d["params"])
        refusals = []
        for call in (lambda: srv1.resume(drain_dir),
                     lambda: srv1.accept_migration(
                         state["requests"], geometry=state["engine"])):
            try:
                call()
                refusals.append(None)
            except ResumeIncompatible as e:
                refusals.append(str(e))
        out["tp1_refusals"] = refusals
        legacy = {k: v for k, v in state["engine"].items()
                  if k not in ("tp", "ep")}
        out["legacy_accepted"] = srv1.accept_migration(
            state["requests"], geometry=legacy)

    def resume(srv, path):
        rids = srv.resume(path)
        return {"rids": rids, "streams": _to_done(srv)}
    out["resumed"] = on_mesh(rank, tp2, lambda s: resume(s, drain_dir), CFG,
                             d["params"])
    out["jax_resumed"] = on_mesh(
        rank, tp2, lambda s: resume(s, d["jax_drain"]), CFG, d["params"])
    return out


def _tp2_lora(rank, d):
    load = lora_reqs()
    lora = dict(adapter_slots=3, lora_rank=4)
    keys = ("adapter_page_ins", "adapter_evictions", "pool_bytes",
            "pool_bytes_logical")

    def drive(srv):
        return {"streams": _run(srv, load), "stats": _stats(srv, *keys),
                "o_a": tuple(srv.adapter_pool["o"]["a"].shape),
                "q_b": tuple(srv.adapter_pool["q"]["b"].shape)}
    out = on_mesh(rank, MeshPlan(tensor=2), drive, CFG, d["params"],
                  setup=_register, **lora)
    if rank == 0:
        srv = engine(CFG, d["params"], **lora)
        _register(srv)
        out["tp1"] = _run(srv, load)
        out["stats1"] = _stats(srv, *keys)
    return out


def _tp2_int8(rank, d):
    load = reqs(seed=13, lens=(11, 30), news=(10, 12))
    config = {"kv_cache_bits": 8}

    def drive(srv):
        return {"streams": _run(srv, load),
                "scale_shape": tuple(srv.pools["k_scale"].shape),
                "stats": _stats(srv, "pool_bytes", "pool_bytes_logical")}
    out = on_mesh(rank, MeshPlan(tensor=2), drive, CFG, d["params"],
                  config=config)
    if rank == 0:
        out["tp1"] = _run(engine(CFG, d["params"], config=config), load)
    return out


def _tp2_weight_bits(rank, d):
    """int8 weights at tp=2: each layer quantized whole (a row-parallel
    leaf's scales span all its rows), then sliced: the scales shard with
    their out columns."""
    load = reqs(seed=19, lens=(12, 27), news=(10, 9))
    config = {"weight_bits": 8}

    def drive(srv):
        w = srv.engine.params["layers"]
        return {"streams": _run(srv, load),
                "wq_scale": tuple(w["wq"]["scale"].shape),
                "wo_scale": tuple(w["wo"]["scale"].shape)}
    out = on_mesh(rank, MeshPlan(tensor=2), drive, CFG, d["params"],
                  config=config)
    if rank == 0:
        out["tp1"] = _run(engine(CFG, d["params"], config=config), load)
    return out


def _tp2_int8_tree(rank, d):
    """An int8 tree with neither quantize_bits nor weight_bits: refused
    before any device call, on each rank, at tp=2 and tp=1."""
    from deepspeed_tpu_torch.models.convert import params_from_numpy
    from deepspeed_tpu_torch.models.transformer import quantize_layer_stack
    cfg = TransformerConfig(**CFG, dtype=torch.float32)
    q = quantize_layer_stack(params_from_numpy(
        d["params"], cfg, device="cpu", dtype=torch.float32))
    out = {}
    for what, plan in (("tp2", MeshPlan(tensor=2)), ("tp1", None)):
        try:
            engine(CFG, q, mesh=plan)
            out[what] = None
        except ValueError as e:
            out[what] = str(e)
    return out


def _tp2_close_after_hang(rank, d):
    """A round the watchdog gave up on: rank 0's close() returns without
    waiting for it, and the other rank's run_worker still returns (the
    round thread sends the stop when its current device call ends). A
    barrier on a group of its own shows the other rank got out; a second
    close() then joins the round thread."""
    side = dist.new_group([0, 1])
    srv = engine(CFG, d["params"], mesh=MeshPlan(tensor=2),
                 dispatch_timeout_s=1e-4)
    if rank:
        srv.run_worker()
        dist.barrier(group=side)
        return None
    try:
        srv.run(reqs())
        hang = None
    except DecodeDispatchHang as e:
        hang = str(e)
    first = srv.close()
    dist.barrier(group=side)
    return {"hang": hang, "first_close": first,
            "joined": srv.close(timeout=60)}


def _tp2_handoff(rank, d):
    """A KV handoff in both directions between tp=2 and tp=1: the
    payload carries all kv heads (gathered on export, sliced on import)."""
    load = reqs(seed=17, lens=(24, 40), news=(10, 8))
    tp2 = MeshPlan(tensor=2)
    out = {}

    def export(srv):
        rids = _first_round(srv, load)
        kv = srv.export_kv(rids)
        recs = srv.release_requests(rids)
        return {"kv": kv, "recs": recs}
    sent = on_mesh(rank, tp2, export, CFG, d["params"])
    if rank == 0:
        out["base"] = _run(engine(CFG, d["params"]), load)
        dst = engine(CFG, d["params"])
        dst.accept_migration(sent["recs"], kv=sent["kv"])
        out["tp2_to_tp1"] = _to_done(dst)
        out["tp2_to_tp1_handoffs"] = dst.stats()["handoffs"]
        out["payload_heads"] = {r: p["geometry"]["kv_heads"]
                                for r, p in sent["kv"].items()}
        out["payload_shape"] = {r: p["data"]["k"].shape
                                for r, p in sent["kv"].items()}
        src = engine(CFG, d["params"])
        rids = _first_round(src, load)
        kv = src.export_kv(rids)
        sent = {"kv": kv, "recs": src.release_requests(rids)}

    def accept(srv):
        srv.accept_migration(sent["recs"], kv=sent["kv"])
        outs = _to_done(srv)
        return outs, srv.stats()["handoffs"]
    got = on_mesh(rank, tp2, accept, CFG, d["params"])
    if rank == 0:
        out["tp1_to_tp2"], out["tp1_to_tp2_handoffs"] = got
    return out


def _tp2_recover(rank, d):
    """Round recovery on a tp=2 engine: rank 0's injector fails the
    dispatch of round attempt 1 and raises a BackendFault at attempt 2;
    each recovery is one seam call, so every rank zeroes its pools (in
    place: no round thread is alive, so no second pool), and the streams
    equal tp=1's without faults."""
    from deepspeed_tpu_torch.robustness import faults
    load = reqs(seed=3)

    def drive(srv):
        faults.install(faults.FaultInjector(faults.FaultSchedule([
            {"kind": "decode_dispatch", "at": 1},
            {"kind": "backend_fault", "at": 2}], seed=0)))
        try:
            before = dict(srv.pools)
            out = _run(srv, load)
            fired = [f["kind"] for f in faults.active().fired]
        finally:
            faults.clear()
        st = srv.stats()
        return {"streams": out, "recoveries": st["recoveries"],
                "degraded": st["degraded"], "fired": fired,
                "pools_kept": all(srv.pools[k] is v
                                  for k, v in before.items())}
    got = on_mesh(rank, MeshPlan(tensor=2), drive, CFG, d["params"])
    if rank == 0:
        got["tp1"] = _run(engine(CFG, d["params"]), load)
    return got


def _tp2_recover_blocked_decode(rank, d):
    """A decode op that blocks inside its seam call, as a collective that
    never completes would: the watchdog gives up on the round, and the
    recovery cannot take the seam from the stuck thread within
    ``dispatch_timeout_s``, so the engine latches and the hang reaches
    the caller in bounded time. Rank 0 then lets the op go, and close()
    stops the other rank."""
    import threading
    import time
    from deepspeed_tpu_torch.inference import serving as serving_mod
    timeout = 1.0
    srv = engine(CFG, d["params"], mesh=MeshPlan(tensor=2),
                 dispatch_timeout_s=timeout)
    if rank:
        srv.run_worker()
        return None
    ops = serving_mod.ServingEngine._OPS
    decode, release, block = ops[serving_mod._DECODE], threading.Event(), []

    def blocking(self, ints, t):
        if block:
            release.wait(120)
        return decode(self, ints, t)
    srv._OPS = {**ops, serving_mod._DECODE: blocking}
    try:
        for p, k in reqs(seed=3):
            srv.add_request(p, k)
        srv.step()                # warm-up round: the watchdog is not armed
        block.append(True)
        t0 = time.perf_counter()
        try:
            srv.step()
            raised = None
        except DecodeDispatchHang as e:
            raised = type(e).__name__
        waited = time.perf_counter() - t0
        try:
            srv.step()
            latched = None
        except RuntimeError as e:
            latched = str(e)
        release.set()
        return {"raised": raised, "waited_s": waited, "latched": latched,
                "recoveries": srv.stats()["recoveries"],
                "closed": srv.close(timeout=60)}
    finally:
        release.set()
        srv.close(timeout=60)


GROUP2 = {"basic": _tp2_basic, "preempt_prefix": _tp2_preempt_prefix,
          "spec_chunked": _tp2_spec_chunked, "drain": _tp2_drain_resume,
          "lora": _tp2_lora, "int8": _tp2_int8,
          "weight_bits": _tp2_weight_bits, "handoff": _tp2_handoff,
          "int8_tree": _tp2_int8_tree,
          "close_after_hang": _tp2_close_after_hang}


# ---------------------------------------------------------------------------
# four ranks: expert parallel, and both axes
# ---------------------------------------------------------------------------

def _ep4(rank, d):
    load = reqs(seed=3)

    def drive(srv):
        return {"streams": _run(srv, load), "degrees": (srv.tp, srv.ep),
                "mesh_desc": srv.mesh_desc,
                "moe_w_in": tuple(
                    srv.engine.params["layers"]["moe_w_in"].shape)}
    out = on_mesh(rank, MeshPlan(expert=4), drive, MOE, d["moe_params"])
    if rank == 0:
        out["ep1"] = _run(engine(MOE, d["moe_params"]), load)
    return out


def _tp2ep2(rank, d):
    load = reqs(seed=3)

    def drive(srv):
        w = srv.engine.params["layers"]
        return {"streams": _run(srv, load), "degrees": (srv.tp, srv.ep),
                "mesh_desc": srv.mesh_desc,
                "moe_w_in": tuple(w["moe_w_in"].shape),
                "wq": tuple(w["wq"].shape)}
    return on_mesh(rank, MeshPlan(expert=2, tensor=2), drive, MOE,
                   d["moe_params"])


def _dense_on_expert_mesh(rank, d):
    load = reqs()

    def drive(srv):
        return {"streams": _run(srv, load),
                "degrees": (srv.engine.ep, srv.tp, srv.ep),
                "migration": srv.accept_migration(
                    [], geometry={"tp": 1, "ep": 1})}
    return on_mesh(rank, MeshPlan(expert=4), drive, CFG, d["params"])


GROUP4 = {"ep4": _ep4, "tp2ep2": _tp2ep2,
          "dense_expert_mesh": _dense_on_expert_mesh}


def _play(scenarios, rank, d):
    results = {}
    for name, fn in scenarios.items():
        try:
            results[name] = fn(rank, d)
        except Exception:                    # reported by the test
            if rank:
                raise
            results[name] = {"error": traceback.format_exc()}
    return results


def group2(rank, world, d):
    return _play(GROUP2, rank, d)


def group_recover(rank, world, d):
    return _play({"recover": _tp2_recover,
                  "blocked_decode": _tp2_recover_blocked_decode}, rank, d)


def group4(rank, world, d):
    return _play(GROUP4, rank, d)

