"""Shared pieces of the fleet tests (``test_torch_router.py``,
``test_torch_fleet.py``, ``test_torch_faults.py``,
``test_torch_fleet_telemetry.py``): each package's fleet modules and stub
replica, the tiny llama of ``tests/unit/test_disagg.py`` (f32, 2 layers,
hidden 64) served by both packages over the same numpy weights, a load,
and a router drive loop for either package's router."""

import collections
import types

import jax
import jax.numpy as jnp
import numpy as np
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.models import transformer as pt

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           num_kv_heads=2, max_seq_len=128, position_type="rotary",
           activation="silu_glu", norm_type="rmsnorm", tie_embeddings=False)
SERVING = dict(max_seqs=3, block_size=16, max_model_len=128,
               decode_quantum=2, prompt_bucket=16, num_blocks=24)


def jax_model():
    return jt.make_model(jt.TransformerConfig(**CFG, dtype=jnp.float32,
                                              attention_impl="xla"))


def make_params():
    return jax.tree.map(np.asarray,
                        jax.device_get(jax_model().init(
                            jax.random.PRNGKey(0))))


def jax_srv(params, model=None, **serving):
    return deepspeed_tpu.init_serving(
        model or jax_model(), config={"kv_cache_bits": 0},
        serving={**SERVING, **serving}, dtype=jnp.float32, params=params)


def port_srv(params, **serving):
    pm = pt.make_model(pt.TransformerConfig(**CFG, dtype=torch.float32))
    return deepspeed_tpu_torch.init_serving(
        pm, config={"kv_cache_bits": 0}, serving={**SERVING, **serving},
        params=params, dtype=torch.float32, device="cpu")


def reqs(seed=0, n=3, lens=(7, 21, 12), news=(8, 6, 9)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 128, size=(lens[i % len(lens)],)
                          ).astype(np.int32), news[i % len(news)])
            for i in range(n)]


def streams(outs):
    return {int(k): np.asarray(v).tolist() for k, v in outs.items()}


def package(name):
    """One package's fleet modules, for scenarios driven through both;
    ``Stub`` is its pure-host replica (JAX's ``_StubReplica``, the port's
    ``tests/_torch_fleet_stub.py``)."""
    if name == "jax":
        from deepspeed_tpu.analysis.serving_lint import _StubReplica as Stub
        from deepspeed_tpu.elasticity import rendezvous
        from deepspeed_tpu.inference import fleet, router, serving
        from deepspeed_tpu.inference.scheduler import AdmissionRejected
        from deepspeed_tpu.robustness import events, faults, integrity
        from deepspeed_tpu.robustness.preemption import PreemptionHandler
        srv = jax_srv
    else:
        from deepspeed_tpu_torch.elasticity import rendezvous
        from deepspeed_tpu_torch.inference import fleet, router, serving
        from deepspeed_tpu_torch.inference.scheduler import AdmissionRejected
        from deepspeed_tpu_torch.robustness import events, faults, integrity
        from deepspeed_tpu_torch.robustness.preemption import \
            PreemptionHandler
        from tests._torch_fleet_stub import StubReplica as Stub
        srv = port_srv
    return types.SimpleNamespace(
        name=name, router=router, fleet=fleet, serving=serving,
        rendezvous=rendezvous, events=events, faults=faults,
        integrity=integrity, Stub=Stub, srv=srv,
        AdmissionRejected=AdmissionRejected,
        PreemptionHandler=PreemptionHandler)


def drive(router, load, tick=None, clock=None, max_rounds=400):
    """Feed ``load`` to ``router`` (a shed is retried the next round) and
    step until every admitted request finished; ``tick`` runs after each
    round (a fleet controller), ``clock`` ([t]) advances 1 s a round.
    Returns ({rid: output ids}, rounds)."""
    pending = collections.deque(load)
    outs, rounds = {}, 0
    while pending or not router.done:
        while pending:
            p, k = pending[0]
            try:
                router.add_request(p.copy(), k)
            except Exception as e:  # noqa: BLE001 — either package's shed
                if type(e).__name__ != "AdmissionRejected":
                    raise
                break
            pending.popleft()
        for r in router.step():
            outs[r.rid] = r.output
        if tick is not None:
            tick()
        if clock is not None:
            clock[0] += 1.0
        rounds += 1
        assert rounds < max_rounds, "the router did not converge"
    return streams(outs), rounds


def strip_times(events):
    return [{k: v for k, v in e.items()
             if k not in ("ts", "ms", "age_s", "path", "elapsed_ms")}
            for e in events]
