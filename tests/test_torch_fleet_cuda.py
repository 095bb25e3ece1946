"""The fleet's host layer over engines on the card: a router over two
engines (a killed replica's requests migrate, the streams stay the single
engine's), the disaggregated roles proven by per-replica launch counts
(the prefill replica never launches the paged decode kernel, the decode
replica launches the flash forward only for its re-prefill fallbacks),
and round recovery that re-runs the paged decode kernel, a BackendFault
included (no second decode path: ``degraded`` stays 0). Every test needs
an NVIDIA GPU (marker ``cuda``) and skips without one; this file imports
neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_fleet_cuda.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference import (RouterConfig, ServingConfig,
                                           ServingEngine, ServingRouter,
                                           init_serving)
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.robustness import events, faults

VOCAB = 512
SERVING = dict(max_seqs=3, block_size=64, max_model_len=512,
               decode_quantum=4)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    faults.clear()
    events.clear()
    yield torch.device("cuda")
    faults.clear()
    events.clear()


def _engine(**serving):
    """An f32 tiny llama (head_dim 64: the kernels') on the card; the
    fleet's replicas share its weights."""
    model = tt.make_model(tt.llama_config("tiny", vocab_size=VOCAB,
                                          num_layers=2, max_seq_len=512,
                                          dtype=torch.float32))
    return init_serving(model, config={"kv_cache_bits": 0},
                        serving={**SERVING, **serving},
                        dtype=torch.float32, seed=3)


def _load(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, VOCAB, int(k)).astype(np.int32), 12)
            for k in rng.integers(20, 200, n)]


def _streams(outs):
    return {int(k): np.asarray(v).tolist() for k, v in outs.items()}


def _counted(handle, into):
    """Add the kernels launched inside each of the replica's rounds to
    ``into`` (the router steps its replicas one after another)."""
    step = handle.step

    def counted():
        before = _build.launch_counts()
        try:
            return step()
        finally:
            for k, v in _build.launch_counts().items():
                into[k] = into.get(k, 0) + v - before.get(k, 0)
    handle.step = counted


def _router(tmp_path, t):
    return ServingRouter(RouterConfig(
        store_dir=str(tmp_path / "store"), drain_dir=str(tmp_path / "drains"),
        dead_after_s=2.5, breaker_faults=2, breaker_probe_after=2,
        clock=lambda: t[0]))


def _drive(router, load, t):
    pending, outs = list(load), {}
    for _ in range(400):
        while pending:
            try:
                router.add_request(*pending[0])
            except Exception as e:  # noqa: BLE001 — a shed is retried
                if type(e).__name__ != "AdmissionRejected":
                    raise
                break
            pending.pop(0)
        for r in router.step():
            outs[r.rid] = r.output
        t[0] += 1.0
        if not pending and router.done:
            return _streams(outs)
    raise AssertionError("the router did not converge")


@pytest.mark.cuda
def test_router_over_two_engines_fails_over(cuda, tmp_path):
    base_srv = _engine(max_seqs=6)
    base = _streams(base_srv.run(list(_load())))
    t = [0.0]
    router = _router(tmp_path, t)
    counts = {"r0": {}, "r1": {}}
    for name in counts:
        h = router.register(name, ServingEngine(base_srv.engine,
                                                ServingConfig(**SERVING)))
        _counted(h, counts[name])
    faults.install(faults.FaultInjector(faults.FaultSchedule(
        [{"kind": "replica_kill", "at": 2, "replica": 0}], seed=0)))
    assert _drive(router, _load(), t) == base
    st = router.stats()
    assert st["failovers"] == 1 and st["migrated"] >= 1
    assert st["lost_requests"] == 0
    for name, h in router.replicas.items():
        es = h.engine.stats()
        assert counts[name]["flash_fwd"] == es["prefills"] * 2
        assert counts[name]["paged_decode"] == es["decode_steps"] * 2
        assert es["recoveries"] == 0


@pytest.mark.cuda
def test_disaggregated_launch_counts(cuda, tmp_path):
    base_srv = _engine(max_seqs=6)
    base = _streams(base_srv.run(list(_load(seed=1))))
    t = [0.0]
    router = _router(tmp_path, t)
    pre = ServingEngine(base_srv.engine,
                        ServingConfig(**SERVING, role="prefill"))
    dec = ServingEngine(base_srv.engine, ServingConfig(
        **{**SERVING, "max_seqs": 6}, role="decode"))
    counts = {"pre": {}, "dec": {}}
    _counted(router.register("pre", pre), counts["pre"])
    _counted(router.register("dec", dec), counts["dec"])
    faults.install(faults.FaultInjector(faults.FaultSchedule(
        [{"kind": "kv_handoff", "at": 1}], seed=0)))
    assert _drive(router, _load(seed=1), t) == base
    st = router.stats()
    assert st["handoffs"] == 6 and st["handoff_fallbacks"] == 1
    assert counts["pre"].get("paged_decode", 0) == 0
    assert counts["pre"]["flash_fwd"] == 6 * 2
    assert counts["dec"].get("flash_fwd", 0) == 1 * 2    # the fallback
    assert counts["dec"]["paged_decode"] == dec.stats()["decode_steps"] * 2
    assert pre.stats()["decode_steps"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["decode_dispatch", "backend_fault"])
def test_recovery_reruns_the_paged_decode_kernel(cuda, kind):
    load = _load(n=3, seed=2)
    plain = _engine()
    base = _streams(plain.run(list(load)))
    srv = ServingEngine(plain.engine, plain.config)
    faults.install(faults.FaultInjector(faults.FaultSchedule(
        [{"kind": kind, "at": 2}], seed=0)))
    _build.reset_launch_counts()
    before_fault = {}
    real = srv._recover

    def recover(reason):
        before_fault.update(_build.launch_counts())
        return real(reason)
    srv._recover = recover
    assert _streams(srv.run(list(load))) == base
    st = srv.stats()
    assert st["recoveries"] == 1 and st["degraded"] == 0
    assert not events.history("backend_degraded")
    after = _build.launch_counts()
    # B4 ran before the fault and again after the recovery, on the same
    # kernel; every decode step of the run is counted
    assert 0 < before_fault.get("paged_decode", 0) < after["paged_decode"]
    assert after["paged_decode"] == st["decode_steps"] * 2
    assert after["flash_fwd"] == st["prefills"] * 2
