"""Deterministic fault injection held against JAX's: the same schedules
accepted and refused, the same firing indices for the same seed, serving
round recovery under every serving kind with streams equal to the
fault-free run and to JAX's engine under the same schedule, the
checkpoint chain's seams (a transient ``io_error`` absorbed by
``retry_io``, a ``torn_save`` walked back, a ``corrupt_payload`` refused
by integrity), the ``preempt`` kind's SIGTERM, and a recovery on a tp=2
gloo group (``_torch_tp_workers.py``).

Each package installs its own process-global injector; where a test runs
both, both get the same schedule."""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.config.config_utils import ConfigError as JaxConfigError
from deepspeed_tpu.config import Config as JaxConfig
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.config.config_utils import ConfigError
from deepspeed_tpu_torch.parallel.launch import run_group
from deepspeed_tpu_torch.robustness import integrity

from tests import _torch_fleet_common as C
from tests import _torch_tp_workers as TPW
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

JAX, PORT = C.package("jax"), C.package("port")


@pytest.fixture(autouse=True)
def _clean():
    for P in (JAX, PORT):
        P.faults.clear()
        P.events.clear()
    yield
    for P in (JAX, PORT):
        P.faults.clear()
        P.events.clear()


@pytest.fixture(scope="module")
def params():
    return C.make_params()


def _install(P, entries, seed=0):
    inj = P.faults.FaultInjector(P.faults.FaultSchedule(entries, seed=seed))
    P.faults.install(inj)
    return inj


# ---------------------------------------------------------------------------
# the schedule and the injector
# ---------------------------------------------------------------------------

SCHEDULES = [
    [{"kind": "bogus"}],
    [{"kind": "device_fault"}],
    [{"kind": "device_fault", "step": 3, "survivors": 2}],
    [{"kind": "preempt"}],
    [{"kind": "preempt", "round": 3}],
    [{"kind": "preempt", "step": 2}],
    [{"kind": "io_error"}],
    [{"kind": "io_error", "at": 0, "errno": "ENOSPC", "op": "ckpt_io"}],
    [{"kind": "io_error", "at": 0, "errno": 28, "times": 3}],
    [{"kind": "torn_save", "rate": 0.5}],
    [{"kind": "replica_kill", "replica": 1}],
    [{"kind": "heartbeat_loss", "at": 2}],
    [{"kind": "router_partition", "at": 0, "replica": 0, "times": 2}],
    [{"kind": "kv_handoff"}],
    [{"kind": "kv_handoff", "at": 1, "mode": "corrupt"}],
    [{"kind": "decode_dispatch", "at": 1, "mode": "hang", "hang_s": 2}],
    [{"kind": "pool_exhaust", "rate": 0.25, "keep": 1},
     {"kind": "backend_fault", "at": 4}],
    [{"kind": "clock_skew", "skew_s": 30.0, "after": 2}],
]


@pytest.mark.parametrize("entries", SCHEDULES, ids=lambda e: "+".join(
    x["kind"] + ("" if len(x) == 1 else "*") for x in e))
def test_schedule_validation_matches_jax(entries):
    """The same schedules accepted, with the same normalized entries; the
    same refused, with the same error type and message; the config
    section refuses them as a ConfigError in both."""
    got = {}
    for P in (JAX, PORT):
        try:
            got[P.name] = ("ok", P.faults.FaultSchedule(entries, 3).entries)
        except Exception as e:  # noqa: BLE001 — compared below
            got[P.name] = (type(e).__name__, str(e))
    assert got["port"] == got["jax"]
    section = {"robustness": {"faults": {"enabled": True, "seed": 3,
                                         "entries": entries}}}
    if got["jax"][0] == "ok":
        assert Config.load(section).robustness.faults.entries == entries
        JaxConfig.from_dict(section)
    else:
        with pytest.raises(ConfigError, match="robustness.faults"):
            Config.load(section)
        with pytest.raises(JaxConfigError, match="robustness.faults"):
            JaxConfig.from_dict(section)


def _drive_seams(P, inj):
    """Every seam, 40 times over, in a fixed order; returns what each
    call did."""
    log = []
    for i in range(40):
        for name, call in (
                ("op", lambda: inj.op("ckpt_io", path="p", offset=i)),
                ("serving", inj.serving_round),
                ("dispatch", inj.decode_dispatch),
                ("router", lambda: inj.router_round(None)),
                ("handoff", lambda: inj.kv_handoff({"data": {}}))):
            try:
                log.append((name, call()))
            except Exception as e:  # noqa: BLE001 — recorded by type name
                log.append((name, type(e).__name__))
    return log


def test_injector_firing_indices_match_jax():
    """Rate-based and indexed entries at every seam fire at the same
    indices for the same seed (the private numpy Generator draws in the
    same order), with the same ``fired`` records; the skewed clock reads
    alike."""
    entries = [
        {"kind": "io_error", "op": "ckpt_io", "rate": 0.2},
        {"kind": "decode_dispatch", "rate": 0.15},
        {"kind": "pool_exhaust", "rate": 0.3, "keep": 2},
        {"kind": "backend_fault", "at": 5, "times": 2},
        {"kind": "heartbeat_loss", "rate": 0.25, "replica": 1},
        {"kind": "replica_kill", "at": 7, "replica": 0},
        {"kind": "router_partition", "at": 3, "times": 2, "replica": 1},
        {"kind": "kv_handoff", "rate": 0.4},
        {"kind": "clock_skew", "skew_s": 10.0, "after": 3},
    ]
    logs, fired, clocks = {}, {}, {}
    for P in (JAX, PORT):
        inj = P.faults.FaultInjector(P.faults.FaultSchedule(entries, 11))
        logs[P.name] = _drive_seams(P, inj)
        clock = inj.make_clock(iter(range(100)).__next__)
        clocks[P.name] = [clock() for _ in range(6)]
        fired[P.name] = inj.fired
    assert logs["port"] == logs["jax"]
    assert fired["port"] == fired["jax"]
    assert clocks["port"] == clocks["jax"] == [0, 1, 2, 13, 14, 15]
    assert sum(1 for f in fired["port"] if f["kind"] == "io_error") > 3


# ---------------------------------------------------------------------------
# serving round recovery
# ---------------------------------------------------------------------------

RECOVERY = {
    "dispatch_fail": [{"kind": "decode_dispatch", "at": 1},
                      {"kind": "decode_dispatch", "at": 4}],
    "dispatch_hang": [{"kind": "decode_dispatch", "at": 2, "mode": "hang",
                       "hang_s": 3.0}],
    "pool_exhaust": [{"kind": "pool_exhaust", "at": 1, "times": 3}],
    "backend_fault": [{"kind": "backend_fault", "at": 2}],
}


RECOVERY_LOAD = C.reqs(n=4, lens=(7, 21, 12, 30), news=(8, 6, 9, 5))


@pytest.fixture(scope="module")
def recovery_engines(params):
    """The fault-free stream, and each package's engine without a
    watchdog, built once: a recovered engine serves on, so the kinds that
    need no watchdog share it (each case resets its stats)."""
    base = C.port_srv(params, max_seqs=4).run(
        [(p.copy(), k) for p, k in RECOVERY_LOAD])
    return [base[k].tolist() for k in sorted(base)], \
        {P.name: P.srv(params, max_seqs=4) for P in (JAX, PORT)}


@pytest.mark.parametrize("kind", sorted(RECOVERY))
def test_serving_recovery_matches_fault_free_and_jax(params, kind,
                                                     recovery_engines):
    """Each serving kind's faults recover (preempt all, zeroed pools,
    retry): the streams equal the fault-free run's and JAX's engine's
    under the same schedule, with the same fired faults and recovery
    count. The port's BackendFault recovers through the same decode
    kernel: ``degraded`` stays 0 and no ``backend_degraded`` event."""
    base, shared = recovery_engines
    got = {}
    for P in (JAX, PORT):
        inj = _install(P, RECOVERY[kind])
        hang = kind == "dispatch_hang"
        srv = (P.srv(params, max_seqs=4, dispatch_timeout_s=1.0) if hang
               else shared[P.name])
        srv.reset_stats()
        before = dict(srv.pools)
        outs = srv.run([(p.copy(), k) for p, k in RECOVERY_LOAD])
        st = srv.stats()
        got[P.name] = {"streams": [outs[k].tolist() for k in sorted(outs)],
                       "recoveries": st["recoveries"], "fired": inj.fired,
                       "recovered": [e["reason"] for e in P.events.history(
                           "serving_recovered")]}
        if P is PORT:
            assert st["degraded"] == 0
            assert not P.events.history("backend_degraded")
            # zeroed in place, unless a round thread the watchdog gave
            # up on was alive at the recovery: then fresh pools
            kept = all(srv.pools[k] is v for k, v in before.items())
            assert kept == (kind != "dispatch_hang")
        if hang:
            srv.close()
        P.faults.clear()
    assert got["port"]["streams"] == base
    assert got["port"] == got["jax"]
    if kind == "pool_exhaust":
        # a squeeze is a storm the scheduler rides out, not a failure
        assert got["port"]["recoveries"] == 0
    else:
        assert got["port"]["recoveries"] == len(got["port"]["fired"])


def test_errors_past_the_retries_reach_the_caller(params):
    """A fault at every attempt exhausts ``round_retries``: the last
    error reaches the caller as raised, after as many recoveries as
    attempts, and the engine refuses later rounds naming it."""
    _install(PORT, [{"kind": "decode_dispatch", "at": 0, "times": 3}])
    srv = C.port_srv(params, round_retries=2)
    srv.add_request(np.arange(9, dtype=np.int32), 4)
    with pytest.raises(PORT.faults.DispatchFault):
        srv.step()
    assert srv.stats()["recoveries"] == 3
    with pytest.raises(RuntimeError, match="DispatchFault"):
        srv.step()


def test_preempt_round_delivers_sigterm_and_drains(params, tmp_path):
    """``preempt`` at a serving round sends this process a real SIGTERM;
    the engine's PreemptionHandler latches it, the next step drains and
    raises Preempted, and a fresh engine resumes to the same streams.
    The same kind at a training step fires through the injector's step
    seam (the elastic agent's, ROADMAP A11)."""
    load = C.reqs()
    base = C.streams(C.port_srv(params).run([(p.copy(), k)
                                             for p, k in load]))
    handler = PORT.PreemptionHandler().install()
    try:
        _install(PORT, [{"kind": "preempt", "round": 2}])
        srv = C.port_srv(params)
        srv.attach_preemption(handler, str(tmp_path))
        for p, k in load:
            srv.add_request(p.copy(), k)
        outs = {}
        with pytest.raises(Exception) as err:
            for _ in range(50):
                for r in srv.step():
                    outs[r.rid] = r.output
        assert type(err.value).__name__ == "Preempted"
        fresh = C.port_srv(params)
        fresh.resume(str(tmp_path))
        fresh.run([])
        outs.update({r.rid: r.output for r in fresh._finished})
        assert C.streams(outs) == base
        handler.restore()
        handler = PORT.PreemptionHandler().install()
        inj = _install(PORT, [{"kind": "preempt", "step": 2}])
        inj.step(1)
        assert not handler.requested
        inj.step(2)
        assert handler.requested
        assert [f["seam"] for f in inj.fired] == ["step"]
    finally:
        handler.restore()


@pytest.fixture(scope="module")
def tp2_recovery(params):
    return run_group(TPW.group_recover, 2, {"params": params}, threads=1,
                     timeout_s=300)


def test_recovery_on_a_tp2_group(tp2_recovery):
    """On a sharded engine recovery is one more seam call: every rank
    zeroes its pools in place, and the streams equal tp=1's without
    faults."""
    out = tp2_recovery["recover"]
    assert "error" not in out, out.get("error")
    assert [x.tolist() for x in out["streams"]] \
        == [x.tolist() for x in out["tp1"]]
    assert out["fired"] == ["decode_dispatch", "backend_fault"]
    assert out["recoveries"] == 2 and out["degraded"] == 0
    assert out["pools_kept"]


def test_tp2_recovery_gives_up_on_a_seam_held_by_a_stuck_decode(
        tp2_recovery):
    """A decode op stuck inside its seam call holds the seam: recovery
    waits ``dispatch_timeout_s`` (1 s) for it, then latches the engine,
    and the DecodeDispatchHang reaches the caller in about two budgets
    instead of when the op lets go (120 s); later rounds are refused
    naming it, and close() still stops the other rank."""
    out = tp2_recovery["blocked_decode"]
    assert "error" not in out, out.get("error")
    assert out["raised"] == "DecodeDispatchHang"
    assert out["waited_s"] < 30
    assert "DecodeDispatchHang" in out["latched"]
    assert out["recoveries"] == 0 and out["closed"]


# ---------------------------------------------------------------------------
# the checkpoint chain's seams
# ---------------------------------------------------------------------------

def _trainer():
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as pt
    model = pt.make_model(pt.llama_config(
        "tiny", vocab_size=128, num_layers=2, hidden_size=64, num_heads=4,
        num_kv_heads=2, intermediate_size=128, max_seq_len=32,
        dtype=torch.float32))
    e, *_ = deepspeed_tpu_torch.initialize(model=model, config={
        "train_batch_size": 2, "bf16": {"enabled": False},
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3}}},
        device="cpu")
    return e


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 128, (2, 32), dtype=np.int32)}


def test_checkpoint_transient_io_error_is_absorbed(tmp_path):
    """An ``io_error`` on the chain's small-file writes, shorter than the
    retry budget, is absorbed by ``retry_io``: the save commits and
    loads."""
    inj = _install(PORT, [{"kind": "io_error", "op": "ckpt_io", "at": 0,
                           "times": 2}])
    e = _trainer()
    e.train_batch(_batch())
    d = str(tmp_path)
    e.save_checkpoint(d)
    assert [f["kind"] for f in inj.fired] == ["io_error", "io_error"]
    assert integrity.validate_tag(os.path.join(d, "global_step1"))[0]
    assert _trainer().load_checkpoint(d)[0] is not None


def test_checkpoint_torn_save_walks_back(tmp_path):
    """A ``torn_save`` at the second save's commit: the payload is on disk
    with no COMMITTED marker, ``latest`` still names the first tag, and a
    load lands there."""
    inj = _install(PORT, [{"kind": "torn_save", "at": 1}])
    e = _trainer()
    d = str(tmp_path)
    e.train_batch(_batch())
    e.save_checkpoint(d)
    e.train_batch(_batch(1))
    with pytest.raises(OSError, match="torn save"):
        e.save_checkpoint(d)
    assert not integrity.is_committed(os.path.join(d, "global_step2"))
    assert [f["kind"] for f in inj.fired] == ["torn_save"]
    assert integrity.newest_valid_tag(d) == "global_step1"
    e2 = _trainer()
    e2.load_checkpoint(d)
    assert e2.global_steps == 1


def test_checkpoint_corrupt_payload_is_refused(tmp_path):
    """A ``corrupt_payload`` truncates a payload file after the manifest:
    the tag commits, integrity refuses it, and a load walks back."""
    inj = _install(PORT, [{"kind": "corrupt_payload", "at": 1}])
    e = _trainer()
    d = str(tmp_path)
    e.train_batch(_batch())
    e.save_checkpoint(d)
    e.train_batch(_batch(1))
    e.save_checkpoint(d)
    bad = os.path.join(d, "global_step2")
    assert integrity.is_committed(bad)
    ok, why = integrity.validate_tag(bad)
    assert not ok and why
    assert [f["kind"] for f in inj.fired] == ["corrupt_payload"]
    e2 = _trainer()
    e2.load_checkpoint(d)
    assert e2.global_steps == 1


def test_training_config_installs_the_injector():
    """The ``robustness.faults`` section arms the process-global injector
    at engine init; a second engine with the same schedule keeps it."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as pt
    section = {"enabled": True, "seed": 1,
               "entries": [{"kind": "io_error", "at": 5}]}
    model = pt.make_model(pt.llama_config(
        "tiny", vocab_size=128, num_layers=1, hidden_size=64, num_heads=4,
        num_kv_heads=2, intermediate_size=128, max_seq_len=32,
        dtype=torch.float32))
    conf = {"train_batch_size": 2, "bf16": {"enabled": False},
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "robustness": {"faults": section}}
    e1, *_ = deepspeed_tpu_torch.initialize(model=model, config=conf,
                                            device="cpu")
    assert e1.fault_injector is PORT.faults.active() is not None
    e2, *_ = deepspeed_tpu_torch.initialize(model=model, config=conf,
                                            device="cpu")
    assert e2.fault_injector is e1.fault_injector
