"""The comms logger against JAX's, and ``log_summary`` into a monitor.

JAX's ``CommsLogger`` records each collective of the facade as
``op[axis]`` with its bytes, once a traced site; the port's records every
call the same way (``comm/comm.py``). One call each of all_reduce,
all_gather, reduce_scatter, broadcast and ppermute over a ``data`` axis
of 2 (JAX: inside a ``shard_map`` over 2 of the conftest's virtual
devices; the port: a 2-rank gloo group, ``_torch_pp_workers.
group_comm2``) gives the same ops, axes, calls and bytes, and the same
summary table; the logger's totals equal the facade's ``counts()``; and
``log_summary(monitor=, step=)`` writes them as scalar events into a
JSONL sink through ``MonitorMaster``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as Pspec

from deepspeed_tpu import comm as jcomm
from deepspeed_tpu.comm import comm as jcomm_mod
from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.config import Config
from deepspeed_tpu_torch.parallel.launch import run_group

from tests import _torch_pp_workers as P
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)


def _jax_logger():
    """The same five collectives through JAX's facade, traced once."""
    from deepspeed_tpu.comm.schedule import shard_map_compat
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))

    def body(x):
        jcomm.all_reduce(x, "data")
        jcomm.all_gather(x, "data")
        jcomm.reduce_scatter(x, "data")
        jcomm.broadcast(x, "data")
        return jcomm.ppermute(x, "data", [(0, 1), (1, 0)])

    jcomm_mod.comms_logger.configure(enabled=True)
    jcomm_mod.comms_logger.reset()
    try:
        f = jax.jit(shard_map_compat(body, mesh, in_specs=Pspec("data"),
                                     out_specs=Pspec("data"),
                                     manual_axes=("data",)))
        x = jnp.concatenate([jnp.arange(8.0), jnp.arange(8.0) + 1])
        out = np.asarray(f(x))
        lg = jcomm_mod.comms_logger
        return {"counts": dict(lg.counts), "bytes": dict(lg.bytes),
                "summary": lg.summary(), "ppermute": out}
    finally:
        jcomm_mod.comms_logger.configure(enabled=False)
        jcomm_mod.comms_logger.reset()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = os.path.join(str(tmp_path_factory.mktemp("comms")), "m.jsonl")
    ranks = run_group(P.group_comm2, 2, path, threads=1, timeout_s=300)
    return ranks, _jax_logger(), path


def test_logger_matches_jax(runs):
    """Ops, axes, calls and bytes of each collective, and the summary
    table, equal JAX's; ppermute over the pair swaps the ranks' pieces."""
    ranks, want, _ = runs
    for r in ranks:
        assert r["counts"] == want["counts"]
        assert r["bytes"] == want["bytes"]
        assert r["summary"] == want["summary"]
    got = np.concatenate([ranks[0]["ppermute"], ranks[1]["ppermute"]])
    np.testing.assert_array_equal(got, want["ppermute"])


def test_logger_equals_facade_counts(runs):
    """Every op the facade counted is in the logger with the same calls
    and bytes."""
    ranks, _, _ = runs
    for r in ranks:
        flat = {f"{op}[{axis}]": v for op, d in r["facade"].items()
                for axis, v in d.items()}
        assert set(flat) == set(r["counts"])
        for key, v in flat.items():
            assert (r["counts"][key], r["bytes"][key]) == \
                (v["calls"], v["bytes"]), key


def test_log_summary_into_a_monitor(runs):
    """``log_summary(monitor=, step=7)`` returns the summary and writes
    ``comm/<op>[axis]/{count,bytes}`` scalar events at step 7 into the
    JSONL sink."""
    ranks, _, path = runs
    assert ranks[0]["log_summary"] == ranks[0]["summary"]
    with open(path) as f:
        events = [json.loads(line) for line in f]
    names = {e["name"]: e["value"] for e in events}
    assert all(e["type"] == "scalar" and e["step"] == 7 for e in events)
    for key, n in ranks[0]["counts"].items():
        assert names[f"comm/{key}/count"] == n
        assert names[f"comm/{key}/bytes"] == ranks[0]["bytes"][key]


def test_config_section_and_facade():
    """The ``comms_logger`` section loads (JAX's fields); ``configure``
    switches the logger; ``prof_ops`` keeps only the named ops; a
    disabled logger records nothing."""
    c = Config.load({"comms_logger": {"enabled": True, "prof_all": False,
                                      "prof_ops": ["all_reduce"]}})
    assert c.comms_logger.enabled and c.comms_logger.prof_ops == \
        ["all_reduce"]
    lg = comm.CommsLogger()
    lg.record("all_reduce", "data", 8)
    assert dict(lg.counts) == {}
    lg.configure(enabled=True, prof_ops=["all_reduce"])
    lg.record("all_reduce", "data", 8)
    lg.record("all_gather", "data", 8)
    assert dict(lg.counts) == {"all_reduce[data]": 1}
    assert [e[0] for e in lg.events(3)] == ["comm/all_reduce[data]/count",
                                            "comm/all_reduce[data]/bytes"]
    assert comm.log_summary() == comm.comms_logger.summary()
