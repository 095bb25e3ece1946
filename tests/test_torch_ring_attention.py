"""Ring attention and sequence-parallel training against JAX.

A 2-rank gloo group (``_torch_pp_workers.group_seq2``) and a 4-rank one
(``group_seq4``) run, while this process runs JAX:

- the port's ``ring_attention`` (JAX's SPMD entry: global q / k / v, each
  rank its piece of the sequence, the output gathered) at seq=2 and
  seq=4, causal and not, against JAX's ``ring_attention`` on a seq mesh
  of the conftest's virtual devices at JAX's bar (2e-4,
  ``tests/unit/test_ring_attention.py:23``); the "pairs" transport (a
  broadcast over the group of each two ring neighbours, the card's over
  gloo) equal to the "p2p" one bit for bit at seq=2 and seq=4;
- the local ring's O and grads (GQA 4/2 heads, causal, full, and under a
  key mask whose rows all see a key) against autograd of the plain
  single-piece attention;
- the sequence-parallel engine (seq=2; seq=2 x fsdp=2 at ZeRO-3) against
  JAX's engine on one device: 5 AdamW steps' losses at 2e-4 / 1e-5
  (``test_ring_attention.py:56``); explicit labels with uneven -100
  counts (the loss a global token mean over the pieces) against the
  port's one-rank run.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import deepspeed_tpu
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops.ring_attention import ring_attention as jax_ring
from deepspeed_tpu.parallel import MeshPlan as JaxPlan, build_mesh
from deepspeed_tpu_torch.parallel.launch import run_group

from tests import _torch_pp_workers as P
from tests import _torch_zero_workers as W
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _qkv():
    """JAX's test inputs: B=2, S=64, 2 heads of 16."""
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    return [np.asarray(jax.random.normal(k, (2, 64, 2, 16))) for k in ks]


def _jax_rings(qkv):
    out = {}
    q, k, v = (jnp.asarray(a) for a in qkv)
    for sp in (2, 4):
        # the batch of 2 over data=2, as JAX's test lays it
        mesh = build_mesh(JaxPlan(seq=sp, data=2),
                          devices=jax.devices()[:2 * sp])
        for causal in (True, False):
            out[(sp, causal)] = np.asarray(jax_ring(q, k, v, mesh,
                                                    causal=causal))
    return out


def _jax_losses(config):
    e, *_ = deepspeed_tpu.initialize(
        model=jt.make_model(jt.llama_config("tiny", dtype=jnp.float32,
                                            **P.DIMS)),
        config=config, devices=jax.devices()[:1])
    return [float(e.train_batch(b)["loss"]) for b in W.batches(P.STEPS)]


@pytest.fixture(scope="module")
def runs():
    qkv = _qkv()
    p0 = jax.tree.map(np.asarray, jt.make_model(jt.llama_config(
        "tiny", dtype=jnp.float32, **P.DIMS)).init(jax.random.PRNGKey(42)))
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        f2 = ex.submit(run_group, P.group_seq2, 2, p0, qkv, threads=1,
                       timeout_s=600)
        f4 = ex.submit(run_group, P.group_seq4, 4, p0, qkv, threads=1,
                       timeout_s=600)
        jax_side = {"rings": _jax_rings(qkv),
                    "losses": _jax_losses(P.conf(gas=1))}
        one = P.run(p0, P.conf(optimizer=W.SGD, gas=1), W.masked_batches(3))
        seq2, seq4 = f2.result(), f4.result()
    return {"jax": jax_side, 2: seq2, 4: seq4, "one": one}


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax(runs, sp, causal):
    want = runs["jax"]["rings"][(sp, causal)]
    for r in runs[sp]:
        np.testing.assert_allclose(r["ring"][f"fwd_causal{int(causal)}"],
                                   want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sp", [2, 4])
def test_pairs_transport_equals_p2p(runs, sp):
    """The broadcast-over-pairs transport (groups of ring neighbours
    only) gives the p2p one's output bit for bit (the card's gloo groups
    take it)."""
    for r in runs[sp]:
        assert r["transports"] == ("p2p", "pairs")
        np.testing.assert_array_equal(r["pairs_fwd"],
                                      r["ring"]["fwd_causal1"])


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("case", ["gqa_causal", "gqa_full", "gqa_masked"])
def test_ring_grads_match_plain(runs, sp, case):
    """The local ring's O, dQ, dK, dV (dK / dV travel back around the ring
    to their piece's owner) against autograd of the plain attention over
    the whole sequence, GQA-native K/V."""
    for r in runs[sp]:
        c = r["ring"][case]
        for name, got, want in zip(("o", "dq", "dk", "dv"), c["got"],
                                   c["want"]):
            assert rel_l2(got, want) <= 1e-5, (name, got.shape)


@pytest.mark.parametrize("what,sp", [("sp2", 2), ("sp2_zero3", 4)])
def test_seq_parallel_training_matches_jax(runs, what, sp):
    """seq=2, and seq=2 x fsdp=2 at ZeRO-3, against JAX's engine on one
    device: 5 AdamW steps' losses at JAX's bar."""
    plans = {"sp2": "seq=2", "sp2_zero3": "fsdp=2xseq=2"}
    for r in runs[sp]:
        assert r[what]["plan"] == plans[what]
        np.testing.assert_allclose(r[what]["losses"], runs["jax"]["losses"],
                                   rtol=2e-4, atol=1e-5)


def test_seq_parallel_uneven_labels(runs):
    """Explicit labels with uneven -100 counts, shifted on the whole
    sequences before the split: each rank's piece over the whole count,
    summed over seq, is the one-rank run's token mean (SGD, 3 steps:
    losses and params within 1e-5; eval too)."""
    want = runs["one"]
    for r in runs[2]:
        got = r["sp2_labels"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                                   atol=1e-6)
        for k in want["params"]:
            assert rel_l2(got["params"][k], want["params"][k]) <= 1e-5, k
        np.testing.assert_allclose(got["eval"], want["eval"], rtol=1e-5)
