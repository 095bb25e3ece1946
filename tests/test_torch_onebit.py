"""The 1-bit optimizers at two ranks against JAX's at two devices:
``onebitadam``, ``onebitlamb`` and ``zerooneadam`` through their warm-up
and compressed phases (0/1 Adam's local steps too), each rank's error
feedback state, the wire's bytes, and the dense fallback off the pure
data-parallel plan.

The port's engines run on a spawned 2-process gloo group
(``_torch_zero_workers.group_onebit``, no jax there), started on a thread
while this process runs JAX's engines on 2 of the conftest's virtual
devices; both packages start from JAX's init as numpy. A second group
then takes each step from JAX's state after the step before, so every
step is held from identical inputs. A tiny llama at f32 (2 layers,
hidden 64), 6 steps, freeze after 2. Bars: losses at rtol 2e-4 / atol
1e-5 (JAX's stage-parity bar), params and state by relative L2 <= 1e-5.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.comm import compressed as jax_comp
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.comm import compressed as port_comp
from deepspeed_tpu_torch.ops.onebit import PhasedOptimizer
from deepspeed_tpu_torch.ops.registry import get_optimizer_builder
from deepspeed_tpu_torch.parallel.launch import run_group

from tests import _torch_zero_workers as W
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

RTOL, ATOL = 2e-4, 1e-5


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def _jcfg():
    return jt.llama_config("tiny", dtype=jnp.float32, **W.DIMS)


def _jax_run(name, stage=0):
    """JAX's engine on 2 devices: every step's loss and whole state
    (flattened to "opt/exp_avg/..." paths, numpy)."""
    e, *_ = deepspeed_tpu.initialize(model=jt.make_model(_jcfg()),
                                     config=W.onebit_conf(name, stage),
                                     devices=jax.devices()[:2])
    losses, states = [], []
    for b in W.batches(W.ONEBIT_STEPS, seed=3):
        losses.append(float(e.train_batch(b)["loss"]))
        states.append(_flat(jax.tree.map(np.asarray, e.state)))
    return {"compressed": e._onebit_comm, "losses": losses,
            "states": states}


@pytest.fixture(scope="module")
def runs():
    """The port's engines run free on a group while JAX's run here; then
    a second group takes each step from JAX's state after the step
    before."""
    p0 = jax.tree.map(np.asarray, jt.make_model(_jcfg()).init(
        jax.random.PRNGKey(42)))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_group, W.group_onebit, 2, p0, None, threads=1,
                        timeout_s=600)
        jax_side = {name: _jax_run(name) for name in W.ONEBIT}
        jax_side["fallback_stage1"] = _jax_run("onebitadam", stage=1)
        port = fut.result()
    replay = run_group(W.group_onebit, 2, p0,
                       {name: jax_side[name]["states"] for name in W.ONEBIT},
                       threads=1, timeout_s=600)
    return {"port": port, "jax": jax_side, "replay": replay}


def _ties(port_step, jax_state, rank):
    """The elements whose compressed sign differs between the packages at
    this step on ``rank``: where the two error states differ by more than
    the leaf's scale (a flipped sign moves the error by twice the scale).
    For each, (leaf, element, the port's momentum + error, JAX's, the
    scale): JAX's value rebuilt from its error state and the opposite
    sign, exact to an ulp of the scale."""
    out = []
    for k, (m, e) in port_step["pre_sign"].items():
        pre = (m + e).ravel()
        scale = np.float32(np.abs(pre).mean())
        ej = jax_state[f"opt/error/{k}"][rank].ravel()
        for i in np.nonzero(np.abs(port_step["error"][k].ravel() - ej)
                            > scale)[0]:
            sign = np.float32(-1.0 if pre[i] >= 0 else 1.0)
            out.append((k, int(i), float(pre[i]),
                        float(ej[i] + sign * scale), float(scale)))
    return out


@pytest.mark.parametrize("name", list(W.ONEBIT))
def test_onebit_engine_losses_match_jax(runs, name):
    """The engines on the compressed path, each run free for 6 steps:
    every step's loss at JAX's bar through warm-up and the compressed
    phase, the params at 1e-5 through warm-up, and each rank its own
    error feedback. On the free runs the two packages' grads differ in
    their last bits, so an element whose momentum + error lies within
    that difference of 0 takes opposite signs (ROADMAP C4): at the first
    step where a sign differs, each such element's two values lie on
    either side of 0 within 1e-4 of the leaf's scale of each other. A
    flipped sign moves that element's error by twice the scale, so later
    steps differ by its consequences; every step is held from identical
    states in the test below."""
    want = runs["jax"][name]
    assert want["compressed"]
    first_tie = {}
    for rank, r in enumerate(runs["port"]):
        got = r[name]
        assert got["compressed"]
        np.testing.assert_allclose([s["loss"] for s in got["steps"]],
                                   want["losses"], rtol=RTOL, atol=ATOL)
        for t, (s, j) in enumerate(zip(got["steps"], want["states"])):
            if s["phase"] in ("warm", "dense"):
                for k, v in s["params"].items():
                    assert rel_l2(v, j[f"params/{k}"]) <= 1e-5, (name, k)
            for k, v in s["error"].items():
                assert v.shape == j[f"opt/error/{k}"].shape[1:]
            ties = _ties(s, j, rank)
            if ties:
                first_tie.setdefault(t, []).extend(ties)
    if first_tie:
        for leaf, i, pre_port, pre_jax, scale in first_tie[min(first_tie)]:
            assert pre_port * pre_jax <= 0, (leaf, i)
            assert abs(pre_port - pre_jax) <= 1e-4 * scale, (leaf, i)
    errs = [runs["port"][r][name]["steps"][-1]["error"] for r in range(2)]
    assert any(not np.array_equal(errs[0][k], errs[1][k]) for k in errs[0])


@pytest.mark.parametrize("name", list(W.ONEBIT))
def test_onebit_engine_steps_from_jax_state_match_jax(runs, name):
    """Each engine step taken from JAX's state after the step before
    (every rank its slice and its own error): the engine's grads of its
    rows, the phase, the compression and the update give every step's
    params, momentum and each rank's error feedback within 1e-5 relative
    L2 of JAX's, through warm-up, the compressed phase and 0/1 Adam's
    local and sync steps, with no element left out; each compressed step
    took every leaf's sign."""
    states = runs["jax"][name]["states"]
    for rank, r in enumerate(runs["replay"]):
        for t, (s, j) in enumerate(zip(r[name]["steps"], states)):
            compressed = s["phase"] in ("comp", "sync")
            assert len(s["pre_sign"]) == (len(s["params"]) if compressed
                                          else 0), (name, t)
            for k, v in s["params"].items():
                assert rel_l2(v, j[f"params/{k}"]) <= 1e-5, (name, t, k)
            for part in ("exp_avg", "error"):
                for k, v in s[part].items():
                    w = j[f"opt/{part}/{k}"]
                    w = w[rank] if w.ndim == v.ndim + 1 else w
                    assert rel_l2(v, w) <= 1e-5, (name, t, rank, part, k)


def _jax_updates(params, grads, phases):
    """JAX's update_phase over a 2-device data mesh on the given per-device
    grads, as its engine's compressed step runs it (rank-varying state
    with a leading [dp] dim): every step's params and state."""
    from jax.sharding import Mesh, PartitionSpec as P
    from deepspeed_tpu.ops import registry as jax_registry
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    out = {}
    for name, kw in W.ONEBIT.items():
        opt = jax_registry.get_optimizer_builder(name)(
            use_master_weights=False, **kw)
        p = {k: jnp.asarray(v) for k, v in params.items()}
        state = opt.init(p)
        rv = set(opt.rank_varying)
        state = {k: (jax.tree.map(lambda a: jnp.stack([a, a]), v)
                     if k in rv else v) for k, v in state.items()}
        specs = {k: (P("data") if k in rv else P()) for k in state}
        steps = []
        for g, phase in zip(grads, phases[name]):
            def body(g, st, p, phase=phase):
                st = {k: (jax.tree.map(lambda a: a[0], v) if k in rv else v)
                      for k, v in st.items()}
                p, st = opt.update_phase(jax.tree.map(lambda a: a[0], g), st,
                                         p, phase=phase, axis="data")
                return p, {k: (jax.tree.map(lambda a: a[None], v)
                               if k in rv else v) for k, v in st.items()}
            fn = jax.jit(jax.shard_map(body, mesh=mesh,
                                       in_specs=(P("data"), specs, P()),
                                       out_specs=(P(), specs),
                                       check_vma=False))
            p, state = fn({k: jnp.asarray(v) for k, v in g.items()}, state, p)
            steps.append({"params": {k: np.asarray(v) for k, v in p.items()},
                          **{k: {n: np.asarray(a) for n, a in
                                 state[k].items()}
                             for k in ("exp_avg", "exp_avg_sq", "error")},
                          "rv": rv})
        out[name] = steps
    return out


def test_onebit_update_matches_jax():
    """The three updates alone at two ranks on the same per-rank grads and
    phases as JAX's at two devices (warm-up, compressed, 0/1 Adam's local
    and sync steps): every step's params, moments and each rank's error
    feedback within 1e-5 relative L2 of JAX's, the compressed wire in
    between."""
    rng = np.random.default_rng(7)
    params = {"a": rng.standard_normal((64, 48)).astype(np.float32) * 0.02,
              "b": rng.standard_normal((37,)).astype(np.float32) * 0.02}
    grads = [{k: rng.standard_normal((2,) + v.shape).astype(np.float32)
              * 1e-2 for k, v in params.items()}
             for _ in range(W.ONEBIT_STEPS)]
    phases = {name: [get_optimizer_builder(name)(**kw).phase_for(i)
                     for i in range(W.ONEBIT_STEPS)]
              for name, kw in W.ONEBIT.items()}
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_group, W.group_onebit_update, 2, params, grads,
                        phases, threads=1, timeout_s=300)
        want = _jax_updates(params, grads, phases)
        port = fut.result()
    for name in W.ONEBIT:
        assert {"comp", "sync"} & set(phases[name])
        for i, ws in enumerate(want[name]):
            for rank in range(2):
                gs = port[rank][name][i]
                for k, v in ws["params"].items():
                    assert rel_l2(gs["params"][k], v) <= 1e-5, (name, i, k)
                for part in ("exp_avg", "exp_avg_sq", "error"):
                    for k, v in ws[part].items():
                        v = v[rank] if part in ws["rv"] else v
                        assert rel_l2(gs[part][k], v) <= 1e-5, \
                            (name, i, rank, part, k)


@pytest.mark.parametrize("name,phases", [
    ("onebitadam", ["warm"] * 2 + ["comp"] * 4),
    ("onebitlamb", ["warm"] * 2 + ["comp"] * 4),
    ("zerooneadam", ["dense", "dense", "sync", "sync", "local", "sync"])])
def test_onebit_phases_and_wire_bytes(runs, name, phases):
    """JAX's phase schedule, and what each phase puts on the wire: the
    warm-up all-reduces every grad (4 bytes a value), the compressed
    phase all-gathers packed signs and one scale a leaf (about 1/32 of
    the dense bytes), a local step nothing but the loss and norm
    scalars."""
    steps = runs["port"][0][name]["steps"]
    assert [s["phase"] for s in steps] == phases
    dense = comp = None
    for s in steps:
        c = s["counts"]
        if s["phase"] in ("warm", "dense"):
            assert "all_gather" not in c
            dense = c["all_reduce"]["data"]["bytes"] - 8   # loss + norm
        elif s["phase"] == "local":
            assert c == {"all_reduce": {"data": {"calls": 2, "bytes": 8}}}
        else:
            assert c["all_reduce"]["data"]["calls"] == 2
            comp = c["all_gather"]["data"]["bytes"]
    assert 1 / 33 < comp / dense < 1 / 31, (comp, dense)


def test_onebit_dense_fallback_off_pure_dp(runs):
    """At ZeRO stage 1 the engine takes the dense update, as JAX's does,
    and trains as JAX's fallback."""
    want = runs["jax"]["fallback_stage1"]
    assert not want["compressed"]
    for r in runs["port"]:
        assert not r["fallback_stage1"]["compressed"]
        np.testing.assert_allclose(r["fallback_stage1"]["losses"],
                                   want["losses"], rtol=RTOL, atol=ATOL)


def test_pack_unpack_match_jax():
    """JAX's sign packing bit for bit (bit = 1 for x >= 0, so 0 decodes
    to +1) and its inverse, on a length that 8 does not divide."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(1003).astype(np.float32)
    x[::7] = 0.0
    want, n = jax_comp.pack_signs(jnp.asarray(x))
    got, m = port_comp.pack_signs(torch.from_numpy(x))
    assert n == m == 1003 and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        port_comp.unpack_signs(got, m).numpy(),
        np.asarray(jax_comp.unpack_signs(want, n)))
    assert port_comp.compressed_bytes(torch.from_numpy(x)) == \
        jax_comp.compressed_bytes(jnp.asarray(x))


@pytest.mark.parametrize("name", ["onebitadam", "onebitlamb", "zerooneadam"])
def test_onebit_builders_and_one_rank_update(name):
    """The registry builds each as a PhasedOptimizer; at one rank its
    dense update (no wire) runs warm-up, then the compressed update, as
    JAX's single-program form does."""
    opt = get_optimizer_builder(name)(lr=1e-2, use_master_weights=False,
                                      **({"var_freeze_step": 1}
                                         if name == "zerooneadam"
                                         else {"freeze_step": 1}))
    assert isinstance(opt, PhasedOptimizer)
    p = {"w": torch.ones(4, 3)}
    state = opt.init(p)
    for _ in range(3):
        opt.update({"w": torch.full((4, 3), 0.5)}, state, p)
    assert state["step"] == 3 and torch.isfinite(p["w"]).all()
    assert float(state["error"]["w"].abs().sum()) >= 0
