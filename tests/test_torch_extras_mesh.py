"""The training extras on the model-parallel axes and on the 1-bit
compressed path, at f32, hidden 64, on gloo groups of 2 and 4 ranks
(``_torch_extras_mesh_workers``), against the JAX package's engine on
the same mesh of the conftest's virtual devices and the same numpy
weights (SGD with momentum, 2 steps: losses within 1e-5, params within
1e-5 relative L2 per leaf):

- compression (8-bit weights, the sparse, row, head and channel masks)
  on tensor=2, on tensor=2 x fsdp=2 at ZeRO-3, on expert=2 (a MoE
  model, the experts' leaves), on pipe=2 and on seq=2; each rank's masks
  of the first step are its slices of the one-rank masks, bit for bit;
- the control: masks each rank computes from its own slice (the fault
  the whole-leaf rule prevents) move the tensor=2 run off JAX's;
- a layer-reduced student (2 of 4 layers) distilled from its teacher at
  tensor=2, the teacher placed as the student;
- MoQ with its probe on tensor=2, expert=2 and seq=2, the probe started
  from JAX's own start vector: the period scales within 1e-2 of JAX's
  (the tolerance of the one-rank engine test) and within 1e-3 of the
  port's one-rank probe from the same start, the bits identical (on
  expert=2's MoE model every pass keeps the probed params' expert
  choices, as JAX's jvp does: ROADMAP C15); the port's own start at
  tensor=2 is each rank's slice of the one-rank draw;
- random-LTD on seq=2 on JAX's own kept tokens, without a key mask, with
  one padded on the right, and with one padded on the left (the padded
  positions' labels -100), against JAX's engine and the port's one-rank
  run; 15 kept tokens over seq=2 raise JAX's ValueError in both
  packages;
- the 1-bit compressed path at data=2 with compression and with MoQ
  (JAX's ``tests/unit/test_onebit.py`` TestOnebitCompression /
  TestOnebitMoQ): the warm-up (dense Adam's update: losses at JAX's
  warm-up bar, each step from JAX's state within 1e-5 out of Adam's eps
  regime) and the compressed stage (losses at JAX's stage-parity bar)
  against JAX's engine at data=2 from the same weights, the warm-up
  equal to dense Adam's run under the same transform, the transform
  live, the compressed stage converging.

Two steps, not three: the port's and JAX's params after two steps
(within 1e-6) put an element on the other side of an 8-bit level's
rounding boundary in the third step's forward, at world 1 as on the
mesh, which parts the third step's params by about 1e-5
(``test_third_step_parts_only_by_level_flips`` and
``test_third_step_forward_on_the_mesh_differs_by_whole_levels`` print
the flips: one element of ``layers/wv`` at world 1, tensor=2, seq=2 and
tensor=2 x fsdp=2, none on expert=2 and pipe=2).
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.compression import compress as jc
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu_torch.parallel.launch import run_group
from deepspeed_tpu_torch.runtime.eigenvalue import random_direction

from tests import _torch_extras_mesh_workers as W
from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)
from tests._torch_extras_common import jax_ltd_selection

TOL = 1e-5


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jcfg(layers, moe=False):
    return jt.llama_config("tiny", dtype=jnp.float32, attention_impl="xla",
                           num_layers=layers, **W.DIMS,
                           **(W.MOE if moe else {}))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v
    return out


def _init(layers, moe, seed):
    return jax.tree.map(np.asarray, jt.make_model(_jcfg(layers, moe)).init(
        jax.random.PRNGKey(seed)))


def _jax_train(model, config, n_dev, tree, bs):
    e, *_ = deepspeed_tpu.initialize(model=model, config=config,
                                     devices=jax.devices()[:n_dev])
    e.state["params"] = jax.tree.map(
        lambda old, new: jax.device_put(jnp.asarray(new, old.dtype),
                                        old.sharding),
        e.state["params"], tree)
    losses = [float(e.train_batch(dict(b))["loss"]) for b in bs]
    rec = {"losses": losses, "plan": e.plan.describe(),
           "params": {k: np.asarray(v, np.float32)
                      for k, v in _flat(e.state["params"]).items()}}
    if e._moq is not None:
        rec["period_scale"] = np.asarray(e._moq._period_scale).tolist()
        rec["bits"] = np.asarray(e._moq.bits(len(bs))).tolist()
    return rec


def _step_keys(seed, n):
    """The keys JAX's engine hands its steps 0 .. n - 1 (``train_batch``
    splits its rng once a step)."""
    rng, keys = jax.random.PRNGKey(seed), []
    for _ in range(n):
        rng, sub = jax.random.split(rng)
        keys.append(sub)
    return keys


def _jax_draws(trees):
    """{scenario: JAX's draws} (``W.feed``): random-LTD's kept tokens of
    each step and MoQ's probe start of each step (``jax.random.normal``
    of each layer leaf, leaves in JAX's flatten order), from the keys
    JAX's engines hand their steps."""
    out = {}
    for n, (layers, moe, config, _) in W.JAX2.items():
        keys = _step_keys(config["seed"], W.STEPS)
        if "data_efficiency" in config:
            keep = config["data_efficiency"]["data_routing"]["random_ltd"][
                "max_value"]
            out[n] = {"ltd": [jax_ltd_selection(k, layers, W.B, W.S, keep)
                              for k in keys]}
        elif "quantize_training" in config:
            layer_tree = trees[layers, moe]["layers"]
            flat, treedef = jax.tree.flatten(layer_tree)
            names = treedef.unflatten(list(range(len(flat))))
            starts = []
            for k in keys:
                sub = jax.random.split(k, len(flat))
                starts.append({name: np.asarray(jax.random.normal(
                    sub[i], flat[i].shape, jnp.float32))
                    for name, i in names.items()})
            out[n] = {"v0": starts}
    return out


def _jax_ltd_refusal(tree):
    model = jt.make_model(_jcfg(4))
    e, *_ = deepspeed_tpu.initialize(
        model=model, config=W.conf(0, **W.SP, **W.ltd(15, 1)),
        devices=jax.devices()[:2])
    try:
        e.train_batch(W.batches(1)[0])
    except ValueError as err:
        return f"ValueError: {err}"
    return "trained"


def _jonebit_cfg():
    return jt.TransformerConfig(**W.ONEBIT_DIMS, dtype=jnp.float32,
                                attention_impl="xla")


def _jax_side(trees, teacher, student):
    out = {}
    for n, (layers, moe, config, masked) in {**W.JAX2, **W.JAX4}.items():
        out[n] = _jax_train(jt.make_model(_jcfg(layers, moe)), config,
                            4 if n in W.JAX4 else 2, trees[layers, moe],
                            W.batches(masked=masked))
    jsc, jtc = _jcfg(2), _jcfg(4)
    jkd = jc.make_distillation_loss(jsc, jax.tree.map(jnp.asarray, teacher),
                                    jtc, alpha=0.5, temperature=2.0)
    out["distill_tp2"] = _jax_train(
        dataclasses.replace(jt.make_model(jsc), loss_fn=jkd),
        W.conf(0, **W.TP), 2, student, W.batches(seed=5))
    out["ltd_refusal"] = _jax_ltd_refusal(trees[4, False])
    return out


def _jax_onebit(tree):
    """JAX's engine on 2 devices for each of ``W.JAX_ONEBIT`` from
    ``tree``: its losses, params, MoQ's bits, and for the warm-up its
    whole state after each step (flattened, numpy)."""
    out = {}
    for n in W.JAX_ONEBIT:
        opt, extras, kw, seed, steps = W.ONEBIT_RUNS[n]
        e, *_ = deepspeed_tpu.initialize(
            model=jt.make_model(_jonebit_cfg()),
            config=W.onebit_conf(opt, extras, **kw),
            devices=jax.devices()[:2])
        e.state["params"] = jax.tree.map(
            lambda old, new: jax.device_put(jnp.asarray(new, old.dtype),
                                            old.sharding),
            e.state["params"], tree)
        b, rec = W.onebit_batch(seed), {"losses": [], "states": []}
        for _ in range(steps):
            rec["losses"].append(float(e.train_batch(dict(b))["loss"]))
            if n.endswith("_warm"):
                rec["states"].append(_flat(jax.tree.map(np.asarray,
                                                        e.state)))
        if e._moq is not None:
            rec["bits"] = np.asarray(e._moq.bits(steps)).tolist()
        out[f"onebit_{n}"] = rec
    return out


@pytest.fixture(scope="module")
def runs():
    trees = {(layers, moe): _init(layers, moe, 10 * layers + moe)
             for layers in (2, 4) for moe in (False, True)}
    teacher = _init(4, False, 7)
    student = jax.tree.map(np.asarray, jc.student_params_from_teacher(
        jax.tree.map(jnp.asarray, teacher), list(W.STUDENT)))
    onebit_tree = jax.tree.map(np.asarray, jt.make_model(
        _jonebit_cfg()).init(jax.random.PRNGKey(5)))
    draws = _jax_draws(trees)
    onebit = _jax_onebit(onebit_tree)
    draws.update({n: r["states"] for n, r in onebit.items() if r["states"]})
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        fut2 = ex.submit(run_group, W.group2, 2, trees, teacher, student,
                         onebit_tree, draws, threads=1, timeout_s=900)
        fut4 = ex.submit(run_group, W.group4, 4, trees, threads=1,
                         timeout_s=900)
        jax_side = _jax_side(trees, teacher, student)
        two, four = fut2.result(), fut4.result()
    jax_side.update(onebit)
    return {"jax": jax_side, "two": two, "four": four, "trees": trees}


def _matches(got, want):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=TOL,
                               atol=1e-7)
    assert set(got["params"]) == set(want["params"])
    for k in want["params"]:
        assert rel_l2(got["params"][k], want["params"][k]) <= TOL, k


@pytest.mark.parametrize("scenario", list(W.JAX2) + list(W.JAX4)
                         + ["distill_tp2"])
def test_extras_match_jax_on_the_same_mesh(runs, scenario):
    """Losses and params after 2 steps on every rank, against JAX's engine
    on the same mesh."""
    want = runs["jax"][scenario]
    ranks = runs["four"] if scenario in W.JAX4 else runs["two"]
    for r in ranks:
        got = r[scenario]
        assert got["plan"] == want["plan"]
        _matches(got, want)


@pytest.mark.parametrize("scenario", ["comp_tp2", "comp_ep2", "comp_pp2",
                                      "comp_sp2", "comp_tp2_fsdp2"])
def test_every_rule_applied_a_mask(runs, scenario):
    """The first step applied every mask rule to each leaf it names (the
    runs above hold them to JAX's)."""
    ranks = runs["four"] if scenario in W.JAX4 else runs["two"]
    kinds = {k.split("|")[1] for k in ranks[0][scenario]["masks"]}
    assert kinds == {"sparse", "row", "head", "channel"}


def test_masks_are_slices_of_the_one_rank_masks(runs):
    """At tensor=2 each rank's masks of the first step are its slices of
    the masks one rank computes on the same params, bit for bit."""
    one = runs["two"][0]["world1"]["comp_tp2"]["masks"]
    for rank in runs["two"]:
        got, cut = rank["comp_tp2"]["masks"], rank["slices_tp2"]
        assert set(got) == set(one)
        for key, m in got.items():
            whole = one[key]
            sl = cut[key.split("|")[0]]
            off = len(sl) - whole.ndim
            want = whole[tuple(
                slice(None) if whole.shape[i] == 1 else slice(*sl[off + i])
                for i in range(whole.ndim))]
            np.testing.assert_array_equal(m, want, err_msg=key)


def test_control_masks_from_a_rank_slice_leave_jax(runs):
    """The fault the tests must catch: each rank thresholding its own
    slice (a row, channel or head threshold over half the leaf) moves the
    tensor=2 run past the tolerance of JAX's, and its masks differ from
    the whole leaf's slices."""
    want = runs["jax"]["comp_tp2"]
    got = runs["two"][0]["comp_tp2_local"]
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(got["losses"], want["losses"]))
    param_err = max(rel_l2(got["params"][k], v)
                    for k, v in want["params"].items())
    assert max(loss_err, param_err) > 10 * TOL, (loss_err, param_err)
    good = runs["two"][0]["comp_tp2"]["masks"]
    assert any(not np.array_equal(good[k], m)
               for k, m in got["masks"].items())


@pytest.mark.parametrize("scenario", ["moq_tp2", "moq_ep2", "moq_sp2"])
def test_moq_probe_on_a_mesh_equals_one_rank(runs, scenario):
    """The probe from JAX's start vector (each rank its slice), every
    norm and dot added over the slices, the difference passes' grads
    reduced as the step's: its period scales within 1e-2 of JAX's probe
    on the same mesh (as the one-rank engine test holds them) and within
    1e-3 of the port's one-rank probe from the same start (the partial
    sums add in another order), the bits identical to both."""
    want = runs["jax"][scenario]
    one = runs["two"][0]["world1"][scenario]
    print(scenario, "period scales: JAX", want["period_scale"], "world 1",
          one["period_scale"], "rank 0", runs["two"][0][scenario][
              "period_scale"])
    for rank in runs["two"]:
        got = rank[scenario]
        assert rel_l2(got["period_scale"], want["period_scale"]) <= 1e-2
        assert rel_l2(got["period_scale"], one["period_scale"]) <= 1e-3
        assert got["bits"] == one["bits"] == want["bits"]
        assert max(abs(s - 1.0) for s in got["period_scale"]) > 1e-3


def test_moq_probe_start_is_the_one_rank_draw_sliced(runs):
    """The port's own probe start at tensor=2: each rank's leaves are its
    slices of the start one rank draws from the same generator."""
    layer_tree = {k: torch.from_numpy(v)
                  for k, v in runs["trees"][2, False]["layers"].items()}
    whole = random_direction(layer_tree, torch.Generator().manual_seed(0))
    cut = 0
    for rank in runs["two"]:
        sl = rank["slices_tp2"]
        for k, v in rank["slices_tp2"]["direction"].items():
            s = sl["layers/" + k]
            want = whole[k].numpy()
            if s is not None:
                want = want[tuple(slice(*d) for d in s)]
                cut += want.shape != whole[k].shape
            np.testing.assert_array_equal(v, want, err_msg=k)
    assert cut


@pytest.mark.parametrize("scenario", [n for n in W.JAX2
                                      if n.startswith("ltd")])
def test_random_ltd_over_seq_equals_one_rank(runs, scenario):
    """Random-LTD on seq=2 (the kept tokens of the whole sequence, each
    rank its 8 of the 16 through the ring, under a key mask too) on JAX's
    kept tokens: the port's one-rank run on the same tokens, losses
    within 1e-5, params within 1e-5 relative L2 (JAX's engine on the same
    mesh: ``test_extras_match_jax_on_the_same_mesh``)."""
    one = runs["two"][0]["world1"][scenario]
    for rank in runs["two"]:
        got = rank[scenario]
        assert got["draws"] == one["draws"] == [{"ltd_keep": 16}]
        _matches(got, one)


def test_random_ltd_keep_seq_does_not_divide(runs):
    """15 kept tokens over seq=2: JAX's ring (a ``shard_map`` over seq)
    raises a ValueError, and so does the port (ROADMAP C14)."""
    assert runs["jax"]["ltd_refusal"].startswith("ValueError")
    for rank in runs["two"]:
        assert rank["ltd_refusal"].startswith("ValueError"), \
            rank["ltd_refusal"]
        assert "do not split evenly" in rank["ltd_refusal"]


@pytest.mark.parametrize("name", list(W.ONEBIT_EXTRAS))
def test_onebit_warmup_matches_dense_under_the_transform(runs, name):
    """The 1-bit path at data=2 applies the transform inside each rank's
    loss: in its warm-up it is dense Adam's run under the same transform,
    and the transform is live (the loss without it differs)."""
    for rank in runs["two"]:
        warm = rank[f"onebit_{name}_warm"]
        assert warm["onebit"] and warm["phase"] == "warm"
        np.testing.assert_allclose(warm["losses"],
                                   rank[f"onebit_{name}_dense"]["losses"],
                                   rtol=2e-5, atol=1e-6)
        plain = rank[f"onebit_{name}_plain"]["losses"][0]
        assert abs(plain - warm["losses"][0]) > 1e-6


@pytest.mark.parametrize("run", W.JAX_ONEBIT)
def test_onebit_matches_jax(runs, run):
    """The 1-bit path at data=2 under the transform against JAX's engine
    at data=2 from the same weights: losses of the warm-up (4 steps of
    dense Adam's update) at the bar JAX's own test holds its warm-up to
    dense Adam (rtol 2e-5, atol 1e-6), of the compressed stage at JAX's
    stage-parity bar (rtol 2e-4, atol 1e-5: an element whose momentum +
    error lies within the packages' rounding of 0 may take the other
    sign, ROADMAP C4); MoQ's bits equal. Each warm-up step taken again
    from JAX's state after the step before: the params within 1e-5
    relative L2 a leaf, but for the elements in Adam's eps regime.
    Adam steps an element by lr m / (sqrt(v) + eps), so where the grads
    stay within a hundred eps of 0 (JAX's second moment says so) the
    packages' rounding of g becomes part of the step (the key bias's
    grad is nothing but rounding: it adds the same q . b to every score
    of a query row); those elements move by at most lr either way and
    are counted (printed). Free-running, 8-bit levels that flip and
    Adam's normalization of momenta that cancel carry the rounding
    further, so the free runs are held by their losses."""
    want = runs["jax"][f"onebit_{run}"]
    for rank in runs["two"]:
        got = rank[f"onebit_{run}"]
        assert got["onebit"]
        if "bits" in want:
            assert got["bits_max"] == max(want["bits"])
        if run.endswith("_compressed"):
            np.testing.assert_allclose(got["losses"], want["losses"],
                                       rtol=2e-4, atol=1e-5)
            continue
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=2e-5, atol=1e-6)
        regime = 0
        for t, (params, state) in enumerate(zip(got["replayed"],
                                                want["states"])):
            for k, v in params.items():
                w = state[f"params/{k}"]
                vhat = state[f"opt/exp_avg_sq/{k}"] / (1 - 0.999 ** (t + 1))
                ok = np.sqrt(vhat) >= 100 * 1e-8
                regime += int((~ok).sum())
                assert rel_l2(v[ok], w[ok]) <= TOL, (t, k)
                assert np.abs(v - w).max() <= 2e-2, (t, k)
        print(run, "replayed steps: elements in Adam's eps regime", regime,
              "of", len(want["states"]) * sum(v.size for v in
                                              got["params"].values()))


@pytest.mark.parametrize("name", list(W.ONEBIT_EXTRAS))
def test_onebit_compressed_stage_converges(runs, name):
    for rank in runs["two"]:
        rec = rank[f"onebit_{name}_compressed"]
        losses = rec["losses"]
        assert rec["phase"] == "comp"
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        if name == "moq":
            assert rec["bits_max"] < 6


def _levels(a, c, amax, bits=8):
    """Elements where ``a`` and ``c`` (a leaf's fake-quantized values)
    sit one level apart at the scale of ``amax``, and whether every other
    element agrees within a thousandth of a level."""
    level = np.float32(amax) / np.float32(2 ** (bits - 1) - 1)
    d = np.abs(np.asarray(a, np.float64) - np.asarray(c, np.float64))
    flips = int((np.abs(d - level) <= 1e-3 * level).sum())
    return flips, bool(((d <= 1e-3 * level)
                        | (np.abs(d - level) <= 1e-3 * level)).all())


def test_third_step_parts_only_by_level_flips():
    """Why the runs above stop at two steps, at world 1 (the comp_tp2
    scenario on one rank): after two steps the port's params are within
    1e-6 of JAX's; on the same params the port's transform is JAX's bit
    for bit and the port's grads of the third step are within 1e-5 of
    JAX's; the transform of the port's own params differs from that of
    JAX's by whole 8-bit levels only (rounding boundaries the 1e-8
    differences cross); and where the third step's params part by more
    than the tolerance, a level flipped. Measured: one element of
    ``layers/wv`` flips, and ``layers/wo`` parts by 1.1e-5 relative L2
    after the third step."""
    from deepspeed_tpu.compression import init_compression
    from deepspeed_tpu_torch.models import params_from_numpy
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves, tree_map
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import transformer as tt

    tree = _init(2, False, 20)
    config = {k: v for k, v in W.JAX2["comp_tp2"][2].items()
              if k != "tensor_parallel"}
    bs = W.batches(n=3)
    je, *_ = deepspeed_tpu.initialize(model=jt.make_model(_jcfg(2)),
                                      config=dict(config),
                                      devices=jax.devices()[:1])
    je.state["params"] = jax.tree.map(
        lambda o, n: jax.device_put(jnp.asarray(n, o.dtype), o.sharding),
        je.state["params"], tree)
    te, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(W.pcfg(2)), config=dict(config), params=tree,
        device="cpu")
    for b in bs[:2]:
        je.train_batch(dict(b))
        te.train_batch(dict(b))
    jp = jax.tree.map(np.asarray, je.state["params"])
    tp = {k: v.detach().numpy().copy()
          for k, v in _flat(te.state["params"]).items()}
    for k, v in _flat(jp).items():
        assert rel_l2(tp[k], v) <= 1e-6, k

    # the third step's forward and grads, each package on JAX's params
    jtr = init_compression(config["compression_training"])
    jmodel = jt.make_model(_jcfg(2))
    batch = bs[2]
    jq = _flat(jax.tree.map(np.asarray, jtr.apply(jp, 2)))
    jg = _flat(jax.tree.map(np.asarray, jax.grad(
        lambda p: jmodel.loss_fn(jtr.apply(p, 2), batch))(
            jax.tree.map(jnp.asarray, jp))))
    on_jax = params_from_numpy(jp, W.pcfg(2), device="cpu",
                               dtype=torch.float32)
    for v in tree_leaves(on_jax):
        v.requires_grad_(True)
    q = te._compression.apply(on_jax, 2)
    loss = te.model.loss_fn(q, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    it = iter(torch.autograd.grad(loss, tree_leaves(on_jax)))
    tg = _flat(tree_map(lambda _: next(it), on_jax))
    tq_jax = {k: v.detach().numpy() for k, v in _flat(q).items()}
    for k in jq:
        np.testing.assert_array_equal(tq_jax[k], jq[k], err_msg=k)
        assert rel_l2(tg[k].numpy(), jg[k]) <= 1e-5, k

    # the port's own params: whole levels apart, nothing else
    with torch.no_grad():
        tq_own = {k: v.numpy() for k, v in _flat(te._compression.apply(
            te.state["params"], 2)).items()}
    flips = {}
    for k, v in jq.items():
        if k.startswith("layers/w"):
            n, whole_levels = _levels(tq_own[k], v, np.abs(
                _flat(jp)[k]).max())
            assert whole_levels, k
            flips[k] = n
    je.train_batch(dict(batch))
    te.train_batch(dict(batch))
    parted = {k: rel_l2(v.detach().numpy(),
                        np.asarray(_flat(je.state["params"])[k]))
              for k, v in _flat(te.state["params"]).items()}
    print("level flips", flips, "third step", max(parted.items(),
                                                  key=lambda kv: kv[1]))
    if max(parted.values()) > TOL:
        assert sum(flips.values()) >= 1, (flips, parted)


@pytest.mark.parametrize("scenario", ["comp_tp2", "comp_ep2", "comp_pp2",
                                      "comp_sp2", "comp_tp2_fsdp2"])
def test_third_step_forward_on_the_mesh_differs_by_whole_levels(runs,
                                                               scenario):
    """The mesh runs' params after two steps, the port's and JAX's, under
    the one-rank transform of the third step: apart by whole 8-bit levels
    only, in the elements counted (printed)."""
    from deepspeed_tpu_torch.compression import compress as pc
    layers, moe, config, _ = (W.JAX4 if scenario in W.JAX4
                              else W.JAX2)[scenario]
    tr = pc.CompressionTransform(config["compression_training"])
    got = (runs["four"] if scenario in W.JAX4 else runs["two"])[0]
    want = runs["jax"][scenario]["params"]
    flips = {}
    with torch.no_grad():
        for k, v in want.items():
            if not k.startswith("layers/w"):
                continue
            a = tr.apply({"layers": {k[7:]: torch.from_numpy(v)}}, 2)
            c = tr.apply({"layers": {k[7:]: torch.from_numpy(
                got[scenario]["params"][k])}}, 2)
            n, whole_levels = _levels(c["layers"][k[7:]].numpy(),
                                      a["layers"][k[7:]].numpy(),
                                      np.abs(v).max())
            assert whole_levels, k
            flips[k] = n
    print(scenario, "level flips", flips)
