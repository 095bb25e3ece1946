"""The port's data-efficiency pipeline against the JAX package's
(``tests/unit/test_data_pipeline.py``): the curriculum and random-LTD
schedulers step for step, the sampler, the indexed dataset and the
analyzer byte for byte, ``random_ltd_layer`` on a real layer fed JAX's
selection (within 1e-5), and engines against engines at f32 (losses
within 1e-5): the seqlen curriculum, and random-LTD with JAX's own
selections fed to the port through its draw."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime import data_pipeline as jd
from deepspeed_tpu_torch.models import params_from_numpy
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime import data_pipeline as pd

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)
from tests._torch_extras_common import (assert_losses, assert_params,
                                        base_conf, cfgs, engines, ids,
                                        init_np, jax_ltd_selection, rel_l2,
                                        step_key, train_both)

CURRICULA = [
    {"min_difficulty": 8, "max_difficulty": 128,
     "schedule_type": "fixed_linear",
     "schedule_config": {"total_curriculum_step": 100, "difficulty_step": 8}},
    {"min_difficulty": 8, "max_difficulty": 128, "schedule_type": "fixed_root",
     "schedule_config": {"total_curriculum_step": 100, "root_degree": 3}},
    {"min_difficulty": 8, "max_difficulty": 64,
     "schedule_type": "fixed_discrete",
     "schedule_config": {"difficulty": [16, 32, 64], "max_step": [10, 20, 30]}},
    {"min_difficulty": 512, "max_difficulty": 2048,
     "schedule_config": {"total_curriculum_step": 4, "difficulty_step": 256}},
]


@pytest.mark.parametrize("cfg", CURRICULA)
def test_curriculum_scheduler_step_for_step(cfg):
    want, got = jd.CurriculumScheduler(cfg), pd.CurriculumScheduler(cfg)
    for step in list(range(0, 40)) + [99, 100, 101, 10 ** 6]:
        assert got.update_difficulty(step) == want.update_difficulty(step)
        assert got.get_current_difficulty() == want.get_current_difficulty()
    fn = lambda s: 3 * s + 5  # noqa: E731
    c = dict(cfg, schedule_type="custom")
    want, got = jd.CurriculumScheduler(c, fn), pd.CurriculumScheduler(c, fn)
    assert [got.update_difficulty(s) for s in range(50)] == \
        [want.update_difficulty(s) for s in range(50)]
    with pytest.raises(ValueError, match="callable"):
        pd.CurriculumScheduler(c)


@pytest.mark.parametrize("cfg", [
    {"random_ltd": {"min_value": 64, "max_value": 512, "total_steps": 100,
                    "seq_step": 64}},
    {"random_ltd": {"random_ltd_schedule": {
        "min_value": 128, "max_value": 2048,
        "schedule_config": {"total_layer_tokens_steps": 37,
                            "seq_step": 16}}}},
    {"min_value": 1024, "max_value": 1024},
])
def test_ltd_scheduler_step_for_step(cfg):
    want, got = jd.RandomLTDScheduler(cfg), pd.RandomLTDScheduler(cfg)
    for step in range(0, 120, 3):
        for seq in (128, 512, 2048):
            assert got.kept_tokens(step, seq) == want.kept_tokens(step, seq)


def test_seqlen_truncation_matches_jax():
    b = {"input_ids": ids(0, 4, 64), "labels": ids(1, 4, 64),
         "attention_mask": np.ones((4, 64), np.int32),
         "scalar": np.float32(3.0)}
    want = jd.apply_seqlen_curriculum(b, 16)
    got = pd.apply_seqlen_curriculum(
        {k: (torch.from_numpy(v) if k != "scalar" else v)
         for k, v in b.items()}, 16)
    for k in ("input_ids", "labels", "attention_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["scalar"] == want["scalar"]


@pytest.mark.parametrize("n,world,shuffle,drop_last", [
    (103, 4, True, True), (10, 4, False, False), (64, 2, True, False)])
def test_distributed_sampler_matches_jax(n, world, shuffle, drop_last):
    for rank in range(world):
        want = jd.DistributedSampler(n, num_replicas=world, rank=rank,
                                     shuffle=shuffle, seed=7,
                                     drop_last=drop_last)
        got = pd.DistributedSampler(n, num_replicas=world, rank=rank,
                                    shuffle=shuffle, seed=7,
                                    drop_last=drop_last)
        for epoch in (0, 1):
            want.set_epoch(epoch)
            got.set_epoch(epoch)
            assert list(got) == list(want) and len(got) == len(want)
    assert len(pd.DistributedSampler(10)) == 10      # no group: one replica
    with pytest.raises(ValueError, match="rank"):
        pd.DistributedSampler(10, num_replicas=2, rank=2)


def test_indexed_dataset_analyzer_and_sampler_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    samples = [rng.integers(0, 100, size=rng.integers(4, 64))
               for _ in range(50)]
    files = {}
    for name, mod in (("jax", jd), ("port", pd)):
        d = tmp_path / name
        d.mkdir()
        assert mod.write_indexed_dataset(iter(samples), str(d / "ds")) == 50
        ds = mod.IndexedDataset(str(d / "ds"))
        mod.DataAnalyzer({"seqlen": mod.DataAnalyzer.BUILTIN["seqlen"],
                          "vocab_rarity": mod.DataAnalyzer.BUILTIN[
                              "vocab_rarity"]}).run(ds, str(d / "m"))
        files[name] = {os.path.relpath(os.path.join(r, f), d):
                       open(os.path.join(r, f), "rb").read()
                       for r, _, fs in os.walk(d) for f in fs}
    assert files["port"] == files["jax"] and len(files["port"]) == 6
    ds = pd.IndexedDataset(str(tmp_path / "port" / "ds"))
    for i in (0, 7, 49):
        np.testing.assert_array_equal(ds[i], samples[i].astype(np.int32))
    np.testing.assert_array_equal(ds.lengths, [len(s) for s in samples])
    (tmp_path / "bad.idx").write_bytes(np.zeros(3, np.int64).tobytes())
    with pytest.raises(ValueError, match="not an indexed dataset"):
        pd.IndexedDataset(str(tmp_path / "bad"))
    sched = {"min_difficulty": 8, "max_difficulty": 64,
             "schedule_config": {"total_curriculum_step": 10,
                                 "difficulty_step": 1}}
    for rank in (0, 1):
        want = jd.CurriculumSampler(
            str(tmp_path / "jax" / "m"), "seqlen",
            jd.CurriculumScheduler(sched), batch_size=2, rank=rank,
            world_size=2, seed=3)
        got = pd.CurriculumSampler(
            str(tmp_path / "port" / "m"), "seqlen",
            pd.CurriculumScheduler(sched), batch_size=2, rank=rank,
            world_size=2, seed=3)
        for step in (1, 5, 10, 10):
            np.testing.assert_array_equal(got.eligible(step),
                                          want.eligible(step))
            np.testing.assert_array_equal(got.sample(step), want.sample(step))


# ---------------------------------------------------------------------------
# random-LTD on a layer, and the engines
# ---------------------------------------------------------------------------

def test_ltd_selection_is_keyed_by_global_row():
    """A rank drawing rows 2..3 draws what one rank draws for them."""
    whole = pd.ltd_selection((42, 3, 0, 1), 4, 64, 16)
    part = pd.ltd_selection((42, 3, 0, 1), 2, 64, 16, row0=2)
    np.testing.assert_array_equal(part, whole[2:])
    assert (np.diff(whole, axis=1) > 0).all() and whole.max() < 64


@pytest.mark.parametrize("masked", [False, True])
def test_random_ltd_layer_matches_jax(masked):
    """A transformer layer (rotary, GQA, a key mask) on JAX's selection:
    the kept tokens see their true positions and their mask, the others
    pass through; within 1e-5 of JAX's ``random_ltd_layer``."""
    jcfg, tcfg = cfgs(layers=1)
    p = init_np(jcfg)
    lp = {k: v[0] for k, v in p["layers"].items()}
    B, Sq, keep = 2, 32, 12
    x = np.random.default_rng(4).normal(size=(B, Sq, 64)).astype(np.float32)
    mask = None
    if masked:
        # no query sees only masked keys (JAX's XLA branch and the
        # kernels' semantics differ on such rows, ROADMAP C2)
        mask = np.ones((B, Sq), np.int32)
        mask[1, 20:26] = 0
    key = jax.random.PRNGKey(3)

    def jfn(xs, positions=None, mask=None):
        return jt.transformer_layer(xs, jax.tree.map(jnp.asarray, lp), jcfg,
                                    mask=mask, positions=positions)
    want = jd.random_ltd_layer(jnp.asarray(x), jfn, keep, key,
                               positions=None,
                               mask=None if mask is None
                               else jnp.asarray(mask))
    want = np.asarray(want[0] if isinstance(want, tuple) else want)
    u = jax.random.uniform(key, (B, Sq))
    sel = np.sort(np.asarray(jnp.argsort(u, axis=1)[:, :keep]), 1)
    assert mask is None or (mask[np.arange(B), sel[:, 0]] == 1).all()
    tp = params_from_numpy(p, tcfg, device="cpu", dtype=torch.float32)
    tlp = {k: v[0] for k, v in tp["layers"].items()}
    pos = torch.arange(Sq)[None].expand(B, Sq)

    def pfn(xs, positions=None, mask=None):
        return tt.transformer_layer(xs, tlp, tcfg, positions=positions,
                                    mask=mask)
    got = pd.random_ltd_layer(torch.from_numpy(x), pfn,
                              torch.from_numpy(sel), positions=pos,
                              mask=None if mask is None
                              else torch.from_numpy(mask))
    got = got[0].detach().numpy()
    assert rel_l2(got, want) <= 1e-5
    kept = np.zeros((B, Sq), bool)
    np.put_along_axis(kept, sel, True, axis=1)
    np.testing.assert_array_equal(got[~kept], x[~kept])
    # keep >= S (or no selection) is the dense layer
    dense = pd.random_ltd_layer(torch.from_numpy(x), pfn, None,
                                positions=pos)[0]
    assert rel_l2(dense.detach().numpy(), np.asarray(jfn(jnp.asarray(x))[0])
                  ) <= 1e-5


def test_lm_loss_draws_ltd_from_the_config():
    """``random_ltd`` / ``random_ltd_keep`` in the config: a training
    ``lm_loss`` draws its kept tokens from its seed (``ltd_draws``), what
    an explicit selection of those draws gives; eval runs dense."""
    _, tcfg = cfgs(layers=3, random_ltd=True, random_ltd_keep=12)
    tp = params_from_numpy(init_np(cfgs(layers=3)[0]), tcfg, device="cpu",
                           dtype=torch.float32)
    b = {"input_ids": torch.from_numpy(ids(8, 2))}
    drawn = tt.lm_loss(tp, b, tcfg, train=True, dropout_seed=5)
    given = tt.lm_loss(tp, b, tcfg, train=True, dropout_seed=5,
                       ltd_select=tt.ltd_draws(tcfg, 2, 32, 12, (5,), "cpu"))
    dense = tt.lm_loss(tp, b, tcfg)
    assert float(drawn) == float(given) != float(dense)
    assert list(tt.ltd_draws(tcfg, 2, 32, 12, (5,), "cpu")) == [1]


def test_curriculum_engine_matches_jax_engine():
    """The batch cut to the schedule's difficulty each step (S 16, 24,
    32): losses within 1e-5 and the params after 3 steps."""
    jcfg, tcfg = cfgs(layers=2)
    conf = base_conf(rows=4, curriculum_learning={
        "enabled": True, "curriculum_type": "seqlen", "min_difficulty": 16,
        "max_difficulty": 32, "schedule_type": "fixed_linear",
        "schedule_config": {"total_curriculum_step": 2,
                            "difficulty_step": 8}})
    je, te = engines(jcfg, tcfg, conf)
    seen = []
    orig = te._accum_micro_grads

    def spy(batch):
        seen.append(batch["input_ids"].shape[1])
        return orig(batch)
    te._accum_micro_grads = spy
    jl, tl = train_both(je, te, [{"input_ids": ids(i, 4)} for i in range(3)])
    assert seen == [24, 32, 32]
    assert te._curriculum.get_current_difficulty() == 32
    assert_losses(jl, tl)
    assert_params(je, te)


def test_random_ltd_engine_matches_jax_engine_on_jax_draws():
    """Random-LTD on layers 1 .. L - 2 (4 layers, 24 of 32 tokens, then
    the schedule's 32: dense again), JAX's selections fed to the port's
    draw: losses within 1e-5 and the params after 3 steps."""
    jcfg, tcfg = cfgs(layers=4)
    conf = base_conf(rows=4, data_efficiency={
        "enabled": True, "data_routing": {"random_ltd": {
            "enabled": True, "min_value": 16, "max_value": 32,
            "total_steps": 2, "seq_step": 8}}})
    je, te = engines(jcfg, tcfg, conf)
    fed = {}

    def feed(t):
        key = step_key(je)
        keep = te._ltd.kept_tokens(t + 1, 32)
        fed[t] = jax_ltd_selection(key, 4, 4, 32, keep)

    def draw(rows, seq_len, keep, micro, row0):
        sel = fed[te.global_steps]
        return {i: torch.from_numpy(s[row0:row0 + rows]).long()
                for i, s in sel.items()}
    te._ltd_draw = draw
    jl, tl = train_both(je, te, [{"input_ids": ids(20 + i, 4)}
                                 for i in range(3)], before=feed)
    assert [len(s[1][0]) for s in fed.values()] == [24, 32, 32]
    assert je._ltd_keep == 32 and te._ltd_keep == 32
    assert_losses(jl, tl)
    assert_params(je, te)


# ---------------------------------------------------------------------------
# two ranks (gloo) against one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_ranks():
    from deepspeed_tpu_torch.parallel.launch import run_group
    from tests import _torch_extras_workers as W
    p0 = init_np(cfgs(layers=W.LAYERS)[0])
    ranks = run_group(W.group_extras, 2, p0, threads=1, timeout_s=600)
    return p0, ranks


@pytest.mark.parametrize("name", ["ltd_compression_z2", "moq_rows_z3",
                                  "pld_curriculum_z1"])
def test_extras_data2_equal_data1(two_ranks, name):
    """Each rank draws the kept tokens of its global rows and the coins of
    its global micro-batch, and the masks and MoQ scales see whole
    leaves, so data=2 (ZeRO-1 to 3, gas 2) trains what one rank trains:
    losses within 1e-5, params within 1e-5 relative L2."""
    from tests import _torch_extras_workers as W
    p0, ranks = two_ranks
    want = W.run(p0, name)
    for rank in ranks:
        got = rank[name]
        assert_losses(want["losses"], got["losses"])
        for k, v in want["params"].items():
            assert rel_l2(got["params"][k], v) <= 1e-5, (name, k)
    if "period_scale" in want:
        # the probe's difference grads are summed over the ranks in
        # another order (measured 2.5e-4)
        assert rel_l2(ranks[0][name]["period_scale"],
                      want["period_scale"]) <= 1e-3
    # rank d's two micro-batches (gas 2) are its rows of global micro-batch
    # d: each draws what one rank draws for that micro-batch
    assert len(want["draws"]) == (0 if name == "moq_rows_z3" else 2)
    for d, rank in enumerate(ranks):
        assert rank[name]["draws"] == want["draws"][d:d + 1] * 2


def test_extras_refusals_on_two_ranks(two_ranks):
    """JAX's ValueErrors for MoQ, PLD and random-LTD under pipeline
    parallelism; compression on the 1-bit compressed path and MoQ over the
    tensor axis, which the port once refused, build and train a step to
    a finite loss (``test_torch_extras_mesh.py`` holds them to JAX)."""
    from tests import _torch_extras_workers as W
    _, ranks = two_ranks
    for rank in ranks:
        for name, (_, kind) in W.REFUSED.items():
            got = rank["refused"][name]
            assert got.startswith(kind), (name, got)
        assert rank["refused"]["compression_onebit"] == "trained"
        assert rank["refused"]["moq_tensor"] == "trained"
