"""The port's resumable trainer against the JAX package's: checkpoint
save/load (the integrity chain, walk-back, retention, async saves), a JAX
training state carried into the port, the fp32 and 16-bit export tools,
and ``ckpt_tools``.

Everything runs on the CPU. The same numpy-seeded weights and batches go
to both packages. Tolerances: the port against JAX within 1e-5 (losses,
relative; params, relative L2) at f32 and 2e-2 at bf16; a port resume
against the uninterrupted port run, bit for bit.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime.engine import load_16bit_model as jax_load_16bit
from deepspeed_tpu.utils.zero_to_fp32 import \
    get_fp32_state_dict_from_zero_checkpoint as jax_fp32
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.robustness import events as rb_events
from deepspeed_tpu_torch.robustness import integrity
from deepspeed_tpu_torch.runtime import checkpointing as ckpt
from deepspeed_tpu_torch.runtime.dataloader import random_token_batches
from deepspeed_tpu_torch.runtime.engine import load_16bit_model
from deepspeed_tpu_torch.utils import ckpt_tools, zero_to_fp32

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

VOCAB, S, B = 512, 64, 4
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": rng.integers(0, VOCAB, (B, S), dtype=np.int32)}
            for _ in range(n)]


CONFIG = {
    "train_batch_size": B,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-3,
                                              "weight_decay": 0.01}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 0.0, "warmup_max_lr": 1e-3, "warmup_num_steps": 4}},
    "gradient_clipping": 1.0}


def _cfgs(dtype):
    kw = dict(vocab_size=VOCAB, num_layers=2, max_seq_len=S)
    if dtype == "float32":
        return (jt.llama_config("tiny", dtype=jax.numpy.float32, **kw),
                tt.llama_config("tiny", dtype=torch.float32, **kw))
    return jt.llama_config("tiny", **kw), tt.llama_config("tiny", **kw)


def _conf(dtype, **extra):
    return dict(CONFIG, bf16={"enabled": dtype == "bfloat16"}, **extra)


# ---------------------------------------------------------------------------
# the JAX side: 2 steps, an Orbax save and a 16-bit export, a reload, and 3
# more steps; computed once per dtype for the tests below
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    runs = {}

    def get(dtype):
        if dtype not in runs:
            jcfg, _ = _cfgs(dtype)
            model = jt.make_model(jcfg)
            je, *_ = deepspeed_tpu.initialize(model=model,
                                              config=_conf(dtype),
                                              devices=jax.devices()[:1])
            p0 = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(42)))
            batches = _batches(5)
            for b in batches[:2]:
                je.train_batch(b)
            d = str(tmp_path_factory.mktemp(f"jax_{dtype}"))
            je.save_checkpoint(d)
            f16 = je.save_16bit_model(d)
            je.load_checkpoint(d)
            state = jax.tree.map(np.asarray, je.state)
            lr, steps = je.get_lr(), je.global_steps
            losses = [float(je.train_batch(b)["loss"]) for b in batches[2:]]
            runs[dtype] = dict(dir=d, f16=f16, p0=p0, state=state,
                               lr=lr, steps=steps, losses=losses,
                               final=jax.tree.map(np.asarray, je.params),
                               final_lr=je.get_lr(), batches=batches)
        return runs[dtype]
    return get


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif v is not None:
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_state_carried_into_the_port_continues_as_jax(jax_runs, dtype):
    """The JAX engine's state after 2 steps, an Orbax save and a reload,
    carried over as numpy (``state_from_numpy`` through
    ``initialize(state=...)``): both continue 3 steps alike."""
    run = jax_runs(dtype)
    _, tcfg = _cfgs(dtype)
    te, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(tcfg), config=_conf(dtype), state=run["state"],
        device="cpu")
    assert te.global_steps == run["steps"] == 2
    assert te.get_lr() == run["lr"]
    assert te.state["opt"]["step"] == 2
    assert (te.state["opt"]["master"] is None) == (dtype == "float32")
    tol = TOL[dtype]
    for b, want in zip(run["batches"][2:], run["losses"]):
        got = float(te.train_batch(b)["loss"])
        assert abs(got - want) <= tol * abs(want), (got, want)
    assert te.get_lr() == run["final_lr"]
    want = _leaves(run["final"])
    got = _leaves(te.params)
    assert set(got) == set(want)
    for name, a in want.items():
        assert rel_l2(_np(got[name]), _np(a)) <= tol, name


def test_state_from_numpy_refuses_a_mismatched_state(jax_runs):
    """A bf16 JAX state (with masters) into an f32 port engine (none)."""
    run = jax_runs("bfloat16")
    _, tcfg = _cfgs("float32")
    with pytest.raises(ValueError, match="opt/master"):
        deepspeed_tpu_torch.initialize(
            model=tt.make_model(tcfg), config=_conf("float32"),
            state=run["state"], device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zero_to_fp32_matches_jax(jax_runs, dtype, tmp_path):
    """The fp32 dicts of the port's directory and of JAX's (f32 masters
    under bf16, the params under f32): the same keys, and the same values
    (1) bit for bit when the port saves the JAX state carried over, (2)
    within the slice's training tolerance (1e-5 at f32, 2e-2 at bf16: the
    bf16 steps round differently) when each package takes the same 2 steps
    from the same weights."""
    run = jax_runs(dtype)
    want = jax_fp32(run["dir"])
    _, tcfg = _cfgs(dtype)
    carried, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(tcfg), config=_conf(dtype), state=run["state"],
        device="cpu")
    carried.save_checkpoint(str(tmp_path / "carried"))
    got = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path / "carried"))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k

    te, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(tcfg), config=_conf(dtype), params=run["p0"],
        device="cpu")
    for b in run["batches"][:2]:
        te.train_batch(b)
    te.save_checkpoint(str(tmp_path))
    got = zero_to_fp32.get_fp32_state_dict_from_zero_checkpoint(
        str(tmp_path))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape
        assert rel_l2(got[k], v) <= TOL[dtype], k
    # the port's dict is this engine's masters (or f32 params), exactly
    src = te.state["opt"]["master"] or te.params
    for k, t in _leaves(src).items():
        assert np.array_equal(got[k], t.detach().float().numpy()), k
    out = zero_to_fp32.convert_zero_checkpoint_to_fp32_state_dict(
        str(tmp_path), str(tmp_path / "fp32"))
    with np.load(out) as z:
        assert set(z.files) == {k.replace("/", "__") for k in got}


def test_16bit_exports_read_across(jax_runs, tmp_path):
    """The port's ``save_16bit_model`` file read by JAX's
    ``load_16bit_model`` and JAX's file by the port's: the same keys, bf16
    values bit for bit."""
    run = jax_runs("bfloat16")
    _, tcfg = _cfgs("bfloat16")
    te, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(tcfg), config=_conf("bfloat16"),
        params=run["p0"], device="cpu")
    path = te.save_16bit_model(str(tmp_path))
    by_jax = jax_load_16bit(path)
    mine = _leaves(te.params)
    assert set(by_jax) == set(mine)
    for k, t in mine.items():
        assert str(by_jax[k].dtype) == "bfloat16"
        assert np.array_equal(by_jax[k].view(np.uint16),
                              t.detach().view(torch.int16).numpy()
                              .view(np.uint16)), k
    jax_file = jax_load_16bit(run["f16"])
    by_port = load_16bit_model(run["f16"])
    assert set(by_port) == set(jax_file) == set(mine)
    for k, a in jax_file.items():
        assert by_port[k].dtype == torch.bfloat16
        assert np.array_equal(by_port[k].view(torch.int16).numpy()
                              .view(np.uint16), a.view(np.uint16)), k


# ---------------------------------------------------------------------------
# a port resume, bit for bit
# ---------------------------------------------------------------------------

def _rows(n=32, seed=3):
    ids = next(random_token_batches(n, S, VOCAB, 1, seed=seed))["input_ids"]
    return [{"input_ids": r} for r in ids]


def _port_engine(async_save=False, **conf):
    _, tcfg = _cfgs("bfloat16")
    config = _conf("bfloat16", checkpoint={"async_save": async_save}, **conf)
    return deepspeed_tpu_torch.initialize(
        model=tt.make_model(tcfg), config=config, device="cpu",
        training_data=_rows())


def _snapshot(engine):
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in ckpt.flatten(engine.state).items()}


def _same_bits(a, b):
    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(
            a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    return int(a) == int(b)


@pytest.mark.parametrize("tag", ["explicit", None])
@pytest.mark.parametrize("async_save", [False, True])
def test_port_resume_is_bit_identical(tmp_path, monkeypatch, async_save, tag):
    """2 steps, a save (with async_save the write is held back until a
    step has updated the state in place), 3 more steps: the uninterrupted
    run. A fresh engine loads the tag (explicit, or `latest`) and runs the
    same 3 steps from the restored loader position: the same losses, params
    and optimizer state, bit for bit; the same step counters, lr and
    loader position. The payload equals the state at save time."""
    gate = None
    if async_save:
        import threading
        gate = threading.Event()
        write = ckpt.CheckpointEngine._write

        def held_write(host, vdir):
            assert gate.wait(30)
            write(host, vdir)
        monkeypatch.setattr(ckpt.CheckpointEngine, "_write",
                            staticmethod(held_write))
    d = str(tmp_path)
    e1, _, loader1, _ = _port_engine(async_save)
    it1 = iter(loader1)
    e1.train_batches(it1, 2)
    at_save = _snapshot(e1)
    e1.save_checkpoint(d, tag=tag)
    losses = [e1.train_batches(it1, 1)["loss"]]
    if async_save:
        assert not os.path.exists(os.path.join(d, ckpt.LATEST_FILE))
        gate.set()
        e1.wait_checkpoint()
    losses += [e1.train_batch(next(it1))["loss"] for _ in range(2)]
    saved_tag = tag or "global_step2"
    assert open(os.path.join(d, ckpt.LATEST_FILE)).read() == saved_tag
    arrays, dtypes = ckpt.read_payload(os.path.join(d, saved_tag, "state"))
    assert set(arrays) == set(at_save)
    for k, v in at_save.items():
        assert _same_bits(ckpt.from_numpy_bits(arrays[k], dtypes[k]), v), k

    e2, _, loader2, _ = _port_engine(async_save)
    assert e2.load_checkpoint(d, tag=tag)[1]["data_position"] == \
        {"epoch": 0, "pos": 2, "seed": 0}
    assert (e2.global_steps, e2.micro_steps) == (2, 2)
    it2 = iter(loader2)
    resumed = [e2.train_batch(next(it2))["loss"] for _ in range(3)]
    assert [float(x) for x in resumed] == [float(x) for x in losses]
    for k, v in _snapshot(e1).items():
        assert _same_bits(_snapshot(e2)[k], v), k
    assert e2.global_steps == e1.global_steps == 5
    assert e2.get_lr() == e1.get_lr()
    assert loader2.state_dict() == loader1.state_dict()


def test_load_without_optimizer_states_keeps_the_optimizer(tmp_path):
    """As JAX (``engine.py`` ``_load_resolved``): the params and counters
    come from the tag; the optimizer state, masters included, stays."""
    e1, *_ = _port_engine()
    b = _batches(1)[0]
    e1.train_batch(b)
    e1.save_checkpoint(str(tmp_path))
    e2, *_ = _port_engine()
    opt_before = {k: v.clone() for k, v in
                  ckpt.flatten(e2.state["opt"]).items()
                  if isinstance(v, torch.Tensor)}
    e2.load_checkpoint(str(tmp_path), load_optimizer_states=False)
    assert e2.global_steps == 1 and e2.state["opt"]["step"] == 0
    for k, v in ckpt.flatten(e2.state["opt"]).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, opt_before[k]), k
    for k, v in ckpt.flatten(e1.params).items():
        assert torch.equal(v, ckpt.flatten(e2.params)[k]), k


@pytest.mark.parametrize("fault", ["torn", "truncated", "bitrot"])
def test_engine_walks_back_past_a_bad_newest_tag(tmp_path, fault):
    """load_checkpoint(tag=None) lands on the newest valid tag when the
    newest is torn (no commit marker), truncated or bit-rotted; an
    explicit tag is honoured verbatim and fails."""
    rb_events.clear()
    d = str(tmp_path)
    e1, *_ = _port_engine()
    b = _batches(1)[0]
    e1.train_batch(b)
    e1.save_checkpoint(d)
    e1.train_batch(b)
    e1.save_checkpoint(d)
    bad = os.path.join(d, "global_step2")
    if fault == "torn":
        os.remove(os.path.join(bad, integrity.COMMIT_FILE))
    else:
        victim = _largest_payload(bad)
        _damage(victim, truncate=fault == "truncated")
    e2, *_ = _port_engine()
    e2.load_checkpoint(d)
    assert e2.global_steps == 1
    ev = rb_events.history("ckpt_fallback")[-1]
    assert ev["requested"] == "global_step2"
    assert ev["resolved"] == "global_step1"
    if fault == "truncated":
        with pytest.raises(ValueError):
            e2.load_checkpoint(d, tag="global_step2")
    else:
        # not validated: the caller asked for exactly that save
        e2.load_checkpoint(d, tag="global_step2")
        assert e2.global_steps == 2


# ---------------------------------------------------------------------------
# the integrity chain, the scenarios of tests/unit/test_robustness.py and
# tests/unit/test_checkpoint.py on the port's payload; faults are made by
# editing the files
# ---------------------------------------------------------------------------

def tree(val):
    return {"w": torch.full((4, 4), float(val)), "step": val}


def _step(d, tag=None):
    arrays, _, _ = ckpt.load_checkpoint(d, tag)
    return int(arrays["step"])


def _largest_payload(tag_dir):
    with open(os.path.join(tag_dir, integrity.MANIFEST_FILE)) as f:
        files = json.load(f)["files"]
    return os.path.join(tag_dir,
                        max(files.items(), key=lambda kv: kv[1]["size"])[0])


def _damage(path, truncate: bool):
    """Truncate to half, or flip the last byte (bitrot: same size)."""
    with open(path, "r+b") as f:
        if truncate:
            f.truncate(os.path.getsize(path) // 2)
        else:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))


def test_save_load_roundtrip_and_layout(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "tag1", tree(1), client_state={"x": 7})
    arrays, dtypes, client = ckpt.load_checkpoint(d)
    assert float(arrays["w"][0, 0]) == 1.0 and client["x"] == 7
    assert dtypes == {"w": "float32", "step": "int64"}
    assert open(os.path.join(d, ckpt.LATEST_FILE)).read() == "tag1"
    tag = os.path.join(d, "tag1")
    vdir = ckpt.resolve_pointer(os.path.join(tag, "state"))
    assert os.path.basename(vdir).startswith("state-v")
    assert np.load(os.path.join(vdir, "w.npy"), allow_pickle=False).shape \
        == (4, 4)


def test_save_writes_manifest_and_marker(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "t", tree(1))
    tag = os.path.join(d, "t")
    assert integrity.is_committed(tag)
    with open(os.path.join(tag, integrity.MANIFEST_FILE)) as f:
        files = json.load(f)["files"]
    assert "meta.json" in files and "state.current" in files
    assert any(f.endswith("w.npy") for f in files)
    assert integrity.validate_tag(tag) == (True, "ok")


@pytest.mark.parametrize("truncate", [True, False])
def test_validate_catches_truncation_and_bitrot(tmp_path, truncate):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "t", tree(1))
    tag = os.path.join(d, "t")
    victim = _largest_payload(tag)
    _damage(victim, truncate)
    ok, reason = integrity.validate_tag(tag)
    assert not ok and os.path.relpath(victim, tag) in reason
    assert ("size" if truncate else "checksum") in reason
    # a shallow check sees the truncation only
    assert integrity.validate_tag(tag, deep=False)[0] == (not truncate)


def test_legacy_tag_without_integrity_is_loadable(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "t", tree(5))
    tag = os.path.join(d, "t")
    os.remove(os.path.join(tag, integrity.COMMIT_FILE))
    os.remove(os.path.join(tag, integrity.MANIFEST_FILE))
    assert integrity.validate_tag(tag) == (True, "legacy")
    assert _step(d) == 5


def test_retention_keeps_last_k_good_tags(tmp_path):
    d = str(tmp_path)
    for i in range(5):
        ckpt.save_checkpoint(d, f"step{i}", tree(i), keep_last_k=2)
    tags = sorted(n for n in os.listdir(d)
                  if os.path.isdir(os.path.join(d, n)))
    assert tags == ["step3", "step4"]
    assert _step(d) == 4


def test_retention_never_prunes_the_tag_latest_names(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "a", tree(1))
    ckpt.save_checkpoint(d, "b", tree(2), save_latest=False, keep_last_k=1)
    ckpt.save_checkpoint(d, "c", tree(3), save_latest=False, keep_last_k=1)
    remaining = sorted(n for n in os.listdir(d)
                       if os.path.isdir(os.path.join(d, n)))
    assert "a" in remaining
    assert _step(d) == 1


def test_retention_never_counts_invalid_tags(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "a", tree(1))
    ckpt.save_checkpoint(d, "b", tree(2))
    integrity.invalidate(os.path.join(d, "b"))
    ckpt.save_checkpoint(d, "c", tree(3), keep_last_k=2)
    remaining = sorted(n for n in os.listdir(d)
                       if os.path.isdir(os.path.join(d, n)))
    assert remaining == ["a", "b", "c"]


def test_overwrite_with_integrity_off_stays_loadable(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "old", tree(1))
    ckpt.save_checkpoint(d, "t", tree(2))
    ckpt.save_checkpoint(d, "t", tree(3), write_integrity=False)
    assert integrity.validate_tag(os.path.join(d, "t")) == (True, "legacy")
    assert _step(d) == 3


def test_uncommitted_latest_falls_back(tmp_path):
    rb_events.clear()
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "good", tree(1))
    ckpt.save_checkpoint(d, "torn", tree(2))
    os.remove(os.path.join(d, "torn", integrity.COMMIT_FILE))
    assert _step(d) == 1
    ev = rb_events.history("ckpt_fallback")[-1]
    assert ev["requested"] == "torn" and ev["resolved"] == "good"
    assert "uncommitted" in ev["reason"]


@pytest.mark.parametrize("latest", ["never_existed", None])
def test_missing_latest_or_its_tag_falls_back(tmp_path, latest):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "good", tree(7))
    if latest is None:
        os.remove(os.path.join(d, ckpt.LATEST_FILE))
    else:
        with open(os.path.join(d, ckpt.LATEST_FILE), "w") as f:
            f.write(latest)
    assert _step(d) == 7


def test_nothing_valid_raises_filenotfound(tmp_path):
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path))
    ckpt.save_checkpoint(str(tmp_path), "torn", tree(1))
    os.remove(os.path.join(tmp_path, "torn", integrity.COMMIT_FILE))
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path))


def test_explicit_tag_is_honored_verbatim(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "a", tree(1))
    ckpt.save_checkpoint(d, "b", tree(2))
    assert ckpt.resolve_load_tag(d, "a") == ("a", False)
    assert _step(d, "a") == 1
    os.remove(os.path.join(d, "a", integrity.COMMIT_FILE))
    assert _step(d, "a") == 1      # not validated: the caller asked for it


def test_overwrite_same_tag_is_atomic(tmp_path):
    """The superseded version dir goes; an orphan version dir (a write
    whose pointer publish never happened) changes nothing."""
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "t", tree(1))
    ckpt.save_checkpoint(d, "t", tree(2))
    assert _step(d, "t") == 2
    versions = [p for p in os.listdir(os.path.join(d, "t"))
                if p.startswith("state-v")]
    assert len(versions) == 1, versions
    os.makedirs(os.path.join(d, "t", "state-vdeadbeef"))
    assert _step(d, "t") == 2


def test_async_save_publishes_on_wait(tmp_path):
    d = str(tmp_path)
    eng = ckpt.CheckpointEngine(async_save=True)
    t = tree(3)
    path = ckpt.save_checkpoint(d, "t", t, engine=eng)
    t["w"].add_(1.0)                 # in place, as the optimizer does
    eng.wait()
    assert os.path.exists(os.path.join(path, "state.current"))
    assert integrity.validate_tag(path) == (True, "ok")
    arrays, _, _ = ckpt.load_checkpoint(d)
    assert float(arrays["w"][0, 0]) == 3.0


def test_failed_async_write_is_never_published(tmp_path, monkeypatch):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, "t", tree(1))

    def broken(host, vdir):
        os.makedirs(vdir)
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(ckpt.CheckpointEngine, "_write",
                        staticmethod(broken))
    eng = ckpt.CheckpointEngine(async_save=True)
    ckpt.save_checkpoint(d, "t", tree(2), engine=eng)
    with pytest.raises(OSError, match="No space"):
        eng.wait()
    assert [p for p in os.listdir(os.path.join(d, "t"))
            if p.startswith("state-v")] == [os.path.basename(
                ckpt.resolve_pointer(os.path.join(d, "t", "state")))]
    # the overwrite dropped the old commit marker first: the tag reads torn
    assert integrity.validate_tag(os.path.join(d, "t")) == \
        (False, "uncommitted")


# ---------------------------------------------------------------------------
# ckpt_tools
# ---------------------------------------------------------------------------

def test_ckpt_tools_inspect_and_validate(tmp_path, capsys):
    e, *_ = _port_engine(zero_optimization={"stage": 2})
    e.train_batch(_batches(1)[0])
    d = str(tmp_path)
    e.save_checkpoint(d)
    assert ckpt_tools.main(["inspect", d, "-v"]) == 0
    out = capsys.readouterr().out
    assert "tags: global_step1" in out and "latest -> global_step1" in out
    assert "global_steps=1" in out and "zero stage: 2" in out
    n = sum(t.numel() for t in ckpt.flatten(e.params).values())
    assert f"params {n / 1e6:.2f}M" in out
    assert "params/layers/wq  [2, 256, 256]  bfloat16" in out
    assert ckpt_tools.main(["validate", d, "--mesh", "fsdp=2,tensor=4"]) == 0
    assert "OK: tag global_step1" in capsys.readouterr().out
    assert ckpt_tools.main(["validate", d, "--mesh", "tensor=7"]) == 1
    assert "NOT restorable" in capsys.readouterr().out
    assert ckpt_tools.main(["validate", d, "--mesh", "bogus=2"]) == 1
    assert ckpt_tools.main(["inspect", str(tmp_path / "nope")]) == 1
