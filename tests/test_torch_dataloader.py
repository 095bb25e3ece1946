"""The port's data loader and training loops against the JAX package's:
``DataLoader`` batches and positions, ``PrefetchLoader`` order,
``RepeatingLoader``, ``random_token_batches``, and the loop APIs
(``train_batches`` and the 3-call ``forward`` / ``backward`` / ``step``).

Everything runs on the CPU. Batches are compared exactly; the port's loop
APIs against its own ``train_batch`` bit for bit; the port against the
JAX engine within 1e-5 (f32).
"""

import itertools

import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.runtime import dataloader as jdl
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.runtime import dataloader as tdl

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

VOCAB, S = 512, 64


def rows(n=12, d=4):
    return [{"x": np.full((d,), i, np.float32)} for i in range(n)]


def _firsts(batches):
    return [b["x"][:, 0].tolist() for b in batches]


# ---------------------------------------------------------------------------
# the loader against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle,drop_last", [(False, True), (True, True),
                                               (True, False)])
def test_loader_yields_jax_batches(shuffle, drop_last):
    """The same dataset, seed and epochs: the same batches, epoch by
    epoch (the order is numpy's default_rng(seed + epoch) shuffle)."""
    mine = tdl.DataLoader(rows(14), batch_size=4, shuffle=shuffle, seed=5,
                          drop_last=drop_last)
    ref = jdl.DataLoader(rows(14), batch_size=4, shuffle=shuffle, seed=5,
                         drop_last=drop_last)
    assert len(mine) == len(ref) == (3 if drop_last else 4)
    for epoch in range(3):
        mine.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert _firsts(mine) == _firsts(ref)


def test_loader_resumes_mid_epoch_as_jax():
    """``load_state_dict`` of a mid-epoch position: the next batch is the
    first the saved run had not consumed, in both packages."""
    saved = tdl.DataLoader(rows(16), batch_size=4, shuffle=True, seed=2)
    saved.set_epoch(1)
    it = iter(saved)
    seen = [next(it), next(it)]
    sd = saved.state_dict()
    assert sd == {"epoch": 1, "pos": 2, "seed": 2}
    rest = _firsts(it)
    mine = tdl.DataLoader(rows(16), batch_size=4, shuffle=True, seed=0)
    ref = jdl.DataLoader(rows(16), batch_size=4, shuffle=True, seed=0)
    mine.load_state_dict(sd)
    ref.load_state_dict(sd)
    assert mine.state_dict() == ref.state_dict() == sd
    assert _firsts(mine) == _firsts(ref) == rest
    assert mine.state_dict() == {"epoch": 1, "pos": 4, "seed": 2}
    assert len(seen) == 2


def test_repeating_loader_position_proxies():
    mine = tdl.RepeatingLoader(tdl.DataLoader(rows(8), batch_size=4,
                                              shuffle=True, seed=1))
    ref = jdl.RepeatingLoader(jdl.DataLoader(rows(8), batch_size=4,
                                             shuffle=True, seed=1))
    assert _firsts(itertools.islice(mine, 5)) == \
        _firsts(itertools.islice(ref, 5))
    assert mine.state_dict() == ref.state_dict() == \
        {"epoch": 2, "pos": 1, "seed": 1}
    mine.load_state_dict({"epoch": 0, "pos": 1, "seed": 1})
    ref.load_state_dict({"epoch": 0, "pos": 1, "seed": 1})
    assert _firsts(itertools.islice(mine, 3)) == \
        _firsts(itertools.islice(ref, 3))


def test_random_token_batches_match_jax():
    mine = list(tdl.random_token_batches(3, 16, 100, 4, seed=9))
    ref = list(jdl.random_token_batches(3, 16, 100, 4, seed=9))
    assert len(mine) == 4
    for a, b in zip(mine, ref):
        assert a["input_ids"].dtype == np.int32
        assert np.array_equal(a["input_ids"], b["input_ids"])


# ---------------------------------------------------------------------------
# prefetch order: the scenarios of tests/unit/test_dataloader_prefetch.py
# ---------------------------------------------------------------------------

def test_prefetch_preserves_order_within_epoch():
    loader = tdl.DataLoader(rows(), batch_size=4)
    pf = tdl.PrefetchLoader(loader, put_fn=lambda b: b)
    assert _firsts(pf) == _firsts(loader)


def test_prefetch_preserves_order_across_epoch_boundary():
    loader = tdl.DataLoader(rows(8), batch_size=4, shuffle=True, seed=3)
    pf = tdl.PrefetchLoader(tdl.RepeatingLoader(loader), put_fn=lambda b: b,
                            depth=3)
    it = iter(pf)
    got = [next(it)["x"][:, 0].tolist() for _ in range(6)]   # 3 epochs
    ref_loader = tdl.DataLoader(rows(8), batch_size=4, shuffle=True, seed=3)
    want = []
    for epoch in range(3):
        ref_loader.set_epoch(epoch)
        want += _firsts(ref_loader)
    assert got == want


def test_prefetch_set_epoch_reshuffles_through_wrapper():
    loader = tdl.DataLoader(rows(16), batch_size=4, shuffle=True, seed=0)
    pf = tdl.PrefetchLoader(loader, put_fn=lambda b: b)
    pf.set_epoch(0)
    e0 = _firsts(pf)
    pf.set_epoch(1)
    e1 = _firsts(pf)
    assert e0 != e1
    assert sorted(sum(e0, [])) == sorted(sum(e1, []))
    assert pf.epoch == 1


def test_prefetch_short_iterator_and_len():
    loader = tdl.DataLoader(rows(4), batch_size=4)
    pf = tdl.PrefetchLoader(loader, put_fn=lambda b: b, depth=8)
    assert len(pf) == 1
    assert len(list(pf)) == 1


def test_prefetch_runs_put_ahead_of_the_consumer():
    """The put of batch N+1 is issued before batch N is handed over."""
    order = []
    pf = tdl.PrefetchLoader(iter(range(4)),
                            put_fn=lambda b: order.append(("put", b)) or b)
    for b in pf:
        order.append(("use", b))
    assert order[:3] == [("put", 0), ("put", 1), ("put", 2)]
    assert order.index(("put", 3)) < order.index(("use", 2))
    with pytest.raises(ValueError):
        tdl.PrefetchLoader([], put_fn=None)


# ---------------------------------------------------------------------------
# the loop APIs
# ---------------------------------------------------------------------------

CONFIG = {
    "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
    "scheduler": {"type": "WarmupLR", "params": {
        "warmup_min_lr": 0.0, "warmup_max_lr": 1e-3, "warmup_num_steps": 3}},
    "gradient_clipping": 1.0, "bf16": {"enabled": False}}


def _tcfg():
    return tt.llama_config("tiny", vocab_size=VOCAB, num_layers=2,
                           max_seq_len=S, dtype=torch.float32)


def _port(params=None, **conf):
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(_tcfg()), config=dict(CONFIG, **conf),
        params=params, device="cpu")
    return engine


def _flat(engine):
    from deepspeed_tpu_torch.runtime.checkpointing import flatten
    return flatten(engine.state)


def _assert_same_state(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def _batches(n, rows_, seed=0):
    return list(tdl.random_token_batches(rows_, S, VOCAB, n, seed=seed))


@pytest.mark.parametrize("prefetch,in_flight", [(True, 2), (False, 1)])
def test_train_batches_equals_train_batch_steps(prefetch, in_flight):
    batches = _batches(4, 4)
    conf = dict(train_batch_size=4,
                pipeline={"in_flight": in_flight, "prefetch": prefetch})
    one, many = _port(**conf), _port(**conf)
    want = [one.train_batch(b)["loss"] for b in batches]
    it = iter(batches)
    got = many.train_batches(it, 3)
    assert torch.equal(got["loss"], want[2])
    got = many.train_batches(it, 5)         # one left: stops early
    assert torch.equal(got["loss"], want[3])
    assert many.global_steps == one.global_steps == 4
    assert many.get_lr() == one.get_lr()
    _assert_same_state(one, many)


def test_forward_backward_step_equals_train_batch():
    """gas = 2: two forward/backward calls on the micro-batches, then
    step, is train_batch on the global batch, bit for bit."""
    batches = _batches(3, 8)
    conf = dict(train_batch_size=8, gradient_accumulation_steps=2)
    ref, e = _port(**conf), _port(**conf)
    for b in batches:
        want = ref.train_batch(b)
        for i in range(2):
            mb = {"input_ids": b["input_ids"][4 * i:4 * i + 4]}
            loss = e.forward(mb)
            assert e.backward(loss) is loss
            if i == 0:
                assert not e.is_gradient_accumulation_boundary()
                assert e.step() is None
        assert e.is_gradient_accumulation_boundary()
        got = e.step()
        for k in ("loss", "grad_norm"):
            assert torch.equal(got[k], want[k]), k
    assert (e.global_steps, e.micro_steps) == (ref.global_steps,
                                               ref.micro_steps) == (3, 6)
    _assert_same_state(ref, e)
    with pytest.raises(RuntimeError, match="without forward"):
        e.backward()


def _three_call_loop(eps):
    """Both engines' 3-call loop (4 micro-steps at gas 2) from the same
    llama weights; returns (JAX engine, port engine, JAX's accumulated
    grads of tok_embed / lm_head at each boundary)."""
    jcfg = jt.llama_config("tiny", vocab_size=VOCAB, num_layers=2,
                           max_seq_len=S, dtype=jax.numpy.float32)
    opt = {"type": "adamw", "params": {"lr": 1e-3, "eps": eps}}
    conf = dict(CONFIG, train_batch_size=8, gradient_accumulation_steps=2,
                optimizer=opt)
    je, *_ = deepspeed_tpu.initialize(model=jt.make_model(jcfg),
                                      config=dict(conf),
                                      devices=jax.devices()[:1])
    p0 = jax.tree.map(np.asarray,
                      jt.make_model(jcfg).init(jax.random.PRNGKey(42)))
    te = _port(params=p0, train_batch_size=8, gradient_accumulation_steps=2,
               optimizer=opt)
    sums = []
    for n, mb in enumerate(_batches(4, 4, seed=1)):
        jl = je.forward(mb)
        je.backward(jl)
        if n % 2:
            sums.append({k: np.array(je._grad_buffer[k])
                         for k in ("tok_embed", "lm_head")})
        je.step()
        tl = te.forward(mb)
        te.backward(tl)
        te.step()
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    return je, te, sums


def test_forward_backward_step_matches_jax():
    """The JAX engine's 3-call loop (``tests/unit/test_engine.py``
    ``test_forward_backward_step``: 4 micro-steps at gas 2, so 2 optimizer
    steps) on the same llama weights and micro-batches: losses within 1e-5,
    the same step counters and lr, params within 1e-5. AdamW's eps is
    1e-3: at 1e-8 an element whose two micro-batch grads cancel takes a
    sign from the last bits of the sum and moves by lr either way
    (ROADMAP C18, ``test_adam_eps_1e8_moves_only_cancelling_elements``)."""
    je, te, _ = _three_call_loop(1e-3)
    assert te.global_steps == je.global_steps == 2
    assert te.micro_steps == je.micro_steps == 4
    assert te.get_lr() == je.get_lr()
    jp = jax.tree.map(np.asarray, je.params)
    for name in ("tok_embed", "lm_head"):
        got = te.params[name].detach().numpy().astype(np.float64)
        want = jp[name].astype(np.float64)
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)


def test_adam_eps_1e8_moves_only_cancelling_elements():
    """ROADMAP C18: at AdamW's eps 1e-8 the same loop parts from JAX's
    only on elements whose accumulated grad cancels to within 1e-4 of the
    leaf's RMS grad (and not to an exact 0) at a boundary (there the
    update is ~lr x the sign of the sum's last bits); everywhere else the
    params hold within 1e-5, and the cancelling elements are under 0.1 %
    of each leaf."""
    je, te, sums = _three_call_loop(1e-8)
    jp = jax.tree.map(np.asarray, je.params)
    for name in ("tok_embed", "lm_head"):
        got = te.params[name].detach().numpy().astype(np.float64)
        want = jp[name].astype(np.float64)
        near = np.zeros(want.shape, bool)
        for g in sums:
            g = g[name].astype(np.float64)
            near |= (g != 0) & (np.abs(g) <= 1e-4 * np.sqrt(np.mean(g ** 2)))
        far = ~near
        assert near.mean() <= 1e-3, name
        assert np.linalg.norm((got - want)[far]) <= \
            1e-5 * np.linalg.norm(want[far]), name


def test_initialize_training_data_builds_and_attaches_a_loader(tmp_path):
    """``initialize(training_data=...)`` returns a DataLoader of
    train_batch_size rows, attached: a checkpoint carries its position and
    a load restores it."""
    data = [{"input_ids": r} for r in _batches(1, 12)[0]["input_ids"]]
    e, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(_tcfg()), config=dict(CONFIG, train_batch_size=4),
        device="cpu", training_data=data)
    assert isinstance(loader, tdl.DataLoader) and loader.batch_size == 4
    assert len(loader) == 3
    e.train_batches(iter(loader), 2)
    e.save_checkpoint(str(tmp_path))
    e2, _, loader2, _ = deepspeed_tpu_torch.initialize(
        model=tt.make_model(_tcfg()), config=dict(CONFIG, train_batch_size=4),
        device="cpu", training_data=data)
    e2.load_checkpoint(str(tmp_path))
    assert loader2.state_dict() == {"epoch": 0, "pos": 2, "seed": 0}
    rest = [b["input_ids"] for b in loader2]
    assert len(rest) == 1
    assert np.array_equal(rest[0], np.stack([d["input_ids"]
                                             for d in data[8:12]]))
