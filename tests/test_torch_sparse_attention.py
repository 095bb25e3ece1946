"""The port's block-sparse attention against the JAX package's: layouts and
adjacency tables, the plain forward and backward, a sparse llama's loss and
gradients, ``train_batch`` engine against engine, the remat replays, and
what the slice refuses.

On the CPU the kernel wrappers take their plain versions; the JAX side
runs its Pallas kernels in interpret mode, as
``tests/unit/ops/test_sparse_attention.py`` does. The same numpy-seeded
inputs and weights go to both. Tolerances: relative L2 <= 1e-5 at f32,
<= 2e-2 at bf16 (bf16 rounds at other places in the two frameworks).
``test_torch_kernels.py`` holds the CUDA kernels against these plain
versions on the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import transformer as jt
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.inference.serving import ServingEngine
from deepspeed_tpu_torch.models import params_from_numpy
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops import flash_attention as port_flash
from deepspeed_tpu_torch.ops import sparse_attention as tsa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype="float32"):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _j(a, dtype="float32"):
    x = jnp.asarray(np.array(a, np.float32))
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _sw(a):
    """[B, S, N, D] <-> [B, N, S, D] (the JAX kernels' layout)."""
    return jnp.swapaxes(jnp.asarray(a), 1, 2)


def _configs(mode, **kw):
    return (jsa.get_sparsity_config(mode, **kw),
            tsa.get_sparsity_config(mode, **kw))


# ---------------------------------------------------------------------------
# (a) layouts and adjacency
# ---------------------------------------------------------------------------

MODES = [
    ("dense", {}),
    ("fixed", dict(num_local_blocks=2, num_global_blocks=1)),
    ("fixed", dict(num_local_blocks=3, num_global_blocks=2)),
    ("bigbird", dict(num_random_blocks=2, num_sliding_window_blocks=5,
                     num_global_blocks=2)),
    ("bslongformer", dict(num_sliding_window_blocks=1,
                          global_block_indices=(0, 3))),
    ("variable", dict(num_global_blocks=2, local_window_blocks=(1, 2, 4))),
]


@pytest.mark.parametrize("mode,kw", MODES,
                         ids=[f"{m}{i}" for i, (m, _) in enumerate(MODES)])
def test_layouts_and_adjacency_match_jax(mode, kw):
    """The same layout for every S and seed (BigBird draws its random
    blocks with the same numpy calls), and the four tables, causal and not,
    on the host and as the device tables."""
    for seed in ((0, 1, 7) if mode == "bigbird" else (None,)):
        extra = {} if seed is None else {"seed": seed}
        jc, tc = _configs(mode, block=16, **kw, **extra)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for S in (16, 64, 160, 512):
            layout = tc.make_layout(S)
            np.testing.assert_array_equal(layout, jc.make_layout(S))
            for causal in (True, False):
                want = jsa._adjacency(jc.make_layout(S), causal)
                host = tsa._cached_adjacency(tc, S, causal)
                dev = tsa.adjacency_tables(tc, S, causal,
                                           torch.device("cpu"))
                for w, h, d in zip(want, host, dev):
                    assert h.dtype == np.int32 and d.dtype == torch.int32
                    np.testing.assert_array_equal(h, w)
                    np.testing.assert_array_equal(d.numpy(), w)
    # the defaults are the JAX ones
    jc, tc = _configs(mode)
    assert type(tc).__name__ == type(jc).__name__
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)


def test_device_tables_are_made_once():
    cfg = tsa.BigBirdSparsityConfig(block=16)
    a = tsa.adjacency_tables(cfg, 64, True, torch.device("cpu"))
    b = tsa.adjacency_tables(tsa.BigBirdSparsityConfig(block=16), 64, True,
                             torch.device("cpu"))
    assert all(x is y for x, y in zip(a, b))
    with pytest.raises(ValueError, match="unknown sparse attention mode"):
        tsa.get_sparsity_config("nope")


WORK_LAYOUTS = [   # the five layout families
    ("dense", {}),
    ("fixed", dict(num_local_blocks=4, num_global_blocks=1)),
    ("bigbird", dict(num_random_blocks=1, num_sliding_window_blocks=3,
                     num_global_blocks=1)),
    ("bslongformer", dict(num_sliding_window_blocks=3,
                          global_block_indices=(0, 5))),
    ("variable", dict(num_global_blocks=1, local_window_blocks=(1, 2, 4))),
]


@pytest.mark.parametrize("mode,kw", WORK_LAYOUTS,
                         ids=[m for m, _ in WORK_LAYOUTS])
@pytest.mark.parametrize("causal", [True, False])
def test_work_list_covers_each_pair_once(mode, kw, causal):
    """B6's and B7's work lists (rows of idx, columns of cidx), at the
    layout's own C and at C = 2: every (output block, listed block) pair
    is walked by exactly one item, no piece is longer than C, the slots of
    the pieces are distinct (0 .. slots - 1, consecutive per block) and
    ``sums`` names them, and the items run longest first."""
    cfg = tsa.get_sparsity_config(mode, block=16, **kw)
    S = 512
    idx, cnt, cidx, ccnt = tsa._cached_adjacency(cfg, S, causal)
    cached = tsa._cached_work(cfg, S, causal)
    for table, counts, own in ((idx, cnt, cached[0]), (cidx, ccnt, cached[1])):
        assert own.chunk == tsa.chunk_length(counts)
        for w in (own, tsa.work_list(counts, 2)):
            items = np.asarray(w.items)
            assert items.dtype == np.int32 and items.shape[1] == 4
            walked = [(o, int(table[o, first + j]))
                      for o, first, n, _ in items for j in range(n)]
            listed = [(o, int(table[o, j]))
                      for o in range(len(counts)) for j in range(counts[o])]
            assert sorted(walked) == sorted(listed)
            assert len(set(walked)) == len(walked)
            assert items[:, 2].max() <= w.chunk
            assert list(items[:, 2]) == sorted(items[:, 2], reverse=True)
            assert sorted(set(items[:, 0])) == list(range(len(counts)))
            slots = items[items[:, 3] >= 0, 3]
            assert sorted(slots) == list(range(w.slots))
            for o, s0, pieces in np.asarray(w.sums):
                mine = items[items[:, 0] == o]
                assert sorted(mine[:, 3]) == list(range(s0, s0 + pieces))
                assert counts[o] > w.chunk and pieces > 1
            split = {int(o) for o in np.asarray(w.sums)[:, 0]}
            assert split == {o for o in range(len(counts))
                             if counts[o] > w.chunk}
    dev = tsa.work_tables(cfg, S, causal, torch.device("cpu"))
    for d, h in zip(dev, cached):
        assert d.items.dtype == torch.int32 and d.slots == h.slots
        np.testing.assert_array_equal(d.items.numpy(), h.items)
        np.testing.assert_array_equal(d.sums.numpy(), h.sums)


def test_work_list_splits_the_global_column():
    """At the BigBird training layout (block 128, S=8192, causal) C is 8:
    the global column (64 query blocks) runs as 8 pieces of 8, and no row
    is split."""
    cfg = tsa.get_sparsity_config("bigbird", block=128, num_random_blocks=1,
                                  num_sliding_window_blocks=3,
                                  num_global_blocks=1)
    rows, cols = tsa._cached_work(cfg, 8192, True)
    assert (rows.chunk, rows.slots, len(rows.sums)) == (8, 0, 0)
    assert cols.chunk == 8 and cols.slots == 8
    np.testing.assert_array_equal(cols.sums, [[0, 0, 8]])
    assert list(cols.items[:8, 2]) == [8] * 8


# ---------------------------------------------------------------------------
# (b) the plain forward, O and LSE
# ---------------------------------------------------------------------------

LAYOUTS = [   # the JAX tests' LAYOUTS, plus Variable
    ("dense", {}),
    ("fixed", dict(num_local_blocks=2, num_global_blocks=1)),
    ("bigbird", dict(num_random_blocks=1, num_sliding_window_blocks=3,
                     num_global_blocks=1)),
    ("bslongformer", dict(num_sliding_window_blocks=3,
                          global_block_indices=(0,))),
    ("variable", dict(num_global_blocks=1, local_window_blocks=(1, 2))),
]


def _qkv(seed, B=2, S=64, N=2, D=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, N, D)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("mode,kw", LAYOUTS, ids=[m for m, _ in LAYOUTS])
def test_plain_forward_matches_jax(mode, kw, causal):
    jc, tc = _configs(mode, block=16, **kw)
    q, k, v, _ = _qkv(3 + int(causal))
    before = _build.launch_counts()
    o, lse = tsa.sparse_attention_fwd(_t(q), _t(k), _t(v), tc, causal=causal)
    assert _build.launch_counts() == before          # CPU: the plain version
    assert o.shape == q.shape and lse.shape == (2, 2, 64, 1)
    idx, cnt, _, _ = jsa._adjacency(jc.make_layout(64), causal)
    jo, jlse = jsa._sp_fwd(_sw(q), _sw(k), _sw(v), jnp.asarray(idx),
                           jnp.asarray(cnt), 0.25, causal, 16)
    assert rel_l2(_np(o), _np(_sw(jo))) <= TOL["float32"]
    assert rel_l2(_np(lse), _np(jlse)) <= TOL["float32"]
    ref = jsa.reference_sparse_attention(_j(q), _j(k), _j(v), jc,
                                         causal=causal)
    assert rel_l2(_np(o), _np(ref)) <= TOL["float32"]


@pytest.mark.parametrize("mode,causal", [("bigbird", True),
                                         ("fixed", False)])
def test_plain_forward_bf16_matches_jax(mode, causal):
    kw = dict(LAYOUTS)[mode]
    jc, tc = _configs(mode, block=16, **kw)
    q, k, v, _ = _qkv(11)
    o = tsa.sparse_attention(_t(q, "bfloat16"), _t(k, "bfloat16"),
                             _t(v, "bfloat16"), tc, causal=causal)
    jo = jsa.sparse_attention(_j(q, "bfloat16"), _j(k, "bfloat16"),
                              _j(v, "bfloat16"), jc, causal=causal)
    assert o.dtype == torch.bfloat16
    assert rel_l2(_np(o), _np(jo)) <= TOL["bfloat16"]


def test_empty_list_gives_zero_and_neg_inf_lse():
    """A layout row with no listed block (a subclass can make one): O is 0
    and the LSE NEG_INF, as the TPU kernel's loop that never runs leaves
    them; its gradients are 0 too."""

    @dataclasses.dataclass(frozen=True)
    class Holey(tsa.SparsityConfig):
        def make_layout(self, seq_len):
            L = np.ones((seq_len // self.block,) * 2, bool)
            L[1] = False
            return L
    cfg = Holey(block=16)
    q, k, v, w = (_t(a).requires_grad_() for a in _qkv(5))
    o = tsa.sparse_attention(q, k, v, cfg, causal=False)
    _, lse = tsa.sparse_attention_reference(q, k, v, cfg, causal=False)
    assert torch.all(o[:, 16:32] == 0)
    assert torch.all(lse[:, :, 16:32] == tsa.NEG_INF)
    dq, = torch.autograd.grad((o * w).sum(), (q,))
    assert torch.all(dq[:, 16:32] == 0) and torch.isfinite(dq).all()


# ---------------------------------------------------------------------------
# (c) the plain backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,causal", [("fixed", True), ("bigbird", True),
                                         ("bslongformer", False),
                                         ("variable", True)])
def test_plain_backward_matches_jax_grad(mode, causal):
    """dQ, dK, dV of sum(O * W) through the port's autograd Function (the
    plain B6 + B7) against ``jax.grad`` through the JAX ``custom_vjp``
    (Pallas, interpret mode), and against torch autograd through the plain
    forward's own ops."""
    kw = dict(LAYOUTS)[mode]
    jc, tc = _configs(mode, block=16, **kw)
    q, k, v, w = _qkv(17, B=1, N=2)

    def f(q_, k_, v_):
        return jnp.sum(jsa.sparse_attention(q_, k_, v_, jc, causal=causal)
                       * jnp.asarray(w))
    want = jax.grad(f, argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    o = tsa.sparse_attention(*leaves, tc, causal=causal)
    got = torch.autograd.grad((o * _t(w)).sum(), leaves)
    o2, _ = tsa.sparse_attention_reference(*leaves, tc, causal=causal)
    auto = torch.autograd.grad((o2 * _t(w)).sum(), leaves)
    for name, a, b, c in zip("qkv", got, want, auto):
        assert rel_l2(_np(a), _np(b)) <= TOL["float32"], f"d{name}"
        assert rel_l2(_np(a), _np(c)) <= TOL["float32"], f"d{name}"


def test_bwd_parts_pick_the_gradients():
    _, tc = _configs("bigbird", block=16)
    q, k, v, do = (_t(a) for a in _qkv(2))
    o, lse = tsa.sparse_attention_fwd(q, k, v, tc)
    full = tsa.sparse_attention_bwd(q, k, v, o, lse, do, tc)
    dq, dk, dv = tsa.sparse_attention_bwd(q, k, v, o, lse, do, tc,
                                          parts=("dq",))
    assert dk is None and dv is None and torch.equal(dq, full[0])
    dq, dk, dv = tsa.sparse_attention_bwd(q, k, v, o, lse, do, tc,
                                          parts=("dkv",))
    assert dq is None and torch.equal(dk, full[1]) and torch.equal(dv,
                                                                   full[2])


# ---------------------------------------------------------------------------
# (d) the model: loss and every gradient of a sparse GQA llama
# ---------------------------------------------------------------------------

SPARSE = {"mode": "bigbird", "block": 16, "num_random_blocks": 1,
          "num_sliding_window_blocks": 3, "num_global_blocks": 1}
VOCAB, S, B = 256, 64, 2


def _model_cfgs(**kw):
    """A 2-layer GQA llama (4 query / 2 kv heads, head_dim 16), f32."""
    base = dict(vocab_size=VOCAB, num_layers=2, max_seq_len=S,
                hidden_size=64, num_heads=4, num_kv_heads=2,
                intermediate_size=128, sparse_attention=SPARSE)
    base.update(kw)
    return (jt.llama_config("tiny", dtype=jnp.float32, **base),
            tt.llama_config("tiny", dtype=torch.float32, **base))


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _batch(masked):
    batch = {"input_ids": np.random.default_rng(2).integers(
        0, VOCAB, (B, S), dtype=np.int32)}
    if masked:
        mask = np.ones((B, S), np.int32)
        mask[1, S - 20:] = 0
        batch["attention_mask"] = mask
    return batch


@pytest.mark.parametrize("masked", [False, True])
def test_sparse_model_loss_and_grads_match_jax(masked, monkeypatch):
    """Without a key mask both sides run block-sparse attention (K/V
    repeated over the group); with one, both take the dense route (the
    port's flash kernels, the JAX XLA branch)."""
    jcfg, tcfg = _model_cfgs()
    p = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    batch = _batch(masked)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda q: jt.lm_loss(
        q, jax.tree.map(jnp.asarray, batch), jcfg)))(
            jax.tree.map(jnp.asarray, p))
    routes = {"sparse": 0, "flash": 0}
    for name, mod, fn in (("sparse", tsa, "sparse_attention_fwd"),
                          ("flash", port_flash, "flash_attention_fwd")):
        orig = getattr(mod, fn)

        def counting(*a, _orig=orig, _name=name, **k):
            routes[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(mod, fn, counting)
    tp = params_from_numpy(p, tcfg, device="cpu", dtype=torch.float32)
    leaves = _leaves(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tt.lm_loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                      tcfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    L = tcfg.num_layers
    assert routes == ({"sparse": 0, "flash": L} if masked
                      else {"sparse": L, "flash": 0})
    want = float(jloss)
    assert abs(float(loss.detach()) - want) <= 1e-5 * abs(want)
    jl = _leaves(jax.tree.map(np.asarray, jgrads))
    assert set(grads) == set(jl)
    for name, g in grads.items():
        assert rel_l2(_np(g), jl[name]) <= 1e-5, name


def test_sparse_model_left_padded_rows_that_see_a_key_match_jax():
    """A sparse config with a left-padding key mask takes the dense route
    on both sides: the port's flash kernels, JAX's XLA branch. A query row
    that sees no key (batch row 1's first 4) gets O = 0 in the port and the
    mean of V in JAX's XLA branch (``models/transformer.attention``'s
    docstring), so only the rows that see a key are compared: their logits
    agree, since no later row reads a masked key's output."""
    jcfg, tcfg = _model_cfgs()
    p = jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), jcfg))
    ids = _batch(False)["input_ids"]
    mask = np.ones((B, S), np.int32)
    mask[1, :4] = 0
    want = np.asarray(jt.forward(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(ids), jcfg,
                                 attention_mask=jnp.asarray(mask)))
    tp = params_from_numpy(p, tcfg, device="cpu", dtype=torch.float32)
    got = tt.forward(tp, torch.from_numpy(ids), tcfg,
                     attention_mask=torch.from_numpy(mask)).numpy()
    sees = np.ones((B, S), bool)
    sees[1, :4] = False
    assert np.isfinite(got).all()
    assert rel_l2(got[sees], want[sees]) <= TOL["float32"]


# ---------------------------------------------------------------------------
# (e) the whole slice: initialize -> train_batch, engine against engine
# ---------------------------------------------------------------------------

def test_sparse_engine_matches_jax_engine():
    jcfg, tcfg = _model_cfgs()
    conf = {"train_batch_size": 2,
            "optimizer": {"type": "adamw", "params": {"lr": 1e-3}},
            "bf16": {"enabled": False}, "zero_optimization": {"stage": 1},
            "gradient_clipping": 1.0}
    je, *_ = deepspeed_tpu.initialize(model=jt.make_model(jcfg),
                                      config=dict(conf),
                                      devices=jax.devices()[:1])
    p0 = jax.tree.map(np.asarray,
                      jt.make_model(jcfg).init(jax.random.PRNGKey(42)))
    te, *_ = deepspeed_tpu_torch.initialize(model=tt.make_model(tcfg),
                                            config=dict(conf), params=p0,
                                            device="cpu")
    rng = np.random.default_rng(0)
    for step in range(2):
        batch = {"input_ids": rng.integers(0, VOCAB, (2, S), dtype=np.int32)}
        jl = float(je.train_batch(batch)["loss"])
        tl = float(te.train_batch(batch)["loss"])
        assert abs(tl - jl) <= 1e-5 * abs(jl), step


# ---------------------------------------------------------------------------
# (f) what the slice refuses
# ---------------------------------------------------------------------------

def test_indivisible_seq_raises():
    q = torch.zeros((1, 60, 2, 16))
    cfg = tsa.FixedSparsityConfig(block=16)
    for call in (lambda: tsa.sparse_attention(q, q, q, cfg),
                 lambda: tsa.sparse_attention(q, q, q, cfg, reference=True),
                 lambda: tsa.sparse_attention_fwd(q, q, q, cfg)):
        with pytest.raises(ValueError, match="divisible"):
            call()


def test_serving_a_sparse_model_raises():
    _, tcfg = _model_cfgs()
    model = tt.make_model(tcfg)
    with pytest.raises(NotImplementedError, match="A10b"):
        deepspeed_tpu_torch.init_serving(model, serving=dict(max_seqs=1),
                                         device="cpu", dtype=torch.float32)
    eng = deepspeed_tpu_torch.init_inference(model, device="cpu",
                                             dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="A10b"):
        ServingEngine(eng)
    with pytest.raises(NotImplementedError, match="A10b"):
        tt.prefill_paged(eng.params, torch.zeros((1, 16), dtype=torch.long),
                         eng.model.config, {"k": torch.zeros(1)}, [1])


def test_wrappers_refuse_other_devices():
    q = torch.empty((1, 64, 2, 64), device="meta")
    cfg = tsa.BigBirdSparsityConfig(block=16)
    with pytest.raises(ValueError, match="runs on cuda"):
        tsa.sparse_attention(q, q, q, cfg)
    with pytest.raises(ValueError, match="runs on cuda"):
        tsa.sparse_attention_bwd(q, q, q, q, q[..., :1], q, cfg)


# ---------------------------------------------------------------------------
# (g) remat: B5 is replayed under both selective policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy,replays", [
    ("none", False), ("full", True), ("dots_saveable", True),
    ("dots_and_attn", True)])
def test_remat_policy_replays_sparse_forward(policy, replays, monkeypatch):
    """The sparse forward (B5, counted through its wrapper) is no custom op
    that a policy can keep: ``dots_and_attn`` replays it like
    ``dots_saveable``, as the JAX policies (which name only the flash
    outputs) replay the sparse kernel."""
    calls = []
    fwd = tsa.sparse_attention_fwd

    def counting(*a, **k):
        calls.append(1)
        return fwd(*a, **k)
    monkeypatch.setattr(tsa, "sparse_attention_fwd", counting)
    jcfg, tcfg = _model_cfgs()
    cfg = dataclasses.replace(tcfg, remat=policy != "none",
                              remat_policy=policy)
    tp = params_from_numpy(jax.tree.map(np.asarray, jt.init_params(
        jax.random.PRNGKey(1), jcfg)), cfg, device="cpu", dtype=torch.float32)
    leaves = list(_leaves(tp).values())
    for t in leaves:
        t.requires_grad_(True)
    loss = tt.lm_loss(tp, {"input_ids": torch.from_numpy(
        _batch(False)["input_ids"])}, cfg)
    L = cfg.num_layers
    assert len(calls) == L
    torch.autograd.grad(loss, leaves)
    assert len(calls) == (2 * L if replays else L)
