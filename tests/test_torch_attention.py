"""The port's attention ops against the JAX package's.

On the CPU the wrappers take their plain versions, so these hold the
plain flash forward, the plain flash backward (through the port's
autograd Function) and the plain paged decode against the JAX kernels
(Pallas in interpret mode, off TPU; ``jax.grad`` through the JAX
``custom_vjp`` for the backward) and the JAX gather path. The same
inputs, made from a seed with numpy, go to both. Tolerances: relative L2
<= 1e-5 at f32, <= 2e-2 at bf16 (bf16 rounds at different places in the
two frameworks). ``test_torch_kernels.py`` holds the CUDA kernels against
these plain versions on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models.transformer import _paged_attention
from deepspeed_tpu.ops import decode_attention as jax_decode
from deepspeed_tpu.ops import flash_attention as jax_flash
from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.decode_attention import paged_decode_attention
from deepspeed_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_reference)

TOL = {np.float32: 1e-5, "bfloat16": 2e-2}


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _t(a, dtype):
    """numpy f32 -> torch tensor of the case dtype (bf16 rounds once)."""
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _j(a, dtype):
    x = jnp.asarray(np.array(a, np.float32))
    return x.astype(jnp.bfloat16) if dtype == "bfloat16" else x


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# flash forward (B1)
# ---------------------------------------------------------------------------

def _flash_case(seed, B, S, N, Nkv, D, mask_kind=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, N, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Nkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Nkv, D)).astype(np.float32)
    mask = None
    if mask_kind == "padding":        # right padding of different lengths
        lens = rng.integers(S // 2, S, size=B)
        mask = (np.arange(S)[None, :] < lens[:, None])
    elif mask_kind == "first_key":    # causal row 0 sees only key 0: masked
        mask = np.ones((B, S), bool)
        mask[:, 0] = False
    return q, k, v, mask


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("mask_kind", [None, "padding", "first_key"])
def test_flash_fwd_matches_jax(causal, rep, mask_kind):
    B, S, Nkv, D = 2, 128, 2, 64
    q, k, v, mask = _flash_case(7 * rep + int(causal), B, S, Nkv * rep, Nkv,
                                D, mask_kind)
    sm = 1.0 / np.sqrt(D)
    tmask = None if mask is None else torch.from_numpy(mask)
    o, lse = flash_attention_fwd(_t(q, np.float32), _t(k, np.float32),
                                 _t(v, np.float32), causal=causal,
                                 sm_scale=sm, kv_mask=tmask)
    jmask = None
    if mask is not None:
        jmask = jnp.broadcast_to(jnp.asarray(mask, jnp.float32)[:, None, :],
                                 (B, 8, S))
    tr = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)      # noqa: E731
    jo, jlse = jax_flash._fwd(tr(q), tr(k), tr(v), jmask, sm, causal,
                              jax_flash.DEFAULT_BLOCK_Q,
                              jax_flash.DEFAULT_BLOCK_K)
    assert rel_l2(_np(o), _np(tr(jo))) <= TOL[np.float32]
    # LSE by relative L2 over the rows that see a key only: a fully masked
    # row's M_FLOOR = -1e20 would swamp any error in the others
    keep = np.tril(np.ones((S, S), bool)) if causal else np.ones((S, S), bool)
    keep = keep[None] if mask is None else keep[None] & mask[:, None, :]
    live = np.broadcast_to(keep.any(-1), (B, S))            # [B, S]
    by_row = np.swapaxes(_np(lse)[..., 0], 1, 2)            # [B, S, N]
    j_row = np.swapaxes(_np(jlse)[..., 0], 1, 2)
    assert rel_l2(by_row[live], j_row[live]) <= TOL[np.float32]
    assert live.all() == (mask_kind != "first_key" or not causal)
    # a fully masked row outputs 0 with LSE M_FLOOR, as the TPU kernel
    assert np.all(_np(o)[~live] == 0)
    assert np.all(by_row[~live] == jax_flash.M_FLOOR)
    assert np.all(j_row[~live] == jax_flash.M_FLOOR)


def test_flash_bf16_matches_jax_public_api():
    B, S, N, Nkv, D = 1, 256, 8, 2, 128
    q, k, v, _ = _flash_case(3, B, S, N, Nkv, D)
    o = flash_attention(_t(q, "bfloat16"), _t(k, "bfloat16"),
                        _t(v, "bfloat16"), causal=True)
    jo = jax_flash.flash_attention(_j(q, "bfloat16"), _j(k, "bfloat16"),
                                   _j(v, "bfloat16"), causal=True)
    assert o.dtype == torch.bfloat16
    assert rel_l2(_np(o), _np(jo)) <= TOL["bfloat16"]


def test_flash_reference_is_reference_attention():
    """Without masked rows the plain version is the JAX
    ``reference_attention`` (softmax over the visible keys)."""
    q, k, v, _ = _flash_case(5, 1, 64, 4, 1, 64)
    o, _ = flash_attention_reference(_t(q, np.float32), _t(k, np.float32),
                                     _t(v, np.float32), causal=True)
    ref = jax_flash.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=True)
    assert rel_l2(_np(o), _np(ref)) <= TOL[np.float32]


# ---------------------------------------------------------------------------
# flash backward (B2 dQ, B3 dK/dV) through the autograd Function
# ---------------------------------------------------------------------------

# causal, rep, D, mask_kind, fused: covers causal and not, rep 1/2/4, D
# 64/128, padding and a fully masked row, delta fused and unfused
BWD_CASES = [(True, 1, 64, None, False), (True, 2, 128, "padding", True),
             (True, 4, 64, "first_key", False), (True, 4, 128, "first_key", True),
             (False, 1, 128, "padding", True), (False, 2, 64, None, False),
             (False, 4, 64, "padding", True), (True, 2, 64, "padding", False)]


def _bwd_grads(q, k, v, do, mask, causal, fused, dtype):
    qt, kt, vt = (_t(a, dtype).requires_grad_() for a in (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    o = flash_attention(qt, kt, vt, causal=causal, kv_mask=tmask,
                        fused_backward=fused)
    o.backward(_t(do, dtype))
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(a, b, c):
        out = jax_flash.flash_attention(a, b, c, causal=causal, kv_mask=jmask,
                                        fused_backward=fused)
        return jnp.sum(out.astype(jnp.float32) * _j(do, dtype)
                       .astype(jnp.float32))
    jg = jax.grad(loss, argnums=(0, 1, 2))(_j(q, dtype), _j(k, dtype),
                                           _j(v, dtype))
    return (qt.grad, kt.grad, vt.grad), jg


@pytest.mark.parametrize("causal,rep,D,mask_kind,fused", BWD_CASES)
def test_flash_bwd_matches_jax_grad(causal, rep, D, mask_kind, fused):
    B, S, Nkv = 2, 128, 2
    q, k, v, mask = _flash_case(11 * rep + D, B, S, Nkv * rep, Nkv, D,
                                mask_kind)
    do = np.random.default_rng(D + rep).standard_normal(q.shape) \
        .astype(np.float32)
    got, want = _bwd_grads(q, k, v, do, mask, causal, fused, np.float32)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert rel_l2(_np(a), _np(b)) <= TOL[np.float32], name
    if mask_kind == "first_key" and causal:
        assert torch.all(got[0][:, 0] == 0)      # fully masked row: dQ = 0


@pytest.mark.parametrize("fused", [False, True])
def test_flash_bwd_bf16_matches_jax_grad(fused):
    B, S, N, Nkv, D = 1, 128, 8, 2, 128
    q, k, v, mask = _flash_case(13, B, S, N, Nkv, D, "padding")
    do = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    got, want = _bwd_grads(q, k, v, do, mask, True, fused, "bfloat16")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        assert rel_l2(_np(a), _np(b)) <= TOL["bfloat16"], name


def test_flash_bwd_reference_is_autograd_of_forward():
    """The plain backward (the kernels' decomposition written out) equals
    autograd through the plain forward's arithmetic."""
    q, k, v, mask = _flash_case(17, 2, 64, 4, 2, 64, "padding")
    do = torch.from_numpy(np.random.default_rng(4).standard_normal(q.shape)
                          .astype(np.float32))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tmask = torch.from_numpy(mask)
    o, lse = flash_attention_reference(qt, kt, vt, kv_mask=tmask)
    o.backward(do)
    got = flash_attention_bwd_reference(qt.detach(), kt.detach(), vt.detach(),
                                        o.detach(), lse, do, kv_mask=tmask)
    for a, b in zip(got, (qt.grad, kt.grad, vt.grad)):
        assert rel_l2(_np(a), _np(b)) <= TOL[np.float32]


# ---------------------------------------------------------------------------
# paged decode (B4)
# ---------------------------------------------------------------------------

def _decode_case(seed, S, NB, MB, Nkv, rep, bs, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, 1, Nkv * rep, D)).astype(np.float32)
    k_pool = rng.standard_normal((NB, Nkv, bs, D)).astype(np.float32)
    v_pool = rng.standard_normal((NB, Nkv, bs, D)).astype(np.float32)
    k_row = rng.standard_normal((S, Nkv, 1, D)).astype(np.float32)
    v_row = rng.standard_normal((S, Nkv, 1, D)).astype(np.float32)
    # distinct non-trash blocks per slot, shuffled: a real permutation
    tables = rng.permutation(np.arange(1, NB))[:S * MB].reshape(S, MB)
    return q, k_pool, v_pool, tables.astype(np.int32), k_row, v_row


def _port_decode(q, kp, vp, tables, lens, kr, vr, dtype):
    return paged_decode_attention(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype),
        torch.from_numpy(tables), torch.from_numpy(np.asarray(lens, np.int32)),
        kv_row=(_t(kr, dtype), _t(vr, dtype)))


def _jax_decode(q, kp, vp, tables, lens, kr, vr, dtype):
    args = (_j(q, dtype), _j(kp, dtype), _j(vp, dtype),
            jnp.asarray(tables), jnp.asarray(lens, jnp.int32))
    kv = (_j(kr, dtype), _j(vr, dtype))
    kernel = jax_decode.paged_decode_attention(*args, kv_row=kv)
    gather = _paged_attention(*args, None, kv_row=kv, backend="xla")
    return kernel, gather


@pytest.mark.parametrize("lens", [[0, 1], [5, 37], [32, 64], [64, 63]])
@pytest.mark.parametrize("rep", [1, 4])
def test_paged_decode_matches_jax(lens, rep):
    """Empty slot, partial block, exact block boundary, full table."""
    S, NB, MB, Nkv, bs, D = 2, 8, 2, 2, 32, 64
    case = _decode_case(sum(lens) * 7 + rep, S, NB, MB, Nkv, rep, bs, D)
    got = _port_decode(*case[:4], lens, *case[4:], np.float32)
    kernel, gather = _jax_decode(*case[:4], lens, *case[4:], np.float32)
    assert rel_l2(_np(got), _np(kernel)) <= TOL[np.float32]
    assert rel_l2(_np(got), _np(gather)) <= TOL[np.float32]


def test_paged_decode_bf16_matches_jax():
    S, NB, MB, Nkv, rep, bs, D = 2, 10, 3, 4, 2, 32, 128
    case = _decode_case(11, S, NB, MB, Nkv, rep, bs, D)
    lens = [70, 96]
    got = _port_decode(*case[:4], lens, *case[4:], "bfloat16")
    kernel, gather = _jax_decode(*case[:4], lens, *case[4:], "bfloat16")
    assert got.dtype == torch.bfloat16
    assert rel_l2(_np(got), _np(kernel)) <= TOL["bfloat16"]
    assert rel_l2(_np(got), _np(gather)) <= TOL["bfloat16"]


def test_paged_decode_ignores_trash_and_stale_rows():
    """Block 0 and rows past each slot's length hold 1e4 garbage (freed
    blocks are reused without zeroing): none of it may reach the output,
    and an empty slot with an all-trash table outputs exactly v_row."""
    S, NB, MB, Nkv, rep, bs, D = 2, 6, 2, 2, 1, 32, 64
    q, kp, vp, tables, kr, vr = _decode_case(3, S, NB, MB, Nkv, rep, bs, D)
    kp[0] = vp[0] = 1e4
    tables[1] = 0
    kp[tables[0, 1], :, 8:] = vp[tables[0, 1], :, 8:] = 1e4
    lens = [40, 0]
    got = _port_decode(q, kp, vp, tables, lens, kr, vr, np.float32)
    kernel, gather = _jax_decode(q, kp, vp, tables, lens, kr, vr, np.float32)
    assert rel_l2(_np(got), _np(kernel)) <= TOL[np.float32]
    assert rel_l2(_np(got), _np(gather)) <= TOL[np.float32]
    assert float(got.abs().max()) < 100.0
    assert torch.equal(got[1], torch.from_numpy(vr[1]).reshape(1, Nkv * rep,
                                                                D))


def test_paged_decode_table_permutation_invariance():
    S, NB, MB, Nkv, rep, bs, D = 1, 9, 4, 2, 2, 32, 64
    q, kp, vp, _, kr, vr = _decode_case(5, S, NB, MB, Nkv, rep, bs, D)
    t1 = np.asarray([[1, 2, 3, 4]], np.int32)
    t2 = np.asarray([[5, 7, 6, 8]], np.int32)
    kp2, vp2 = kp.copy(), vp.copy()
    for a, b in zip(t1[0], t2[0]):
        kp2[b], vp2[b] = kp[a], vp[a]
    o1 = _port_decode(q, kp, vp, t1, [100], kr, vr, np.float32)
    o2 = _port_decode(q, kp2, vp2, t2, [100], kr, vr, np.float32)
    assert torch.equal(o1, o2)


def test_cpu_dispatch_counts_no_launch():
    """A CPU tensor takes the plain version: no kernel launch is counted."""
    _build.reset_launch_counts()
    q, k, v, _ = _flash_case(1, 1, 64, 2, 2, 64)
    qt, kt, vt = (_t(a, np.float32).requires_grad_() for a in (q, k, v))
    flash_attention(qt, kt, vt).sum().backward()
    counts = _build.launch_counts()
    assert set(counts) == {"flash_fwd", "paged_decode", "flash_bwd_dq",
                           "flash_bwd_dkv", "sparse_fwd", "sparse_bwd_dq",
                           "sparse_bwd_dkv"}
    assert not any(counts.values())
