"""The split walks of the port's paged decode (B4) and block-sparse forward
(B5) against the JAX package's kernels.

Both CUDA kernels cut long walks into pieces that write f32 partials and
merge them in a second pass by the log-sum-exp rule. Their host-side plans
(``decode_pieces``; B6's row work list for B5) and plain PyTorch versions
of both passes (``decode_pieces_reference`` / ``decode_merge_reference``,
``sparse_pieces_reference`` / ``sparse_merge_reference``) sit beside the
kernels; here they run piecewise through those plans, at small widths, and
are held against the JAX kernels run as the JAX tests run them on the CPU
(Pallas in interpret mode), on the same numpy-seeded inputs. Tolerance:
relative L2 <= 1e-5 at f32 (other summation order); an empty slot and an
empty list are held exactly. A piece that is empty (past its slot's
length) is never written: its workspace entries stay NaN, so a merge that
read it would poison the output.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import decode_attention as jax_decode
from deepspeed_tpu.ops import sparse_attention as jsa
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import sparse_attention as tsa

from tests import _torch_cpu  # noqa: F401  (torch threads under xdist)

TOL = 1e-5


def rel_l2(got, want):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# B4: pieces of R rows, merged in piece order, the fresh row last
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("MB,bs,rows,want", [
    (32, 64, 256, (256, 8)),     # the serving path: 4 blocks of 64
    (4, 24, 256, (240, 1)),      # R rounds down to whole blocks
    (6, 16, 32, (32, 3)),
    (5, 16, 40, (32, 3)),        # the last piece is part of a piece
    (2, 300, 256, (300, 2)),     # a block longer than R: one block a piece
])
def test_decode_piece_geometry(MB, bs, rows, want):
    R, P = tda.decode_pieces(MB, bs, rows)
    assert (R, P) == want
    assert R % bs == 0 and (P - 1) * R < MB * bs <= P * R


@pytest.mark.parametrize("rep", [1, 4])
def test_decode_split_matches_jax(rep):
    """Lengths 0, 1, R - 1, R, R + 1, MB bs and MB bs + 3 (past the table:
    read as MB bs, as the JAX kernel's MB blocks), pieces of R = 32 rows
    over blocks of 16: against the JAX kernel; the empty slot exactly
    v_row; each slot's pieces written below ceil(len / R) and no others."""
    S, MB, Nkv, bs, D, rows = 7, 6, 2, 16, 64, 32
    NB = S * MB + 1
    rng = np.random.default_rng(rep)
    q = rng.standard_normal((S, 1, Nkv * rep, D)).astype(np.float32)
    kp = rng.standard_normal((NB, Nkv, bs, D)).astype(np.float32)
    vp = rng.standard_normal((NB, Nkv, bs, D)).astype(np.float32)
    kp[0] = vp[0] = 1e4                  # the trash block holds garbage
    kr = rng.standard_normal((S, Nkv, 1, D)).astype(np.float32)
    vr = rng.standard_normal((S, Nkv, 1, D)).astype(np.float32)
    tables = rng.permutation(np.arange(1, NB)).reshape(S, MB).astype(np.int32)
    R, P = tda.decode_pieces(MB, bs, rows)
    lens = np.array([0, 1, R - 1, R, R + 1, MB * bs, MB * bs + 3], np.int32)
    for s, n in enumerate(lens):         # stale rows past each length
        if n < MB * bs and n % bs:
            kp[tables[s, n // bs], :, n % bs:] = 1e4
            vp[tables[s, n // bs], :, n % bs:] = 1e4
    t = [torch.from_numpy(a) for a in (q, kp, vp, tables, lens, kr, vr)]
    scale = D ** -0.5
    ws = tda.decode_pieces_reference(*t[:5], sm_scale=scale, rows=rows)
    assert ws.shape == (S, Nkv, P, rep, D + 2)
    for s, n in enumerate(lens):
        written = -(-min(int(n), MB * bs) // R)
        assert not torch.isnan(ws[s, :, :written]).any()
        assert torch.isnan(ws[s, :, written:]).all()
    got = tda.decode_merge_reference(ws, t[0], t[4], MB * bs, R,
                                     kv_row=(t[5], t[6]), sm_scale=scale)
    assert torch.equal(got, tda.paged_decode_split_reference(
        *t[:5], kv_row=(t[5], t[6]), rows=rows))
    want = jax_decode.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lens)),
        kv_row=(jnp.asarray(kr), jnp.asarray(vr)))
    assert rel_l2(_np(got), _np(want)) <= TOL
    assert torch.equal(got[0, 0], t[6][0, :, 0].repeat_interleave(rep, 0))
    assert float(got.abs().max()) < 100.0


def test_decode_merge_folds_the_fresh_row_last():
    """A slot whose pool scores are far below the fresh row's: the merge's
    running max is the fresh row's and every piece's weight underflows to
    0, so the output is v_row to f32 rounding; with the pieces' scores far
    above, the fresh row's weight is 0 and the output is the pool's."""
    S, MB, Nkv, rep, bs, D, rows = 1, 4, 1, 1, 16, 64, 32
    rng = np.random.default_rng(7)
    q = torch.from_numpy(np.full((S, 1, Nkv * rep, D), 1.0, np.float32))
    kp = torch.from_numpy(rng.standard_normal((MB + 1, Nkv, bs, D))
                          .astype(np.float32))
    vp = torch.from_numpy(rng.standard_normal((MB + 1, Nkv, bs, D))
                          .astype(np.float32))
    tables = torch.arange(1, MB + 1, dtype=torch.int32)[None]
    lens = torch.tensor([MB * bs], dtype=torch.int32)
    vr = torch.from_numpy(rng.standard_normal((S, Nkv, 1, D))
                          .astype(np.float32))
    for sign in (1.0, -1.0):
        kr = torch.full((S, Nkv, 1, D), 200.0 * sign)
        got = tda.paged_decode_split_reference(q, kp, vp, tables, lens,
                                               kv_row=(kr, vr), rows=rows)
        want = tda.paged_decode_reference(q, kp, vp, tables, lens,
                                          kv_row=(kr, vr))
        assert rel_l2(_np(got), _np(want)) <= TOL
        if sign > 0:
            assert rel_l2(_np(got[0, 0]), _np(vr[0, :, 0])) <= 1e-6


# ---------------------------------------------------------------------------
# B5: B6's row work list, split rows merged in slot order
# ---------------------------------------------------------------------------

def _qkv(seed, B, S, N, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, N, D)).astype(np.float32)
            for _ in range(3)]


def _jax_fwd(cfg_layout, q, k, v, causal, block, scale):
    idx, cnt, _, _ = jsa._adjacency(cfg_layout, causal)
    sw = [jnp.swapaxes(jnp.asarray(a), 1, 2) for a in (q, k, v)]
    o, lse = jsa._sp_fwd(*sw, jnp.asarray(idx), jnp.asarray(cnt), scale,
                         causal, block)
    return np.swapaxes(_np(o), 1, 2), _np(lse)


@pytest.mark.parametrize("causal", [False, True])
def test_sparse_split_matches_jax(causal):
    """BigBird (window 1, one random and one global block) at S=256, block
    16: non-causal, the global row lists all 16 key blocks against a mean
    of ~3.5, so the row work list (C = 8) cuts it into two pieces whose
    merge writes query block 0; causal, nothing is split. O and LSE
    against the JAX kernel; the work list is B6's."""
    B, S, N, D, block = 2, 256, 2, 16, 16
    kw = dict(block=block, num_random_blocks=1, num_sliding_window_blocks=1,
              num_global_blocks=1)
    tc = tsa.get_sparsity_config("bigbird", **kw)
    jc = jsa.get_sparsity_config("bigbird", **kw)
    q, k, v = _qkv(21 + int(causal), B, S, N, D)
    scale = D ** -0.5
    o, lse, partials, work = tsa.sparse_pieces_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), tc, causal=causal,
        sm_scale=scale)
    rows = tsa.work_tables(tc, S, causal, torch.device("cpu"))[0]
    assert np.array_equal(np.array(work.items), rows.items.numpy())
    if causal:
        assert work.slots == 0
    else:
        assert work.chunk == 8
        assert np.array(work.sums).tolist() == [[0, 0, 2]]
        # before the merge, the split block holds nothing the pieces wrote
        assert torch.all(o[:, :, 0] == 0)
        assert not torch.isnan(partials[0]).any()
    o, lse = tsa.sparse_merge_reference(o, lse, partials, work)
    got_o = tsa._unblock(o).numpy()
    got_lse = lse.reshape(B, N, S, 1).numpy()
    want_o, want_lse = _jax_fwd(jc.make_layout(S), q, k, v, causal, block,
                                scale)
    assert rel_l2(got_o, want_o) <= TOL
    assert rel_l2(got_lse, want_lse) <= TOL
    split_o, split_lse = tsa.sparse_attention_split_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), tc, causal=causal,
        sm_scale=scale)
    assert np.array_equal(split_o.numpy(), got_o)
    assert np.array_equal(split_lse.numpy(), got_lse)


def test_sparse_split_empty_list_and_split_row():
    """A layout with a global row (every key block) and a row that lists
    nothing: the global row is split into pieces, the empty row's item
    walks nothing. The empty row comes out O = 0 and LSE exactly -1e30 (as
    the JAX kernel's loop that never runs leaves it), the rest as the JAX
    kernel's."""

    @dataclasses.dataclass(frozen=True)
    class GlobalAndHole(tsa.SparsityConfig):
        def make_layout(self, seq_len):
            n = seq_len // self.block
            L = np.eye(n, dtype=bool)
            L[0] = True                  # the global row
            L[2] = False                 # a row that lists nothing
            return L

    B, S, N, D, block = 1, 256, 2, 16, 16
    cfg = GlobalAndHole(block=block)
    q, k, v = _qkv(5, B, S, N, D)
    scale = D ** -0.5
    work = tsa._cached_work(cfg, S, False)[0]
    assert work.slots > 1 and np.array(work.sums)[0, 0] == 0
    assert [2, 0, 0, -1] in np.array(work.items).tolist()
    got_o, got_lse = tsa.sparse_attention_split_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), cfg, causal=False,
        sm_scale=scale)
    want_o, want_lse = _jax_fwd(cfg.make_layout(S), q, k, v, False, block,
                                scale)
    hole = slice(2 * block, 3 * block)
    assert torch.all(got_o[:, hole] == 0)
    assert torch.all(got_lse[:, :, hole] == tsa.NEG_INF)
    assert np.all(want_lse[:, :, hole] == tsa.NEG_INF)
    assert rel_l2(got_o.numpy(), want_o) <= TOL
    live = np.ones(S, bool)
    live[hole] = False
    assert rel_l2(got_lse.numpy()[:, :, live], want_lse[:, :, live]) <= TOL
