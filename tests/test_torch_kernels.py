"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU (marker ``cuda``) and skips
without one; this file imports neither jax nor the JAX package, so it runs
on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

Tolerances: relative L2 <= 2e-2 at bf16 (the kernel and the plain version
round at different places), <= 1e-4 at f32 (other summation order).
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import _build
from deepspeed_tpu_torch.ops.decode_attention import (paged_decode_attention,
                                                      paged_decode_reference)
from deepspeed_tpu_torch.ops.flash_attention import (
    M_FLOOR, flash_attention, flash_attention_bwd,
    flash_attention_bwd_reference, flash_attention_fwd,
    flash_attention_reference)
from deepspeed_tpu_torch.ops import sparse_attention as tsa

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def rel_l2(got, want):
    got = got.double().cpu().ravel()
    want = want.double().cpu().ravel()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    a = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _live_rows(B, S, causal, mask, device):
    """[B, S] bool: the query rows that see at least one key."""
    keep = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        keep = torch.tril(keep)
    keep = keep[None].expand(B, S, S)
    if mask is not None:
        keep = keep & mask[:, None, :]
    return keep.any(-1)


# rep, D, masked, causal, S. S=200 leaves a ragged edge for every tile;
# rep 3 is no power of two (42 positions a bf16 block); rep 64 is the
# largest group (2 positions a bf16 block); S=17 is below one tile
FWD_CASES = [(1, 128, False, True, 200), (4, 64, False, True, 200),
             (8, 128, True, True, 200), (3, 64, True, False, 200),
             (64, 64, False, True, 200), (4, 64, True, True, 17),
             (1, 128, False, False, 300), (2, 128, True, False, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rep,D,masked,causal,S", FWD_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, rep, D, masked, causal, S):
    rng = np.random.default_rng(rep + S)
    B, Nkv = 2, 2
    q = _randn(rng, (B, S, Nkv * rep, D), dtype, cuda)
    k = _randn(rng, (B, S, Nkv, D), dtype, cuda)
    v = _randn(rng, (B, S, Nkv, D), dtype, cuda)
    mask = None
    if masked:                          # padding, and key 0 masked: causal
        lens = torch.tensor([S - S // 4, S], device=cuda)  # row 0 is then
        mask = torch.arange(S, device=cuda)[None, :] < lens[:, None]
        mask[:, 0] = False                                  # fully masked
    before = _build.FLASH_FWD.launches
    o, lse = flash_attention_fwd(q, k, v, causal=causal, kv_mask=mask)
    ro, rlse = flash_attention_reference(q, k, v, causal=causal,
                                         kv_mask=mask)
    torch.cuda.synchronize()
    assert _build.FLASH_FWD.launches == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert rel_l2(o, ro) <= TOL[dtype]
    # LSE by relative L2 over the rows that see a key (a fully masked
    # row's M_FLOOR = -1e20 would swamp any error in the others); fully
    # masked rows exactly O = 0 and LSE = M_FLOOR
    live = _live_rows(B, S, causal, mask, cuda)
    assert bool(live.all()) == (not (masked and causal))
    by_row = lse[..., 0].transpose(1, 2)            # [B, S, N]
    assert rel_l2(by_row[live], rlse[..., 0].transpose(1, 2)[live]) <= 1e-4
    assert torch.all(o[~live] == 0)
    assert torch.all(by_row[~live] == M_FLOOR)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_fwd_kernel_is_deterministic(cuda, dtype, masked):
    """Two launches of B1 on the same inputs give the same O and LSE bit
    for bit: no atomics, every sum in a fixed order."""
    rng = np.random.default_rng(12)
    q, k, v, _, mask = _bwd_inputs(rng, 2, 1024, 16, 4, 64, dtype, cuda,
                                   masked)
    first = flash_attention_fwd(q, k, v, kv_mask=mask)
    second = flash_attention_fwd(q, k, v, kv_mask=mask)
    torch.cuda.synchronize()
    for name, a, b in zip(("o", "lse"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rep,D,bs", [(1, 128, 64), (8, 128, 64),
                                      (4, 64, 64), (2, 128, 24), (3, 64, 16)])
def test_paged_decode_kernel_matches_plain(cuda, dtype, rep, D, bs):
    rng = np.random.default_rng(rep)
    S, NB, MB, Nkv = 4, 20, 4, 2
    q = _randn(rng, (S, 1, Nkv * rep, D), dtype, cuda)
    kp = _randn(rng, (NB, Nkv, bs, D), dtype, cuda)
    vp = _randn(rng, (NB, Nkv, bs, D), dtype, cuda)
    kp[0] = vp[0] = 1e4                 # the trash block holds garbage
    row = (_randn(rng, (S, Nkv, 1, D), dtype, cuda),
           _randn(rng, (S, Nkv, 1, D), dtype, cuda))
    tables = torch.from_numpy(rng.permutation(np.arange(1, NB))[:S * MB]
                              .reshape(S, MB).astype(np.int32)).to(cuda)
    tables[0] = 0                       # the empty slot: an all-trash table
    lens = torch.tensor([0, 1, MB * bs // 2 + 3, MB * bs], dtype=torch.int32,
                        device=cuda)
    before = _build.PAGED_DECODE.launches
    got = paged_decode_attention(q, kp, vp, tables, lens, kv_row=row)
    ref = paged_decode_reference(q, kp, vp, tables, lens, kv_row=row)
    torch.cuda.synchronize()
    assert _build.PAGED_DECODE.launches == before + 1
    assert rel_l2(got, ref) <= TOL[dtype]
    # the empty slot: exactly v_row, for each query head of the group
    assert torch.equal(got[0, 0], row[1][0, :, 0].repeat_interleave(rep, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_kernel_past_capacity(cuda, dtype):
    """The last slot's length is 3 rows past its table (a request that
    reached max_model_len mid-quantum keeps counting): B4 reads only its MB
    blocks, as the plain version's gather does, and nothing past the
    [S, MB] table."""
    rng = np.random.default_rng(21)
    S, NB, MB, Nkv, rep, D, bs = 3, 16, 4, 2, 4, 128, 64
    q = _randn(rng, (S, 1, Nkv * rep, D), dtype, cuda)
    kp = _randn(rng, (NB, Nkv, bs, D), dtype, cuda)
    vp = _randn(rng, (NB, Nkv, bs, D), dtype, cuda)
    kp[0] = vp[0] = 1e4                 # the trash block holds garbage
    row = (_randn(rng, (S, Nkv, 1, D), dtype, cuda),
           _randn(rng, (S, Nkv, 1, D), dtype, cuda))
    tables = torch.from_numpy(rng.permutation(np.arange(1, NB))[:S * MB]
                              .reshape(S, MB).astype(np.int32)).to(cuda)
    lens = torch.tensor([MB * bs, 7, MB * bs + 3], dtype=torch.int32,
                        device=cuda)
    got = paged_decode_attention(q, kp, vp, tables, lens, kv_row=row)
    ref = paged_decode_reference(q, kp, vp, tables, lens, kv_row=row)
    at_cap = paged_decode_attention(q, kp, vp, tables,
                                    lens.clamp(max=MB * bs), kv_row=row)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert rel_l2(got, ref) <= TOL[dtype]
    assert torch.equal(got, at_cap)


# B4's split walk: pieces of R = 256 rows at bs 64 (``decode_pieces``);
# (Nkv, rep, D): llama-70b's GQA 64/8, llama-7b's 32 heads at rep 1, and
# llama-1b's D=64 at rep 4
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Nkv,rep,D", [(8, 8, 128), (32, 1, 128),
                                       (8, 4, 64)])
def test_paged_decode_kernel_piece_edges(cuda, dtype, Nkv, rep, D):
    """Lengths on the pieces' edges (R - 1, R, R + 1, 2R), a full table, 3
    rows past it, one row and none: against the plain version; the empty
    slot exactly v_row; a second launch the same bit for bit (the pieces
    are merged in a fixed order, no atomics)."""
    from deepspeed_tpu_torch.ops.decode_attention import decode_pieces
    rng = np.random.default_rng(Nkv + rep)
    MB, bs = 8, 64
    R, P = decode_pieces(MB, bs)
    assert (R, P) == (256, 2)
    lens = [0, 1, R - 1, R, R + 1, 2 * R, MB * bs, MB * bs + 3]
    S = len(lens)
    NB = S * MB + 1
    q = _randn(rng, (S, 1, Nkv * rep, D), dtype, cuda)
    kp = _randn(rng, (NB, Nkv, bs, D), dtype, cuda)
    vp = _randn(rng, (NB, Nkv, bs, D), dtype, cuda)
    kp[0] = vp[0] = 1e4                 # the trash block holds garbage
    row = (_randn(rng, (S, Nkv, 1, D), dtype, cuda),
           _randn(rng, (S, Nkv, 1, D), dtype, cuda))
    tab = rng.permutation(np.arange(1, NB)).reshape(S, MB).astype(np.int32)
    for s, n in enumerate(lens):        # stale rows past each length
        if n < MB * bs and n % bs:
            kp[int(tab[s, n // bs]), :, n % bs:] = 1e4
            vp[int(tab[s, n // bs]), :, n % bs:] = 1e4
    tables = torch.from_numpy(tab).to(cuda)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = _build.PAGED_DECODE.launches
    got = paged_decode_attention(q, kp, vp, tables, ln, kv_row=row)
    again = paged_decode_attention(q, kp, vp, tables, ln, kv_row=row)
    ref = paged_decode_reference(q, kp, vp, tables, ln, kv_row=row)
    torch.cuda.synchronize()
    assert _build.PAGED_DECODE.launches == before + 2
    assert torch.isfinite(got).all()
    assert rel_l2(got, ref) <= TOL[dtype]
    assert torch.equal(got, again)
    assert torch.equal(got[0, 0], row[1][0, :, 0].repeat_interleave(rep, 0))


def _bwd_inputs(rng, B, S, N, Nkv, D, dtype, device, masked):
    q = _randn(rng, (B, S, N, D), dtype, device)
    k = _randn(rng, (B, S, Nkv, D), dtype, device)
    v = _randn(rng, (B, S, Nkv, D), dtype, device)
    do = _randn(rng, (B, S, N, D), dtype, device)
    mask = None
    if masked:                          # padding, and key 0 masked: causal
        lens = torch.tensor([S - S // 3] + [S] * (B - 1), device=device)
        mask = torch.arange(S, device=device)[None, :] < lens[:, None]
        mask[:, 0] = False              # row 0 is then fully masked
    return q, k, v, do, mask


# the grid of the CPU parity tests (test_torch_attention.py): causal and
# not, rep 1/2/4, D 64/128, a key mask with a fully masked row, fused and
# unfused delta; S=200 leaves a ragged edge for every tile. Then S a
# multiple of every tile of the bf16 kernels (B2: 128 / rep positions x
# 64 keys; B3: 128 keys x 64 or 32 rows) and S=1024, where the 3-stage
# ring of each block wraps many times, at rep 1, 4 and 8, D 64 and 128
BWD_CASES = [(True, 1, 64, False, False, 200), (True, 2, 128, False, True, 200),
             (True, 4, 64, True, False, 200), (True, 4, 128, True, True, 200),
             (False, 1, 128, True, True, 200), (False, 2, 64, False, False, 200),
             (False, 4, 64, True, True, 200), (True, 8, 128, False, False, 200),
             (True, 1, 64, False, True, 256), (True, 8, 64, True, True, 256),
             (True, 4, 128, False, True, 256), (True, 1, 128, False, True, 1024),
             (True, 4, 64, False, True, 1024), (True, 8, 128, False, False, 1024),
             (False, 4, 64, True, True, 1024), (True, 8, 64, True, False, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,rep,D,masked,fused,S", BWD_CASES)
def test_flash_bwd_kernels_match_plain(cuda, dtype, causal, rep, D, masked,
                                       fused, S):
    rng = np.random.default_rng(rep * D + int(causal))
    B, Nkv = 2, 2
    q, k, v, do, mask = _bwd_inputs(rng, B, S, Nkv * rep, Nkv, D, dtype,
                                    cuda, masked)
    o, lse = flash_attention_reference(q, k, v, causal=causal, kv_mask=mask)
    before = (_build.FLASH_BWD_DQ.launches, _build.FLASH_BWD_DKV.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                              kv_mask=mask, fused=fused)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                         kv_mask=mask)
    torch.cuda.synchronize()
    assert (_build.FLASH_BWD_DQ.launches,
            _build.FLASH_BWD_DKV.launches) == (before[0] + 1, before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == b.shape
        assert torch.isfinite(a).all(), name
        assert rel_l2(a, b) <= TOL[dtype], name
    if masked and causal:               # the fully masked row: dQ exactly 0
        assert torch.all(got[0][:, 0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("masked,fused", [(False, True), (True, False)])
def test_flash_bwd_kernels_are_deterministic(cuda, dtype, masked, fused):
    """Two launches of B2 and B3 on the same inputs give the same dQ, dK
    and dV bit for bit: no atomics, every sum in a fixed order."""
    rng = np.random.default_rng(11)
    q, k, v, do, mask = _bwd_inputs(rng, 2, 1024, 16, 4, 64, dtype, cuda,
                                    masked)
    o, lse = flash_attention_reference(q, k, v, kv_mask=mask)
    first = flash_attention_bwd(q, k, v, o, lse, do, kv_mask=mask,
                                fused=fused)
    second = flash_attention_bwd(q, k, v, o, lse, do, kv_mask=mask,
                                 fused=fused)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["dq", "dkv"])
def test_flash_bwd_parts_launch_one_kernel(cuda, part):
    """Each backward kernel alone (as chip_smoke times them): only its
    launch is counted and only its gradients come back."""
    rng = np.random.default_rng(5)
    q, k, v, do, _ = _bwd_inputs(rng, 1, 128, 8, 2, 64, torch.bfloat16,
                                 cuda, False)
    o, lse = flash_attention_reference(q, k, v)
    before = _build.launch_counts()
    dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, fused=True,
                                     parts=(part,))
    after = _build.launch_counts()
    assert after["flash_bwd_dq"] - before["flash_bwd_dq"] == (part == "dq")
    assert after["flash_bwd_dkv"] - before["flash_bwd_dkv"] == (part == "dkv")
    assert (dq is None) == (part != "dq")
    assert (dk is None) == (dv is None) == (part != "dkv")
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, parts=(part,))
    for a, b in zip((dq, dk, dv), want):
        assert (a is None) == (b is None)
        if a is not None:
            assert rel_l2(a, b) <= TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_flash_autograd_function_on_cuda(cuda, fused):
    """flash_attention end to end on CUDA tensors: B1 forward, B2 + B3
    backward, against the same Function on the plain versions."""
    rng = np.random.default_rng(3)
    B, S, N, Nkv, D = 2, 256, 8, 2, 64
    q, k, v, do, mask = _bwd_inputs(rng, B, S, N, Nkv, D, torch.float32,
                                    cuda, True)
    grads = []
    for reference in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = _build.launch_counts()
        o = flash_attention(*leaves, kv_mask=mask, fused_backward=fused,
                            reference=reference)
        o.backward(do)
        after = _build.launch_counts()
        n = 0 if reference else 1
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert after[name] == before[name] + n, name
        grads.append([o.detach()] + [t.grad for t in leaves])
    for a, b in zip(*grads):
        assert rel_l2(a, b) <= TOL[torch.float32]


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 64, 4, 32), device=cuda)     # head_dim 32
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(q, q, q, q, q.new_zeros((1, 4, 64, 1)), q)
    q = torch.zeros((1, 64, 4, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, q, q)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, q, q, q, q.new_zeros((1, 4, 64, 1)).float(), q)
    q = torch.zeros((1, 64, 4, 64), device=cuda)
    lse = q.new_zeros((1, 4, 64, 1))
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, q, q, q, lse[..., 0], q)
    with pytest.raises(ValueError, match="do"):
        flash_attention_bwd(q, q, q, q, lse, q.transpose(1, 2).contiguous()
                            .transpose(1, 2))
    with pytest.raises(ValueError, match="runs on cuda"):
        m = torch.zeros((1, 64, 4, 64), device="meta")
        flash_attention_bwd(m, m, m, m, m[..., :1], m)
    buf = torch.zeros(1 * 64 * 4 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    odd = buf[1:].view(1, 64, 4, 64)          # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(odd, odd, odd)


# block-sparse (B5-B7): S=512, so block 64 gives 8 query blocks and block
# 128 gives 4; the layouts have a global column (every query block lists
# key block 0: B7's longest walk) and, non-causal, a global row. At S=2048
# and 4096 those lists are longer than the work list's C, so the bf16 B7
# (and, non-causal, B6) run them as pieces summed by the second pass
SPARSE_LAYOUTS = {
    "bigbird": dict(num_random_blocks=1, num_sliding_window_blocks=3,
                    num_global_blocks=1),
    "fixed": dict(num_local_blocks=2, num_global_blocks=1),
    "bslongformer": dict(num_sliding_window_blocks=1,
                         global_block_indices=(0,)),
}
SPARSE_CASES = [("bigbird", 128, 64, True, 512),
                ("bigbird", 64, 128, False, 512),
                ("fixed", 64, 64, True, 512), ("fixed", 128, 128, False, 512),
                ("bslongformer", 128, 128, True, 512),
                ("bslongformer", 64, 64, False, 512),
                ("bigbird", 64, 64, True, 2048),
                ("bigbird", 128, 128, False, 4096),
                ("bslongformer", 128, 64, True, 4096),
                ("bigbird", 64, 128, False, 2048)]


def _sparse_inputs(rng, B, S, N, D, dtype, device):
    return [_randn(rng, (B, S, N, D), dtype, device) for _ in range(4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode,block,D,causal,S", SPARSE_CASES)
def test_sparse_kernels_match_plain(cuda, dtype, mode, block, D, causal, S):
    """B5 (O and LSE), B6 (dQ) and B7 (dK, dV) against the plain versions
    on the same inputs."""
    rng = np.random.default_rng(block + D + int(causal))
    cfg = tsa.get_sparsity_config(mode, block=block, **SPARSE_LAYOUTS[mode])
    q, k, v, do = _sparse_inputs(rng, 2, S, 3, D, dtype, cuda)
    before = _build.launch_counts()
    o, lse = tsa.sparse_attention_fwd(q, k, v, cfg, causal=causal)
    ro, rlse = tsa.sparse_attention_reference(q, k, v, cfg, causal=causal)
    got = tsa.sparse_attention_bwd(q, k, v, ro, rlse, do, cfg, causal=causal)
    want = tsa.sparse_attention_bwd_reference(q, k, v, ro, rlse, do, cfg,
                                              causal=causal)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for name in ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv"):
        assert after[name] == before[name] + 1, name
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert rel_l2(o, ro) <= TOL[dtype]
    assert rel_l2(lse, rlse) <= 1e-4
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and torch.isfinite(a).all(), name
        assert rel_l2(a, b) <= TOL[dtype], name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", [1024, 32768])
def test_sparse_dkv_global_column_alone(cuda, dtype, S):
    """B7 on a table restricted to the global column (key block 0, listed
    by every query block; the others list nothing): dK/dV of block 0 equal
    the full launch's bit for bit (in bf16 both cut the column into the
    same pieces: 2 at S=1024, 64 at S=32768), and every other key block's
    are exactly 0. At S=32768 the full launch is also held against the
    plain version."""
    rng = np.random.default_rng(9)
    cfg = tsa.get_sparsity_config("bigbird", block=64,
                                  **SPARSE_LAYOUTS["bigbird"])
    q, k, v, do = _sparse_inputs(rng, 1, S, 2, 64, dtype, cuda)
    o, lse = tsa.sparse_attention_fwd(q, k, v, cfg)
    idx, cnt, cidx, ccnt = tsa.adjacency_tables(cfg, S, True, q.device)
    assert int(ccnt[0]) == S // 64                    # the global column
    if dtype == torch.bfloat16:
        cols = tsa.work_tables(cfg, S, True, q.device)[1]
        assert cols.chunk == 8 and cols.slots == S // 64 // 8
    only = torch.zeros_like(ccnt)
    only[0] = ccnt[0]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    _, dk, dv = tsa.sparse_bwd_launch(q, k, v, do, lse, delta, cfg,
                                      (idx, cnt, cidx, only), causal=True,
                                      sm_scale=64 ** -0.5, parts=("dkv",))
    _, dk_all, dv_all = tsa.sparse_attention_bwd(q, k, v, o, lse, do, cfg,
                                                 parts=("dkv",))
    torch.cuda.synchronize()
    assert torch.equal(dk[:, :64], dk_all[:, :64])
    assert torch.equal(dv[:, :64], dv_all[:, :64])
    assert torch.all(dk[:, 64:] == 0) and torch.all(dv[:, 64:] == 0)
    if S == 32768:
        _, dk_ref, dv_ref = tsa.sparse_attention_bwd_reference(
            q, k, v, o, lse, do, cfg, parts=("dkv",))
        assert rel_l2(dk_all, dk_ref) <= TOL[dtype]
        assert rel_l2(dv_all, dv_ref) <= TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_sparse_bwd_kernels_are_deterministic(cuda, causal):
    """Two launches of the bf16 B6 and B7 on the same inputs give the same
    dQ, dK and dV bit for bit, where the walks are split (BigBird block
    128 at S=4096: the global column, and non-causal the global row, run
    as pieces summed in a fixed order) and where they are not."""
    rng = np.random.default_rng(13)
    cfg = tsa.get_sparsity_config("bigbird", block=128,
                                  **SPARSE_LAYOUTS["bigbird"])
    q, k, v, do = _sparse_inputs(rng, 2, 4096, 4, 64, torch.bfloat16, cuda)
    o, lse = tsa.sparse_attention_fwd(q, k, v, cfg, causal=causal)
    rows, cols = tsa.work_tables(cfg, 4096, causal, q.device)
    assert cols.slots > 0 and (rows.slots > 0) == (not causal)
    first = tsa.sparse_attention_bwd(q, k, v, o, lse, do, cfg, causal=causal)
    second = tsa.sparse_attention_bwd(q, k, v, o, lse, do, cfg,
                                      causal=causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
def test_sparse_fwd_kernel_split_rows_deterministic(cuda, causal, D):
    """The bf16 B5 walks B6's row work list: at BigBird block 128, S=4096,
    non-causal, the global row (32 key blocks) runs as pieces merged by
    the second pass; causal, nothing is split. O and LSE against the plain
    version, and a second launch the same bit for bit."""
    rng = np.random.default_rng(17 + D)
    cfg = tsa.get_sparsity_config("bigbird", block=128,
                                  **SPARSE_LAYOUTS["bigbird"])
    q, k, v, _ = _sparse_inputs(rng, 2, 4096, 2, D, torch.bfloat16, cuda)
    rows = tsa.work_tables(cfg, 4096, causal, q.device)[0]
    assert (rows.slots > 0) == (not causal)
    first = tsa.sparse_attention_fwd(q, k, v, cfg, causal=causal)
    second = tsa.sparse_attention_fwd(q, k, v, cfg, causal=causal)
    ro, rlse = tsa.sparse_attention_reference(q, k, v, cfg, causal=causal)
    torch.cuda.synchronize()
    assert rel_l2(first[0], ro) <= TOL[torch.bfloat16]
    assert rel_l2(first[1], rlse) <= 1e-4
    for name, a, b in zip(("o", "lse"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sparse_fwd_kernel_empty_list(cuda, dtype):
    """A layout with a global row (split into pieces in bf16) and a query
    block that lists nothing: that block's rows come out O = 0 and LSE =
    -1e30 exactly; the rest as the plain version's."""
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class GlobalAndHole(tsa.SparsityConfig):
        def make_layout(self, seq_len):
            n = seq_len // self.block
            lay = np.eye(n, dtype=bool)
            lay[0] = True
            lay[2] = False
            return lay

    rng = np.random.default_rng(23)
    cfg = GlobalAndHole(block=64)
    q, k, v, _ = _sparse_inputs(rng, 2, 1024, 2, 64, dtype, cuda)
    assert tsa.work_tables(cfg, 1024, False, q.device)[0].slots > 0
    o, lse = tsa.sparse_attention_fwd(q, k, v, cfg, causal=False)
    ro, rlse = tsa.sparse_attention_reference(q, k, v, cfg, causal=False)
    torch.cuda.synchronize()
    assert torch.all(o[:, 128:192] == 0)
    assert torch.all(lse[:, :, 128:192] == tsa.NEG_INF)
    assert rel_l2(o, ro) <= TOL[dtype]
    live = torch.ones(1024, dtype=torch.bool, device=cuda)
    live[128:192] = False
    assert rel_l2(lse[:, :, live], rlse[:, :, live]) <= 1e-4


@pytest.mark.cuda
def test_sparse_autograd_function_on_cuda(cuda):
    """sparse_attention end to end on CUDA tensors (B5, then B6 + B7)
    against the same Function on the plain versions."""
    rng = np.random.default_rng(4)
    cfg = tsa.get_sparsity_config("bigbird", block=64,
                                  **SPARSE_LAYOUTS["bigbird"])
    q, k, v, do = _sparse_inputs(rng, 2, 256, 4, 64, torch.float32, cuda)
    grads = []
    for reference in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = _build.launch_counts()
        o = tsa.sparse_attention(*leaves, cfg, reference=reference)
        o.backward(do)
        after = _build.launch_counts()
        for name in ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv"):
            assert after[name] == before[name] + (not reference), name
        grads.append([o.detach()] + [t.grad for t in leaves])
    for a, b in zip(*grads):
        assert rel_l2(a, b) <= TOL[torch.float32]


@pytest.mark.cuda
def test_sparse_wrappers_dispatch_and_refuse(cuda):
    """CPU tensors take the plain version (no launch); on CUDA a block or
    head_dim the kernels do not take, f16, or a mismatched k raises."""
    cfg16 = tsa.BigBirdSparsityConfig(block=16)
    cpu = torch.zeros((1, 64, 2, 64))
    before = _build.launch_counts()
    o, lse = tsa.sparse_attention_fwd(cpu, cpu, cpu, cfg16)
    assert _build.launch_counts() == before and o.device.type == "cpu"
    q = torch.zeros((1, 64, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="block"):
        tsa.sparse_attention_fwd(q, q, q, cfg16)
    with pytest.raises(ValueError, match="block"):
        tsa.sparse_attention_bwd(q, q, q, q, q[..., :1].contiguous(), q,
                                 cfg16)
    cfg = tsa.BigBirdSparsityConfig(block=64)
    q32 = torch.zeros((1, 64, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        tsa.sparse_attention_fwd(q32, q32, q32, cfg)
    q16 = q.half()
    with pytest.raises(TypeError):
        tsa.sparse_attention_fwd(q16, q16, q16, cfg)
    kv = torch.zeros((1, 64, 1, 64), device=cuda)
    with pytest.raises(ValueError, match="one shape"):
        tsa.sparse_attention_fwd(q, kv, kv, cfg)
    with pytest.raises(ValueError, match="divisible"):
        tsa.sparse_attention_fwd(q[:, :48].contiguous(), q[:, :48]
                                 .contiguous(), q[:, :48].contiguous(), cfg)
    lse = torch.zeros((1, 2, 64, 1), device=cuda)
    tabs = tsa.adjacency_tables(cfg, 64, True, q.device)
    with pytest.raises(ValueError, match="delta"):
        tsa.sparse_bwd_launch(q, q, q, q, lse, lse, cfg, tabs, causal=True,
                              sm_scale=0.125)
    with pytest.raises(ValueError, match="runs on cuda"):
        tsa.sparse_bwd_launch(cpu, cpu, cpu, cpu, lse.cpu(), lse[..., 0].cpu(),
                              cfg, tabs, causal=True, sm_scale=0.125)
