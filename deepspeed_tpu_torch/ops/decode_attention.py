"""Paged decode attention: single-token GQA attention against a block pool
through per-slot block tables, PyTorch port of
``deepspeed_tpu/ops/decode_attention.py``.

The kernel is ``csrc/paged_decode.cu`` (hand-written CUDA for sm_90a); its
note says what bounds it and how it is laid out. It walks each slot's rows
in pieces of R rows (``decode_pieces``: the grid's geometry, fixed by the
table) that write f32 partials, then merges them in piece order
(``decode_merge_reference`` is that second pass in plain PyTorch, and
``paged_decode_split_reference`` the whole split walk).

Layout: q [S, 1, Nq, D] (one in-flight token per slot); pools
[NB, Nkv, bs, D]; block_tables [S, MB] int32 (entry 0 = the reserved trash
block, never valid); seq_lens [S] int32 = rows already in the pool for the
slot. The CURRENT token's (k, v) row is not in the pool: it arrives as
kv_row = (k_row, v_row) [S, Nkv, 1, D] and joins the softmax last; the
caller scatters it into the pool afterwards.

Dispatch: a tensor on the CPU takes the plain PyTorch version; a CUDA
tensor launches the kernel or raises. Nothing falls back.
"""

import math
from typing import Optional, Tuple

import torch

from deepspeed_tpu_torch.ops._build import PAGED_DECODE, stream_handle

NEG_INF = -1e30
# floor of the running max, as the TPU kernel's
M_FLOOR = -1e20
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_MAX_REP = 8
# rows a piece of the kernel's split walk aims at (csrc/paged_decode.cu)
PIECE_ROWS = 256


def decode_pieces(max_blocks: int, block_size: int,
                  rows: int = PIECE_ROWS) -> Tuple[int, int]:
    """(R, P): the kernel cuts each slot's MB * bs table rows into P =
    ceil(MB * bs / R) pieces of R rows, R = ``rows`` rounded down to whole
    blocks (at least one). Piece p walks rows [p R, min(p R + R, len))."""
    R = block_size * max(1, rows // block_size)
    return R, -(-max_blocks * block_size // R)


def paged_decode_reference(q, k_pool, v_pool, block_tables, seq_lens, *,
                           kv_row, sm_scale: Optional[float] = None):
    """Plain version: the block-table gather into a contiguous
    [S, Nkv, MB*bs, D] view, then the ring-buffer decode math of
    ``models/transformer._decode_attention`` (per-slot cursor, fresh row as
    a separate softmax term). Returns [S, 1, Nq, D] in q's dtype."""
    S, _, Nq, D = q.shape
    NB, Nkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    rep = Nq // Nkv
    T = MB * bs
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    tables = block_tables.long()

    def view(pool):                          # [S, MB, Nkv, bs, D] -> [S, Nkv, T, D]
        return pool[tables].permute(0, 2, 1, 3, 4).reshape(S, Nkv, T, D)

    k_row, v_row = kv_row
    qg = q.reshape(S, Nkv, rep, D)
    scores = torch.einsum("bgrd,bgtd->bgrt", qg, view(k_pool)).float()
    scores = scores * sm_scale
    keep = (torch.arange(T, device=q.device)[None, :]
            < seq_lens.long()[:, None])
    scores = torch.where(keep[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    s_self = torch.einsum("bgrd,bgtd->bgrt", qg,
                          k_row.to(qg.dtype)).float() * sm_scale
    probs = torch.softmax(torch.cat([scores, s_self], dim=-1), dim=-1)
    out = torch.einsum("bgrt,bgtd->bgrd", probs[..., :T].to(q.dtype),
                       view(v_pool))
    out = out + probs[..., T:].to(q.dtype) * v_row.to(q.dtype)
    return out.reshape(S, 1, Nq, D)


def decode_pieces_reference(q, k_pool, v_pool, block_tables, seq_lens, *,
                            sm_scale: float, rows: int = PIECE_ROWS):
    """Plain version of the kernel's first pass: each piece's f32 partials
    ``ws`` [S, Nkv, P, rep, D + 2] (acc over D relative to the piece's max
    m, then m and l), as ``paged_decode_split`` writes them. A piece at or
    past its slot's length (clamped to MB * bs) writes nothing: its entries
    stay NaN, and the merge must not read them."""
    S, _, Nq, D = q.shape
    NB, Nkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    rep = Nq // Nkv
    R, P = decode_pieces(MB, bs, rows)
    qg = q.float().reshape(S, Nkv, rep, D) * sm_scale
    ws = torch.full((S, Nkv, P, rep, D + 2), float("nan"),
                    dtype=torch.float32, device=q.device)
    for s in range(S):
        n = min(int(seq_lens[s]), MB * bs)
        for p in range(-(-n // R)):
            rows_ = torch.arange(p * R, min(p * R + R, n), device=q.device)
            blocks = block_tables[s].long()[rows_ // bs]
            k = k_pool[blocks, :, rows_ % bs].float()    # [n, Nkv, D]
            v = v_pool[blocks, :, rows_ % bs].float()
            sc = torch.einsum("grd,ngd->grn", qg[s], k)
            m = sc.amax(-1)
            e = torch.exp(sc - m[..., None])
            ws[s, :, p, :, :D] = torch.einsum("grn,ngd->grd", e, v)
            ws[s, :, p, :, D] = m
            ws[s, :, p, :, D + 1] = e.sum(-1)
    return ws


def decode_merge_reference(ws, q, seq_lens, max_rows: int, rows: int, *,
                           kv_row, sm_scale: float):
    """Plain version of the kernel's second pass (``paged_decode_merge``):
    the pieces of each (slot, kv head) below ceil(len / R) merged in piece
    order by the log-sum-exp rule, then the fresh row folded last with the
    running max floored at M_FLOOR. ``max_rows`` = MB * bs (the length's
    clamp), ``rows`` = R. Returns [S, 1, Nq, D] in q's dtype; a slot with
    no rows gives exactly v_row."""
    S, _, Nq, D = q.shape
    Nkv, rep = ws.shape[1], ws.shape[3]
    k_row, v_row = kv_row
    qg = q.float().reshape(S, Nkv, rep, D) * sm_scale
    s1 = torch.einsum("grd,gd->gr", qg.reshape(S * Nkv, rep, D),
                      k_row.float().reshape(S * Nkv, D)).reshape(S, Nkv, rep)
    out = torch.empty((S, Nkv, rep, D), dtype=torch.float32, device=q.device)
    for s in range(S):
        pieces = -(-min(int(seq_lens[s]), max_rows) // rows)
        M = torch.full((Nkv, rep), NEG_INF, device=q.device)
        for p in range(pieces):
            M = torch.maximum(M, ws[s, :, p, :, D])
        L = torch.zeros((Nkv, rep), device=q.device)
        A = torch.zeros((Nkv, rep, D), device=q.device)
        for p in range(pieces):
            f = torch.exp(ws[s, :, p, :, D] - M)
            L = L + ws[s, :, p, :, D + 1] * f
            A = A + ws[s, :, p, :, :D] * f[..., None]
        m_new = torch.maximum(M, s1[s]).clamp_min(M_FLOOR)
        p1 = torch.exp(s1[s] - m_new)
        alpha = torch.exp(M - m_new)
        l_new = L * alpha + p1
        o = A * alpha[..., None] + p1[..., None] * v_row[s, :, 0].float()[:, None]
        out[s] = o / torch.where(l_new == 0, torch.ones_like(l_new),
                                 l_new)[..., None]
    return out.reshape(S, 1, Nq, D).to(q.dtype)


def paged_decode_split_reference(q, k_pool, v_pool, block_tables, seq_lens, *,
                                 kv_row, sm_scale: Optional[float] = None,
                                 rows: int = PIECE_ROWS):
    """The kernel's split walk in plain PyTorch: ``decode_pieces_reference``
    then ``decode_merge_reference``, with the kernel's piece geometry
    (``decode_pieces``; ``rows`` picks R). Returns [S, 1, Nq, D]."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    MB, bs = block_tables.shape[1], k_pool.shape[2]
    R, _ = decode_pieces(MB, bs, rows)
    ws = decode_pieces_reference(q, k_pool, v_pool, block_tables, seq_lens,
                                 sm_scale=sm_scale, rows=rows)
    return decode_merge_reference(ws, q, seq_lens, MB * bs, R, kv_row=kv_row,
                                  sm_scale=sm_scale)


def _check(q, k_pool, v_pool, block_tables, seq_lens, k_row, v_row):
    tensors = (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("k_row", k_row), ("v_row", v_row))
    for name, t in tensors:
        if t.dtype != q.dtype:
            raise TypeError(f"paged_decode: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"paged_decode takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("block_tables", block_tables), ("seq_lens", seq_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"paged_decode: {name} must be int32, got {t.dtype}")
    for name, t in tensors + (("block_tables", block_tables),
                              ("seq_lens", seq_lens)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"paged_decode: {name} must be contiguous on "
                             f"{q.device}")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"paged_decode wants q [S, 1, Nq, D], got "
                         f"{tuple(q.shape)}")
    S, _, Nq, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be [NB, Nkv, bs, D], got "
                         f"{tuple(k_pool.shape)} {tuple(v_pool.shape)}")
    NB, Nkv, bs, Dp = k_pool.shape
    if Dp != D or D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode supports head_dim {_HEAD_DIMS}; "
                         f"q has {D}, pools {Dp}")
    if Nq % Nkv or Nq // Nkv > _MAX_REP:
        raise ValueError(f"n_q_heads {Nq} must be a multiple (<= "
                         f"{_MAX_REP}x) of n_kv_heads {Nkv}")
    if bs < 1:
        raise ValueError(f"block_size {bs} must be >= 1")
    for name, t in tensors:
        # the kernel reads each lane's D/32 elements in one vector load
        if t.data_ptr() % 16:
            raise ValueError(f"paged_decode: {name} must be 16-byte aligned")
    if block_tables.dim() != 2 or block_tables.shape[0] != S \
            or seq_lens.shape != (S,):
        raise ValueError(f"block_tables [S, MB] / seq_lens [S] with S={S}, "
                         f"got {tuple(block_tables.shape)} "
                         f"{tuple(seq_lens.shape)}")
    if k_row.shape != (S, Nkv, 1, D) or v_row.shape != (S, Nkv, 1, D):
        raise ValueError(f"kv_row must be [S, Nkv, 1, D] = {(S, Nkv, 1, D)}")


def paged_decode_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                           kv_row, sm_scale: Optional[float] = None):
    """q: [S, 1, Nq, D]; k_pool/v_pool: [NB, Nkv, bs, D]; block_tables:
    [S, MB] int32; seq_lens: [S] int32; kv_row: (k_row, v_row)
    [S, Nkv, 1, D]. Returns [S, 1, Nq, D].

    The kernel trusts the tables: every entry below ceil(len/bs) must be a
    block of the pool. A len past MB * bs is read as MB * bs, as the plain
    version's gather of MB blocks does: the serving quantum keeps raising
    the length of a slot whose request reached max_model_len mid-quantum
    (the rows it then computes are discarded)."""
    if kv_row is None:
        raise ValueError("paged_decode_attention requires the fresh-row "
                         "fold (kv_row): the decode step never pre-writes "
                         "the current token into the pool")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_decode_reference(q, k_pool, v_pool, block_tables,
                                      seq_lens, kv_row=kv_row,
                                      sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode runs on cuda (or cpu), not {q.device}")
    k_row, v_row = kv_row
    _check(q, k_pool, v_pool, block_tables, seq_lens, k_row, v_row)
    S, _, Nq, D = q.shape
    _, Nkv, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    R, P = decode_pieces(MB, bs)
    # the pieces' f32 partials, from the caching allocator (no host sync:
    # the grid and this size are fixed by the table, not by the lengths)
    ws = torch.empty((S, Nkv, P, Nq // Nkv, D + 2), dtype=torch.float32,
                     device=q.device)
    out = torch.empty_like(q)
    PAGED_DECODE.launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                        block_tables.data_ptr(), seq_lens.data_ptr(),
                        k_row.data_ptr(), v_row.data_ptr(), ws.data_ptr(),
                        out.data_ptr(), S, Nq, Nkv, D, bs, MB, R,
                        _DTYPES[q.dtype], float(sm_scale), stream_handle(q))
    return out
