"""Block-sparse attention, forward and backward, PyTorch port of
``deepspeed_tpu/ops/sparse_attention.py``: the five sparsity layouts, their
adjacency tables and three hand-written CUDA kernels for sm_90a (each
source's note says what bounds it and how it is laid out):

- ``csrc/sparse_fwd.cu`` (B5): O and the f32 log-sum-exp, each query block
  walking only the key blocks its adjacency row lists;
- ``csrc/sparse_bwd_dq.cu`` (B6): dQ over the same rows;
- ``csrc/sparse_bwd_dkv.cu`` (B7): dK and dV, each key block walking the
  query blocks of its transposed row.

In bf16, the kernels walk a work list (``work_list``) rather than one
list per CUDA block: a list longer than C entries (BigBird's global
column, listed by every query block, and non-causal its global row) is cut
into pieces that run side by side, each writing f32 partials that a second
pass combines in a fixed order: B6 and B7 add them, B5 (which walks B6's
row list) merges its pieces' softmax states by the log-sum-exp rule.
``sparse_pieces_reference`` and ``sparse_merge_reference`` are B5's split
walk and its merge in plain PyTorch.

``sparse_attention`` is a ``torch.autograd.Function``, the TPU module's
``_sparse`` and its ``custom_vjp``: the forward launches B5 and keeps (q,
k, v, O, LSE); the backward takes delta = rowsum(dO * O) in one torch pass
(one XLA pass in JAX), then launches B6 and B7 (no atomics, so the
gradients are deterministic). B5 is a plain launch, not a custom op, so no
remat policy keeps its outputs: ``dots_saveable`` and ``dots_and_attn``
both replay it in the backward, as the JAX policies (which name only the
flash outputs) replay the sparse kernel.

The layouts are copies of the JAX module's (same names, fields and
defaults; BigBird makes the same ``np.random.default_rng(seed)`` calls in
the same order, so the layouts are identical). Each layout's four tables
(``idx``, ``cnt``, ``cidx``, ``ccnt``) are made once per (config, S,
causal) on the host and once per device as int32 tensors, so a step does
not copy them every layer.

Layout: [B, S, N, D] in and out; K and V have as many heads as Q (the
model repeats them over the query-head group first, as JAX does).

Dispatch: a tensor on the CPU takes the plain PyTorch version, written over
the adjacency (each query block's listed key blocks gathered, not a dense
[S, S] mask); a CUDA tensor launches the kernel or raises. Nothing falls
back.
"""

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops._build import (SPARSE_BWD_DKV, SPARSE_BWD_DQ,
                                            SPARSE_FWD, stream_handle)
from deepspeed_tpu_torch.ops.flash_attention import _default_scale, _on_cuda

NEG_INF = -1e30
# floor of the running row max, as the TPU kernel's
M_FLOOR = -1e20
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_BLOCKS = (64, 128)
BWD_PARTS = ("dq", "dkv")


# --------------------------------------------------------------------------
# sparsity configs (the JAX module's, field for field)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SparsityConfig:
    """Base: dense layout (reference: DenseSparsityConfig)."""
    block: int = 128

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = seq_len // self.block
        return np.ones((n, n), bool)


@dataclasses.dataclass(frozen=True)
class DenseSparsityConfig(SparsityConfig):
    pass


@dataclasses.dataclass(frozen=True)
class FixedSparsityConfig(SparsityConfig):
    """Local blocks + periodic global columns (the first blocks of each
    local window)."""
    num_local_blocks: int = 4
    num_global_blocks: int = 1

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = seq_len // self.block
        L = np.zeros((n, n), bool)
        nl = self.num_local_blocks
        for i in range(n):
            w0 = (i // nl) * nl
            L[i, w0:min(w0 + nl, n)] = True          # local window
        for w0 in range(0, n, nl):                    # global columns
            g = min(self.num_global_blocks, n - w0)
            L[:, w0:w0 + g] = True
        return L


@dataclasses.dataclass(frozen=True)
class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding window + global blocks."""
    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = seq_len // self.block
        L = np.zeros((n, n), bool)
        w = self.num_sliding_window_blocks // 2
        for i in range(n):
            L[i, max(0, i - w):min(n, i + w + 1)] = True
        g = min(self.num_global_blocks, n)
        L[:, :g] = True
        L[:g, :] = True
        rng = np.random.default_rng(self.seed)
        for i in range(n):
            pick = rng.choice(n, size=min(self.num_random_blocks, n),
                              replace=False)
            L[i, pick] = True
        return L


@dataclasses.dataclass(frozen=True)
class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + designated global block indices."""
    num_sliding_window_blocks: int = 3
    global_block_indices: Tuple[int, ...] = (0,)

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = seq_len // self.block
        L = np.zeros((n, n), bool)
        w = self.num_sliding_window_blocks // 2
        for i in range(n):
            L[i, max(0, i - w):min(n, i + w + 1)] = True
        for g in self.global_block_indices:
            if g < n:
                L[:, g] = True
                L[g, :] = True
        return L


@dataclasses.dataclass(frozen=True)
class VariableSparsityConfig(SparsityConfig):
    """Variable local window sizes + global blocks."""
    num_global_blocks: int = 1
    local_window_blocks: Tuple[int, ...] = (4,)

    def make_layout(self, seq_len: int) -> np.ndarray:
        n = seq_len // self.block
        L = np.zeros((n, n), bool)
        windows = list(self.local_window_blocks)
        start = 0
        wi = 0
        while start < n:
            w = windows[min(wi, len(windows) - 1)]
            end = min(start + w, n)
            L[start:end, start:end] = True
            start, wi = end, wi + 1
        L[:, :min(self.num_global_blocks, n)] = True
        return L


_MODES = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
    "variable": VariableSparsityConfig,
}


def get_sparsity_config(mode: str, **kw) -> SparsityConfig:
    if mode not in _MODES:
        raise ValueError(f"unknown sparse attention mode {mode!r}; "
                         f"have {sorted(_MODES)}")
    return _MODES[mode](**kw)


def _adjacency(layout: np.ndarray, causal: bool):
    """layout [Qb, Kb] -> (idx [Qb, max_deg] int32 padded -1, count [Qb]),
    plus the transpose for the dK/dV pass."""
    n = layout.shape[0]
    if causal:
        layout = layout & np.tril(np.ones((n, n), bool))
    rows = [np.nonzero(layout[i])[0] for i in range(n)]
    deg = max((len(r) for r in rows), default=0)
    idx = np.full((n, max(deg, 1)), -1, np.int32)
    for i, r in enumerate(rows):
        idx[i, :len(r)] = r
    count = np.array([len(r) for r in rows], np.int32)
    cols = [np.nonzero(layout[:, j])[0] for j in range(n)]
    cdeg = max((len(c) for c in cols), default=0)
    cidx = np.full((n, max(cdeg, 1)), -1, np.int32)
    for j, c in enumerate(cols):
        cidx[j, :len(c)] = c
    ccount = np.array([len(c) for c in cols], np.int32)
    return idx, count, cidx, ccount


@functools.lru_cache(maxsize=None)
def _cached_adjacency(config: SparsityConfig, seq_len: int, causal: bool):
    """(idx, cnt, cidx, ccnt) of the layout at ``seq_len``, made once, as
    read-only numpy int32 arrays. This cache and the three below are
    unbounded: one small entry per (layout, S, causal[, device]), so a
    server with any number of prompt buckets builds each bucket's tables
    once."""
    tables = _adjacency(config.make_layout(seq_len), causal)
    for t in tables:
        t.setflags(write=False)
    return tables


@dataclasses.dataclass(frozen=True)
class WorkList:
    """The work of one bf16 backward kernel (B6 over the rows of ``idx``,
    B7 over the columns of ``cidx``). ``items`` [n, 4] int32: (output
    block, first list entry, entry count, partial slot), longest first;
    the slot is -1 where the list is not split (the item writes its
    output block), else the f32 workspace slot its piece writes. ``sums``
    [m, 3] int32: (output block, first slot, pieces) of each split block,
    which the kernels' second pass adds up in slot order. ``slots``: the
    workspace's slots; ``chunk``: C, the most entries a piece walks."""
    items: object
    sums: object
    slots: int
    chunk: int


def chunk_length(counts) -> int:
    """C for lists of these lengths: twice the mean length, rounded up to
    a power of two, at least 4. A piece then walks about as long as a few
    ordinary lists (8 at the causal BigBird layouts, whose mean column is
    3.4 entries and median 2, so the global column of S / 128 entries runs
    as S / 1024 pieces), while each piece's f32 partial (block x D x 4
    bytes per tensor, batch and head) stays a small share of the kernel's
    traffic."""
    mean = float(np.mean(counts)) if len(counts) else 0.0
    return max(4, 1 << int(np.ceil(np.log2(max(2.0 * mean, 1.0)))))


def work_list(counts, chunk: int) -> WorkList:
    """Items of lists of ``counts`` entries: a list of at most ``chunk``
    entries is one item; a longer one is cut into ceil(n / chunk) pieces
    of near-equal length, each with its own workspace slot (one block's
    slots are consecutive). Items are ordered longest first (ties keep
    block order), so the longest walks start first."""
    items, sums, slots = [], [], 0
    for o, n in enumerate(int(c) for c in counts):
        if n <= chunk:
            items.append((o, 0, n, -1))
            continue
        pieces = -(-n // chunk)
        size, extra = divmod(n, pieces)
        sums.append((o, slots, pieces))
        first = 0
        for i in range(pieces):
            c = size + (i < extra)
            items.append((o, first, c, slots + i))
            first += c
        slots += pieces
    items.sort(key=lambda it: -it[2])
    return WorkList(np.array(items, np.int32).reshape(-1, 4),
                    np.array(sums, np.int32).reshape(-1, 3), slots, chunk)


@functools.lru_cache(maxsize=None)
def _cached_work(config: SparsityConfig, seq_len: int, causal: bool):
    """(B6's, B7's) work lists of the layout at ``seq_len``, made once."""
    _, cnt, _, ccnt = _cached_adjacency(config, seq_len, causal)
    return tuple(work_list(c, chunk_length(c)) for c in (cnt, ccnt))


def _work_on(w: WorkList, device) -> WorkList:
    return dataclasses.replace(
        w, items=torch.from_numpy(np.array(w.items)).to(device),
        sums=torch.from_numpy(np.array(w.sums)).to(device))


@functools.lru_cache(maxsize=None)
def work_tables(config: SparsityConfig, seq_len: int, causal: bool,
                device: torch.device) -> Tuple[WorkList, WorkList]:
    """(B6's, B7's) work lists with int32 tensors on ``device``, copied
    there once per (config, S, causal, device)."""
    return tuple(_work_on(w, device)
                 for w in _cached_work(config, int(seq_len), bool(causal)))


def work_for(tables, config: SparsityConfig, S: int, causal: bool,
             device: torch.device) -> Tuple[WorkList, WorkList]:
    """The (B6's, B7's) work lists of ``tables``: the cached ones for the
    layout's own tables; for other tables (a measurement's cut of them)
    made from their counts (a host copy), with the layout's own C."""
    if all(a is b for a, b in zip(tables, adjacency_tables(
            config, S, bool(causal), device))):
        return work_tables(config, S, bool(causal), device)
    chunks = [w.chunk for w in _cached_work(config, S, bool(causal))]
    return tuple(_work_on(work_list(t.cpu().numpy(), c), device)
                 for t, c in zip((tables[1], tables[3]), chunks))


@functools.lru_cache(maxsize=None)
def adjacency_tables(config: SparsityConfig, seq_len: int, causal: bool,
                     device: torch.device) -> Tuple[torch.Tensor, ...]:
    """(idx, cnt, cidx, ccnt) as int32 tensors on ``device``, copied there
    once per (config, S, causal, device)."""
    return tuple(torch.from_numpy(np.array(t)).to(device)
                 for t in _cached_adjacency(config, int(seq_len),
                                            bool(causal)))


def _check_seq(S, config):
    if S % config.block:
        raise ValueError(f"seq len {S} not divisible by block {config.block}")


# --------------------------------------------------------------------------
# plain versions: the kernels' arithmetic over the gathered adjacency
# --------------------------------------------------------------------------

def _blocks(x, block):
    """[B, S, N, D] -> f32 [B, N, S / block, block, D]."""
    B, S, N, D = x.shape
    return x.float().reshape(B, S // block, block, N, D).permute(0, 3, 1, 2, 4)


def _unblock(x):
    """[B, N, Qb, block, D] -> [B, S, N, D]."""
    B, N, Qb, block, D = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(B, Qb * block, N, D)


def _gather(x, idx, block):
    """[B, S, N, D] -> f32 [B, N, Qb, deg * block, D]: each query block's
    listed key blocks, in list order (padding entries read block 0 and are
    masked by the caller)."""
    xb = _blocks(x, block)
    g = xb[:, :, idx.clamp_min(0).long()]            # [B, N, Qb, deg, bk, D]
    return g.reshape(g.shape[0], g.shape[1], idx.shape[0], -1, g.shape[-1])


def _listed(idx, cnt, block, causal):
    """[Qb, block, deg * block] bool: key column c of query row r is in a
    listed block (t < cnt) and, causal, not after r."""
    Qb, deg = idx.shape
    dev = idx.device
    keep = torch.arange(deg, device=dev)[None, :] < cnt[:, None].long()
    keep = keep[:, None, :, None].expand(Qb, block, deg, block)
    if causal:
        r = torch.arange(block, device=dev)
        q_pos = torch.arange(Qb, device=dev)[:, None] * block + r[None, :]
        k_pos = idx.long()[:, :, None] * block + r
        keep = keep & (k_pos[:, None] <= q_pos[:, :, None, None])
    return keep.reshape(Qb, block, deg * block)


def _scores(q, k, config, causal, sm_scale):
    """(q blocks, gathered k, scores with unlisted pairs at NEG_INF, the
    listed mask, idx, cnt)."""
    idx, cnt = adjacency_tables(config, q.shape[1], bool(causal),
                                q.device)[:2]
    qb = _blocks(q, config.block)
    kg = _gather(k, idx, config.block)
    keep = _listed(idx, cnt, config.block, causal)
    s = torch.einsum("bnqrd,bnqcd->bnqrc", qb, kg) * sm_scale
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return qb, kg, s, keep, idx, cnt


def sparse_attention_reference(q, k, v, config: SparsityConfig, *,
                               causal: bool = True,
                               sm_scale: Optional[float] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B5 with the kernel's semantics: online-softmax
    result over each row's listed blocks, the running max floored at
    M_FLOOR, an empty list giving O = 0 and LSE NEG_INF (the loop never
    ran). Returns (O [B, S, N, D] in q's dtype, LSE [B, N, S, 1] f32)."""
    B, S, N, D = q.shape
    _check_seq(S, config)
    sm_scale = _default_scale(q, sm_scale)
    _, _, s, keep, idx, cnt = _scores(q, k, config, causal, sm_scale)
    m = s.amax(-1, keepdim=True).clamp_min(M_FLOOR)
    m = torch.where((cnt > 0)[:, None, None], m, torch.full_like(m, NEG_INF))
    p = torch.where(keep, torch.exp(s - m), torch.zeros_like(s))
    del s
    l = p.sum(-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = torch.einsum("bnqrc,bnqcd->bnqrd", p / l_safe,
                     _gather(v, idx, config.block))
    lse = (m + torch.log(l_safe)).reshape(B, N, S, 1)
    return _unblock(o).to(q.dtype).contiguous(), lse.contiguous()


def sparse_pieces_reference(q, k, v, config: SparsityConfig, *,
                            causal: bool = True,
                            sm_scale: Optional[float] = None):
    """Plain version of the bf16 B5's walk over its row work list (B6's,
    ``work_tables(...)[0]``): each item's online-softmax state over its
    entries of the row's list. An unsplit item writes its query block's O
    and LSE (an empty list: O = 0, LSE NEG_INF); a piece writes its f32
    partials to its slot. Returns (O, LSE) f32 [B, N, Qb, block, D] and
    [B, N, Qb, block], then the partials (acc [slots, B, N, block, D]
    relative to the piece's max m, m and l [slots, B, N, block]; NaN where
    no piece wrote) and the work list, for ``sparse_merge_reference``."""
    B, S, N, D = q.shape
    _check_seq(S, config)
    block = config.block
    sm_scale = _default_scale(q, sm_scale)
    idx = _cached_adjacency(config, S, bool(causal))[0]
    work = _cached_work(config, S, bool(causal))[0]
    qb, kb, vb = (_blocks(t, block) for t in (q, k, v))
    Qb = S // block
    o = torch.zeros((B, N, Qb, block, D), device=q.device)
    lse = torch.full((B, N, Qb, block), NEG_INF, device=q.device)
    nan = float("nan")
    acc = torch.full((work.slots, B, N, block, D), nan, device=q.device)
    m = torch.full((work.slots, B, N, block), nan, device=q.device)
    l = torch.full_like(m, nan)
    r = torch.arange(block, device=q.device)
    for qi, first, n, slot in work.items.tolist():
        if n == 0:
            continue                     # an empty list: O = 0, LSE NEG_INF
        ents = torch.from_numpy(np.array(idx[qi, first:first + n])).long()
        kg = kb[:, :, ents].reshape(B, N, n * block, D)
        vg = vb[:, :, ents].reshape(B, N, n * block, D)
        sc = torch.einsum("bnrd,bncd->bnrc", qb[:, :, qi], kg) * sm_scale
        keep = torch.ones((block, n * block), dtype=torch.bool,
                          device=q.device)
        if causal:
            k_pos = (ents.to(q.device)[:, None] * block + r).reshape(-1)
            keep = k_pos[None, :] <= (qi * block + r)[:, None]
        sc = torch.where(keep, sc, torch.full_like(sc, NEG_INF))
        mi = sc.amax(-1).clamp_min(M_FLOOR)
        p = torch.where(keep, torch.exp(sc - mi[..., None]),
                        torch.zeros_like(sc))
        li = p.sum(-1)
        ai = torch.einsum("bnrc,bncd->bnrd", p, vg)
        if slot < 0:
            l_safe = torch.where(li == 0, torch.ones_like(li), li)
            o[:, :, qi] = ai / l_safe[..., None]
            lse[:, :, qi] = mi + torch.log(l_safe)
        else:
            acc[slot], m[slot], l[slot] = ai, mi, li
    return o, lse, (acc, m, l), work


def sparse_merge_reference(o, lse, partials, work: WorkList):
    """Plain version of B5's second pass (``split_sum.cuh``,
    ``lse_merge``): for each split query block of ``work.sums``, its
    pieces' partials merged in slot order by the log-sum-exp rule (M = max
    m, f = exp(m - M), O = sum f acc / sum f l, LSE = M + log(sum f l)),
    written into ``o`` and ``lse`` (as ``sparse_pieces_reference`` returns
    them), which come back."""
    acc, m, l = partials
    for qi, s0, pieces in np.array(work.sums).tolist():
        M = m[s0]
        for p in range(1, pieces):
            M = torch.maximum(M, m[s0 + p])
        L = torch.zeros_like(M)
        A = torch.zeros_like(acc[s0])
        for p in range(pieces):
            f = torch.exp(m[s0 + p] - M)
            L = L + l[s0 + p] * f
            A = A + acc[s0 + p] * f[..., None]
        L_safe = torch.where(L == 0, torch.ones_like(L), L)
        o[:, :, qi] = A / L_safe[..., None]
        lse[:, :, qi] = M + torch.log(L_safe)
    return o, lse


def sparse_attention_split_reference(q, k, v, config: SparsityConfig, *,
                                     causal: bool = True,
                                     sm_scale: Optional[float] = None
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 B5's split walk in plain PyTorch: ``sparse_pieces_reference``
    then ``sparse_merge_reference``. Returns (O [B, S, N, D] in q's dtype,
    LSE [B, N, S, 1] f32), as ``sparse_attention_reference``."""
    B, S, N, D = q.shape
    o, lse, partials, work = sparse_pieces_reference(
        q, k, v, config, causal=causal, sm_scale=sm_scale)
    o, lse = sparse_merge_reference(o, lse, partials, work)
    return (_unblock(o).to(q.dtype).contiguous(),
            lse.reshape(B, N, S, 1).contiguous())


def sparse_attention_bwd_reference(q, k, v, o, lse, do,
                                   config: SparsityConfig, *,
                                   causal: bool = True,
                                   sm_scale: Optional[float] = None,
                                   parts=BWD_PARTS):
    """Plain version of B6 + B7: p = exp(s - LSE) on the listed pairs,
    delta = rowsum(dO * O), dS = p (dP - delta) sm_scale; dQ = dS K over
    the gathered blocks, dK = dS^T Q and dV = p^T dO scattered back to
    their key blocks with ``index_add_``. ``parts`` picks "dq" (B6) and/or
    "dkv" (B7); a part left out comes back as None. Returns (dQ, dK, dV)
    in q's dtype."""
    B, S, N, D = q.shape
    _check_seq(S, config)
    block = config.block
    sm_scale = _default_scale(q, sm_scale)
    qb, kg, s, keep, idx, _ = _scores(q, k, config, causal, sm_scale)
    lse_b = lse.float().reshape(B, N, S // block, block, 1)
    p = torch.where(keep, torch.exp(s - lse_b), torch.zeros_like(s))
    del s
    dob = _blocks(do, block)
    delta = (dob * _blocks(o, block)).sum(-1, keepdim=True)
    dp = torch.einsum("bnqrd,bnqcd->bnqrc", dob, _gather(v, idx, block))
    ds = p * (dp - delta) * sm_scale
    del dp
    dq = dk = dv = None
    if "dq" in parts:
        dq = _unblock(torch.einsum("bnqrc,bnqcd->bnqrd", ds, kg)).to(q.dtype)
    if "dkv" in parts:
        flat = idx.clamp_min(0).long().reshape(-1)

        def scatter(g):          # [B, N, Qb, deg * block, D] -> [B, S, N, D]
            g = g.reshape(B, N, -1, block, D)
            out = torch.zeros((B, N, S // block, block, D), dtype=g.dtype,
                              device=g.device)
            return _unblock(out.index_add_(2, flat, g))
        dk = scatter(torch.einsum("bnqrc,bnqrd->bnqcd", ds, qb)).to(k.dtype)
        dv = scatter(torch.einsum("bnqrc,bnqrd->bnqcd", p, dob)).to(v.dtype)
    return dq, dk, dv


# --------------------------------------------------------------------------
# the kernels' wrappers
# --------------------------------------------------------------------------

def _check(q, k, v, config, name):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{name} wants q, k, v of one shape [B, S, N, D]; "
                         f"got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if q.shape[-1] not in _HEAD_DIMS:
        raise ValueError(f"{name} supports head_dim {_HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    if config.block not in _BLOCKS:
        raise ValueError(f"{name} supports block {_BLOCKS}, got "
                         f"{config.block}")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {nm} must start on a 16-byte boundary "
                             "(the kernels load 16 bytes at once)")


def _check_vec(name, nm, t, shape, device):
    if t.shape != shape or t.dtype != torch.float32 \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: {nm} must be contiguous float32 {shape} "
                         f"on {device}")


def _plan(w: WorkList, q, block: int, widths):
    """Work list ``w``'s f32 workspaces for the pieces' partials: one
    [slots, B * N, block, width] tensor per width, from the caching
    allocator; none when nothing is split, and in f32, whose kernels walk
    whole lists. Returns them (to keep them alive through the launch) and
    the C arguments they give: the items, the sums and the workspaces'
    pointers (0 for none); the item and sum counts."""
    B, _, N, _ = q.shape
    ws = []
    if q.dtype == torch.bfloat16 and w.slots:
        ws = [torch.empty((w.slots, B * N, block, n), dtype=torch.float32,
                          device=q.device) for n in widths]
    ptrs = [t.data_ptr() for t in ws] or [0] * len(widths)
    return ws, (w.items.data_ptr(), w.sums.data_ptr(), *ptrs), \
        (w.items.shape[0], w.sums.shape[0])


def sparse_attention_fwd(q, k, v, config: SparsityConfig, *,
                         causal: bool = True, sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k, v: [B, S, N, D]. Returns (O [B, S, N, D] in q's dtype, LSE
    [B, N, S, 1] f32)."""
    sm_scale = _default_scale(q, sm_scale)
    _check_seq(q.shape[1], config)
    if not _on_cuda(q, "sparse_fwd"):
        return sparse_attention_reference(q, k, v, config, causal=causal,
                                          sm_scale=sm_scale)
    _check(q, k, v, config, "sparse_fwd")
    B, S, N, D = q.shape
    idx, cnt = adjacency_tables(config, S, bool(causal), q.device)[:2]
    o = torch.empty_like(q)
    lse = torch.empty((B, N, S, 1), dtype=torch.float32, device=q.device)
    # the bf16 kernel walks B6's row work list; a split row's pieces write
    # acc and (m, l) partials that its second pass merges
    work = work_tables(config, S, bool(causal), q.device)[0]
    ws, ptrs, counts = _plan(work, q, config.block, (D, 2))
    SPARSE_FWD.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      idx.data_ptr(), cnt.data_ptr(), *ptrs, o.data_ptr(),
                      lse.data_ptr(), B, S, N, D, config.block, idx.shape[1],
                      *counts, _DTYPES[q.dtype], int(bool(causal)),
                      float(sm_scale), stream_handle(q))
    return o, lse


def sparse_attention_bwd(q, k, v, o, lse, do, config: SparsityConfig, *,
                         causal: bool = True, sm_scale: Optional[float] = None,
                         parts=BWD_PARTS):
    """Gradients (dQ, dK, dV) of ``sparse_attention`` from the forward's O
    and LSE and the output gradient ``do`` [B, S, N, D]. On CUDA: delta =
    rowsum(dO * O) in one torch pass, then ``sparse_bwd_launch``: B6 (dQ)
    and B7 (dK/dV). ``parts`` picks the kernels ("dq", "dkv"; a part left
    out comes back as None)."""
    sm_scale = _default_scale(q, sm_scale)
    _check_seq(q.shape[1], config)
    if not _on_cuda(q, "sparse_bwd"):
        return sparse_attention_bwd_reference(
            q, k, v, o, lse, do, config, causal=causal, sm_scale=sm_scale,
            parts=parts)
    if o.shape != q.shape or o.dtype != q.dtype or o.device != q.device:
        raise ValueError(f"sparse_bwd: o must be a {q.dtype} "
                         f"{tuple(q.shape)} on {q.device}")
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return sparse_bwd_launch(
        q, k, v, do, lse, delta, config,
        adjacency_tables(config, q.shape[1], bool(causal), q.device),
        causal=causal, sm_scale=sm_scale, parts=parts)


def sparse_bwd_launch(q, k, v, do, lse, delta, config: SparsityConfig,
                      tables, *, causal: bool, sm_scale: float,
                      parts=BWD_PARTS, work=None):
    """B6 and/or B7 on CUDA tensors, given delta = rowsum(dO * O) [B, N, S]
    f32 and the adjacency ``tables`` (idx, cnt, cidx, ccnt) int32 on the
    card: the launches of ``sparse_attention_bwd``. In bf16 each kernel
    walks its work list (``work_list``: lists longer than C cut into
    pieces whose f32 partials a second pass in the same launch adds up).
    A measurement calls it alone to time the kernels without the delta
    pass, or B7 on a transposed table cut to one key block: ``work``, the
    (B6, B7) work lists of ``tables`` (default ``work_for(tables, ...)``,
    which copies a cut table's counts to the host: a timing passes them
    made beforehand)."""
    if not _on_cuda(q, "sparse_bwd"):
        raise ValueError(f"sparse_bwd_launch runs on cuda, not {q.device}")
    _check(q, k, v, config, "sparse_bwd")
    B, S, N, D = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous() \
            or do.device != q.device or do.data_ptr() % 16:
        raise ValueError(f"sparse_bwd: do must be a contiguous {q.dtype} "
                         f"{tuple(q.shape)} on {q.device}, 16-byte aligned")
    _check_vec("sparse_bwd", "lse", lse, (B, N, S, 1), q.device)
    _check_vec("sparse_bwd", "delta", delta, (B, N, S), q.device)
    for t in tables:
        if t.dtype != torch.int32 or t.device != q.device \
                or not t.is_contiguous() or t.shape[0] != S // config.block:
            raise ValueError(f"sparse_bwd: adjacency tables must be "
                             f"contiguous int32 on {q.device} with "
                             f"{S // config.block} rows")
    idx, cnt, cidx, ccnt = tables
    work_dq, work_dkv = work or work_for(tables, config, S, causal, q.device)
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())
    common = (_DTYPES[q.dtype], int(bool(causal)), float(sm_scale),
              stream_handle(q))

    dq = dk = dv = None
    if "dq" in parts:
        dq = torch.empty_like(q)
        ws, ptrs, counts = _plan(work_dq, q, config.block, (D,))
        SPARSE_BWD_DQ.launch(*inputs, idx.data_ptr(), cnt.data_ptr(), *ptrs,
                             dq.data_ptr(), B, S, N, D, config.block,
                             idx.shape[1], *counts, *common)
    if "dkv" in parts:
        dk = torch.empty_like(k)
        dv = torch.empty_like(v)
        ws, ptrs, counts = _plan(work_dkv, q, config.block, (D, D))
        SPARSE_BWD_DKV.launch(*inputs, cidx.data_ptr(), ccnt.data_ptr(),
                              *ptrs, dk.data_ptr(), dv.data_ptr(), B, S, N,
                              D, config.block, cidx.shape[1], *counts,
                              *common)
    return dq, dk, dv


class _SparseAttention(torch.autograd.Function):
    """``_sparse`` and its ``custom_vjp``: forward B5, backward B6 + B7
    (``reference``: their plain versions, by name)."""

    @staticmethod
    def forward(ctx, q, k, v, config, causal, sm_scale, reference):
        fwd = sparse_attention_reference if reference else sparse_attention_fwd
        o, lse = fwd(q, k, v, config, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.config, ctx.causal = config, causal
        ctx.sm_scale, ctx.reference = sm_scale, reference
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = (sparse_attention_bwd_reference if ctx.reference
               else sparse_attention_bwd)
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), ctx.config,
                         causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None, None


def sparse_attention(q, k, v, config: SparsityConfig, *, causal: bool = True,
                     sm_scale: Optional[float] = None,
                     reference: bool = False) -> torch.Tensor:
    """Block-sparse attention. q, k, v: [B, S, N, D] -> [B, S, N, D],
    differentiable in q, k and v. The layout's tables are made once per
    (config, S, causal, device). reference: the plain versions of all
    three kernels, on any device (comparisons)."""
    return _SparseAttention.apply(q, k, v, config, bool(causal),
                                  float(_default_scale(q, sm_scale)),
                                  bool(reference))
