#!/usr/bin/env python3
"""Drive deepspeed_tpu_torch on one NVIDIA H100 (or another sm_90 card).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which raises on failure (exit code != 0):

1. build: the CUDA kernels from ``deepspeed_tpu_torch/csrc/*.cu``, one
   ``nvcc`` per source, all started together, with ``-Xptxas -v``; for
   the kernels on wgmma (flash forward B1, backward B2, B3; sparse
   forward B5, backward B6, B7) each kernel's registers, shared memory
   and spills, ptxas's warnings, and its SASS census (``cuobjdump
   -sass``: HGMMA = wgmma, UTMALDG = TMA loads, atomics). A bf16 kernel
   of those without HGMMA or UTMALDG, or with spills, and any atomic in
   their libraries, fail the run. The paged decode (B4) has a census of
   its own: its split kernels must stage by bulk copies (UBLKCP, or
   UTMALDG), and nothing in its library may spill or use atomics;
2. kernels: each kernel at the serving and training paths' shapes (and a
   few more) against its plain PyTorch version on the same inputs
   (relative L2 < 2e-2 in bf16, < 1e-4 in f32; B1's LSE < 1e-4 over the
   rows that see a key, and its fully masked rows exactly O = 0 and LSE =
   M_FLOOR; B4's empty slot exactly v_row, with a case of lengths on its
   pieces' edges and past the table), timed with CUDA events beside the
   plain version, SDPA (forward, or its backward for the backward
   kernels: B2 + B3 beside it as a pair) as a library yardstick, and the
   least time the card could take (bytes over 3.35 TB/s vs flops over
   the dtype's peak); B1, B2, B3 and B4 launched twice must agree bit for
   bit;
3. serving: llama-7b at full width and depth (random weights from a seed,
   bf16) through ``init_serving``: 24 requests, prompts of 64..1024 tokens,
   32 new tokens each, on 16 slots. Every request must finish with 32
   in-vocab tokens, the pool must be empty afterwards, and the kernels'
   launch counts (zeroed just before the run) must cover every prefill and
   decode step of all 32 layers;
4. cross-check: on the same weights, one prefill and 4 teacher-forced
   decode steps through the kernels against the plain versions;
5. training: the serving engine freed, llama-1b at full width and depth
   (random weights from seed 0, bf16 with f32 masters, AdamW, ZeRO-1,
   dots_saveable remat, chunked loss, fused attention backward: the
   settings of the JAX bench's ladder row ("1b", 2048, 8)) through
   ``initialize`` -> ``train_batch`` on one fixed batch of 8 x 2048
   tokens: 1 warm-up step and 8 timed steps with the launch counts zeroed
   just before them. Losses must be finite and fall, and the flash
   forward (with its remat replay) and both backward kernels must have
   run for every layer of every step. One more step runs under
   torch.profiler and prints where its device time goes;
6. training cross-check: llama-1b width, 2 layers, S=512: the loss and
   the grad of every leaf through the kernels against the plain versions,
   in f32 under dots_saveable (B1 replayed: 2 launches per layer) and
   dots_and_attn (B1's outputs kept: 1 launch per layer), and in bf16
   (the tensor-core kernels) under dots_saveable;
7. sparse kernels (B5-B7, in phase 2's place in the run): the training
   path's shape (BigBird, B=2 S=8192 N=32 D=64, block 128, bf16), the JAX
   bench's three layouts (``bench.py:893-901``), a non-causal and an f32
   case, each against the plain version (gathered over the adjacency),
   timed beside it, beside flex_attention with a BlockMask of the layout
   (compiled by torch.compile; the library time: B5 beside flex's
   forward in every case), beside SDPA with the layout as a dense boolean
   mask, and beside the bound; B5, B6 and B7 launched twice must agree
   bit for bit; their work lists (C, the pieces of the split lists)
   logged; B7's longest key column timed alone; the main shape also
   beside dense B1 + B2 + B3; and B5 on a layout with a split global row
   and a query block that lists nothing (exactly O = 0, LSE = -1e30);
8. sparse training: llama-1b at full width and depth, S=8192, the BigBird
   layout, B=2, 1 warm-up + 8 timed steps with the counts zeroed just
   before them: losses must fall, B5 (forward and its replay), B6 and B7
   must have run for every layer of every step and the flash kernels not
   at all (no key mask: the sparse route); one step profiled; then the
   same model dense (B1-B3) at the same B and S, 1 warm-up + 3 steps;
9. sparse training cross-check: llama-1b width, 2 layers, S=2048, the
   BigBird layout, loss and every grad through B5-B7 against the plain
   versions, in f32 (dots_saveable and dots_and_attn: both replay B5)
   and bf16.

Prints the card's name and power limit first, one ``{"kernels": [...]}``
line, and as its last line ``{"ok": true, "device": {...}}``. Imports
torch, numpy and the port only.
"""

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
VOCAB = 32000


def log(msg: str) -> None:
    print(msg, flush=True)


def rel_l2(got, want) -> float:
    got, want = got.double().ravel(), want.double().ravel()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def max_abs(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def cuda_ms(fn, iters: int = 10, warmup: int = 2, batch: int = 1) -> float:
    """Median CUDA-event time of one call of ``fn``, in ms. Each of the
    ``iters`` samples starts on an idle card, so it includes the host's
    work before the first launch (the wrapper's checks and allocations);
    ``batch`` > 1 times that many calls back to back in each sample and
    divides, so the host runs ahead and the time is the card's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return float(np.median(times))


def bound(nbytes: float, flops: float, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# --------------------------------------------------------------------------
# kernel phases
# --------------------------------------------------------------------------

def _attn_inputs(B, S, N, Nkv, D, dtype, masked, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((B, S, N, D), generator=g, device="cuda",
                         dtype=dtype) for _ in range(2))
    k, v = (torch.randn((B, S, Nkv, D), generator=g, device="cuda",
                        dtype=dtype) for _ in range(2))
    keep = torch.tril(torch.ones((S, S), dtype=torch.bool, device="cuda"))
    keep = keep[None].expand(B, S, S)
    mask = None
    if masked:                      # right padding, and key 0 masked: the
        lens = torch.tensor([S - S // 4] + [S] * (B - 1), device="cuda")
        mask = torch.arange(S, device="cuda")[None, :] < lens[:, None]
        mask[:, 0] = False          # causal row 0 is then fully masked
        keep = keep & mask[:, None, :]
    return q, k, v, do, mask, keep


def flash_case(name, B, S, N, Nkv, D, dtype, masked=False, seed=0):
    """B1 against the plain version: O by relative L2, LSE by relative L2
    over the rows that see a key (a fully masked row's M_FLOOR = -1e20
    would swamp any error in the others), fully masked rows exactly O = 0
    and LSE = M_FLOOR, a second launch bit for bit; then timed beside the
    plain version, SDPA's forward and the bound."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        M_FLOOR, flash_attention_fwd, flash_attention_reference)
    q, k, v, _, mask, keep = _attn_inputs(B, S, N, Nkv, D, dtype, masked,
                                          seed)
    o, lse = flash_attention_fwd(q, k, v, causal=True, kv_mask=mask)
    ro, rlse = flash_attention_reference(q, k, v, causal=True, kv_mask=mask)
    again = flash_attention_fwd(q, k, v, causal=True, kv_mask=mask)
    torch.cuda.synchronize()
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        raise RuntimeError(f"flash_fwd {name}: non-finite output")
    live = keep.any(-1)                              # [B, S]
    by_row, ref_row = (x[..., 0].transpose(1, 2) for x in (lse, rlse))
    err, err_lse = rel_l2(o, ro), rel_l2(by_row[live], ref_row[live])
    if err >= TOL[dtype] or err_lse >= 1e-4:
        raise RuntimeError(f"flash_fwd {name}: rel L2 {err:.3g} (O), "
                           f"{err_lse:.3g} (LSE of the live rows) vs the "
                           "plain version")
    dead = int((~live).sum())
    if not (torch.all(o[~live] == 0) and torch.all(by_row[~live] == M_FLOOR)):
        raise RuntimeError(f"flash_fwd {name}: a fully masked row is not "
                           "exactly O = 0, LSE = M_FLOOR")
    bitwise = {"o": bool(torch.equal(o, again[0])),
               "lse": bool(torch.equal(lse, again[1]))}
    if not all(bitwise.values()):
        raise RuntimeError(f"flash_fwd {name}: two launches differ {bitwise}")
    del again
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=True,
                                             kv_mask=mask))
    plain_ms = cuda_ms(lambda: flash_attention_reference(
        q, k, v, causal=True, kv_mask=mask), iters=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if masked:
        am = keep[:, None]
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=am,
                                          enable_gqa=True))
    else:
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                          enable_gqa=True))
    pairs = float(keep.sum()) * N            # (query head, key) pairs visible
    flops = 4.0 * D * pairs
    moved = nbytes(q, k, v, o, lse) + (0 if mask is None else B * S)
    bound_ms, bound_by = bound(moved, flops, dtype)
    rec = dict(case=name, shape=f"B={B} S={S} Nq={N} Nkv={Nkv} D={D} "
               f"{str(dtype).split('.')[-1]} causal"
               + (" kv_mask" if masked else ""),
               rel_l2=err, rel_l2_lse=err_lse, fully_masked_positions=dead,
               max_abs_err=max_abs(o, ro), bitwise_repeat=bitwise,
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               tflops=flops / ms / 1e9)
    log("flash_fwd " + json.dumps(rec))
    return rec


def decode_case(name, S, Nq, Nkv, D, bs, MB, lens, dtype, seed=0):
    from deepspeed_tpu_torch.ops.decode_attention import (
        decode_pieces, paged_decode_attention, paged_decode_reference)
    NB = S * MB + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((S, 1, Nq, D), generator=g, device="cuda", dtype=dtype)
    kp = torch.randn((NB, Nkv, bs, D), generator=g, device="cuda", dtype=dtype)
    vp = torch.randn((NB, Nkv, bs, D), generator=g, device="cuda", dtype=dtype)
    row = (torch.randn((S, Nkv, 1, D), generator=g, device="cuda", dtype=dtype),
           torch.randn((S, Nkv, 1, D), generator=g, device="cuda", dtype=dtype))
    rng = np.random.default_rng(seed)
    tab_np = rng.permutation(np.arange(1, NB)).reshape(S, MB).astype(np.int32)
    lens_np = np.asarray(lens, np.int32)
    # garbage where nothing may be read: the trash block, stale rows
    kp[0] = vp[0] = 1e4
    for s, n in enumerate(lens_np):
        if n < MB * bs and n % bs:
            blk = int(tab_np[s, n // bs])
            kp[blk, :, n % bs:] = vp[blk, :, n % bs:] = 1e4
    tables = torch.from_numpy(tab_np).cuda()
    ln = torch.from_numpy(lens_np).cuda()
    out = paged_decode_attention(q, kp, vp, tables, ln, kv_row=row)
    again = paged_decode_attention(q, kp, vp, tables, ln, kv_row=row)
    ref = paged_decode_reference(q, kp, vp, tables, ln, kv_row=row)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"paged_decode {name}: non-finite output")
    err = rel_l2(out, ref)
    if err >= TOL[dtype]:
        raise RuntimeError(f"paged_decode {name}: rel L2 {err:.3g} vs the "
                           "plain version")
    # the pieces are merged in a fixed order: bit for bit the same
    if not torch.equal(out, again):
        raise RuntimeError(f"paged_decode {name}: two launches differ")
    del again
    for s in np.flatnonzero(lens_np == 0):
        if not torch.equal(out[s, 0],
                           row[1][s, :, 0].repeat_interleave(Nq // Nkv, 0)):
            raise RuntimeError(f"paged_decode {name}: empty slot {s} is not "
                               "exactly v_row")
    ms = cuda_ms(lambda: paged_decode_attention(q, kp, vp, tables, ln,
                                                kv_row=row))
    ms_batched = cuda_ms(lambda: paged_decode_attention(
        q, kp, vp, tables, ln, kv_row=row), batch=20)
    plain_ms = cuda_ms(lambda: paged_decode_reference(
        q, kp, vp, tables, ln, kv_row=row), iters=5, warmup=1)
    # yardstick: SDPA over the already-gathered view (gather not timed)
    T = MB * bs
    kg = torch.cat([kp[tables.long()].permute(0, 2, 1, 3, 4)
                    .reshape(S, Nkv, T, D), row[0]], dim=2)
    vg = torch.cat([vp[tables.long()].permute(0, 2, 1, 3, 4)
                    .reshape(S, Nkv, T, D), row[1]], dim=2)
    am = torch.cat([torch.arange(T, device="cuda")[None, :] < ln[:, None].long(),
                    torch.ones((S, 1), dtype=torch.bool, device="cuda")],
                   dim=1)[:, None, None, :]
    qt = q.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kg, vg, attn_mask=am, enable_gqa=True))
    del kg, vg
    # what the kernel reads: the rows below min(len, MB bs)
    walked = np.minimum(lens_np, MB * bs)
    valid = float(walked.sum())
    blocks = float(sum(-(-int(n) // bs) for n in walked))
    esz = q.element_size()
    moved = (2 * valid * Nkv * D * esz + nbytes(q, out, *row)
             + 4 * blocks + 4 * S)
    flops = 4.0 * D * Nq * (valid + S)
    bound_ms, bound_by = bound(moved, flops, dtype)
    R, P = decode_pieces(MB, bs)
    rec = dict(case=name, shape=f"slots={S} Nq={Nq} Nkv={Nkv} D={D} bs={bs} "
               f"MB={MB} {str(dtype).split('.')[-1]} lens={lens}",
               rel_l2=err, max_abs_err=max_abs(out, ref), bitwise_repeat=True,
               pieces={"rows": R, "per_slot": P,
                       "walked": int(sum(-(-int(n) // R) for n in walked))},
               ms=ms, ms_batched=ms_batched, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
               share_of_bound=bound_ms / ms, gb_per_s=moved / ms / 1e6)
    log("paged_decode " + json.dumps(rec))
    return rec


def bwd_case(name, B, S, N, Nkv, D, dtype, masked=False, seed=0):
    """B2 (dQ) and B3 (dK/dV), fused and unfused delta, against the plain
    backward on the same inputs, and a second launch against the first
    (bit for bit); then each kernel timed alone, beside its plain part,
    and B2 + B3 beside SDPA's backward (which computes dQ, dK and dV in
    one call)."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd)
    q, k, v, do, mask, keep = _attn_inputs(B, S, N, Nkv, D, dtype, masked,
                                           seed)
    o, lse = flash_attention_fwd(q, k, v, causal=True, kv_mask=mask)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True,
                                         kv_mask=mask)
    errs, max_err = {}, {"dq": 0.0, "dkv": 0.0}
    for fused in (False, True):
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                  kv_mask=mask, fused=fused)
        torch.cuda.synchronize()
        for part, a, b in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a).all():
                raise RuntimeError(f"flash_bwd {name}: non-finite {part}")
            err = rel_l2(a, b)
            errs[f"{part}{'_fused' if fused else ''}"] = err
            if err >= TOL[dtype]:
                raise RuntimeError(f"flash_bwd {name} fused={fused}: rel L2 "
                                   f"{err:.3g} ({part}) vs the plain version")
            kern = "dq" if part == "dq" else "dkv"
            max_err[kern] = max(max_err[kern], max_abs(a, b))
        if masked and not torch.all(got[0][:, 0] == 0):
            raise RuntimeError(f"flash_bwd {name}: the fully masked row has "
                               "a nonzero dQ")
    # deterministic: a second launch of B2 and of B3, right after the
    # first, gives the same dQ, dK and dV bit for bit (no atomics)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                kv_mask=mask, fused=True)
    torch.cuda.synchronize()
    bitwise = {p: bool(torch.equal(a, b))
               for p, a, b in zip(("dq", "dk", "dv"), got, again)}
    if not all(bitwise.values()):
        raise RuntimeError(f"flash_bwd {name}: two launches differ {bitwise}")
    del want, got, again
    torch.cuda.empty_cache()
    pairs = float(keep.sum()) * N        # (query head, key) pairs visible
    recs = {}
    for part, products in (("dq", 3), ("dkv", 4)):
        ms = {f: cuda_ms(lambda: flash_attention_bwd(
            q, k, v, o, lse, do, causal=True, kv_mask=mask, fused=f,
            parts=(part,))) for f in (True, False)}
        plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=True, kv_mask=mask, parts=(part,)),
            iters=3, warmup=1)
        outs = (q,) if part == "dq" else (k, v)       # dQ; dK, dV
        # the fused kernel (the training path's) reads O for delta
        moved = nbytes(q, do, k, v, lse, o, *outs) \
            + (0 if mask is None else B * S)
        flops = 2.0 * D * products * pairs
        bound_ms, bound_by = bound(moved, flops, dtype)
        recs[part] = dict(ms=ms[True], ms_unfused=ms[False],
                          plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, tflops=flops / ms[True] / 1e9)
    # yardstick: SDPA's backward (dQ, dK and dV in one call) on the same
    # inputs, in its [B, N, S, D] layout
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if masked:
        out = sdpa(qt, kt, vt, attn_mask=keep[:, None], enable_gqa=True)
    else:
        out = sdpa(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    del out, qt, kt, vt
    shape = (f"B={B} S={S} Nq={N} Nkv={Nkv} D={D} "
             f"{str(dtype).split('.')[-1]} causal"
             + (" kv_mask" if masked else ""))
    # B2 + B3, the pair that SDPA's one backward call replaces
    pair_ms = recs["dq"]["ms"] + recs["dkv"]["ms"]
    out = {}
    for part in ("dq", "dkv"):
        out[part] = dict(case=name, shape=shape, rel_l2=errs,
                         max_abs_err=max_err[part], library_ms=library_ms,
                         b2_plus_b3_ms=pair_ms,
                         b2_plus_b3_over_library=pair_ms / library_ms,
                         bitwise_repeat=bitwise, **recs[part])
        log(f"flash_bwd_{part} " + json.dumps(out[part]))
    return out


def kernel_phase():
    bf, f32 = torch.bfloat16, torch.float32
    flash = [
        flash_case("llama-7b S=64", 1, 64, 32, 32, 128, bf),
        flash_case("llama-7b S=1024 (1000-token prompt bucket)",
                   1, 1024, 32, 32, 128, bf),
        flash_case("llama-7b S=2048", 1, 2048, 32, 32, 128, bf),
        flash_case("llama-70b GQA 64/8 S=1024", 1, 1024, 64, 8, 128, bf),
        flash_case("llama-1b D=64 rep=4 S=1024", 1, 1024, 32, 8, 64, bf),
        flash_case("llama-1b training B=8 S=2048", 8, 2048, 32, 8, 64, bf),
        flash_case("llama-7b kv_mask S=1000", 2, 1000, 32, 32, 128, bf,
                   masked=True),
        flash_case("llama-7b f32 S=256", 1, 256, 32, 32, 128, f32),
    ]
    lens = [0, 1, 63, 64, 65, 100, 333, 500, 777, 1000, 1024, 1234, 1500,
            2000, 2047, 2048]
    decode = [
        decode_case("llama-7b 16 slots", 16, 32, 32, 128, 64, 32, lens, bf),
        decode_case("llama-70b GQA 64/8 16 slots", 16, 64, 8, 128, 64, 32,
                    lens, bf),
        decode_case("llama-1b D=64 rep=4 16 slots", 16, 32, 8, 64, 64, 32,
                    lens, bf),
        decode_case("llama-7b f32 16 slots", 16, 32, 32, 128, 64, 32, lens,
                    f32),
        # B4's piece edges (R = 256 at bs 64) and a slot 3 rows past its
        # table (read as MB bs = 2048)
        decode_case("llama-70b GQA 64/8 piece edges", 8, 64, 8, 128, 64, 32,
                    [0, 1, 255, 256, 257, 1024, 2048, 2051], bf),
    ]
    bwd = [
        bwd_case("llama-1b training B=8 S=2048", 8, 2048, 32, 8, 64, bf),
        bwd_case("llama-7b S=2048", 1, 2048, 32, 32, 128, bf),
        bwd_case("llama-70b GQA 64/8 S=1024", 1, 1024, 64, 8, 128, bf),
        bwd_case("llama-1b kv_mask S=1000", 2, 1000, 32, 8, 64, bf,
                 masked=True),
        bwd_case("llama-1b f32 S=256", 2, 256, 32, 8, 64, f32),
    ]
    torch.cuda.empty_cache()
    return flash, decode, bwd


# --------------------------------------------------------------------------
# block-sparse kernel phase (B5-B7)
# --------------------------------------------------------------------------

# the JAX bench's BigBird layout (bench.py:1181-1183)
BIGBIRD_128 = dict(block=128, num_random_blocks=1,
                   num_sliding_window_blocks=3, num_global_blocks=1)


def _layout_mask(cfg, S, causal):
    """[S, S] bool on the card: the pairs the layout lets a query see (the
    SDPA yardstick's attn_mask)."""
    blk = torch.from_numpy(cfg.make_layout(S)).cuda()
    keep = blk.repeat_interleave(cfg.block, 0).repeat_interleave(cfg.block, 1)
    return torch.tril(keep) if causal else keep


def _flex_yardstick(cfg, S, causal, q, k, v, do, o, grads):
    """flex_attention (compiled by torch.compile into Triton kernels) with a
    BlockMask made from the layout: a library call that, like B5-B7, skips
    the blocks the layout leaves out (SDPA with a boolean mask does all
    S^2). The BlockMask's tiles are 128 x 128: a tile with every pair
    visible is full, one with some is partial and masked by position. Its
    O and grads are held against the kernels' (rel L2 < 2e-2: the same
    function). Returns (forward ms, whole backward ms, errors)."""
    from torch.nn.attention.flex_attention import BlockMask, flex_attention
    F, blk = 128, cfg.block
    lay = torch.from_numpy(cfg.make_layout(S)).cuda()
    if causal:
        lay = torch.tril(lay)
    n, r = S // F, F // blk
    sub = lay.reshape(n, r, n, r)
    listed, full = sub.any(3).any(1), sub.all(3).all(1)
    if causal:                  # a diagonal tile is never full
        full &= torch.tril(torch.ones_like(full), -1)
    partial = listed & ~full

    def kv_table(m):            # counts [1, 1, n], indices [1, 1, n, n]
        order = torch.argsort((~m).int(), dim=1, stable=True)
        return m.sum(1).int()[None, None], order.int()[None, None].contiguous()

    def mask_mod(b, h, qi, ki):
        seen = lay[qi // blk, ki // blk]
        return seen & (ki <= qi) if causal else seen

    bm = BlockMask.from_kv_blocks(*kv_table(partial), *kv_table(full),
                                  BLOCK_SIZE=F, mask_mod=mask_mod)
    flex = torch.compile(flex_attention, dynamic=False)
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    # the forward timed as training runs it (one compile serves both)
    fwd_ms = cuda_ms(lambda: flex(qt, kt, vt, block_mask=bm))
    out = flex(qt, kt, vt, block_mask=bm)
    dot = do.transpose(1, 2).contiguous()
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                 retain_graph=True))
    lib = (out,) + torch.autograd.grad(out, (qt, kt, vt), dot)
    errs = {p: rel_l2(a.detach().transpose(1, 2), b)
            for p, a, b in zip(("o", "dq", "dk", "dv"), lib, (o,) + grads)}
    if not max(errs.values()) < 2e-2:
        raise RuntimeError(f"flex_attention yardstick: rel L2 {errs} vs "
                           "the kernels")
    return fwd_ms, bwd_ms, errs


def sparse_case(name, mode, kw, B, S, N, D, dtype, causal=True, seed=0,
                dense=False):
    """B5, B6 and B7 on one layout, each against its plain version on the
    same inputs (B6/B7 from B5's O and LSE), then timed alone (B6/B7 with
    delta precomputed) beside the plain version, flex_attention with a
    BlockMask of the layout (the library time: its forward; its whole
    backward for B6/B7), SDPA with the layout as a dense boolean attn_mask
    and the bound. B7's longest key column (the global one) is timed alone
    and the rest without it. ``dense``: B1 + B2 + B3 at the same shape
    with the model's 8 kv heads (the dense route of the same layer)."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    cfg = sa.get_sparsity_config(mode, **kw)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((B, S, N, D), generator=g, device="cuda",
                               dtype=dtype) for _ in range(4))
    o, lse = sa.sparse_attention_fwd(q, k, v, cfg, causal=causal)
    o2, lse2 = sa.sparse_attention_fwd(q, k, v, cfg, causal=causal)
    ro, rlse = sa.sparse_attention_reference(q, k, v, cfg, causal=causal)
    got = sa.sparse_attention_bwd(q, k, v, o, lse, do, cfg, causal=causal)
    again = sa.sparse_attention_bwd(q, k, v, o, lse, do, cfg, causal=causal)
    want = sa.sparse_attention_bwd_reference(q, k, v, o, lse, do, cfg,
                                             causal=causal)
    torch.cuda.synchronize()
    for part, a in zip(("o", "lse", "dq", "dk", "dv"), (o, lse) + got):
        if not torch.isfinite(a).all():
            raise RuntimeError(f"sparse {name}: non-finite {part}")
    # B5 merges and B6/B7 sum their split walks in a fixed order: bit for
    # bit the same
    differ = [p for p, a, b in zip(("o", "lse", "dq", "dk", "dv"),
                                   (o, lse) + got, (o2, lse2) + again)
              if not torch.equal(a, b)]
    if differ:
        raise RuntimeError(f"sparse {name}: a second launch changed {differ}")
    del again, o2, lse2
    errs = {"o": rel_l2(o, ro), "lse": rel_l2(lse, rlse)}
    errs.update((p, rel_l2(a, b)) for p, a, b in zip(("dq", "dk", "dv"),
                                                     got, want))
    bad = {p: e for p, e in errs.items()
           if not e < (1e-4 if p == "lse" else TOL[dtype])}
    if bad:
        raise RuntimeError(f"sparse {name}: rel L2 {bad} vs the plain "
                           "version")
    max_err = {"fwd": max_abs(o, ro), "dq": max_abs(got[0], want[0]),
               "dkv": max(max_abs(got[1], want[1]), max_abs(got[2], want[2]))}
    del ro, rlse, want
    torch.cuda.empty_cache()

    tables = sa.adjacency_tables(cfg, S, causal, q.device)
    idx, cnt, cidx, ccnt = tables
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()

    def bwd(part, tabs=tables, work=None):
        return sa.sparse_bwd_launch(q, k, v, do, lse, delta, cfg, tabs,
                                    causal=causal, sm_scale=1.0 / D ** 0.5,
                                    parts=(part,), work=work)
    fwd_batched = cuda_ms(lambda: sa.sparse_attention_fwd(
        q, k, v, cfg, causal=causal), batch=20)
    ms = {"fwd": cuda_ms(lambda: sa.sparse_attention_fwd(q, k, v, cfg,
                                                         causal=causal)),
          "dq": cuda_ms(lambda: bwd("dq")), "dkv": cuda_ms(lambda: bwd("dkv"))}
    plain = {"fwd": cuda_ms(lambda: sa.sparse_attention_reference(
        q, k, v, cfg, causal=causal), iters=3, warmup=1)}
    for part in ("dq", "dkv"):
        plain[part] = cuda_ms(lambda: sa.sparse_attention_bwd_reference(
            q, k, v, o, lse, do, cfg, causal=causal, parts=(part,)),
            iters=3, warmup=1)
    # B7's load: the key block listed most (the global column) alone, then
    # every other block without it
    top = int(ccnt.argmax())
    only, rest = torch.zeros_like(ccnt), ccnt.clone()
    only[top], rest[top] = ccnt[top], 0
    cut = {n: (idx, cnt, cidx, c) for n, c in (("only", only), ("rest", rest))}
    work = {n: sa.work_for(t, cfg, S, causal, q.device) for n, t in cut.items()}
    tail = {"key_block": top, "its_query_blocks": int(ccnt[top]),
            "median_query_blocks": float(ccnt.float().median()),
            "dkv_ms_that_block_alone": cuda_ms(
                lambda: bwd("dkv", cut["only"], work["only"])),
            "dkv_ms_all_others": cuda_ms(
                lambda: bwd("dkv", cut["rest"], work["rest"]))}
    lib_fwd, lib_bwd, lib_err = _flex_yardstick(cfg, S, causal, q, k, v, do,
                                                o, got)
    del got
    # second yardstick: SDPA with the layout as a dense boolean mask
    keep = _layout_mask(cfg, S, causal)
    visible = float(keep.sum())
    am = keep[None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    with torch.no_grad():
        sdpa_fwd = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=am))
    out = sdpa(qt, kt, vt, attn_mask=am)
    dot = do.transpose(1, 2).contiguous()
    sdpa_bwd = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                   retain_graph=True))
    del out, qt, kt, vt, dot, am, keep
    torch.cuda.empty_cache()

    listed = int(cnt.sum())
    # the pairs the function computes: every visible (query, key) pair,
    # so half of each diagonal block under causal masking
    unit = D * visible * B * N
    act = B * S * N * D * q.element_size()         # one [B, S, N, D] tensor
    vec = B * N * S * 4                             # LSE or delta, f32
    work = {"fwd": (4 * act + vec + nbytes(idx, cnt), 4 * unit),
            "dq": (5 * act + 2 * vec + nbytes(idx, cnt), 6 * unit),
            "dkv": (6 * act + 2 * vec + nbytes(cidx, ccnt), 8 * unit)}
    shape = (f"B={B} S={S} N={N} D={D} {str(dtype).split('.')[-1]} {mode} "
             f"block {cfg.block} {'causal' if causal else 'non-causal'}, "
             f"{listed} listed block pairs, {visible / S / S:.4f} of S^2 "
             "visible")
    recs = {}
    for part, (moved, flops) in work.items():
        bound_ms, bound_by = bound(moved, flops, dtype)
        recs[part] = dict(case=name, shape=shape, rel_l2=errs,
                          max_abs_err=max_err[part], ms=ms[part],
                          plain_ms=plain[part],
                          library_ms=lib_fwd if part == "fwd" else lib_bwd,
                          library="flex_attention + BlockMask",
                          library_rel_l2=lib_err,
                          sdpa_dense_mask_ms=(sdpa_fwd if part == "fwd"
                                              else sdpa_bwd),
                          bound_ms=bound_ms, bound_by=bound_by,
                          tflops=flops / ms[part] / 1e9)
    recs["dkv"]["tail"] = tail
    recs["fwd"]["over_library"] = ms["fwd"] / lib_fwd
    recs["fwd"]["ms_batched"] = fwd_batched
    # the bf16 kernels' work lists (B5 walks B6's): C, and the pieces of
    # the split lists
    if dtype == torch.bfloat16:
        rows, cols = sa.work_tables(cfg, S, causal, q.device)
        for part, w in (("fwd", rows), ("dq", rows), ("dkv", cols)):
            recs[part]["work"] = {"chunk": w.chunk, "items": len(w.items),
                                  "split_lists": len(w.sums),
                                  "pieces": w.slots}
    if dense:
        from deepspeed_tpu_torch.ops.flash_attention import (
            flash_attention_bwd, flash_attention_fwd)
        kd, vd = (torch.randn((B, S, 8, D), generator=g, device="cuda",
                              dtype=dtype) for _ in range(2))
        od, lsed = flash_attention_fwd(q, kd, vd, causal=causal)
        dense_ms = {
            "fwd_ms": cuda_ms(lambda: flash_attention_fwd(q, kd, vd,
                                                          causal=causal)),
            "bwd_ms": cuda_ms(lambda: flash_attention_bwd(
                q, kd, vd, od, lsed, do, causal=causal, fused=True))}
        dense_ms["sparse_fwd_bwd_ms"] = ms["fwd"] + ms["dq"] + ms["dkv"]
        dense_ms["dense_fwd_bwd_ms"] = dense_ms["fwd_ms"] + dense_ms["bwd_ms"]
        recs["fwd"]["dense_flash_same_shape"] = dense_ms
        del kd, vd, od, lsed
    for part in ("fwd", "dq", "dkv"):
        log(f"sparse_{'fwd' if part == 'fwd' else 'bwd_' + part} "
            + json.dumps(recs[part]))
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return recs


def sparse_empty_case(dtype, B=1, S=4096, N=4, D=64, block=128, seed=0):
    """B5 on a layout with a global row (every key block: split into
    pieces in bf16) and a query block that lists nothing: that block's
    rows exactly O = 0 and LSE = -1e30, the rest against the plain version,
    a second launch bit for bit."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    @dataclasses.dataclass(frozen=True)
    class GlobalRowAndHole(sa.SparsityConfig):
        def make_layout(self, seq_len):
            n = seq_len // self.block
            lay = np.eye(n, dtype=bool)
            lay[0] = True
            lay[2] = False
            return lay
    cfg = GlobalRowAndHole(block=block)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((B, S, N, D), generator=g, device="cuda",
                           dtype=dtype) for _ in range(3))
    o, lse = sa.sparse_attention_fwd(q, k, v, cfg, causal=False)
    again = sa.sparse_attention_fwd(q, k, v, cfg, causal=False)
    ro, rlse = sa.sparse_attention_reference(q, k, v, cfg, causal=False)
    torch.cuda.synchronize()
    hole = slice(2 * block, 3 * block)
    live = torch.ones(S, dtype=torch.bool, device="cuda")
    live[hole] = False
    rec = {"case": f"global row + empty list, {str(dtype).split('.')[-1]}",
           "shape": f"B={B} S={S} N={N} D={D} block {block} non-causal",
           "rel_l2": rel_l2(o, ro),
           "rel_l2_lse_live": rel_l2(lse[:, :, live], rlse[:, :, live]),
           "empty_exact": bool(torch.all(o[:, hole] == 0)
                               and torch.all(lse[:, :, hole] == sa.NEG_INF)),
           "bitwise_repeat": bool(torch.equal(o, again[0])
                                  and torch.equal(lse, again[1])),
           "pieces": sa.work_tables(cfg, S, False, q.device)[0].slots}
    log("sparse_fwd empty list " + json.dumps(rec))
    if not (rec["rel_l2"] < TOL[dtype] and rec["rel_l2_lse_live"] < 1e-4
            and rec["empty_exact"] and rec["bitwise_repeat"]):
        raise RuntimeError(f"sparse_fwd empty list: {rec}")
    return rec


def sparse_kernel_phase():
    import torch._dynamo
    import torch._inductor.config
    from deepspeed_tpu_torch.ops import _build
    # flex_attention, the yardstick, compiles through Inductor and Triton:
    # in this process (no compile workers), caches beside the kernels'
    # build, once per case
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(_build.BUILD_DIR / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))
    torch._inductor.config.compile_threads = 1
    torch._dynamo.config.recompile_limit = 64
    bf, f32 = torch.bfloat16, torch.float32
    for dtype in (bf, f32):
        sparse_empty_case(dtype)
    return [
        sparse_case("llama-1b training BigBird B=2 S=8192", "bigbird",
                    BIGBIRD_128, 2, 8192, 32, 64, bf, dense=True),
        sparse_case("bench BigBird S=32768", "bigbird", BIGBIRD_128,
                    1, 32768, 4, 64, bf),
        sparse_case("bench Fixed S=4096", "fixed",
                    dict(block=128, num_local_blocks=4, num_global_blocks=1),
                    2, 4096, 4, 64, bf),
        sparse_case("bench BSLongformer S=8192 D=128", "bslongformer",
                    dict(block=128, num_sliding_window_blocks=3),
                    1, 8192, 4, 128, bf),
        sparse_case("BigBird non-causal S=8192", "bigbird", BIGBIRD_128,
                    1, 8192, 4, 64, bf, causal=False),
        sparse_case("BigBird f32 block 64 S=4096", "bigbird",
                    dict(BIGBIRD_128, block=64), 1, 4096, 4, 64, f32),
    ]


# --------------------------------------------------------------------------
# serving phase
# --------------------------------------------------------------------------

def serving_phase():
    from deepspeed_tpu_torch import init_serving, llama_config, make_model
    from deepspeed_tpu_torch.ops import _build

    cfg = llama_config("7b")
    t0 = time.perf_counter()
    srv = init_serving(make_model(cfg, "llama-7b"),
                       config={"kv_cache_bits": 0},
                       serving=dict(max_seqs=16, block_size=64,
                                    max_model_len=2048, decode_quantum=8),
                       dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in srv.engine.params["layers"].values())
    n_params += sum(t.numel() for k, t in srv.engine.params.items()
                    if k != "layers")
    log(f"serving: llama-7b bf16, {n_params / 1e9:.3f}B params, pool "
        f"{srv.pool_bytes / 2**30:.2f} GiB ({srv.num_blocks} blocks), init "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(0)
    srv.run([(rng.integers(0, VOCAB, size=64).astype(np.int32), 8)])  # warm
    lengths = [(64, 128, 256, 512, 1024)[i % 5] for i in range(24)]
    prompts = [rng.integers(0, VOCAB, size=n).astype(np.int32)
               for n in lengths]
    srv.reset_stats()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = srv.run([(p, 32) for p in prompts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    st = srv.stats()
    st["wall_s"] = wall
    st["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log("serving stats " + json.dumps(st))
    log("serving launches " + json.dumps(launches))
    if len(outs) != len(prompts):
        raise RuntimeError(f"serving: {len(outs)} of {len(prompts)} finished")
    for (rid, out), p in zip(sorted(outs.items()), prompts):
        gen = out[len(p):]
        if not np.array_equal(out[:len(p)], p) or gen.size != 32 \
                or gen.min() < 0 or gen.max() >= VOCAB:
            raise RuntimeError(f"serving: request {rid} returned "
                               f"{gen.size} tokens in [{gen.min()}, "
                               f"{gen.max()}]")
    if srv.allocator.used_blocks != 0:
        raise RuntimeError(f"serving: {srv.allocator.used_blocks} blocks "
                           "still held after run()")
    L = cfg.num_layers
    if launches["flash_fwd"] < st["prefills"] * L or st["prefills"] < 24:
        raise RuntimeError(f"serving: flash_fwd launched "
                           f"{launches['flash_fwd']} times for "
                           f"{st['prefills']} prefills x {L} layers")
    if launches["paged_decode"] < st["decode_steps"] * L \
            or st["decode_steps"] < 1:
        raise RuntimeError(f"serving: paged_decode launched "
                           f"{launches['paged_decode']} times for "
                           f"{st['decode_steps']} decode steps x {L} layers")
    return srv, st, launches


def _prefill_and_decode(params, cfg, ids, n, tokens, reference):
    """Logits of one prefill (prompt ids[0, :n] in its bucket) and of
    teacher-forced decode steps feeding ``tokens``, on a fresh pool."""
    from deepspeed_tpu_torch.models import transformer as tf
    bs = 64
    nblk = ids.shape[1] // bs
    pools = tf.init_paged_cache(cfg, nblk + 1, bs, device="cuda")
    block_ids = torch.arange(1, nblk + 1, device="cuda")
    out = [tf.prefill_paged(params, ids, cfg, pools, block_ids, length=n,
                            reference=reference)]
    tables = torch.zeros((1, 2048 // bs), dtype=torch.int32, device="cuda")
    tables[0, :nblk] = block_ids.int()
    lens = torch.tensor([n], dtype=torch.int32, device="cuda")
    for tok in tokens:
        out.append(tf.decode_step_paged(params, tok, cfg, pools, tables, lens,
                                        reference=reference))
        lens = lens + 1
    for x in out:
        if not torch.isfinite(x).all():
            raise RuntimeError("cross-check: non-finite logits")
    return out


def cross_check(srv):
    """One prefill (1000-token prompt, 1024 bucket) and 4 teacher-forced
    decode steps through the kernels vs the plain versions, called by
    name, on the served weights. The comparison runs in f32 (the same
    weights, upcast exactly): at bf16 a 32-layer random-weight stack
    amplifies single-ulp rounding differences to percent-level logit
    differences, so the bf16 paths are reported against the f32 plain
    path instead (both kernels are held in bf16 in the kernel phase)."""
    import dataclasses
    cfg, params = srv.model.config, srv.engine.params
    rng = np.random.default_rng(1)
    n, P = 1000, 1024
    ids = torch.zeros((1, P), dtype=torch.long, device="cuda")
    ids[0, :n] = torch.from_numpy(rng.integers(0, VOCAB, size=n)).cuda()
    tokens = [torch.from_numpy(rng.integers(0, VOCAB, size=1)).cuda()
              for _ in range(4)]
    names = ["prefill"] + [f"decode{i}" for i in range(len(tokens))]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: ({n_: t.float() for n_, t in v.items()}
                    if k == "layers" else v.float())
                for k, v in params.items()}
    kern32 = _prefill_and_decode(params32, cfg32, ids, n, tokens, False)
    plain32 = _prefill_and_decode(params32, cfg32, ids, n, tokens, True)
    del params32
    torch.cuda.empty_cache()
    errs = {k: rel_l2(a, b) for k, a, b in zip(names, kern32, plain32)}
    log("cross-check f32, kernels vs plain versions, rel L2 "
        + json.dumps(errs))
    bad = {k: v for k, v in errs.items() if not v < 2e-2}
    if bad:
        raise RuntimeError(f"cross-check: kernel path disagrees: {bad}")
    kern16 = _prefill_and_decode(params, cfg, ids, n, tokens, False)
    plain16 = _prefill_and_decode(params, cfg, ids, n, tokens, True)
    drift = {"bf16_kernels_vs_f32_plain": {
                 k: rel_l2(a, b) for k, a, b in zip(names, kern16, plain32)},
             "bf16_plain_vs_f32_plain": {
                 k: rel_l2(a, b) for k, a, b in zip(names, plain16, plain32)},
             "bf16_kernels_vs_bf16_plain": {
                 k: rel_l2(a, b) for k, a, b in zip(names, kern16, plain16)}}
    log("bf16 drift (reported, not a check) " + json.dumps(drift))
    return errs, drift


def host_issue_ms(fn, iters: int = 10) -> float:
    """Median host time to issue ``fn`` (no sync inside). Close to the
    CUDA-event time of the same call, it means the device waited on the
    host: the call is bound by dispatch, not by the kernels."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return float(np.median(times))


def step_times(srv):
    """Where the time goes on the served model: one 1024-bucket prefill
    and one 16-slot decode step (every slot at 1000 rows), each beside the
    time of its attention kernel at the same shapes, times the layers."""
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops.decode_attention import paged_decode_attention
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention_fwd
    cfg, params = srv.model.config, srv.engine.params
    L, H = cfg.num_layers, cfg.num_heads
    D = cfg.dim_per_head
    n, P = 1000, 1024
    pools = srv.pools              # scratch use: every block is free now
    ids = torch.randint(0, VOCAB, (1, P), device="cuda")
    block_ids = torch.arange(1, P // 64 + 1, device="cuda")
    prefill_ms = cuda_ms(lambda: tf.prefill_paged(
        params, ids, cfg, pools, block_ids, length=n), iters=5)
    q = torch.randn((1, P, H, D), device="cuda", dtype=cfg.dtype)
    flash_ms = cuda_ms(lambda: flash_attention_fwd(q, q, q, causal=True))
    S, MB = srv.config.max_seqs, srv.MB
    tab = torch.arange(1, S * MB + 1, dtype=torch.int32,
                       device="cuda").reshape(S, MB)
    lens = torch.full((S,), n, dtype=torch.int32, device="cuda")
    toks = torch.zeros((S,), dtype=torch.long, device="cuda")
    def decode():
        return tf.decode_step_paged(params, toks, cfg, pools, tab, lens)
    decode_ms = cuda_ms(decode, iters=10)
    decode_issue_ms = host_issue_ms(decode)
    qd = torch.randn((S, 1, H, D), device="cuda", dtype=cfg.dtype)
    row = torch.randn((S, H, 1, D), device="cuda", dtype=cfg.dtype)
    def attn():
        return paged_decode_attention(qd, pools["k"][0], pools["v"][0], tab,
                                      lens, kv_row=(row, row))
    attn_ms = cuda_ms(attn)
    attn_batched_ms = cuda_ms(attn, batch=20)
    times = {"prefill_1024_ms": prefill_ms,
             "prefill_flash_ms_x_layers": flash_ms * L,
             "decode_step_16x1000_ms": decode_ms,
             "decode_step_host_issue_ms": decode_issue_ms,
             "decode_attention_ms_x_layers": attn_ms * L,
             "decode_attention_batched_ms_x_layers": attn_batched_ms * L}
    log("step times " + json.dumps(times))
    return times


# --------------------------------------------------------------------------
# training phases
# --------------------------------------------------------------------------

TRAIN_STEPS = 8


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "flash_" in n or "sparse_" in n:
        return "attention kernels (B1-B7)"
    if any(t in n for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "matmuls (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    if "reduce" in n:
        return "reductions"
    if "elementwise" in n:
        return "elementwise"
    return "other"


def device_split(step):
    """Run ``step`` once under torch.profiler: the device time of every
    kernel it ran, by class and by kernel, beside the CUDA-event time of
    the step, and the CPU ops whose own kernels took the most of it.
    Reported, not checked: a profiler that sees no device activity leaves
    ``device_busy_ms`` at 0."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        step()
        b.record()
        torch.cuda.synchronize()
    kernels = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = kernels.setdefault(evt.name, [0.0, 0])
        k[0] += evt.time_range.elapsed_us() / 1e3
        k[1] += 1
    by_class = {}
    for name, (ms, n) in kernels.items():
        c = by_class.setdefault(_kernel_class(name), [0.0, 0])
        c[0] += ms
        c[1] += n
    ops = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            ops.append([e.key, us / 1e3, e.count])
    busy = sum(ms for ms, _ in kernels.values())
    step_ms = a.elapsed_time(b)
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    return dict(step_ms_profiled=step_ms, device_busy_ms=busy,
                idle_share=1.0 - busy / step_ms,
                by_class=dict(sorted(by_class.items(),
                                     key=lambda kv: -kv[1][0])),
                top_kernels=[[k[:90], ms, n] for k, (ms, n) in top],
                top_ops=sorted(ops, key=lambda o: -o[1])[:12])
TRAIN_CONFIG = {
    # bench.py _try_rung / LADDER row ("1b", 2048, 8)
    "train_batch_size": 8, "gradient_accumulation_steps": 1,
    "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
    "bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
    "transformer": {"fused_backward": True}, "seed": 0}


def _train(cfg, name, config, steps):
    """``initialize`` -> ``train_batch`` on one fixed batch: 1 warm-up
    step, then ``steps`` timed steps with the launch counts zeroed just
    before them. Returns (engine, batch, record)."""
    from deepspeed_tpu_torch import initialize, make_model
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    B, S = config["train_batch_size"], cfg.max_seq_len
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = initialize(model=make_model(cfg, name), config=dict(config))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(engine.params))
    log(f"training: {name} {n_params / 1e9:.4f}B params, B={B} S={S}, "
        f"bf16 + f32 masters, init {time.perf_counter() - t0:.1f}s")
    ids = np.random.default_rng(0).integers(0, VOCAB, (B, S), dtype=np.int32)
    batch = {"input_ids": torch.from_numpy(ids).cuda()}
    t0 = time.perf_counter()
    losses = [engine.train_batch(batch)["loss"]]          # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    _build.reset_launch_counts()
    marks, issue_ms = [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t1 = time.perf_counter()
        losses.append(engine.train_batch(batch)["loss"])
        # host time to issue the step (no sync inside): when it reaches the
        # step's device time the host, not the card, sets the pace (or the
        # launch queue is full because the card is behind)
        issue_ms.append((time.perf_counter() - t1) * 1e3)
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    losses = [float(x) for x in losses]
    step_ms = [a.elapsed_time(b) for a, b in marks]
    L, H = cfg.num_layers, cfg.hidden_size
    tok_s = B * S * steps / wall
    # bench.py _mfu: 6N plus the dense attention term 12 L H S (no causal
    # or sparse discount)
    mfu = tok_s * (6.0 * n_params + 12.0 * L * H * S) / PEAK_FLOPS[
        torch.bfloat16]
    rec = dict(steps=steps, warmup_step_s=warm_s,
               step_ms_cuda_median=float(np.median(step_ms)),
               step_ms_cuda=step_ms, step_ms_wall=wall / steps * 1e3,
               step_issue_ms=issue_ms, tokens_per_s=tok_s, mfu=mfu,
               n_params=n_params,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
               losses=losses, launches=launches)
    return engine, batch, rec


def _check_run(name, rec, want, absent=()):
    """Finite, falling losses; at least ``want`` launches of each kernel
    and none of ``absent``."""
    losses = rec["losses"]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"{name}: non-finite loss {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        raise RuntimeError(f"{name}: loss did not fall {losses}")
    got = rec["launches"]
    short = {k: (got[k], v) for k, v in want.items() if got[k] < v}
    if short:
        raise RuntimeError(f"{name}: launches (got, want) {short}")
    extra = {k: got[k] for k in absent if got[k]}
    if extra:
        raise RuntimeError(f"{name}: kernels off this route launched {extra}")


def training_phase(fwd_rec, bwd_rec):
    """llama-1b, full width and depth, through initialize -> train_batch.
    ``fwd_rec`` / ``bwd_rec``: the kernel phase's records at this shape,
    to split the step's time."""
    from deepspeed_tpu_torch import llama_config
    S = 2048
    cfg = llama_config("1b", max_seq_len=S, remat=True,
                       remat_policy="dots_saveable", loss_chunk=S)
    engine, batch, rec = _train(cfg, "llama-1b", TRAIN_CONFIG, TRAIN_STEPS)
    n, L = TRAIN_STEPS, cfg.num_layers
    per_step = {k: v / n for k, v in rec["launches"].items()}
    attn = {"fwd_ms": fwd_rec["ms"] * L,
            "replay_ms": fwd_rec["ms"] * (per_step["flash_fwd"] - L),
            "bwd_ms": (bwd_rec["dq"]["ms"] * per_step["flash_bwd_dq"]
                       + bwd_rec["dkv"]["ms"] * per_step["flash_bwd_dkv"])}
    attn["other_ms"] = rec["step_ms_cuda_median"] - sum(attn.values())
    rec["attention_split_per_step"] = attn
    log("training " + json.dumps(rec))
    # dots_saveable replays B1 in the backward (its outputs are not dots)
    _check_run("training", rec, {"flash_bwd_dq": n * L,
                                 "flash_bwd_dkv": n * L,
                                 "flash_fwd": 2 * n * L})
    # where a step's device time goes: one more step, profiled
    rec["device_split"] = device_split(lambda: engine.train_batch(batch))
    log("training device split " + json.dumps(rec["device_split"]))
    del engine, batch
    torch.cuda.empty_cache()
    return rec


SPARSE_TRAIN_CONFIG = dict(TRAIN_CONFIG, train_batch_size=2)
SPARSE_MODEL = {"mode": "bigbird", **BIGBIRD_128}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SPARSE_KERNELS = ("sparse_fwd", "sparse_bwd_dq", "sparse_bwd_dkv")
# the libraries whose bf16 kernels run on wgmma with TMA-fed tiles
WGMMA_KERNELS = FLASH_KERNELS + SPARSE_KERNELS
# the libraries whose kernels stage their tiles by bulk copies
# (cp.async.bulk: UBLKCP in SASS) into an mbarrier ring
BULK_KERNELS = ("paged_decode",)


def sparse_training_phase(recs):
    """llama-1b at full width and depth, S=8192, the JAX bench's BigBird
    layout, through initialize -> train_batch: B=2 (16,384 tokens a step,
    as the dense phase's 8 x 2048), no key mask, so every layer takes the
    sparse route (K/V repeated over the query-head group, B5-B7). Then one
    profiled step, then the same model dense (B1-B3) at the same B and S.
    ``recs``: the kernel phase's records at this shape."""
    from deepspeed_tpu_torch import llama_config
    S = 8192
    cfg = llama_config("1b", max_seq_len=S, remat=True,
                       remat_policy="dots_saveable", loss_chunk=2048,
                       sparse_attention=SPARSE_MODEL)
    engine, batch, rec = _train(cfg, "llama-1b BigBird", SPARSE_TRAIN_CONFIG,
                                TRAIN_STEPS)
    n, L = TRAIN_STEPS, cfg.num_layers
    per_step = {k: v / n for k, v in rec["launches"].items()}
    split = {"fwd_ms": recs["fwd"]["ms"] * L,
             "replay_ms": recs["fwd"]["ms"] * (per_step["sparse_fwd"] - L),
             "bwd_ms": (recs["dq"]["ms"] * per_step["sparse_bwd_dq"]
                        + recs["dkv"]["ms"] * per_step["sparse_bwd_dkv"])}
    split["other_ms"] = rec["step_ms_cuda_median"] - sum(split.values())
    rec["attention_split_per_step"] = split
    log("sparse training " + json.dumps(rec))
    # dots_saveable (and dots_and_attn alike) replays B5 in the backward
    _check_run("sparse training", rec,
               {"sparse_fwd": 2 * n * L, "sparse_bwd_dq": n * L,
                "sparse_bwd_dkv": n * L}, absent=FLASH_KERNELS)
    rec["device_split"] = device_split(lambda: engine.train_batch(batch))
    log("sparse training device split " + json.dumps(rec["device_split"]))
    del engine, batch
    gc.collect()
    torch.cuda.empty_cache()
    steps = 3
    engine, batch, dense = _train(
        dataclasses.replace(cfg, sparse_attention=None), "llama-1b dense",
        SPARSE_TRAIN_CONFIG, steps)
    log("dense training, same B and S " + json.dumps(dense))
    _check_run("dense training", dense,
               {"flash_bwd_dq": steps * L, "flash_bwd_dkv": steps * L,
                "flash_fwd": 2 * steps * L}, absent=SPARSE_KERNELS)
    del engine, batch
    gc.collect()
    torch.cuda.empty_cache()
    rec["dense_same_shape"] = dense
    log("sparse vs dense training step, B=2 S=8192 " + json.dumps({
        "sparse_step_ms": rec["step_ms_cuda_median"],
        "dense_step_ms": dense["step_ms_cuda_median"],
        "dense_over_sparse": dense["step_ms_cuda_median"]
        / rec["step_ms_cuda_median"],
        "sparse_tokens_per_s": rec["tokens_per_s"],
        "dense_tokens_per_s": dense["tokens_per_s"],
        "sparse_peak_mem_gib": rec["peak_mem_gib"],
        "dense_peak_mem_gib": dense["peak_mem_gib"]}))
    return rec


def training_cross_check(S=512, sparse=None):
    """lm_loss and the grad of every leaf (llama-1b width, 2 layers, B=2,
    chunked loss, fused backward) through the kernels and through their
    plain versions on the same weights. f32 (the CUDA-core kernels; loss
    within 1e-5 relative, grads within 1e-4 rel L2), under the training
    phase's remat policy (dots_saveable, which replays the attention
    forward in the backward) and under dots_and_attn (which keeps B1's
    outputs: one launch per layer, but replays B5 like dots_saveable);
    then bf16 (the tensor-core kernels the training phases run; 2e-2)
    under dots_saveable. ``sparse``: a block-sparse layout, so every layer
    runs B5-B7 and no flash kernel. Two layers stay far from the rounding
    amplification of a deep random bf16 stack (cross_check)."""
    from deepspeed_tpu_torch import llama_config
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.optimizers import cast_tree, tree_leaves
    L = 2
    cfg = llama_config("1b", num_layers=L, max_seq_len=S,
                       dtype=torch.float32, remat=True,
                       remat_policy="dots_saveable", loss_chunk=S,
                       fused_backward=True, sparse_attention=sparse)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params32 = tf.init_params(cfg, gen, "cuda", dtype=torch.float32)
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, S))
    batch = {"input_ids": torch.from_numpy(ids).cuda()}

    def value_and_grad(params, c, reference):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        _build.reset_launch_counts()
        loss = tf.lm_loss(params, batch, c, reference=reference)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return float(loss.detach()), grads, _build.launch_counts()

    recs = {}
    kern = "sparse" if sparse else "flash"
    cases = (("f32", "dots_saveable", 2 * L, 1e-5, 1e-4),
             ("f32", "dots_and_attn", 2 * L if sparse else L, 1e-5, 1e-4),
             ("bf16", "dots_saveable", 2 * L, 2e-2, 2e-2))
    for dt in ("f32", "bf16"):
        dtype = torch.float32 if dt == "f32" else torch.bfloat16
        params = params32
        if dt == "bf16":
            with torch.no_grad():
                params = cast_tree(params32, dtype)
        cd = dataclasses.replace(cfg, dtype=dtype)
        lp, gp, npl = value_and_grad(params, cd, True)
        if any(npl.values()):
            raise RuntimeError(f"training cross-check {dt}: plain path "
                               f"launched {npl}")
        for _, policy, fwd, tol_loss, tol_grad in (
                c for c in cases if c[0] == dt):
            lk, gk, nk = value_and_grad(
                params, dataclasses.replace(cd, remat_policy=policy), False)
            loss_err = abs(lk - lp) / abs(lp)
            err = max(rel_l2(a, b) for a, b in zip(gk, gp))
            recs[f"{dt} {policy}"] = dict(
                loss_kernels=lk, loss_plain=lp, loss_rel_err=loss_err,
                grad_rel_l2_max=err, launches=nk)
            if not loss_err <= tol_loss or not err <= tol_grad:
                raise RuntimeError(f"training cross-check {dt} {policy}: "
                                   f"loss rel {loss_err:.3g}, grad rel L2 "
                                   f"{err:.3g}")
            # exactly these launches, and no other kernel's
            want = {f"{kern}_fwd": fwd, f"{kern}_bwd_dq": L,
                    f"{kern}_bwd_dkv": L}
            if {k: n for k, n in nk.items() if n} != want:
                raise RuntimeError(f"training cross-check {dt} {policy}: "
                                   f"launches {nk}, want {want}")
            del gk
        del params, gp
    log(f"{'sparse ' if sparse else ''}training cross-check S={S} "
        + json.dumps(recs))
    del params32
    torch.cuda.empty_cache()
    return recs


def ptxas_report(log: str):
    """[{function, registers, spill_stores, spill_loads, smem_bytes}] from
    ``nvcc -Xptxas -v`` output (smem: ptxas's static shared memory; the
    wgmma kernels' ring is dynamic and sized by their launchers)."""
    import re
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = {"function": m.group(1)}
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn is not None:
            fn["spill_stores"], fn["spill_loads"] = int(m.group(1)), int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            fn["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            fn["smem_bytes"] = int(sm.group(1)) if sm else 0
            out.append(fn)
            fn = None
    return out


def sass_census(path):
    """{function: {"HGMMA": n, "UTMALDG": n, "UBLKCP": n, "atomics": n,
    "bulk_ops": [...]}} from ``cuobjdump -sass`` of a library (wgmma, TMA
    tile loads, plain bulk copies, and ATOM, ATOMS, ATOMG, RED, REDG;
    bulk_ops: every distinct UBLK* / UTMA* opcode, to show what the bulk
    copies compile to)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    atomics = {"ATOM", "ATOMS", "ATOMG", "RED", "REDG"}
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        ops = []
        for ln in body.splitlines():
            toks = ln.split("*/", 1)[-1].split() if "*/" in ln else []
            if toks and toks[0].startswith("@"):     # a predicate guard
                toks = toks[1:]
            if toks and not toks[0].startswith("/*"):
                ops.append(toks[0].split(".")[0])
        counts = {op: ops.count(op) for op in ("HGMMA", "UTMALDG", "UBLKCP")}
        counts["atomics"] = sum(o in atomics for o in ops)
        counts["bulk_ops"] = sorted({o for o in ops
                                     if o.startswith(("UBLK", "UTMA"))})
        out[name.strip()] = counts
    return out


def build_phase():
    """Every kernel from source, one nvcc per source, with ptxas's report;
    then, for the libraries on wgmma (the three flash kernels and the
    sparse backward B6, B7), each kernel's registers, shared memory and
    spills, ptxas's warnings (a serialized wgmma shows there), and its SASS
    census. Raises if a wgmma kernel (the bf16 path) has no HGMMA or no
    UTMALDG, spills, or any kernel of those libraries uses atomics."""
    from deepspeed_tpu_torch.ops import _build
    t0 = time.perf_counter()
    logs = _build.build(force=True, verbose=True)
    seconds = time.perf_counter() - t0
    log(f"build: {len(_build.KERNELS)} kernels from source in {seconds:.1f}s")
    info = {}
    for name in WGMMA_KERNELS:     # bf16 on wgmma with TMA-fed tiles
        ptx = ptxas_report(logs[name])
        sass = sass_census(_build.KERNELS[name].library_path())
        warnings = [ln.strip() for ln in logs[name].splitlines()
                    if "warning" in ln.lower() or "Performance Loss" in ln]
        info[name] = {"ptxas": ptx, "ptxas_warnings": warnings,
                      "sass": sass}
        log(f"build {name} " + json.dumps(info[name]))
        for fn in ptx:
            if "wgmma" in fn["function"] and (fn["spill_stores"]
                                              or fn["spill_loads"]):
                raise RuntimeError(f"{name}: {fn['function']} spills {fn}")
        wg = {f: c for f, c in sass.items() if "wgmma" in f}
        if not wg or not all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                             for c in wg.values()):
            raise RuntimeError(f"{name}: the bf16 kernels do not run on "
                               f"wgmma with TMA loads: {sass}")
        if any(c["atomics"] for c in sass.values()):
            raise RuntimeError(f"{name}: atomics in {sass}")
    for name in BULK_KERNELS:      # the pool tiles by bulk copies
        ptx = ptxas_report(logs[name])
        sass = sass_census(_build.KERNELS[name].library_path())
        info[name] = {"ptxas": ptx, "sass": sass}
        log(f"build {name} " + json.dumps(info[name]))
        spills = [fn for fn in ptx if fn["spill_stores"] or fn["spill_loads"]]
        if spills:
            raise RuntimeError(f"{name}: spills {spills}")
        split = {f: c for f, c in sass.items() if "split" in f}
        if not split or not all(c["UBLKCP"] + c["UTMALDG"] > 0
                                for c in split.values()):
            raise RuntimeError(f"{name}: the kernels do not stage their "
                               f"tiles by bulk copies: {sass}")
        if any(c["atomics"] for c in sass.values()):
            raise RuntimeError(f"{name}: atomics in {sass}")
    return seconds, info


def kernel_line(name, replaces, launches, cases, main):
    rec = {k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}
    return {"name": name, "route": "cuda",
            "source": f"deepspeed_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **rec, "shape": main["shape"], "cases": cases}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script drives the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.accelerator import device_kind
    from deepspeed_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability (9, 0), got {cap}")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s, build_info = build_phase()

    flash, decode, bwd = kernel_phase()
    sparse = sparse_kernel_phase()
    srv, st, launches = serving_phase()
    step_times(srv)
    cross_check(srv)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    train = training_phase(
        next(c for c in flash if c["case"].startswith("llama-1b training")),
        bwd[0])
    training_cross_check()
    sparse_train = sparse_training_phase(sparse[0])
    training_cross_check(S=2048, sparse=SPARSE_MODEL)

    main_flash = flash[1]      # the 1024 bucket
    main_decode = decode[0]    # 16 slots of llama-7b
    tl = train["launches"]
    line = {"kernels": [
        kernel_line("flash_fwd", "deepspeed_tpu/ops/flash_attention.py:220",
                    launches["flash_fwd"] + tl["flash_fwd"], flash,
                    main_flash),
        kernel_line("paged_decode",
                    "deepspeed_tpu/ops/decode_attention.py:172",
                    launches["paged_decode"], decode, main_decode),
        kernel_line("flash_bwd_dq", "deepspeed_tpu/ops/flash_attention.py:426",
                    tl["flash_bwd_dq"], [c["dq"] for c in bwd], bwd[0]["dq"]),
        kernel_line("flash_bwd_dkv",
                    "deepspeed_tpu/ops/flash_attention.py:452",
                    tl["flash_bwd_dkv"], [c["dkv"] for c in bwd],
                    bwd[0]["dkv"]),
    ]}
    sl = sparse_train["launches"]
    for name, site, part in (("sparse_fwd", 463, "fwd"),
                             ("sparse_bwd_dq", 491, "dq"),
                             ("sparse_bwd_dkv", 507, "dkv")):
        line["kernels"].append(kernel_line(
            name, f"deepspeed_tpu/ops/sparse_attention.py:{site}", sl[name],
            [c[part] for c in sparse], sparse[0][part]))
    for entry in line["kernels"]:
        if entry["name"] in build_info:
            entry["build"] = build_info[entry["name"]]
    line["build_s"] = build_s
    line["kernels"][0]["launches_by_path"] = {
        "serving": launches["flash_fwd"], "training": tl["flash_fwd"]}
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind("cuda:0"),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
