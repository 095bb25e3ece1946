#!/usr/bin/env python3
"""Drive deepspeed_tpu_torch on one NVIDIA H100 (or another sm_90 card).

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which raises on failure (exit code != 0):

1. build: the CUDA kernels from ``deepspeed_tpu_torch/csrc/*.cu``, one
   ``nvcc`` per source, all started together;
2. kernels: each kernel at the serving path's shapes (and a few more)
   against its plain PyTorch version on the same inputs (relative L2 <
   2e-2 in bf16, < 1e-4 in f32), timed with CUDA events beside the plain
   version, SDPA as a library yardstick, and the least time the card could
   take (bytes over 3.35 TB/s vs flops over the dtype's peak);
3. serving: llama-7b at full width and depth (random weights from a seed,
   bf16) through ``init_serving``: 24 requests, prompts of 64..1024 tokens,
   32 new tokens each, on 16 slots. Every request must finish with 32
   in-vocab tokens, the pool must be empty afterwards, and the kernels'
   launch counts (zeroed just before the run) must cover every prefill and
   decode step of all 32 layers;
4. cross-check: on the same weights, one prefill and 4 teacher-forced
   decode steps through the kernels against the plain versions.

Prints the card's name and power limit first, one ``{"kernels": [...]}``
line, and as its last line ``{"ok": true, "device": {...}}``. Imports
torch, numpy and the port only.
"""

import json
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


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median CUDA-event time of one call of ``fn``, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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

def flash_case(name, B, S, N, Nkv, D, dtype, masked=False, seed=0):
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention_fwd, flash_attention_reference)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, S, N, D), generator=g, device="cuda", dtype=dtype)
    k = torch.randn((B, S, Nkv, D), generator=g, device="cuda", dtype=dtype)
    v = torch.randn((B, S, Nkv, D), generator=g, device="cuda", dtype=dtype)
    mask = None
    keep = torch.tril(torch.ones((S, S), dtype=torch.bool, device="cuda"))
    keep = keep[None].expand(B, S, S)
    if masked:                      # right padding, and key 0 masked: the
        lens = torch.tensor([S - S // 4] + [S] * (B - 1), device="cuda")
        mask = torch.arange(S, device="cuda")[None, :] < lens[:, None]
        mask[:, 0] = False          # causal row 0 is then fully masked
        keep = keep & mask[:, None, :]
    o, lse = flash_attention_fwd(q, k, v, causal=True, kv_mask=mask)
    ro, rlse = flash_attention_reference(q, k, v, causal=True, kv_mask=mask)
    torch.cuda.synchronize()
    if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
        raise RuntimeError(f"flash_fwd {name}: non-finite output")
    err, err_lse = rel_l2(o, ro), rel_l2(lse, rlse)
    if err >= TOL[dtype] or err_lse >= 1e-4:
        raise RuntimeError(f"flash_fwd {name}: rel L2 {err:.3g} (O), "
                           f"{err_lse:.3g} (LSE) vs the plain version")
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
               rel_l2=err, rel_l2_lse=err_lse, max_abs_err=max_abs(o, ro),
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               tflops=flops / ms / 1e9)
    log("flash_fwd " + json.dumps(rec))
    return rec


def decode_case(name, S, Nq, Nkv, D, bs, MB, lens, dtype, seed=0):
    from deepspeed_tpu_torch.ops.decode_attention import (
        paged_decode_attention, paged_decode_reference)
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
        if n % bs:
            blk = int(tab_np[s, n // bs])
            kp[blk, :, n % bs:] = vp[blk, :, n % bs:] = 1e4
    tables = torch.from_numpy(tab_np).cuda()
    ln = torch.from_numpy(lens_np).cuda()
    out = paged_decode_attention(q, kp, vp, tables, ln, kv_row=row)
    ref = paged_decode_reference(q, kp, vp, tables, ln, kv_row=row)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"paged_decode {name}: non-finite output")
    err = rel_l2(out, ref)
    if err >= TOL[dtype]:
        raise RuntimeError(f"paged_decode {name}: rel L2 {err:.3g} vs the "
                           "plain version")
    for s in np.flatnonzero(lens_np == 0):
        if not torch.equal(out[s, 0],
                           row[1][s, :, 0].repeat_interleave(Nq // Nkv, 0)):
            raise RuntimeError(f"paged_decode {name}: empty slot {s} is not "
                               "exactly v_row")
    ms = cuda_ms(lambda: paged_decode_attention(q, kp, vp, tables, ln,
                                                kv_row=row))
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
    valid = float(lens_np.sum())
    blocks = float(sum(-(-int(n) // bs) for n in lens_np))
    esz = q.element_size()
    moved = (2 * valid * Nkv * D * esz + nbytes(q, out, *row)
             + 4 * blocks + 4 * S)
    flops = 4.0 * D * Nq * (valid + S)
    bound_ms, bound_by = bound(moved, flops, dtype)
    rec = dict(case=name, shape=f"slots={S} Nq={Nq} Nkv={Nkv} D={D} bs={bs} "
               f"MB={MB} {str(dtype).split('.')[-1]} lens={lens}",
               rel_l2=err, max_abs_err=max_abs(out, ref), ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, gb_per_s=moved / ms / 1e6)
    log("paged_decode " + json.dumps(rec))
    return rec


def kernel_phase():
    bf, f32 = torch.bfloat16, torch.float32
    flash = [
        flash_case("llama-7b S=64", 1, 64, 32, 32, 128, bf),
        flash_case("llama-7b S=1024 (1000-token prompt bucket)",
                   1, 1024, 32, 32, 128, bf),
        flash_case("llama-7b S=2048", 1, 2048, 32, 32, 128, bf),
        flash_case("llama-70b GQA 64/8 S=1024", 1, 1024, 64, 8, 128, bf),
        flash_case("llama-1b D=64 rep=4 S=1024", 1, 1024, 32, 8, 64, bf),
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
    ]
    torch.cuda.empty_cache()
    return flash, decode


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
    attn_ms = cuda_ms(lambda: paged_decode_attention(
        qd, pools["k"][0], pools["v"][0], tab, lens, kv_row=(row, row)))
    times = {"prefill_1024_ms": prefill_ms,
             "prefill_flash_ms_x_layers": flash_ms * L,
             "decode_step_16x1000_ms": decode_ms,
             "decode_step_host_issue_ms": decode_issue_ms,
             "decode_attention_ms_x_layers": attn_ms * L}
    log("step times " + json.dumps(times))
    return times


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

    t0 = time.perf_counter()
    _build.build(force=True)
    log(f"build: {len(_build.KERNELS)} kernels from source in "
        f"{time.perf_counter() - t0:.1f}s")

    flash, decode = kernel_phase()
    srv, st, launches = serving_phase()
    step_times(srv)
    cross_check(srv)

    main_flash = flash[1]      # the 1024 bucket
    main_decode = decode[0]    # 16 slots of llama-7b
    line = {"kernels": [
        kernel_line("flash_fwd", "deepspeed_tpu/ops/flash_attention.py:220",
                    launches["flash_fwd"], flash, main_flash),
        kernel_line("paged_decode",
                    "deepspeed_tpu/ops/decode_attention.py:172",
                    launches["paged_decode"], decode, main_decode),
    ]}
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind("cuda:0"),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
