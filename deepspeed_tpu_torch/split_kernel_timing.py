"""Time the paged decode (B4) and the block-sparse forward (B5) of a
checkout on the card, at chip_smoke's shapes, beside their plain versions'
errors:

    python3 deepspeed_tpu_torch/split_kernel_timing.py [CHECKOUT] [--only b4|b5] [--rows R]

CHECKOUT (default: the checkout that holds this file) is put first on the
import path and builds into its own ``csrc/_build``, so two checkouts (a
parent and a change, or variants of one kernel's source) are compared in
one process each, within one machine. ``--rows`` sets B4's piece rows (R)
where the checkout's wrapper reads ``decode_pieces``. Prints one JSON line
``TIMING {...}``: per case the median time of one call over 50 samples
(CUDA events; each sample starts on an idle card, as chip_smoke's ``ms``)
and the relative L2 error against the plain version. Needs one card.
"""

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", nargs="?",
                    default=os.path.dirname(os.path.dirname(
                        os.path.abspath(__file__))))
    ap.add_argument("--only", choices=("b4", "b5"))
    ap.add_argument("--rows", type=int)
    args = ap.parse_args()
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    os.environ["DSTPU_TORCH_BUILD_DIR"] = os.path.join(
        root, "deepspeed_tpu_torch", "csrc", "_build")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("split_kernel_timing: needs a CUDA card", file=sys.stderr)
        return 1
    from deepspeed_tpu_torch.ops import decode_attention as da
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    def cuda_ms(fn, iters=50, warmup=5):
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

    def rel(a, b):
        a, b = a.double().ravel(), b.double().ravel()
        return float((a - b).norm() / b.norm())

    out = {"schema": 1, "checkout": root,
           "card": torch.cuda.get_device_name(0)}
    if args.rows:
        pieces = da.decode_pieces
        da.decode_pieces = lambda MB, bs, rows=args.rows: pieces(MB, bs, rows)
        out["rows"] = args.rows
    lens = [0, 1, 63, 64, 65, 100, 333, 500, 777, 1000, 1024, 1234, 1500,
            2000, 2047, 2048]
    decode = (("llama-7b", 32, 32, 128), ("llama-70b GQA 64/8", 64, 8, 128),
              ("llama-1b D=64 rep 4", 32, 8, 64))
    for name, Nq, Nkv, D in (() if args.only == "b5" else decode):
        S, MB, bs, dt = 16, 32, 64, torch.bfloat16
        NB = S * MB + 1
        g = torch.Generator(device="cuda").manual_seed(0)
        q = torch.randn((S, 1, Nq, D), generator=g, device="cuda", dtype=dt)
        kp, vp = (torch.randn((NB, Nkv, bs, D), generator=g, device="cuda",
                              dtype=dt) for _ in range(2))
        row = tuple(torch.randn((S, Nkv, 1, D), generator=g, device="cuda",
                                dtype=dt) for _ in range(2))
        tab = torch.from_numpy(np.random.default_rng(0).permutation(
            np.arange(1, NB)).reshape(S, MB).astype(np.int32)).cuda()
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")

        def run():
            return da.paged_decode_attention(q, kp, vp, tab, ln, kv_row=row)
        ref = da.paged_decode_reference(q, kp, vp, tab, ln, kv_row=row)
        out[f"B4 {name}"] = {"ms": cuda_ms(run), "rel_l2": rel(run(), ref)}
    bigbird = dict(block=128, num_random_blocks=1,
                   num_sliding_window_blocks=3, num_global_blocks=1)
    sparse = (("BigBird B=2 S=8192 N=32", "bigbird", bigbird, 2, 8192, 32,
               64, True),
              ("BigBird non-causal S=8192", "bigbird", bigbird, 1, 8192, 4,
               64, False),
              ("BSLongformer S=8192 D=128", "bslongformer",
               dict(block=128, num_sliding_window_blocks=3), 1, 8192, 4, 128,
               True),
              ("BigBird S=32768", "bigbird", bigbird, 1, 32768, 4, 64, True))
    for name, mode, kw, B, S, N, D, causal in (
            () if args.only == "b4" else sparse):
        cfg = sa.get_sparsity_config(mode, **kw)
        g = torch.Generator(device="cuda").manual_seed(0)
        q, k, v = (torch.randn((B, S, N, D), generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))

        def run():
            return sa.sparse_attention_fwd(q, k, v, cfg, causal=causal)
        o, lse = run()
        ro, rlse = sa.sparse_attention_reference(q, k, v, cfg, causal=causal)
        out[f"B5 {name}"] = {"ms": cuda_ms(run), "rel_l2": rel(o, ro),
                             "rel_l2_lse": rel(lse, rlse)}
        del o, lse, ro, rlse
        torch.cuda.empty_cache()
    print("TIMING " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
