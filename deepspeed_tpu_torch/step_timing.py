"""Time the dense training step and the serving decode step of a checkout
on the card, at chip_smoke's cells, so that two checkouts (a parent and a
change) are compared on one machine:

    python3 deepspeed_tpu_torch/step_timing.py [CHECKOUT]

CHECKOUT (default: the checkout that holds this file) is put first on the
import path and builds into its own ``csrc/_build``. The training step is
chip_smoke's dense cell (llama-1b, B=8, S=2048, bf16 with f32 masters,
AdamW, ZeRO-1, ``dots_saveable``, chunked loss, fused backward; one
warm-up step, then the median CUDA-event time of 8); the decode step is
the serving cell's (llama-7b bf16 on a float pool, 16 slots at 1000 rows
each; the median of 10 CUDA-event samples and the median host time to
issue one step). Prints one JSON line ``STEPS {...}``. Needs one card.
"""

import json
import os
import sys
import time


def _median_ms(fn, iters):
    import numpy as np
    import torch
    fn()
    torch.cuda.synchronize()
    cuda, issue = [], []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        issue.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        cuda.append(a.elapsed_time(b))
    return float(np.median(cuda)), float(np.median(issue))


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    sys.path.insert(0, root)
    os.environ["DSTPU_TORCH_BUILD_DIR"] = os.path.join(
        root, "deepspeed_tpu_torch", "csrc", "_build")
    import gc
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("step_timing: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from deepspeed_tpu_torch import (init_serving, initialize, llama_config,
                                     make_model)
    from deepspeed_tpu_torch.models import transformer as tf

    cfg = llama_config("1b", max_seq_len=2048, remat=True,
                       remat_policy="dots_saveable", loss_chunk=2048)
    engine, *_ = initialize(model=make_model(cfg), config={
        "train_batch_size": 8, "gradient_accumulation_steps": 1,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
        "bf16": {"enabled": True}, "zero_optimization": {"stage": 1},
        "transformer": {"fused_backward": True}, "seed": 0})
    ids = np.random.default_rng(0).integers(0, 32000, (8, 2048),
                                            dtype=np.int32)
    batch = {"input_ids": torch.from_numpy(ids).cuda()}
    train_ms, train_issue_ms = _median_ms(lambda: engine.train_batch(batch),
                                          8)
    del engine, batch
    gc.collect()
    torch.cuda.empty_cache()

    srv = init_serving(make_model(llama_config("7b")),
                       config={"kv_cache_bits": 0},
                       serving=dict(max_seqs=16, block_size=64,
                                    max_model_len=2048, decode_quantum=8),
                       dtype=torch.bfloat16, seed=0)
    S, MB = srv.config.max_seqs, srv.MB
    tab = torch.arange(1, S * MB + 1, dtype=torch.int32,
                       device="cuda").reshape(S, MB)
    lens = torch.full((S,), 1000, dtype=torch.int32, device="cuda")
    toks = torch.zeros((S,), dtype=torch.long, device="cuda")
    with torch.no_grad():
        decode_ms, decode_issue_ms = _median_ms(
            lambda: tf.decode_step_paged(srv.engine.params, toks,
                                         srv.model.config, srv.pools, tab,
                                         lens), 10)
    print("STEPS " + json.dumps({
        "schema": 1, "checkout": root, "train_step_ms": train_ms,
        "train_issue_ms": train_issue_ms, "decode_step_ms": decode_ms,
        "decode_issue_ms": decode_issue_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
