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
   in f32 under dots_saveable, dots_with_no_batch_dims and offload_dots
   (B1 replayed: 2 launches per layer) and dots_and_attn (B1's outputs
   kept: 1 launch per layer), and in bf16 (the tensor-core kernels) under
   dots_saveable; the device memory of the first three side by side
   (what the forward leaves on the card, and the peak);
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
   and bf16;
10. resumable training (after phase 6): llama-1b at full width, 2
   layers, B=8 S=2048, bf16 with f32 masters, dots_with_no_batch_dims,
   data from ``random_token_batches`` through an attached
   ``DataLoader``: ``train_batches`` 3 steps (in_flight 2, prefetch), an
   async ``save_checkpoint``, a step while it is written,
   ``wait_checkpoint``, 2 more steps; then a fresh engine,
   ``load_checkpoint(tag=None)`` and the same 3 steps. The resumed losses
   and the whole final state must equal the uninterrupted run's bit for
   bit (the counters, lr and loader position too); ``zero_to_fp32`` of the
   tag must equal the masters at save time and the 16-bit export must
   round-trip, bit for bit; launch counts zeroed before each leg: B1
   twice per layer per step (the policy replays it), B2 and B3 once.
   Reports the checkpoint's bytes and the save (async and not), wait and
   load seconds beside the card's name and power limit;
11. serving breadth (after phase 4, on the serving phase's engine once
   its pool is freed): (a) ``InferenceEngine.generate`` of 4 prompts x 512
   tokens, 64 new tokens each, on the contiguous cache: every token in
   vocab, and with the launch counts zeroed just before it B1 = 32 (one
   prefill) and B4 = 0; ms per step and per token, and the share of its
   tokens equal to the paged engine's greedy stream (reported, not
   checked: bf16 through other attention code may diverge), with the
   top-two logit gap of the bf16 ``forward`` at each stream pair's first
   divergence, in units of the logits' bf16 noise (phase 4's drift x
   their RMS). (b) 16
   requests of an 800-token shared prefix plus a tail of 64..512 tokens,
   32 new tokens each (request 0 first, requests 1-14 after its first
   round, request 15, a retry of request 0's prompt, once it finished),
   through an engine with the prefix cache and a 1024-token prefill
   budget (16 slots, block 64, quantum 8): 32 in-vocab tokens each,
   prefix_hits >= 15, cow_forks >= 1, prefill_chunks >= 1, B1 = 32 x the
   whole-prompt prefills and B4 = 32 x the decode steps (counts zeroed
   just before), the pool holding only the cache's blocks afterwards and
   none once it is cleared; every request's first-token logits (fork and
   span on the warm engine, B1 on the cold one) within 3 x phase 4's
   largest bf16 drift of the cold ones, relative L2, and the divergence
   gaps as in (a); TTFT, ITL, tok/s and the hit rate beside the same load
   with the cache and the budget off. (c) f32 at llama-7b
   width, 2 layers: rows [512, 1024) through the span path behind a
   512-row prefill against one 1024-row pass, and the contiguous cache's
   prefill and 16 teacher-forced decode steps against the paged ones,
   within 2e-2 relative L2; the token agreement of ``generate`` and the
   paged engine (reported). (d) on that engine: a deadline that expires
   mid-decode cancels the request and frees its blocks, ``max_queue=2``
   sheds the third waiting request, the JSONL sink holds both records,
   and ``dispatch_timeout_s=60`` leaves the greedy stream unchanged.
12. quantized and speculative decode (after phase 11): llama-7b at full
   width and depth, bf16, on the serving geometry (16 slots, block 64,
   max_model_len 2048), a fresh engine for each pool or weight type,
   freed before the next, with the launch counts zeroed just before each
   load. (a) speculation (``spec_tokens=3``, ``spec_ngram=3``, float
   pool): 16 prompts that copy a motif 4-8 times, 32 new tokens, against
   the same load without it and under an oracle draft hook that proposes
   the streams the n-gram run emitted: B1 = 32 x whole prefills in each,
   B4 = 0 and no decode step under speculation (B4 = 32 x decode steps
   without it); the accept rate, tokens per verify step, the verify
   step's ms and host issue time, TTFT, ITL, tok/s, and the streams'
   agreement with the divergence gaps of phase 11. (b) the int8 KV pool that
   ``init_serving``'s default must pick at this cap, on the serving
   phase's load: B1 = 32 x prefills, B4 = 0; ``pool_bytes`` beside the
   float pool's, the decode step's ms and issue time. (c)
   ``weight_bits=8`` on a float pool, on that load: B4 = 32 x decode
   steps; the layer stack's bytes beside bf16's, the decode step, the
   agreement with the serving phase's streams; ``quantize_bits=8`` once
   (4 requests). (d) f32 at llama-7b width, 2 layers: speculation
   token-identical to the same engine without it, an oracle draft hook
   accepting >= 0.6; the int8 pool against the int8 contiguous
   ``generate``, and int8 + speculation against the int8 pool, by JAX's
   int8 bar (the first 4 generated tokens equal, agreement > 0.9); the
   int8 pool's teacher-forced decode logits within 0.1 relative L2 of
   the float pool's.
13. multi-LoRA, drain / resume and the KV handoff (after phase 12):
   llama-7b on the serving geometry, float pool. (a) bf16 at full depth,
   ``adapter_slots=8``, ``lora_rank=16``: 12 random adapters registered
   (7 usable slots), the serving phase's 24 prompts x 32 new tokens with
   adapter ids i % 13 (two base requests): 32 in-vocab tokens each,
   ``adapter_page_ins`` >= 12, ``adapter_evictions`` >= 1, and with the
   launch counts zeroed just before the load B1 = 0 (a LoRA engine
   prefills on the span path) and B4 = 32 x decode steps; the adapter
   pool's bytes, the LoRA decode step's ms and host issue ms beside the
   plain step's (and phase 4's), TTFT, ITL, tok/s. (b) f32, 2 layers:
   a mixed batch {base, 1, 2, 3} equal, token for token, to each tenant
   served alone on ``apply_lora_dense`` weights; a drain after one round
   resumed on a fresh engine, a KV handoff (``export_kv`` ->
   ``release_requests`` -> ``accept_migration(kv=)``), and after a
   payload with one flipped byte is refused (``ResumeIncompatible``)
   the re-prefill fallback, each equal to the pooled run. (c) bf16 at
   full depth: 4 requests of 1000-row prompts, 32 new tokens, handed off
   after the source's first round: payload bytes, export, crc, accept
   and scatter ms, the agreement with the colocated streams (reported);
   no fallback, and on the decode engine (counts zeroed just before) B1
   = 0 and B4 = 32 x decode steps.
14. sharded serving (after phase 13). (a) MoE on one card: Mixtral 8x7b
   at full width (H 4096, F 14336, 32 / 8 heads, 8 experts, top-2) cut
   to 8 of 32 layers, bf16, float pool, the serving phase's load: 32
   in-vocab tokens each, B1 = 8 x prefills and B4 = 8 x decode steps
   (counts zeroed just before), TTFT, ITL, tok/s and the decode step's
   CUDA-event and host issue ms beside phase 4's llama-7b step; then f32
   at Mixtral width, 2 layers: the kernels' teacher-forced logits within
   2e-2 relative L2 of the plain versions'. (b) llama-7b at tensor=2 and
   (c) the 8-layer Mixtral at expert=2, each as two processes sharing the
   card over a gloo group (``parallel/launch.run_group``; the kernels
   built before spawning): the serving load at bf16, every rank's B1 = L
   x prefills and B4 = L x decode steps (reported to rank 0), (b)'s
   ``pool_bytes x 2 == pool_bytes_logical`` and layer bytes halved but
   for the replicated norms, (c)'s expert stacks halved, the agreement
   with the one-card streams (reported: (b) runs 8 of llama-7b's 32
   layers and (c) 2 of Mixtral's), and f32 at 2 layers token for
   token equal to the unsharded engine. Times of (b) and (c) are of two
   processes sharing one card: not a tensor-parallel speed.
15. after the sparse training cross-check. (a) a block-sparse model
   served: llama-1b at full width and depth under the BigBird layout
   (block 128), bf16, float pool, prompt bucket 128: 16 requests of
   2048-8064 tokens, 32 new tokens each, on 16 slots. B5 = 16 x prefills,
   B1 = 0 and B4 = 16 x decode steps exactly (counts zeroed just before),
   the layout's tables built once a bucket; TTFT, ITL and tok/s beside
   the same load on the same weights dense (B1); then f32 at 2 layers: a
   prefill and 4 decode steps through the kernels within 2e-2 relative
   L2 of the plain versions. (b) fp16 training: llama-1b at full width
   and depth in f16 with the dynamic loss scaler (B=8, S=2048,
   dots_saveable, AdamW): 1 + 8 steps, the scaler after each step, B1 =
   2 x 8 x 16 and B2 = B3 = 8 x 16 launches exactly, step ms, tok/s and
   MFU beside phase 5's bf16 step; the f16 cross-check (2 layers, loss
   and every grad within 2e-2 of the plain versions); one forced
   overflow (params, masters and optimizer state bit for bit unchanged,
   the scale halved). (c) f16 serving: llama-7b width, 4 layers, the
   serving phase's load on f16 pools (B1 = 4 x prefills, B4 = 4 x decode
   steps exactly), its agreement with the same weights in bf16. (d) SGD
   (momentum), Adagrad, Lion and LAMB over llama-1b's leaves at 2 layers:
   2 updates on the card within 1e-5 of the same updates on CPU copies,
   update ms beside their bound. (e) dropout 0.1 at llama-1b width, 2
   layers, B=8, S=2048: the keep fraction within 5 sigma of 0.9, grads
   under dots_saveable equal to those without remat for one seed, a step
   beside the same step at rate 0. The kernel phase holds B1-B4's f16
   instantiations at these paths' shapes (within 2e-2, bitwise repeats,
   timed beside SDPA in f16), and the build phase requires them (f16
   wgmma instantiations of B1-B3 packing f16 pairs, B4's f16 split
   kernels, no saturating conversion anywhere). (d) also times LAMB's
   update and the global grad norm before and after the C3 repair
   (``c3_cost``), and its CPU copies run the repaired CPU sums as they
   are;
16. multi-rank training (after phase 15), two processes sharing the card
   over gloo (``parallel/launch.run_group``). First B1-B3 in bf16 against
   their plain versions at a rank's shapes (B = 4, S = 2048, as phase 0's
   cases). Then on the ranks: (a) every comm-facade collective on CUDA
   tensors against its expected value; (b) llama-1b at full width, 4 of
   its 16 layers, bf16 with f32 masters, AdamW, global B = 8, S = 2048 (4
   rows a rank), ZeRO stages 0-3, 2 steps each, the launch counts zeroed just
   before: losses within 2e-2 of stage 0's, the f32 masters' change over
   the steps within 1e-6 of stage 0's and equal to it bit for bit (a bf16
   param's reduced grad is rounded to bf16 at every stage, as JAX's and
   as stage 3's gather backward gives it), B1 = 2 x 2 x L and B2 = B3 =
   2 x L on every rank, the ZeRO memory laws on each rank's bytes of params, grads
   and optimizer state, peak memory, step times (two processes on one
   card: not a data-parallel speed); (c) f32 at 2 layers, S = 1024:
   stages 0-3 through the kernels against stage 0 through their plain
   versions on each rank's rows (losses within 1e-5, params within
   1e-4; 2 steps each); (d) onebitadam at 2 layers: its warm-up (2
   steps) equal to Adam, the
   compressed phase's wire about 1/32 of the dense all-reduce; (e) a
   stage-3 save at world 2 loaded here at world 1, stage 0, the next loss
   equal;
17. the fleet (after phase 16; serving engines recover a failed round by
   default, so first: no round of phases 3-16 may have recovered).
   (a) llama-7b bf16, two ``both`` replicas over ONE copy of the weights
   (two ``ServingEngine``s on one ``InferenceEngine``), 8 slots each,
   behind ``ServingRouter`` on a simulated clock; the serving phase's 24
   prompts x 32 new tokens, replica 0 killed at router round 3 (its
   engine drains, the router fails its requests over): every request
   finishes with 32 in-vocab tokens, one failover, none lost, each
   replica's B1 = 32 x its prefills and B4 = 32 x its decode steps
   (counted inside its own rounds), no recovery; TTFT / ITL p50 / p99,
   tok/s, failover ms, migrated / resubmitted, and the agreement with the
   one-replica streams and the divergence gaps in phase 4's drift units.
   (b) a ``prefill`` and a ``decode`` replica, ``handoff_kv`` on: the
   prefill replica's B4 = 0 and B1 = 32 x 24, the decode replica's B1 =
   32 x its fallbacks; handoff bytes and the export / crc / import ms.
   The fleet's launches (the kernels line's ``fleet`` and ``fleet_f32``)
   are counted over each drive alone, and each drive's count must equal
   the sum of its replicas' round counts. A recovery at llama-7b width (a
   failed dispatch after 8 prefills): the card's peak over it stays far
   below one pool (no second pool while no round thread is alive). (c) f32 at llama-7b width, 2 layers, four replicas (prefill, decode,
   two both), every serving, router and handoff kind injected: every
   stream token-identical to a fault-free single replica's, recoveries
   == the injected round failures, degraded 0. (d) tracing off, then on,
   on the same engines: the same streams, zero device syncs, a merged
   Chrome trace written and read back, the router's Prometheus text
   parsed back. (e) ``FleetController`` over a 2-slot replica: the burst
   scales up, the lull scales down, none lost, the streams equal.
18. the capacity tier (after phase 17): (a) the host C++ (CPU-Adam,
   CPU-Adagrad, aio) built from ``deepspeed_tpu_torch/csrc/host/`` with
   their g++ flags printed, which IO path a handle takes (io_uring or
   the thread pool), and the fused CPU-Adam's host bytes per second over
   the model's values. (b) the llama-1b training cell (full width, 4 of
   its 16 layers, B=8, S=2048, bf16, AdamW, dots_saveable), 1 + 2
   steps from one set of seeded weights: the on-device run, then (i)
   ``offload_optimizer.device=cpu`` (the chunk-streamed pinned tier),
   (ii) ``use_cpu_adam`` (the host C++ update), (iii) ``device=nvme``
   (the chunk files) and (iv) ``offload_param`` nvme (ZeRO-Infinity
   layer streaming). For each: step ms, the card's peak over the steps,
   the bytes of state on the card / host / disk equal to the config's
   law, losses within 2e-2 of the on-device run's, B1 = 2 x 4 x 3 and
   B2 = B3 = 4 x 3 (launch counts zeroed just before the steps), the
   host libraries' calls and the chunk files' reads and writes equal to
   their counts; the peak below the on-device run's by at least the
   optimizer state's 12 bytes a param under (i)-(iii), and lower still
   under (iv). The nvme tier writes into ``offload_scratch/`` in the
   checkout (its free space and filesystem type printed first; removed
   after the phase). (c) f32 at llama-1b width, 2 layers: each route's
   masters after 2 steps within 1e-6 relative L2 of the on-device run's
   (for (iv) with its layers rounded to bf16 after each update, as the
   layer store keeps them); a save under (iii) and (iv) resumed bit for
   bit.
19. model-parallel training (after phase 18). First B1 and B2 + B3 in
   bf16 against their plain versions at the MoE cell's shape (B=2,
   S=2048, 32/8 heads of 128, rep 4) and at a tensor=2 rank's (16/16
   heads of 128), with their bounds and SDPA's times. (a) Mixtral 8x7b
   at full width (hidden 4096, 32/8 heads, 8 experts of 14336, top-2,
   vocab 32000), 2 of its 32 layers, one card: bf16 with f32 masters,
   AdamW, B=2, S=2048, dots_saveable, aux weight 0.01, capacity 640 an
   expert; 1 warm-up + 3 steps: step ms (CUDA events, median), tok/s,
   MFU over the active params (tok/s x (6 N_active + 12 L H S) / 989
   TF/s), the card's peak, each layer's aux loss and dropped fraction;
   B1 = 2 x 3 x 2 (the replay), B2 = B3 = 3 x 2. Then two processes
   sharing the card over gloo (not a parallel speed): (b) expert=2,
   Mixtral width, 1 layer, 4 experts and 1 row a rank; (c) tensor=2,
   llama-7b width (32/32 heads of 128, FFN 11008), 4 layers, B=2,
   S=2048, with ``transformer.tp_overlap_chunks`` 0 and 4: the same
   losses bit for bit; each rank's bytes of params, grads and optimizer
   state equal to the law (the expert stacks halved at expert=2; the
   column, row and vocab leaves halved at tensor=2, the norms whole),
   and its B1 = 2 x L, B2 = B3 = L over 1 step after a warm-up.
   (d) f32 at S=512, SGD with momentum: expert=2 (Mixtral width, 1
   layer, capacity 0.5: tokens drop) and tensor=2 (llama-7b width, 2
   layers) against the same run at world 1,
   losses within 1e-5 and params after 2 steps within 1e-5 relative L2;
   one f32 MoE step's grads through the kernels within 1e-4 of the
   plain path.
20. pipeline, ring attention, data-mesh generate, the comms logger
   (after phase 19). First the kernels' times at the ring's shapes
   (llama-1b's heads, 32/8 of 64, S=16384 in two pieces of 8192, bf16
   and f32): B1 and B2 / B3 on a causal and a non-causal pair, the
   causal ring's three pairs summed, beside one call over the whole
   sequence, SDPA and the bound. Then two processes sharing the card
   over gloo (their point-to-point as a broadcast over the group of two
   ring neighbours; not a parallel speed), the comms logger on: (a)
   pipe=2, llama-1b width, 4 layers, B=8 S=2048 in M=4 micro-batches,
   bf16 + f32 masters, AdamW, ZeRO-1, dots_saveable, 1 + 2 steps: each
   stage's bytes of params / optimizer state / grads equal to the law
   (its 2 layers, the other leaves whole), B1 = 3 x M x L/P a step on
   stage 0 (the forward tick, the backward tick's recompute and its
   remat replay) and 2 x M x L/P on the last stage (one pass under
   autograd and its replay), B2 = B3 = M x L/P, 2 (M + 2) ppermutes
   over pipe a step, the bubble (P - 1) / (M + P - 1), peak memory; (c)
   seq=2, llama-1b width, 4 layers, B=1 S=16384 (8192 a rank), 1 + 2
   steps: rank j's B1 = 2 (j + 1) L and B2 = B3 = (j + 1) L a step;
   then ``ring_attention_local`` at those attention shapes in bf16 and
   f32: rank j's B1 = B2 = B3 = j + 1 a call, bit for bit on repeat,
   each rank's wall time, and the gathered O, dQ, dK, dV, and one B1 /
   B2 / B3 call over the whole sequence, each within 2e-2 (bf16) / 1e-4
   (f32) of the plain version (chunked by query rows); (b) f32 at
   2 layers, S=512: pipe=2 and seq=2 against world 1, losses and params
   after 2 steps within 1e-5; (d) ``InferenceEngine.generate`` on
   data=2, llama-7b width, 4 layers, 4 prompts of 512 (2 a rank), 32
   new tokens: B1 = 4 a rank (one prefill), and at f32 and 2 layers the
   stream token-identical to one rank's; (e) each rank's logger summary
   of (a) and (c), its calls and bytes equal to the facade's counts.
21. the model families (after phase 20). Every bias and norm leaf is
   drawn from the seed (nonzero). First B1-B3 at GPT-2 1.3b's shapes
   (32/32 heads of 64: the 1024 bucket, B=8 S=1024 training) and
   BERT-large's bidirectional padded batch (B=8 S=512, 16/16 heads of
   64, bf16 and f32), and B4 at GPT-2 1.3b's decode, each against its
   plain version. (a) GPT-2 1.3b (``gpt2_config("1.3b")``: 24 layers,
   H 2048, vocab 50257, learned positions, tied head) served in bf16:
   16 requests of 64..896 tokens, 32 new each: B1 = prefills x 24, B4 =
   decode steps x 24, TTFT, ITL and tok/s; (b) the same config trained
   at B=8 S=1024, 1 + 2 steps: B2 = B3 = 24 and B1 = 2 x 24 a step
   (dots_saveable), step time, tok/s, MFU, peak memory; (c) BERT-large
   from its ``config.json`` fields (post-LN, bidirectional, two token
   types): a padded B=8 S=512 forward (B1 = 24) and 2 training steps
   with the key mask (B2 = B3 = 24, B1 = 2 x 24 a step); (d) Pythia-1.4b
   (parallel block, rotary_dim 32, D 128: B1 and B4 on every layer),
   GPT-Neo-1.3B (global and 256-token local layers alternating,
   ``attn_scale`` 1.0: B1 on the global layers only, B4 = 0) and
   BLOOM-1b7 (ALiBi, vocab 250880: B1 = B4 = 0) at 4 layers each, 4
   requests of 300..900 tokens served; (e) f32 at 2 layers for each of
   the five: a greedy stream through the paged protocol token-identical
   to the plain versions', and ``lm_loss`` and its grads within 1e-5 /
   1e-4.
22. the training extras (after phase 21), on the dense training cell
   (llama-1b, B=8, S=2048, bf16 + f32 masters, AdamW, ZeRO-1,
   dots_saveable). First B1-B3 at the runs' new sequences (the
   curriculum's S=264, off every tile, and random-LTD's 1024 kept
   tokens) against their plain versions. Each run ``initialize`` ->
   ``train_batch`` with the launch counts zeroed before its first step,
   printing step ms, tok/s, MFU over the work done and peak memory: (a)
   the seqlen curriculum over 4 steps (fixed_linear 512 -> 2048,
   difficulty_step 256: S = 1024, 1280, 1792, 2048); (b) random-LTD, 1024
   of 2048 tokens on layers 1 .. 14; (c) progressive layer drop (theta
   0.5, gamma 0.1) over 6 steps, the kept layers read from the engine's
   host draws; (d) 8-bit weight fake-quant and 50 % sparse pruning on
   every layer matmul from the second step, 8-bit activations from the
   third, with the sort of ``w_in`` (184.5 M values) and the whole
   transform timed; (e) a student of 8 of the 16 layers
   (``student_params_from_teacher``) distilled from the bf16 teacher;
   (f) MoQ 16 -> 8 bits with the eigenvalue probe at 4 of the 16 layers,
   probes at steps 0 and 2. Launch laws, exact: B1 = 2 x the layers run a
   step and B2 = B3 = the layers run (dots_saveable replays B1), the
   teacher's 16 forward-only B1 a step, the probe's 2 (max_iter + 1)
   passes each a training pass; (g) f32 at 2 layers (random-LTD 3, the
   student 1 of 2), B=2, S=512, 3 SGD steps of each run through the
   kernels against the same run through the plain versions, every
   extra acting from step 1 (PLD's coins drop layer 1 at steps 1 and 2,
   activation quant from step 1): the same draws, every step's loss
   within 1e-5 and grads within 1e-4, the launch counts zeroed before
   each side, the kernel side's B1-B3 equal to its law and the plain
   side's launches 0.
23. the model families and the block-sparse model on a mesh (after phase
   22). First B1-B4 at a Pythia-1.4b tensor=2 rank's shapes (8/8 heads
   of 128: the 1024 bucket, B=4 S=2048 training, 8 decode slots) and B5
   at the BigBird model's rank (16 query heads of 64 after the repeat of
   its 4 kv heads, phase 15 (a)'s longest bucket), each against its
   plain version. Then one two-rank gloo group on the card plays every
   part (laws and identities, not a parallel speed): (a) Pythia-1.4b at
   full width (``config.json`` fields: H 2048, 16 heads of 128,
   ``rotary_dim`` 32, parallel block, biases, vocab 50304), cut to 4
   layers, at tensor=2: 8 requests of 64..1024 tokens, 32 new each (a
   rank's B1 = prefills x 4, B4 = decode steps x 4), then trained at
   B=4 S=2048, 1 + 2 steps (B1 = 2 x 4, B2 = B3 = 4 a step); each
   rank's bytes of params (served and trained), optimizer state and
   grads equal to the law: column, row and vocab leaves halved, row
   biases and norms whole; (b) BLOOM-1b7 width at tensor=2, 2 layers:
   bf16 logits within 2e-2 of world 1's, B1 = B4 = 0 (ALiBi at the
   rank's head offset, plain); (c) the BigBird llama-1b-width model at
   tensor=2, 4 layers, on phase 15 (a)'s load: a rank's B5 = prefills x
   4, B4 = decode steps x 4, B1 = 0; (d) f32 at 2 layers: Pythia, BLOOM
   and BERT-large at tensor=2 and BERT-large at data=2 under ZeRO-3, 2
   SGD steps each against world 1 (losses and params within 1e-5), and
   Pythia's and BLOOM's greedy streams at tensor=2 token-identical to
   world 1's.

Every phase prints ``phase_s {"phase": ..., "s": ...}`` (its wall
seconds) when it ends, and the script a ``"total"`` one before the
kernels line; every result line is followed by ``part_s {"phase":
..., "part": ..., "s": ...}``, the seconds since the phase's previous
part (in a process of a gloo group: rank 0's since its start). From
the start, three processes of this script (``--flex-warmup i``)
compile flex_attention for the sparse cases while the build runs,
filling the Inductor and Triton caches the sparse phase's own compiles
then read; the script waits for them before the first timed phase.

The script puts its own directory first on ``sys.path``, so it runs from
any working directory and under ``python -P``; in a directory without
the rest of the repo it fails (exit code 1) without printing a result.
Prints the card's name and power limit first, one ``{"kernels": [...]}``
line, and as its last line ``{"ok": true, "device": {...}}``. Imports
torch, numpy and the port only.
"""

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

# the port sits beside this script: importable from any working directory
# and under safe-path mode (python -P), which leaves the script's directory
# off sys.path
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 1e-4}
VOCAB = 32000


# the phase clock's running phase and the end of its last part (in a rank
# process: its start)
_CLOCK = {"phase": "rank", "t": time.perf_counter()}


def mark_part(label: str) -> None:
    """One ``part_s {"phase": ..., "part": label, "s": ...}`` line: the
    wall seconds since the phase began or its last part ended (in a
    process of a gloo group, rank 0's only)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() and dist.get_rank():
        return
    now = time.perf_counter()
    print("part_s " + json.dumps({"phase": _CLOCK["phase"], "part": label,
                                  "s": now - _CLOCK["t"]}), flush=True)
    _CLOCK["t"] = now


def log(msg: str) -> None:
    """Print ``msg``; a result line ends a part of the phase clock."""
    print(msg, flush=True)
    if not msg.startswith(("phase_s", "part_s", "{")):
        mark_part(msg.split(" {")[0].split(" [")[0][:60])


def timed(phase: str, fn, *args, **kw):
    """``fn(*args, **kw)``, then one ``phase_s`` line: its wall seconds."""
    t0 = time.perf_counter()
    _CLOCK.update(phase=phase, t=t0)
    out = fn(*args, **kw)
    log("phase_s " + json.dumps({"phase": phase,
                                 "s": time.perf_counter() - t0}))
    return out


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

def _attn_inputs(B, S, N, Nkv, D, dtype, masked, seed, causal=True):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((B, S, N, D), generator=g, device="cuda",
                         dtype=dtype) for _ in range(2))
    k, v = (torch.randn((B, S, Nkv, D), generator=g, device="cuda",
                        dtype=dtype) for _ in range(2))
    keep = torch.ones((S, S), dtype=torch.bool, device="cuda")
    if causal:
        keep = torch.tril(keep)
    keep = keep[None].expand(B, S, S)
    mask = None
    if masked:                      # right padding, and key 0 masked: the
        lens = torch.tensor([S - S // 4] + [S] * (B - 1), device="cuda")
        mask = torch.arange(S, device="cuda")[None, :] < lens[:, None]
        mask[:, 0] = False          # causal row 0 is then fully masked
        keep = keep & mask[:, None, :]
    return q, k, v, do, mask, keep


def flash_case(name, B, S, N, Nkv, D, dtype, masked=False, seed=0,
               causal=True):
    """B1 against the plain version: O by relative L2, LSE by relative L2
    over the rows that see a key (a fully masked row's M_FLOOR = -1e20
    would swamp any error in the others), fully masked rows exactly O = 0
    and LSE = M_FLOOR, a second launch bit for bit; then timed beside the
    plain version, SDPA's forward and the bound. ``causal`` False: the
    encoders' bidirectional attention."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        M_FLOOR, flash_attention_fwd, flash_attention_reference)
    q, k, v, _, mask, keep = _attn_inputs(B, S, N, Nkv, D, dtype, masked,
                                          seed, causal)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, kv_mask=mask)
    ro, rlse = flash_attention_reference(q, k, v, causal=causal,
                                         kv_mask=mask)
    again = flash_attention_fwd(q, k, v, causal=causal, kv_mask=mask)
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
    ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, causal=causal,
                                             kv_mask=mask))
    plain_ms = cuda_ms(lambda: flash_attention_reference(
        q, k, v, causal=causal, kv_mask=mask), iters=3, warmup=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if masked:
        am = keep[:, None]
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=am,
                                          enable_gqa=True))
    else:
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=causal,
                                          enable_gqa=True))
    pairs = float(keep.sum()) * N            # (query head, key) pairs visible
    flops = 4.0 * D * pairs
    moved = nbytes(q, k, v, o, lse) + (0 if mask is None else B * S)
    bound_ms, bound_by = bound(moved, flops, dtype)
    rec = dict(case=name, shape=f"B={B} S={S} Nq={N} Nkv={Nkv} D={D} "
               f"{str(dtype).split('.')[-1]} "
               + ("causal" if causal else "bidirectional")
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


def bwd_case(name, B, S, N, Nkv, D, dtype, masked=False, seed=0,
             causal=True):
    """B2 (dQ) and B3 (dK/dV), fused and unfused delta, against the plain
    backward on the same inputs, and a second launch against the first
    (bit for bit); then each kernel timed alone, beside its plain part,
    and B2 + B3 beside SDPA's backward (which computes dQ, dK and dV in
    one call). ``causal`` False: the encoders' bidirectional attention."""
    from deepspeed_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd)
    q, k, v, do, mask, keep = _attn_inputs(B, S, N, Nkv, D, dtype, masked,
                                           seed, causal)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, kv_mask=mask)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=causal,
                                         kv_mask=mask)
    errs, max_err = {}, {"dq": 0.0, "dkv": 0.0}
    for fused in (False, True):
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
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
        if masked and causal and not torch.all(got[0][:, 0] == 0):
            raise RuntimeError(f"flash_bwd {name}: the fully masked row has "
                               "a nonzero dQ")
    # deterministic: a second launch of B2 and of B3, right after the
    # first, gives the same dQ, dK and dV bit for bit (no atomics)
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
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
            q, k, v, o, lse, do, causal=causal, kv_mask=mask, fused=f,
            parts=(part,))) for f in (True, False)}
        plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal=causal, kv_mask=mask,
            parts=(part,)), iters=3, warmup=1)
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
        out = sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)
    dot = do.transpose(1, 2).contiguous()
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qt, kt, vt), dot, retain_graph=True))
    del out, qt, kt, vt
    shape = (f"B={B} S={S} Nq={N} Nkv={Nkv} D={D} "
             f"{str(dtype).split('.')[-1]} "
             + ("causal" if causal else "bidirectional")
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
        # the sparse serving load's decode (phase 15 a): llama-1b's 32/8
        # heads over a 8192-row table (MB = 128), slots up to 8096 rows
        decode_case("llama-1b GQA 32/8 MB=128 (sparse serving)", 16, 32, 8,
                    64, 64, 128, [0, 1, 127, 128, 129, 1000, 2047, 2048,
                                  2049, 3000, 4096, 5000, 6143, 7000, 8000,
                                  8096], bf),
        # B4's piece edges (R = 256 at bs 64) and a slot 3 rows past its
        # table (read as MB bs = 2048)
        decode_case("llama-70b GQA 64/8 piece edges", 8, 64, 8, 128, 64, 32,
                    [0, 1, 255, 256, 257, 1024, 2048, 2051], bf),
        # a fleet replica's decode (phase 17): 8 slots in bf16 (a, b) and
        # 4 in f32 (c-e) of llama-7b's 32/32 heads
        decode_case("llama-7b fleet replica 8 slots", 8, 32, 32, 128, 64, 32,
                    [0, 1, 63, 64, 65, 500, 1024, 2048], bf),
        decode_case("llama-7b f32 fleet replica 4 slots", 4, 32, 32, 128, 64,
                    32, [1, 64, 333, 2047], f32),
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


def sparse_prompt_lengths(rng):
    """Phase 15 (a)'s 16 prompt lengths, 2048-8064 tokens."""
    return rng.integers(2048, 8065, size=16)


SPARSE_PROMPT_SEED = 15
# the longest prompt bucket of phase 15 (a)'s load
SERVED_SPARSE_S = max(-(-int(n) // 128) * 128 for n in sparse_prompt_lengths(
    np.random.default_rng(SPARSE_PROMPT_SEED)))


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
    from torch.nn.attention.flex_attention import flex_attention
    bm = _flex_block_mask(cfg, S, causal)
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


def _flex_block_mask(cfg, S, causal):
    """The layout's BlockMask for flex_attention (tiles of 128 x 128, the
    layout's blocks inside them by ``mask_mod``)."""
    from torch.nn.attention.flex_attention import BlockMask
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

    return BlockMask.from_kv_blocks(*kv_table(partial), *kv_table(full),
                                    BLOCK_SIZE=F, mask_mod=mask_mod)


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
    mark_part(f"sparse {name}: kernels, plain versions")
    lib_fwd, lib_bwd, lib_err = _flex_yardstick(cfg, S, causal, q, k, v, do,
                                                o, got)
    mark_part(f"sparse {name}: flex_attention")
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


def _sparse_cases():
    """The sparse kernel phase's layouts and shapes: (name, mode, layout
    kwargs, B, S, N, D, dtype, sparse_case keywords)."""
    bf, f32 = torch.bfloat16, torch.float32
    return [
        ("llama-1b training BigBird B=2 S=8192", "bigbird", BIGBIRD_128,
         2, 8192, 32, 64, bf, {"dense": True}),
        ("bench BigBird S=32768", "bigbird", BIGBIRD_128, 1, 32768, 4, 64,
         bf, {}),
        ("bench Fixed S=4096", "fixed",
         dict(block=128, num_local_blocks=4, num_global_blocks=1),
         2, 4096, 4, 64, bf, {}),
        ("bench BSLongformer S=8192 D=128", "bslongformer",
         dict(block=128, num_sliding_window_blocks=3), 1, 8192, 4, 128, bf,
         {}),
        ("BigBird non-causal S=8192", "bigbird", BIGBIRD_128, 1, 8192, 4,
         64, bf, {"causal": False}),
        ("BigBird f32 block 64 S=4096", "bigbird",
         dict(BIGBIRD_128, block=64), 1, 4096, 4, 64, f32, {}),
        # the sparse serving prefill (phase 15 a) at its longest bucket:
        # B = 1, llama-1b's 32 heads after the K/V repeat, 63 blocks
        (f"llama-1b served BigBird B=1 S={SERVED_SPARSE_S}", "bigbird",
         BIGBIRD_128, 1, SERVED_SPARSE_S, 32, 64, bf, {}),
    ]


# phase 23's B5 case: a tensor=2 rank of the BigBird llama-1b-width model
# at phase 15 (a)'s longest bucket, 16 query heads after the repeat of its
# 4 kv heads (index 7 of the flex warm-up's cases)
FM_SPARSE_CASE = (f"llama-1b BigBird tensor=2 rank B=1 S={SERVED_SPARSE_S}",
                  "bigbird", BIGBIRD_128, 1, SERVED_SPARSE_S, 16, 64,
                  torch.bfloat16, {})


def _flex_setup():
    """flex_attention, the yardstick, compiles through Inductor and
    Triton: in-process (no compile workers), its caches beside the
    kernels' build, shared by this process and the warm-up processes; its
    backward without donated buffers, so a backward compiled in one
    process serves the timing loop's ``retain_graph`` calls in another."""
    import torch._dynamo
    import torch._functorch.config
    import torch._inductor.config
    from deepspeed_tpu_torch.ops import _build
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                          str(_build.BUILD_DIR / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(_build.BUILD_DIR / "triton"))
    torch._inductor.config.compile_threads = 1
    torch._dynamo.config.recompile_limit = 64
    torch._functorch.config.donated_buffer = False


# the sparse cases (indices into _sparse_cases) each warm-up process
# compiles flex_attention for: about 40 s of compiles each on an H100 host
FLEX_WARMUP_GROUPS = ((0, 2, 7), (1, 3), (4, 5, 6))


def start_flex_warmup():
    """Start one process per FLEX_WARMUP_GROUPS entry (this script with
    ``--flex-warmup i``) that compiles flex_attention's forward and
    backward for its sparse cases, so the sparse phase's compiles find
    Inductor's and Triton's caches filled (a graph does not depend on the
    layout's values). They only fill caches: the sparse phase compiles,
    runs and checks flex itself. They run beside the build, and the
    script waits for them before anything is timed
    (``wait_flex_warmup``)."""
    import atexit
    from deepspeed_tpu_torch.ops import _build
    _flex_setup()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for i in range(len(FLEX_WARMUP_GROUPS)):
        with open(_build.BUILD_DIR / f"flex_warmup_{i}.log", "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--flex-warmup",
                 str(i)], stdout=out, stderr=subprocess.STDOUT,
                env=dict(os.environ)))
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return procs


def wait_flex_warmup(procs, timeout_s=240.0):
    """Wait for the warm-up processes (one still running after
    ``timeout_s`` is ended) and log their exit codes: a failed warm-up
    costs compile time only."""
    end = time.perf_counter() + timeout_s
    for p in procs:
        try:
            p.wait(timeout=max(1.0, end - time.perf_counter()))
        except subprocess.TimeoutExpired:
            p.kill()
    log("flex warm-up exit codes " + json.dumps([p.wait() for p in procs]))


def flex_warmup(index: int) -> int:
    """One warm-up process: flex_attention's forward and backward at the
    shapes of the sparse cases of FLEX_WARMUP_GROUPS[index], on random
    inputs."""
    from torch.nn.attention.flex_attention import flex_attention
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _flex_setup()
    cases = _sparse_cases() + [FM_SPARSE_CASE]
    for j in FLEX_WARMUP_GROUPS[index]:
        name, mode, kw, B, S, N, D, dtype, extra = cases[j]
        t0 = time.perf_counter()
        cfg = sa.get_sparsity_config(mode, **kw)
        bm = _flex_block_mask(cfg, S, extra.get("causal", True))
        flex = torch.compile(flex_attention, dynamic=False)
        qt, kt, vt, dot = (torch.randn((B, N, S, D), device="cuda",
                                       dtype=dtype) for _ in range(4))
        qt, kt, vt = (t.requires_grad_() for t in (qt, kt, vt))
        out = flex(qt, kt, vt, block_mask=bm)
        # as the yardstick's first backward (its timing loop) runs
        torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        torch.cuda.synchronize()
        print(f"flex warm-up {name}: {time.perf_counter() - t0:.1f}s",
              flush=True)
        del qt, kt, vt, dot, out, bm
        torch.cuda.empty_cache()
    return 0


def sparse_kernel_phase():
    _flex_setup()
    for dtype in (torch.bfloat16, torch.float32):
        sparse_empty_case(dtype)
    return [sparse_case(name, mode, kw, B, S, N, D, dtype, **extra)
            for name, mode, kw, B, S, N, D, dtype, extra in _sparse_cases()]


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
    gens = [outs[k][len(p):] for k, p in zip(sorted(outs), prompts)]
    return srv, st, launches, (prompts, gens)


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
# serving breadth (phase 11)
# --------------------------------------------------------------------------

# the serving phase's engine settings, as phase 11's engines take them
BREADTH_SERVING = dict(max_seqs=16, block_size=64, max_model_len=2048,
                       decode_quantum=8)
# f32 model-level limit of the serving paths (PERF.md section 2)
SERVING_F32_TOL = 2e-2


def _agreement(a, b) -> float:
    """Share of equal tokens between two lists of generated streams."""
    a = np.concatenate([np.asarray(x).ravel() for x in a])
    b = np.concatenate([np.asarray(x).ravel() for x in b])
    return float((a == b).mean())


def _first_divergence(a, b):
    """Per stream pair, the index of the first differing token (the
    stream's length when none differs): after it, the two condition on
    different text."""
    out = []
    for x, y in zip(a, b):
        diff = np.flatnonzero(np.asarray(x) != np.asarray(y))
        out.append(int(diff[0]) if diff.size else len(x))
    return out


def _divergence_gaps(eng, prompts, a, b, drift):
    """At each stream pair's first divergence d, the bf16 model's logits
    for the text both streams share (prompt + a[:d]) through ``forward``:
    the gap between its top two, that gap over the logits' bf16 noise
    (``drift`` x their RMS: the per-logit scale of a relative-L2 drift),
    and whether the two streams' tokens at d are those top two. A gap of
    a few noise units is a near tie that bf16 rounding can flip."""
    out = []
    for p, x, y in zip(prompts, a, b):
        x, y = np.asarray(x), np.asarray(y)
        diff = np.flatnonzero(x != y)
        if not diff.size:
            continue
        d = int(diff[0])
        ids = np.concatenate([np.asarray(p).ravel(), x[:d]])[None]
        z = eng.forward(ids)[0, -1].float()
        top = torch.topk(z, 2)
        gap = float(top.values[0] - top.values[1])
        noise = drift * float(z.pow(2).mean().sqrt())
        out.append({"at": d, "gap": gap, "gap_over_noise": gap / noise,
                    "tokens_are_top2": sorted((int(x[d]), int(y[d])))
                    == sorted(top.indices.tolist())})
    return out


def _capture_first_logits(srv):
    """Keep each request's first-token logits (an f32 copy on the card,
    by request id): both prefill paths, the whole prompt's and the last
    span chunk's, pass them to ``_sample`` and hand the token to
    ``_set_first`` next."""
    firsts, last = {}, {}
    sample, set_first = srv._sample, srv._set_first

    def sample_kept(logits):
        last["z"] = logits
        return sample(logits)

    def set_first_kept(req, first):
        firsts[req.rid] = last["z"][0].float().clone()
        return set_first(req, first)

    srv._sample, srv._set_first = sample_kept, set_first_kept
    return firsts


def _check_generated(what, gens, n):
    for i, g in enumerate(gens):
        g = np.asarray(g)
        if g.size != n or g.min() < 0 or g.max() >= VOCAB:
            raise RuntimeError(f"{what}: request {i} returned {g.size} "
                               f"tokens in [{g.min()}, {g.max()}]")


def _serve_arrivals(srv, prompts, n):
    """The breadth load's arrival schedule: request 0 alone (its prefill
    publishes the shared prefix's blocks), requests 1 .. N-2 after its
    first round, and request N-1 (a retry of request 0's prompt) once
    request 0 has finished. Returns the generated tokens and the request
    ids in submission order, and the host seconds of the run."""
    done = {}

    def pump():
        for req in srv.step():
            done[req.rid] = req.output[len(req.prompt):]

    t0 = time.perf_counter()
    rids = [srv.add_request(prompts[0], n)]
    pump()
    rids += [srv.add_request(p, n) for p in prompts[1:-1]]
    while rids[0] not in done:
        pump()
    rids.append(srv.add_request(prompts[-1], n))
    while not srv.scheduler.done:
        pump()
    torch.cuda.synchronize()
    return [done[r] for r in rids], rids, time.perf_counter() - t0


def breadth_generate(eng, prompts, n):
    """(a) one-shot generate of the batch on the contiguous cache: B1 once
    per layer (one prefill of the whole batch) and no paged decode."""
    from deepspeed_tpu_torch.ops import _build
    L = eng.model.config.num_layers
    eng.generate(prompts[:1, :64], max_new_tokens=8)           # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    gens = list(out[:, prompts.shape[1]:].cpu().numpy())
    _check_generated("generate", gens, n)
    if launches["flash_fwd"] != L or launches["paged_decode"] != 0:
        raise RuntimeError(f"generate: launches {launches}, want flash_fwd "
                           f"{L} (one prefill x {L} layers), paged_decode 0")
    B = prompts.shape[0]
    return gens, {"B": B, "prompt": prompts.shape[1], "new_tokens": n,
                  "wall_s": wall, "ms_per_step": wall * 1e3 / n,
                  "ms_per_token": wall * 1e3 / (B * n),
                  "launches": launches}


def breadth_cross_check(rng):
    """(c) f32 at llama-7b width, 2 layers, teacher-forced: rows [512,
    1024) through the span path behind a 512-row prefill against one
    1024-row pass (logits of every row against ``forward``, the last
    against ``prefill_paged``, the pool rows against its writes); the
    contiguous cache's prefill and 16 decode steps against the paged
    prefill and decode steps on the same tokens; the token agreement of
    ``generate`` and the paged engine's greedy streams. Returns the
    2-layer engine, reused by (d)."""
    from deepspeed_tpu_torch import init_inference, llama_config, make_model
    from deepspeed_tpu_torch.inference.serving import (ServingConfig,
                                                       ServingEngine)
    from deepspeed_tpu_torch.models import transformer as tf
    cfg = llama_config("7b", num_layers=2, dtype=torch.float32)
    eng = init_inference(make_model(cfg, "llama-7b-2l"),
                         config={"kv_cache_bits": 0}, dtype=torch.float32,
                         seed=1)
    params, bs, MB = eng.params, 64, 2048 // 64
    ids = torch.from_numpy(rng.integers(0, VOCAB, (1, 1024))).cuda()
    tables = torch.zeros((1, MB), dtype=torch.int32, device="cuda")
    tables[0, :16] = torch.arange(1, 17, dtype=torch.int32)
    blocks = tables[0, :16].long()
    rec = {}
    with torch.no_grad():
        full = tf.forward(params, ids, cfg)[0]                   # [1024, V]
        whole = tf.init_paged_cache(cfg, 17, bs, device="cuda")
        last = tf.prefill_paged(params, ids, cfg, whole, blocks)
        split = tf.init_paged_cache(cfg, 17, bs, device="cuda")
        tf.prefill_paged(params, ids[:, :512], cfg, split, blocks[:8])
        span = tf.decode_span_paged(
            params, ids[:, 512:], cfg, split, tables,
            torch.tensor([512], dtype=torch.int32, device="cuda"))[0]
        rec["span_logits_vs_forward"] = rel_l2(span, full[512:])
        rec["span_last_vs_prefill"] = rel_l2(span[-1], last[0])
        rec["span_pool_k"] = rel_l2(split["k"][:, 9:17], whole["k"][:, 9:17])
        rec["span_pool_v"] = rel_l2(split["v"][:, 9:17], whole["v"][:, 9:17])
        del full, whole, split
        # contiguous against paged, teacher-forced
        feed = torch.from_numpy(rng.integers(0, VOCAB, (16, 1))).cuda()
        cache = tf.init_cache(cfg, 1, 576, device="cuda")
        c_last, cache = tf.prefill(params, ids[:, :512], cfg, cache)
        pools = tf.init_paged_cache(cfg, 17, bs, device="cuda")
        p_last = tf.prefill_paged(params, ids[:, :512], cfg, pools,
                                  blocks[:8])
        errs = [rel_l2(c_last, p_last)]
        lens = torch.tensor([512], dtype=torch.int32, device="cuda")
        for tok in feed:
            lc, cache = tf.decode_step(params, tok, cfg, cache)
            lp = tf.decode_step_paged(params, tok, cfg, pools, tables, lens)
            errs.append(rel_l2(lc, lp))
            lens = lens + 1
        rec["contiguous_vs_paged_prefill"] = errs[0]
        rec["contiguous_vs_paged_decode_max"] = max(errs[1:])
        del cache, pools
    bad = {k: v for k, v in rec.items() if not v < SERVING_F32_TOL}
    gen = eng.generate(ids[:, :512], max_new_tokens=16)[0, 512:].cpu()
    srv = ServingEngine(eng, ServingConfig(**BREADTH_SERVING))
    out = srv.run([(ids[0, :512].cpu().numpy(), 16)])
    paged = next(iter(out.values()))[512:]
    rec["generate_vs_paged_token_agreement"] = _agreement([gen], [paged])
    del srv
    log("breadth cross-check f32 (llama-7b width, 2 layers), rel L2 "
        + json.dumps(rec))
    if bad:
        raise RuntimeError(f"breadth cross-check: over {SERVING_F32_TOL}: "
                           f"{bad}")
    return eng, rec


def breadth_reliability(eng, rng):
    """(d) on the 2-layer engine: a total deadline that expires
    mid-decode cancels the request and returns its blocks; max_queue=2
    sheds the third waiting request; the JSONL sink holds both records;
    dispatch_timeout_s=60 leaves the greedy stream as it is without it."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch.inference.scheduler import AdmissionRejected
    from deepspeed_tpu_torch.inference.serving import (ServingConfig,
                                                       ServingEngine)
    tmp = tempfile.mkdtemp(prefix="dstpu_breadth_")
    sink = os.path.join(tmp, "events.jsonl")
    prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
               for n in (300, 700, 129)]
    rec = {}
    try:
        srv = ServingEngine(eng, ServingConfig(
            **BREADTH_SERVING, max_queue=2, telemetry_jsonl=sink))
        rid = srv.add_request(prompts[0], 200)
        srv.step()
        held = srv.allocator.used_blocks
        # the deadline is set after the first round: warm-up time must not
        # race the clock
        srv.scheduler.running[0].deadline_ms = 1e-3
        srv.step()
        cancelled = [r.rid for r in srv.cancelled]
        if cancelled != [rid] or srv.allocator.used_blocks != 0 or held < 1:
            raise RuntimeError(f"deadline: cancelled {cancelled}, blocks "
                               f"{held} -> {srv.allocator.used_blocks}")
        srv.add_request(prompts[1], 8)
        srv.add_request(prompts[2], 8)
        try:
            srv.add_request(prompts[0], 8)
            raise RuntimeError("max_queue=2 admitted a third waiting request")
        except AdmissionRejected as e:
            rec["shed_reason"] = e.reason
        srv.run([])                      # drains the two queued requests
        st = srv.stats()
        with open(sink) as f:
            types = [json.loads(line)["type"] for line in f]
        rec.update(deadline_misses=st["deadline_misses"], shed=st["shed"],
                   completed=st["completed"], sink_types=sorted(set(types)))
        if {"deadline_miss", "request_shed"} - set(types) \
                or rec["shed_reason"] != "queue_full" or st["completed"] != 2:
            raise RuntimeError(f"reliability: {rec}")
        del srv
        load = [(p, 24) for p in prompts]
        outs = []
        for timeout in (None, 60.0):
            srv = ServingEngine(eng, ServingConfig(
                **BREADTH_SERVING, dispatch_timeout_s=timeout))
            got = srv.run(load)
            outs.append([got[k] for k in sorted(got)])
            srv.close()
            del srv
        rec["watchdog_stream_equal"] = all(
            np.array_equal(a, b) for a, b in zip(*outs))
        if not rec["watchdog_stream_equal"]:
            raise RuntimeError("dispatch_timeout_s=60 changed the stream")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("breadth reliability " + json.dumps(rec))
    return rec


def serving_breadth_phase(srv, smi: str, drift: float):
    """Phase 11, on the serving phase's engine (llama-7b, bf16) once its
    first ServingEngine's pools are freed: (a) generate; (b) the prefix
    cache and chunked prefill against the same load with both off; then
    (c) and (d) on a 2-layer f32 engine. ``drift`` is phase 4's largest
    relative L2 of the bf16 kernel path's logits from the f32 plain
    path's. Returns the record, with the launch counts of (a) and (b)
    warm (zeroed just before each)."""
    from deepspeed_tpu_torch.inference.serving import (ServingConfig,
                                                       ServingEngine)
    from deepspeed_tpu_torch.ops import _build
    eng = srv.engine
    srv.pools = None
    gc.collect()
    torch.cuda.empty_cache()
    L = eng.model.config.num_layers
    rng = np.random.default_rng(11)
    t_phase = time.perf_counter()
    rec = {"card": smi}

    # (a) generate, and the paged engine's greedy stream for its prompts
    prompts_a = torch.from_numpy(rng.integers(0, VOCAB, (4, 512))).cuda()
    gens, rec["generate"] = breadth_generate(eng, prompts_a, 64)
    gc.collect()
    torch.cuda.empty_cache()
    cold = ServingEngine(eng, ServingConfig(**BREADTH_SERVING))
    outs = cold.run([(p.cpu().numpy(), 64) for p in prompts_a])
    paged = [outs[k][512:] for k in sorted(outs)]
    rec["generate"]["paged_token_agreement"] = _agreement(gens, paged)
    rec["generate"]["paged_first_divergence"] = _first_divergence(gens,
                                                                  paged)
    rec["generate"]["divergence_gaps"] = _divergence_gaps(
        eng, prompts_a.cpu().numpy(), gens, paged, drift)
    log("breadth generate " + json.dumps(rec["generate"]))

    # (b) 16 requests: an 800-token shared prefix (12.5 blocks) and a
    # tail of 64..512 tokens; request 15 retries request 0's prompt,
    # whose 100-token tail leaves a partial boundary block to fork
    shared = rng.integers(0, VOCAB, 800)
    tails = [100] + [int(t) for t in rng.integers(64, 513, 14)]
    prompts_b = [np.concatenate([shared, rng.integers(0, VOCAB, t)])
                 .astype(np.int32) for t in tails]
    prompts_b.append(prompts_b[0].copy())
    cold.reset_stats()
    cold_first = _capture_first_logits(cold)
    cold_gens, cold_rids, cold_s = _serve_arrivals(cold, prompts_b, 32)
    _check_generated("breadth cold", cold_gens, 32)
    rec["cold"] = dict(cold.stats(), host_s=cold_s)
    del cold, outs
    gc.collect()
    torch.cuda.empty_cache()
    warm = ServingEngine(eng, ServingConfig(
        **BREADTH_SERVING, enable_prefix_cache=True,
        prefill_token_budget=1024))
    warm_first = _capture_first_logits(warm)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    warm_gens, warm_rids, warm_s = _serve_arrivals(warm, prompts_b, 32)
    launches = _build.launch_counts()
    _check_generated("breadth warm", warm_gens, 32)
    st = dict(warm.stats(), host_s=warm_s)
    held, used = st["prefix_held_blocks"], warm.allocator.used_blocks
    warm._prefix_cache.clear()
    st["used_blocks_after_clear"] = warm.allocator.used_blocks
    st["token_agreement_with_cold"] = _agreement(warm_gens, cold_gens)
    st["first_divergence_from_cold"] = _first_divergence(warm_gens,
                                                         cold_gens)
    st["divergence_gaps"] = _divergence_gaps(eng, prompts_b, warm_gens,
                                             cold_gens, drift)
    # first-token logits, warm (request 15: the fork) against cold
    first_err = [rel_l2(warm_first[w], cold_first[c])
                 for w, c in zip(warm_rids, cold_rids)]
    first_tol = 3 * drift
    st["first_logits_vs_cold"] = {"rel_l2": first_err, "limit": first_tol,
                                  "bf16_drift": drift}
    rec["warm"], rec["launches"] = st, launches
    log("breadth prefix cache + chunked prefill " + json.dumps(
        {"warm": st, "cold": rec["cold"], "launches": launches}))
    want = {"prefix_hits >= 15": st["prefix_hits"] >= 15,
            "cow_forks >= 1": st["cow_forks"] >= 1,
            "prefill_chunks >= 1": st["prefill_chunks"] >= 1,
            "flash_fwd == L x prefills":
                launches["flash_fwd"] == L * st["prefills"] >= L,
            "paged_decode == L x decode_steps":
                launches["paged_decode"] == L * st["decode_steps"] > 0,
            "first-token logits within 3 x bf16 drift of cold":
                max(first_err) < first_tol,
            "used_blocks == prefix_held_blocks": used == held,
            "used_blocks == 0 after clear":
                st["used_blocks_after_clear"] == 0}
    failed = [k for k, v in want.items() if not v]
    if failed:
        raise RuntimeError(f"breadth: failed {failed}")
    del warm
    eng.params = None
    gc.collect()
    torch.cuda.empty_cache()

    # (c) and (d): 2 layers at llama-7b width, f32
    eng2, rec["cross_check"] = breadth_cross_check(rng)
    rec["reliability"] = breadth_reliability(eng2, rng)
    del eng2
    gc.collect()
    torch.cuda.empty_cache()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"serving breadth: {rec['phase_s']:.1f}s")
    return rec


# --------------------------------------------------------------------------
# quantized and speculative decode (phase 12)
# --------------------------------------------------------------------------

SPEC_K = 3
# f32 engines of (d): llama-7b width, 2 layers, 4 slots
QS_F32_SERVING = dict(max_seqs=4, block_size=64, max_model_len=1024,
                      decode_quantum=8)
# relative L2 of the int8 pool's decode logits from the float pool's at
# f32: per-row int8 rounds each K/V element by at most half a step of
# max|row| / 127, which JAX's note puts at ~1e-2 of the softmax's output;
# ten times that is a broken path, not rounding
INT8_LOGITS_LIMIT = 1e-1


def _motif_prompts(rng, n, motif=48, copies=(4, 8), gap=8, tail=16):
    """Prompts that copy spans, the n-gram proposer's home traffic (agent
    and code prompts re-quote tool names, identifiers and whole
    snippets): a motif repeated 4..8 times, random tokens between the
    copies and after the last."""
    out = []
    for _ in range(n):
        m = rng.integers(0, VOCAB, motif)
        parts = []
        for _ in range(int(rng.integers(copies[0], copies[1] + 1))):
            parts += [m, rng.integers(0, VOCAB, gap)]
        parts.append(rng.integers(0, VOCAB, tail))
        out.append(np.concatenate(parts).astype(np.int32))
    return out


def _serve_counted(srv, prompts, n, what, before=None):
    """One warm-up request, then ``prompts`` with the stats and the launch
    counts zeroed just before: the generated streams (checked: n in-vocab
    tokens each), the stats with the wall time, and the launches.
    ``before``: called after the warm-up, before the counted run."""
    from deepspeed_tpu_torch.ops import _build
    srv.run([(prompts[0][:64], 4)])
    if before is not None:
        before()
    srv.reset_stats()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = srv.run([(p, n) for p in prompts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    gens = [outs[k][len(p):] for k, p in zip(sorted(outs), prompts)]
    _check_generated(what, gens, n)
    st = dict(srv.stats(), wall_s=wall)
    if srv.allocator.used_blocks != 0:
        raise RuntimeError(f"{what}: {srv.allocator.used_blocks} blocks held")
    return gens, st, launches


def _step_scratch(srv, rows=1000):
    """Tables and lengths of a full batch (every slot at ``rows`` rows)
    over the engine's pools, whose blocks are all free after a run."""
    S, MB = srv.config.max_seqs, srv.MB
    tab = torch.arange(1, S * MB + 1, dtype=torch.int32,
                       device="cuda").reshape(S, MB)
    lens = torch.full((S,), rows, dtype=torch.int32, device="cuda")
    return S, tab, lens


def _decode_step_times(srv):
    """CUDA-event ms and host issue ms of one decode step of every slot at
    1000 rows (the kernel on a float pool, the gathered int8 read on an
    int8 pool)."""
    from deepspeed_tpu_torch.models import transformer as tf
    S, tab, lens = _step_scratch(srv)
    toks = torch.zeros((S,), dtype=torch.long, device="cuda")

    def step():
        return tf.decode_step_paged(srv.engine.params, toks,
                                    srv.model.config, srv.pools, tab, lens)
    return {"ms": cuda_ms(step, iters=5), "issue_ms": host_issue_ms(step, 5)}


def _verify_step_times(srv):
    """The same for one verify step (the pending token plus K proposals
    of every slot, one span pass, the accept rule)."""
    S, tab, lens = _step_scratch(srv)
    tok_mat = torch.zeros((S, SPEC_K + 1), dtype=torch.long, device="cuda")
    act = torch.ones((S,), dtype=torch.bool, device="cuda")

    def step():
        return srv._spec_step(tok_mat, tab, lens, act)
    return {"ms": cuda_ms(step, iters=5), "issue_ms": host_issue_ms(step, 5)}


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _int8_bar(what, prompts, got, want):
    """JAX's int8 parity bar (``tests/unit/test_serving.py:299-327``): per
    request, the first 4 generated tokens equal (the prompt is shared) and
    more than 0.9 of all tokens agree."""
    for i, (p, g, w) in enumerate(zip(prompts, got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if not (g[:4] == w[:4]).all() or not (g == w).mean() > 0.9:
            raise RuntimeError(f"{what}: request {i} {g.tolist()} against "
                               f"{w.tolist()}")
    return _agreement(got, want)


def _oracle(prompts, streams):
    """A draft hook that proposes the given continuation of each prompt
    (keyed by its first 16 tokens)."""
    table = {tuple(p[:16].tolist()): np.concatenate([p, s]).astype(np.int32)
             for p, s in zip(prompts, streams)}

    def draft(ctx, k):
        full = table[tuple(np.asarray(ctx)[:16].tolist())]
        return full[ctx.size:ctx.size + k]
    return draft


def quantized_spec_checks(rng):
    """(d) f32 at llama-7b width, 2 layers (TF32 off): speculation against
    the same engine without it (token-identical) and with an oracle draft
    hook (accept rate >= 0.6); the int8 pool against the int8 contiguous
    ``generate``, and int8 + speculation against the int8 pool, by JAX's
    int8 bar; the int8 pool's teacher-forced decode logits against the
    float pool's (relative L2, under INT8_LOGITS_LIMIT)."""
    from deepspeed_tpu_torch import init_inference, llama_config, make_model
    from deepspeed_tpu_torch.inference.serving import (ServingConfig,
                                                       ServingEngine)
    cfg = llama_config("7b", num_layers=2, dtype=torch.float32)
    rec = {}
    prompts = _motif_prompts(rng, 4, motif=32, copies=(6, 6), gap=0, tail=64)
    load = [(p, 32) for p in prompts]

    def run(eng, **extra):
        srv = ServingEngine(eng, ServingConfig(**QS_F32_SERVING, **extra))
        outs = srv.run(list(load))
        gens = [outs[k][len(p):] for k, p in zip(sorted(outs), prompts)]
        return gens, srv.stats()

    e32 = init_inference(make_model(cfg, "llama-7b-2l"),
                         config={"kv_cache_bits": 0}, dtype=torch.float32,
                         seed=5)
    off, _ = run(e32)
    on, st = run(e32, spec_tokens=SPEC_K)
    rec["spec_equal_spec_off"] = all(np.array_equal(a, b)
                                     for a, b in zip(on, off))
    rec["spec_accept_rate"] = st.get("spec_accept_rate", 0.0)
    _, st = run(e32, spec_tokens=SPEC_K, spec_proposer=_oracle(prompts, off))
    rec["oracle_accept_rate"] = st["spec_accept_rate"]
    e8 = init_inference(make_model(cfg, "llama-7b-2l"),
                        config={"kv_cache_bits": 8}, dtype=torch.float32,
                        seed=5)
    if e8.model.config.kv_cache_bits != 8:
        raise RuntimeError("(d): kv_cache_bits=8 not served")
    p8, _ = run(e8)
    g8 = e8.generate(np.stack(prompts), max_new_tokens=32)
    g8 = list(g8[:, len(prompts[0]):].cpu().numpy())
    rec["int8_paged_vs_generate"] = _int8_bar("int8 paged vs generate",
                                              prompts, p8, g8)
    s8, st8 = run(e8, spec_tokens=SPEC_K)
    rec["int8_spec_vs_int8"] = _int8_bar("int8 + spec vs int8", prompts,
                                         s8, p8)
    rec["int8_spec_accept_rate"] = st8.get("spec_accept_rate", 0.0)
    ids = torch.zeros((1, 256), dtype=torch.long, device="cuda")
    ids[0] = torch.from_numpy(prompts[0][:256]).cuda()
    feed = [torch.from_numpy(rng.integers(0, VOCAB, 1)).cuda()
            for _ in range(8)]
    with torch.no_grad():
        lf = _prefill_and_decode(e32.params, e32.model.config, ids, 250,
                                 feed, False)
        l8 = _prefill_and_decode(e8.params, e8.model.config, ids, 250,
                                 feed, False)
    rec["int8_vs_float_logits"] = [rel_l2(a, b) for a, b in zip(l8, lf)]
    log("quantized + spec f32 checks (llama-7b width, 2 layers) "
        + json.dumps(rec))
    want = {"spec streams == spec-off streams": rec["spec_equal_spec_off"],
            "oracle accept rate >= 0.6": rec["oracle_accept_rate"] >= 0.6,
            f"int8 vs float logits < {INT8_LOGITS_LIMIT}":
                max(rec["int8_vs_float_logits"]) < INT8_LOGITS_LIMIT}
    failed = [k for k, v in want.items() if not v]
    if failed:
        raise RuntimeError(f"(d): failed {failed}")
    return rec


def quantized_spec_phase(smi: str, drift: float, base):
    """Phase 12: llama-7b at full width and depth, bf16, the serving
    geometry (16 slots, block 64, max_model_len 2048), a fresh engine for
    each pool or weight type, freed before the next. (a) speculation
    (K = 3, n-gram 3) on a float pool, 16 motif-copying prompts x 32
    tokens, against the same load without it and under an oracle draft
    hook that proposes the streams the n-gram run emitted; (b) the int8
    KV pool that ``init_serving``'s default picks at this cap, on the
    serving phase's load; (c) weight_bits=8 on a float pool, on that
    load, against the serving phase's streams (``base``: its prompts and
    greedy streams), and quantize_bits=8 once; (d) the f32 checks. Launch
    counts zeroed just before each load: B1 = 32 x whole prefills
    everywhere, B4 = 0 under speculation and on the int8 pool, 32 x
    decode steps with int8 weights. Returns the record, with the summed
    launches."""
    from deepspeed_tpu_torch import init_serving, llama_config, make_model
    from deepspeed_tpu_torch.inference.engine import init_inference
    from deepspeed_tpu_torch.inference.kv_cache import pool_bytes
    from deepspeed_tpu_torch.inference.serving import (ServingConfig,
                                                       ServingEngine)
    cfg = llama_config("7b")
    L = cfg.num_layers
    rng = np.random.default_rng(12)
    t_phase = time.perf_counter()
    rec = {"card": smi}
    total = {"flash_fwd": 0, "paged_decode": 0}
    checks = {}

    def count(name, st, launches, decode_kernel):
        for k in total:
            total[k] += launches[k]
        checks[f"{name}: flash_fwd == L x prefills"] = \
            launches["flash_fwd"] == L * st["prefills"] > 0
        if decode_kernel:
            checks[f"{name}: paged_decode == L x decode_steps"] = \
                launches["paged_decode"] == L * st["decode_steps"] > 0
        else:
            checks[f"{name}: paged_decode == 0"] = \
                launches["paged_decode"] == 0

    # (a) speculation on a float pool, against the same load without it
    eng = init_inference(make_model(cfg, "llama-7b"),
                         config={"kv_cache_bits": 0}, dtype=torch.bfloat16,
                         seed=0)
    prompts = _motif_prompts(rng, 16)
    off = ServingEngine(eng, ServingConfig(**BREADTH_SERVING))
    off_gens, off_st, launches = _serve_counted(off, prompts, 32, "spec off")
    count("spec off", off_st, launches, True)
    off_st["decode_step"] = _decode_step_times(off)
    del off
    _free()
    spec = ServingEngine(eng, ServingConfig(
        **BREADTH_SERVING, spec_tokens=SPEC_K, spec_ngram=3))
    gens, st, launches = _serve_counted(spec, prompts, 32, "spec")
    count("spec", st, launches, False)
    checks["spec: no decode step, verify steps > 0"] = \
        st["decode_steps"] == 0 and st["verify_steps"] > 0
    st["verify_step"] = _verify_step_times(spec)
    st["tokens_per_verify"] = ((st["spec_accepted"] + st["spec_steps"])
                               / max(st["spec_steps"], 1))
    st["token_agreement_with_spec_off"] = _agreement(gens, off_gens)
    st["first_divergence_from_spec_off"] = _first_divergence(gens, off_gens)
    st["divergence_gaps"] = _divergence_gaps(eng, prompts, gens, off_gens,
                                             drift)
    rec["spec"], rec["spec_off"] = st, off_st
    rec["prompt_lengths"] = [len(p) for p in prompts]
    del spec
    _free()
    # the same load under a draft that proposes what the speculative
    # engine itself emitted above: what verify steps give where proposals
    # are right (a stream may still part from it at a bf16 near tie, as
    # the spec-off streams do at once, after which its proposals miss)
    spec = ServingEngine(eng, ServingConfig(
        **BREADTH_SERVING, spec_tokens=SPEC_K,
        spec_proposer=_oracle(prompts, gens)))
    o_gens, o_st, launches = _serve_counted(spec, prompts, 32, "spec oracle")
    count("spec oracle", o_st, launches, False)
    o_st["tokens_per_verify"] = ((o_st["spec_accepted"] + o_st["spec_steps"])
                                 / max(o_st["spec_steps"], 1))
    o_st["token_agreement_with_spec"] = _agreement(o_gens, gens)
    rec["spec_oracle"] = o_st
    log("phase 12 (a) speculation " + json.dumps(
        {"spec": st, "spec_off": off_st, "spec_oracle": o_st}))
    del spec, eng
    _free()

    # (b) the int8 KV pool init_serving picks by default at this cap
    base_prompts, base_gens = base
    srv = init_serving(make_model(cfg, "llama-7b"), serving=BREADTH_SERVING,
                       dtype=torch.bfloat16, seed=0)
    checks["int8: kv_cache_bits resolves to 8"] = (
        srv.model.config.kv_cache_bits == 8
        and srv.pools["k"].dtype == torch.int8
        and srv.engine.config.max_tokens == 2048)
    gens, st, launches = _serve_counted(srv, base_prompts, 32, "int8 kv")
    count("int8 kv", st, launches, False)
    st["float_pool_bytes"] = pool_bytes(
        dataclasses.replace(cfg, kv_cache_bits=0), srv.num_blocks, 64,
        dtype=torch.bfloat16)
    st["decode_backend"] = srv.backend_bench
    st["decode_step"] = _decode_step_times(srv)
    st["token_agreement_with_serving_phase"] = _agreement(gens, base_gens)
    rec["int8_kv"] = st
    log("phase 12 (b) int8 KV " + json.dumps(st))
    del srv
    _free()

    # (c) int8 weights on a float pool; quantize_bits once
    eng = init_inference(make_model(cfg, "llama-7b"),
                         config={"kv_cache_bits": 0, "weight_bits": 8},
                         dtype=torch.bfloat16, seed=0)
    layers = eng.params["layers"]
    int8_bytes = sum(t.numel() * t.element_size() for v in layers.values()
                     for t in (v.values() if isinstance(v, dict) else [v]))
    bf16_bytes = sum((v["q"] if isinstance(v, dict) else v).numel() * 2
                     for v in layers.values())
    srv = ServingEngine(eng, ServingConfig(**BREADTH_SERVING))
    gens, st, launches = _serve_counted(srv, base_prompts, 32,
                                        "weight_bits")
    count("weight_bits", st, launches, True)
    st.update(layer_bytes=int8_bytes, layer_bytes_bf16=bf16_bytes,
              decode_step=_decode_step_times(srv),
              token_agreement_with_serving_phase=_agreement(gens, base_gens),
              first_divergence_from_serving_phase=_first_divergence(
                  gens, base_gens))
    st["divergence_gaps"] = _divergence_gaps(eng, base_prompts[:8],
                                             gens[:8], base_gens[:8], drift)
    rec["weight_bits"] = st
    log("phase 12 (c) weight_bits " + json.dumps(st))
    del srv, eng, layers
    _free()
    eng = init_inference(make_model(cfg, "llama-7b"),
                         config={"kv_cache_bits": 0, "quantize_bits": 8},
                         dtype=torch.bfloat16, seed=0)
    srv = ServingEngine(eng, ServingConfig(**BREADTH_SERVING))
    q_gens, st, launches = _serve_counted(srv, base_prompts[:4], 16,
                                          "quantize_bits")
    count("quantize_bits", st, launches, True)
    st["decode_step"] = _decode_step_times(srv)
    st["token_agreement_with_weight_bits"] = _agreement(
        q_gens, [g[:16] for g in gens[:4]])
    rec["quantize_bits"] = st
    log("phase 12 (c) quantize_bits " + json.dumps(st))
    del srv, eng
    _free()

    # (d) f32 checks at 2 layers
    rec["f32"] = quantized_spec_checks(rng)
    _free()
    rec["launches"] = total
    rec["phase_s"] = time.perf_counter() - t_phase
    failed = [k for k, v in checks.items() if not v]
    log(f"phase 12: {rec['phase_s']:.1f}s, launches {json.dumps(total)}, "
        f"checks {json.dumps(checks)}")
    if failed:
        raise RuntimeError(f"phase 12: failed {failed}")
    return rec



# --------------------------------------------------------------------------
# multi-LoRA, drain / resume and the KV handoff (phase 13)
# --------------------------------------------------------------------------

# the README's documented multi-LoRA settings on the serving geometry: 8
# slots (7 usable beside the null slot 0), rank 16
LORA_SERVING = dict(BREADTH_SERVING, adapter_slots=8, lora_rank=16)
N_ADAPTERS = 12
# f32 engines of (b): llama-7b width, 2 layers, 4 slots, 3 adapters
LORA_F32_SERVING = dict(max_seqs=4, block_size=64, max_model_len=1024,
                        decode_quantum=8)
LORA_F32 = dict(adapter_slots=4, lora_rank=16)
HANDOFF_ROWS = 1000


def _lora_step_times(srv):
    """CUDA-event ms and host issue ms of one decode step of every slot at
    1000 rows with the adapter delta, the slots' adapter indices cycling
    over the slot pool (slot 0, the null adapter, included)."""
    from deepspeed_tpu_torch.models import transformer as tf
    S, tab, lens = _step_scratch(srv)
    toks = torch.zeros((S,), dtype=torch.long, device="cuda")
    aidx = torch.arange(S, device="cuda") % srv.adapter_slots.num_slots
    lora = (srv.adapter_pool, aidx)

    def step():
        return tf.decode_step_paged(srv.engine.params, toks,
                                    srv.model.config, srv.pools, tab, lens,
                                    lora=lora)
    return {"ms": cuda_ms(step, iters=5), "issue_ms": host_issue_ms(step, 5)}


def _until_first_tokens(srv, rids):
    """Step until every request of ``rids`` runs with its first token (the
    handoff-ready state of a colocated engine)."""
    for _ in range(100):
        live = {r.rid: r for r in srv.scheduler.running}
        if all(r in live and live[r].prefill_done and live[r].generated
               for r in rids):
            return
        srv.step()
    raise RuntimeError("handoff: prefill never completed on the source")


def _to_done(srv, budget=1000):
    """Step to the end; the finished outputs by request id."""
    outs = {}
    for _ in range(budget):
        if srv.scheduler.done:
            return outs
        for req in srv.step():
            outs[req.rid] = req.output
    raise RuntimeError("serving did not converge")


def lora_serving_load(cfg, base, plain_step):
    """(a) 12 random adapters in 7 usable slots, the serving phase's 24
    requests x 32 tokens with adapter ids i % 13 (two base requests), on
    llama-7b bf16 at full depth; the launch counts zeroed just before."""
    from deepspeed_tpu_torch import make_model
    from deepspeed_tpu_torch.inference.engine import init_inference
    from deepspeed_tpu_torch.inference.lora import make_random_adapter
    from deepspeed_tpu_torch.inference.serving import (ServingConfig,
                                                       ServingEngine)
    from deepspeed_tpu_torch.ops import _build
    prompts, base_gens = base
    eng = init_inference(make_model(cfg, "llama-7b"),
                         config={"kv_cache_bits": 0}, dtype=torch.bfloat16,
                         seed=0)
    srv = ServingEngine(eng, ServingConfig(**LORA_SERVING))
    t0 = time.perf_counter()
    for a in range(1, N_ADAPTERS + 1):
        srv.register_adapter(a, make_random_adapter(
            eng.model.config, LORA_SERVING["lora_rank"], seed=a))
    register_s = time.perf_counter() - t0
    srv.run([(prompts[0][:64], 4)])          # warm-up, base adapter
    srv.reset_stats()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = srv.run([(p, 32, i % (N_ADAPTERS + 1))
                    for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    gens = [outs[k][len(p):] for k, p in zip(sorted(outs), prompts)]
    _check_generated("lora", gens, 32)
    st = dict(srv.stats(), wall_s=wall, register_s=register_s)
    if srv.allocator.used_blocks != 0:
        raise RuntimeError(f"lora: {srv.allocator.used_blocks} blocks held")
    st["adapter_pool_bytes"] = sum(t.numel() * t.element_size()
                                   for ab in srv.adapter_pool.values()
                                   for t in ab.values())
    st["decode_step_lora"] = _lora_step_times(srv)
    st["decode_step_plain"] = _decode_step_times(srv)
    st["decode_step_phase4_ms"] = plain_step
    base_ids = [i for i in range(len(prompts)) if i % (N_ADAPTERS + 1) == 0]
    st["base_requests_agreement_with_serving_phase"] = _agreement(
        [gens[i] for i in base_ids], [base_gens[i] for i in base_ids])
    return st, launches


def lora_migration_checks(rng):
    """(b) f32, llama-7b width, 2 layers (TF32 off): a mixed batch {base,
    1, 2, 3} pooled against each tenant alone on merged dense weights; a
    drain after one round resumed on a fresh engine; a KV handoff (export,
    release, accept with kv=) onto another engine; a payload with one
    flipped byte refused, then the re-prefill fallback. Every stream must
    equal the pooled run's, token for token."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch import llama_config, make_model
    from deepspeed_tpu_torch.inference.engine import init_inference
    from deepspeed_tpu_torch.inference.lora import (apply_lora_dense,
                                                    make_random_adapter)
    from deepspeed_tpu_torch.inference.serving import (ResumeIncompatible,
                                                       ServingConfig,
                                                       ServingEngine)
    from deepspeed_tpu_torch.models.transformer import unfuse_layer_stack
    cfg = llama_config("7b", num_layers=2, dtype=torch.float32)
    model = make_model(cfg, "llama-7b-2l")
    eng = init_inference(model, config={"kv_cache_bits": 0},
                         dtype=torch.float32, seed=5)
    adapters = {a: make_random_adapter(eng.model.config, 16, seed=100 + a)
                for a in (1, 2, 3)}
    load = [(rng.integers(0, VOCAB, n).astype(np.int32), 24, a)
            for n, a in ((300, 0), (120, 1), (200, 2), (64, 3))]

    def lora_srv():
        srv = ServingEngine(eng, ServingConfig(**LORA_F32_SERVING,
                                               **LORA_F32))
        for a, tabs in adapters.items():
            srv.register_adapter(a, tabs)
        return srv

    def streams(outs):
        return [outs[k] for k in sorted(outs)]

    def same(outs):
        got = streams(outs)
        return len(got) == len(want) and all(
            np.array_equal(g, w) for g, w in zip(got, want))

    rec = {}
    want = streams(lora_srv().run(list(load)))
    plain = streams(ServingEngine(eng, ServingConfig(**LORA_F32_SERVING))
                    .run([(p, n) for p, n, _ in load]))
    rec["adapters_change_tokens"] = sum(
        not np.array_equal(w, o) for w, o in zip(want[1:], plain[1:]))
    host = {k: ({n: t.cpu().numpy() for n, t in v.items()}
                if k == "layers" else v.cpu().numpy())
            for k, v in unfuse_layer_stack(eng.params, cfg).items()}
    merged = []
    for (p, n, a), w in zip(load, want):
        e = (eng if a == 0 else init_inference(
            model, config={"kv_cache_bits": 0},
            params=apply_lora_dense(host, cfg, adapters[a]),
            dtype=torch.float32))
        solo = ServingEngine(e, ServingConfig(**LORA_F32_SERVING))
        got = list(solo.run([(p, n)]).values())[0]
        merged.append(bool(np.array_equal(got, w)))
        del solo, e
        _free()
    rec["pooled_equal_merged"] = merged
    del host
    tmp = tempfile.mkdtemp(prefix="dstpu_drain_")
    try:
        srv = lora_srv()
        for p, n, a in load:
            srv.add_request(p, n, adapter_id=a)
        srv.step()
        srv.drain(tmp)
        fresh = lora_srv()
        fresh.resume(tmp)
        outs = _to_done(fresh)
        for req in srv._finished:
            outs.setdefault(req.rid, req.output)
        rec["drain_resume_equal"] = same(outs)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    src = lora_srv()
    rids = [src.add_request(p, n, adapter_id=a) for p, n, a in load]
    _until_first_tokens(src, rids)
    payloads = src.export_kv(rids)
    recs = src.release_requests(rids)
    dst = lora_srv()
    dst.accept_migration(recs, kv=payloads)
    rec["handoff_equal"] = same(_to_done(dst))
    rec["handoff_fallbacks"] = dst.stats()["handoff_fallbacks"]
    src = lora_srv()
    rids = [src.add_request(p, n, adapter_id=a) for p, n, a in load]
    _until_first_tokens(src, rids)
    payloads = src.export_kv(rids)
    payloads[rids[0]]["data"]["k"].reshape(-1).view(np.uint8)[0] ^= 1
    recs = src.release_requests(rids)
    dst = lora_srv()
    try:
        dst.accept_migration(recs, kv=payloads)
        rec["torn_refused"] = False
    except ResumeIncompatible:
        rec["torn_refused"] = True
    dst.accept_migration(recs)                     # the re-prefill path
    rec["torn_fallback_equal"] = same(_to_done(dst))
    del src, dst, eng
    _free()
    log("phase 13 (b) f32 checks (llama-7b width, 2 layers) "
        + json.dumps(rec))
    checks = {"pooled == merged dense, every tenant":
                  all(rec["pooled_equal_merged"]),
              "adapters change tokens": rec["adapters_change_tokens"] > 0,
              "drain + resume == uninterrupted": rec["drain_resume_equal"],
              "handoff == colocated": rec["handoff_equal"]
                  and rec["handoff_fallbacks"] == 0,
              "torn payload refused": rec["torn_refused"],
              "fallback == colocated": rec["torn_fallback_equal"]}
    return rec, checks


def handoff_cost(cfg, rng):
    """(c) llama-7b bf16 at full depth, the serving geometry: 4 requests
    of 1000-row prompts, 32 new tokens, colocated against a handoff after
    the source's first round (prefill + one quantum). Times export_kv
    (gather, device-to-host copy, crc), the crc alone, accept_migration
    (its checks and crc) and the scatter at admission; the decode engine's
    launch counts zeroed just before it runs."""
    from deepspeed_tpu_torch import make_model
    from deepspeed_tpu_torch.inference.engine import init_inference
    from deepspeed_tpu_torch.inference.kv_cache import kv_payload_nbytes
    from deepspeed_tpu_torch.inference.serving import (ServingConfig,
                                                       ServingEngine,
                                                       kv_payload_crc)
    from deepspeed_tpu_torch.ops import _build
    eng = init_inference(make_model(cfg, "llama-7b"),
                         config={"kv_cache_bits": 0}, dtype=torch.bfloat16,
                         seed=0)
    prompts = [rng.integers(0, VOCAB, HANDOFF_ROWS).astype(np.int32)
               for _ in range(4)]
    colo = ServingEngine(eng, ServingConfig(**BREADTH_SERVING))
    colo.run([(prompts[0][:64], 4)])          # warm-up
    outs = colo.run([(p, 32) for p in prompts])
    want = [outs[k][len(p):] for k, p in zip(sorted(outs), prompts)]
    del colo
    _free()
    src = ServingEngine(eng, ServingConfig(**BREADTH_SERVING))
    rids = [src.add_request(p, 32) for p in prompts]
    _until_first_tokens(src, rids)
    torch.cuda.synchronize()
    st = {}
    t0 = time.perf_counter()
    payloads = src.export_kv(rids)
    st["export_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for pl in payloads.values():
        kv_payload_crc(pl["data"])
    st["crc_ms"] = (time.perf_counter() - t0) * 1e3
    st["payload_bytes"] = [kv_payload_nbytes(payloads[r]["data"])
                           for r in rids]
    st["payload_rows"] = [payloads[r]["rows"] for r in rids]
    recs = src.release_requests(rids)
    del src
    _free()
    dst = ServingEngine(eng, ServingConfig(**BREADTH_SERVING))
    scatter = []
    inner = dst._dispatch_kv_import

    def timed_import(req):
        torch.cuda.synchronize()
        t = time.perf_counter()
        inner(req)
        torch.cuda.synchronize()
        scatter.append((time.perf_counter() - t) * 1e3)
    dst._dispatch_kv_import = timed_import
    t0 = time.perf_counter()
    dst.accept_migration(recs, kv=payloads)
    st["accept_ms"] = (time.perf_counter() - t0) * 1e3
    del payloads
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = _to_done(dst)
    torch.cuda.synchronize()
    st["decode_wall_s"] = time.perf_counter() - t0
    launches = _build.launch_counts()
    st["scatter_ms"] = scatter
    gens = [outs[r][len(p):] for r, p in zip(rids, prompts)]
    _check_generated("handoff", gens, 32)
    st.update({k: v for k, v in dst.stats().items()
               if k.startswith("handoff") or k in (
                   "prefills", "decode_steps", "prefill_chunks",
                   "p50_itl_ms", "tok_per_sec")})
    st["token_agreement_with_colocated"] = _agreement(gens, want)
    st["first_divergence_from_colocated"] = _first_divergence(gens, want)
    st["launches"] = launches
    del dst, eng
    _free()
    return st, launches


def lora_handoff_phase(smi: str, base, plain_step):
    """Phase 13: (a) multi-LoRA at llama-7b bf16 full depth (B1 = 0: a
    LoRA engine prefills on the span path; B4 = 32 x decode steps), (b)
    the f32 parities of LoRA, drain / resume and the handoff at 2 layers,
    (c) the handoff's cost at full depth bf16 (no fallback; B4 = 32 x the
    decode engine's decode steps). Returns the record, with the summed
    launches of (a) and (c)'s decode engine."""
    from deepspeed_tpu_torch import llama_config
    cfg = llama_config("7b")
    L = cfg.num_layers
    rng = np.random.default_rng(13)
    t_phase = time.perf_counter()
    rec = {"card": smi}
    checks = {}
    st, la = lora_serving_load(cfg, base, plain_step)
    checks["lora: flash_fwd == 0"] = la.get("flash_fwd", 0) == 0
    checks["lora: paged_decode == L x decode_steps"] = \
        la["paged_decode"] == L * st["decode_steps"] > 0
    checks["lora: adapter_page_ins >= 12"] = st["adapter_page_ins"] >= 12
    checks["lora: adapter_evictions >= 1"] = st["adapter_evictions"] >= 1
    rec["lora"] = st
    log("phase 13 (a) multi-LoRA " + json.dumps(st))
    _free()
    rec["f32"], f32_checks = lora_migration_checks(rng)
    checks.update({f"f32: {k}": bool(v) for k, v in f32_checks.items()})
    st, lc = handoff_cost(cfg, rng)
    checks["handoff: handoff_fallbacks == 0"] = st["handoff_fallbacks"] == 0
    checks["handoff: handoffs == 4"] = st["handoffs"] == 4
    checks["handoff: paged_decode == L x decode_steps"] = \
        lc["paged_decode"] == L * st["decode_steps"] > 0
    checks["handoff: flash_fwd == 0 (tail spans only)"] = \
        lc.get("flash_fwd", 0) == 0
    rec["handoff"] = st
    log("phase 13 (c) handoff " + json.dumps(st))
    rec["launches"] = {k: la.get(k, 0) + lc.get(k, 0)
                       for k in ("flash_fwd", "paged_decode")}
    rec["phase_s"] = time.perf_counter() - t_phase
    failed = [k for k, v in checks.items() if not v]
    log(f"phase 13: {rec['phase_s']:.1f}s, launches "
        f"{json.dumps(rec['launches'])}, checks {json.dumps(checks)}")
    if failed:
        raise RuntimeError(f"phase 13: failed {failed}")
    return rec


# --------------------------------------------------------------------------
# sharded serving (phase 14)
# --------------------------------------------------------------------------

# Mixtral 8x7b at full width, cut to 8 of its 32 layers (23.2 GB of bf16
# layers + 0.52 GB of embeddings: the whole model is ~93 GB)
MOE_LAYERS = 8
SHARED_CARD = ("two processes sharing one card over gloo (collectives "
               "staged through the host): not a tensor-parallel speed")


def _mixtral(layers, dtype):
    from deepspeed_tpu_torch.models import make_model
    from deepspeed_tpu_torch.models.transformer import mixtral_config
    return make_model(mixtral_config("8x7b", num_layers=layers, dtype=dtype),
                      f"mixtral-8x7b-{layers}L")


def moe_single_card(served, plain_step):
    """Phase 14 (a): Mixtral at full width, 8 layers, bf16, float pool, on
    the serving geometry: the serving phase's load with the launch counts
    zeroed just before (B1 = 8 x prefills, B4 = 8 x decode steps), then
    one decode step's CUDA-event and host issue ms beside phase 4's
    llama-7b step. Returns (record, generated streams, launches)."""
    from deepspeed_tpu_torch import init_serving
    from deepspeed_tpu_torch.parallel import sharded_bytes
    t0 = time.perf_counter()
    srv = init_serving(_mixtral(MOE_LAYERS, torch.bfloat16),
                       config={"kv_cache_bits": 0}, serving=BREADTH_SERVING,
                       dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gens, st, la = _serve_counted(srv, served[0], 32, "phase 14 (a)")
    step = _decode_step_times(srv)
    rec = {"model": "mixtral-8x7b, 8 of 32 layers, bf16",
           "param_bytes": sharded_bytes(srv.engine.params),
           "pool_bytes": st["pool_bytes"], "init_s": init_s,
           "decode_step_16x1000_ms": step["ms"],
           "decode_step_host_issue_ms": step["issue_ms"],
           "llama7b_decode_step_16x1000_ms": plain_step,
           "launches": la,
           **{k: st.get(k) for k in ("p50_ttft_ms", "p99_ttft_ms",
                                     "p50_itl_ms", "p99_itl_ms",
                                     "tok_per_sec", "prefills",
                                     "decode_steps", "wall_s")}}
    del srv
    _free()
    return rec, gens, la


def moe_f32_check():
    """Phase 14 (a), f32 at Mixtral width, 2 layers: one 1000-token
    prefill and 4 teacher-forced decode steps through the kernels against
    the plain versions (relative L2 of the logits)."""
    from deepspeed_tpu_torch.models import transformer as tf
    cfg = _mixtral(2, torch.float32).config
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(5),
                            "cuda", dtype=torch.float32)
    rng = np.random.default_rng(21)
    n, P = 1000, 1024
    ids = torch.zeros((1, P), dtype=torch.long, device="cuda")
    ids[0, :n] = torch.from_numpy(rng.integers(0, VOCAB, size=n)).cuda()
    tokens = [torch.from_numpy(rng.integers(0, VOCAB, size=1)).cuda()
              for _ in range(4)]
    kern = _prefill_and_decode(params, cfg, ids, n, tokens, False)
    plain = _prefill_and_decode(params, cfg, ids, n, tokens, True)
    names = ["prefill"] + [f"decode{i}" for i in range(4)]
    del params
    _free()
    return {k: rel_l2(a, b) for k, a, b in zip(names, kern, plain)}


def _gather_rows(values):
    """Each rank's row of numbers, summed into place on every rank (an
    all_reduce of a zero-filled [world, n] f64 table: byte counts and
    launch counts stay exact): rank 0 reads all."""
    import torch.distributed as dist
    t = torch.zeros((dist.get_world_size(), len(values)), dtype=torch.float64)
    t[dist.get_rank()] = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t)
    return t.tolist()


def _shard_kernels_vs_plain(srv):
    """This rank's teacher-forced logits (one 1000-token prefill, 4 decode
    steps) through the kernels at its shard's head counts, against the
    plain versions on the same shard: relative L2 of each. Collective:
    every rank of the mesh calls it."""
    from deepspeed_tpu_torch.parallel import parallel_context
    rng = np.random.default_rng(23)
    n, P = 1000, 1024
    ids = torch.zeros((1, P), dtype=torch.long, device="cuda")
    ids[0, :n] = torch.from_numpy(rng.integers(0, VOCAB, size=n)).cuda()
    tokens = [torch.from_numpy(rng.integers(0, VOCAB, size=1)).cuda()
              for _ in range(4)]
    params, cfg = srv.engine.params, srv.model.config
    with torch.no_grad(), parallel_context(srv.mesh):
        kern = _prefill_and_decode(params, cfg, ids, n, tokens, False)
        plain = _prefill_and_decode(params, cfg, ids, n, tokens, True)
    return [rel_l2(a, b) for a, b in zip(kern, plain)]


def _sharded_rank(rank, world, kind, layers, prompts, f32_prompts):
    """One rank of phase 14 (b) (kind "tp": llama-7b at tensor=2) or (c)
    ("ep": Mixtral at expert=2), ``layers`` deep, both ranks on cuda:0
    over gloo.
    bf16 at the serving geometry: a warm-up request on a first serving
    engine, then the load on a fresh one over the same weights, each
    rank's launch counts zeroed just before it (rank 0 drives the load,
    the other rank serves its device calls); each rank's counts and
    resident bytes go to rank 0. Then f32 at the same width, 2 layers:
    each rank's kernels against the plain versions at its shard shapes,
    the sharded greedy streams and rank 0's unsharded ones."""
    from deepspeed_tpu_torch import init_serving, llama_config, make_model
    from deepspeed_tpu_torch.inference.serving import ServingEngine
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.parallel import MeshPlan, sharded_bytes
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = MeshPlan(tensor=2) if kind == "tp" else MeshPlan(expert=2)

    def model(layers, dtype):
        if kind == "tp":
            return make_model(llama_config("7b", num_layers=layers,
                                           dtype=dtype), "llama-7b")
        return _mixtral(layers, dtype)

    def engine(layers, dtype, mesh):
        return init_serving(model(layers, dtype),
                            config={"kv_cache_bits": 0},
                            serving=BREADTH_SERVING, dtype=dtype, seed=0,
                            mesh=mesh)

    t0 = time.perf_counter()
    warm = engine(layers, torch.bfloat16, plan)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if rank == 0:
        warm.run([(prompts[0][:64], 4)])
        warm.close()
    else:
        warm.run_worker()
    eng, sc = warm.engine, warm.config
    del warm
    _free()
    srv = ServingEngine(eng, sc, seed=0)
    lay = eng.params["layers"]
    mine = [sharded_bytes(lay)] + [
        sharded_bytes({k: v for k, v in lay.items() if k.startswith(p)})
        for p in ("ln", "moe_")] + [srv.pool_bytes, srv.pool_bytes_logical]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    rec = None
    if rank == 0:
        t0 = time.perf_counter()
        outs = srv.run([(p, 32) for p in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.stats()
        gens = [outs[k][len(p):] for k, p in zip(sorted(outs), prompts)]
        _check_generated(f"phase 14 ({kind})", gens, 32)
        rec = {"gens": gens, "init_s": init_s, "wall_s": wall,
               "mesh_desc": srv.mesh_desc,
               "held_blocks_after": srv.allocator.used_blocks,
               **{k: st.get(k) for k in (
                   "p50_ttft_ms", "p99_ttft_ms", "p50_itl_ms", "p99_itl_ms",
                   "tok_per_sec", "prefills", "decode_steps", "tp", "ep",
                   "recoveries")}}
        srv.close()
    else:
        srv.run_worker()
    counts = _build.launch_counts()
    rows = _gather_rows([counts["flash_fwd"], counts["paged_decode"]] + mine
                        + [torch.cuda.max_memory_allocated()])
    del srv, eng, lay
    _free()
    srv = engine(2, torch.float32, plan)
    errs = _gather_rows(_shard_kernels_vs_plain(srv))
    if rank:
        srv.run_worker()
        return None
    outs = srv.run([(p, 16) for p in f32_prompts])
    srv.close()
    del srv
    _free()
    sharded = [outs[k] for k in sorted(outs)]
    one = engine(2, torch.float32, None)
    outs = one.run([(p, 16) for p in f32_prompts])
    rec["f32_identical"] = all(
        np.array_equal(a, b) for a, b in zip(sharded,
                                             [outs[k] for k in sorted(outs)]))
    names = ("flash_fwd", "paged_decode", "layer_bytes", "norm_bytes",
             "expert_bytes", "pool_bytes", "pool_bytes_logical",
             "peak_bytes")
    rec["ranks"] = [
        dict({k: int(v) for k, v in zip(names, r)},
             f32_kernels_vs_plain_rel_l2=dict(zip(
                 ["prefill"] + [f"decode{i}" for i in range(4)], e)))
        for r, e in zip(rows, errs)]
    return rec


def _layer_bytes_unsharded(cfg, itemsize=2):
    """An unsharded engine's resident bytes of ``cfg``'s layer stack
    (unfused), and of its expert stacks alone."""
    from deepspeed_tpu_torch.models.transformer import logical_axes
    H, L, F, E = cfg.hidden_size, cfg.num_layers, cfg.ffn_dim, \
        cfg.num_experts
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head
    per = {"ln1_scale": H, "ln2_scale": H, "wq": H * nh * hd,
           "wk": H * nkv * hd, "wv": H * nkv * hd, "wo": nh * hd * H,
           "w_in": H * F, "w_out": F * H, "w_gate": H * F, "wg": H * E,
           "moe_w_in": E * H * F, "moe_w_out": E * F * H,
           "moe_w_gate": E * H * F}
    names = list(logical_axes(cfg)["layers"])
    total = sum(per[n] for n in names) * L * itemsize
    experts = sum(per[n] for n in names if n.startswith("moe_")) * L
    return total, experts * itemsize


# the two-rank serving loads' depth (the run's time limit cuts depth,
# never width): llama-7b 8 of its 32 layers, Mixtral 2 of its 32
TP_SERVE_LAYERS = 8
EP_SERVE_LAYERS = 2


def sharded_serving_phase(smi: str, served, plain_step):
    """Phase 14: (a) MoE on one card (Mixtral 8 layers bf16, the serving
    load, B1 / B4 counts, the decode step beside phase 4's, and the f32
    kernels-vs-plain logits at 2 layers); (b) llama-7b at tp=2 and (c)
    Mixtral at ep=2, each two processes sharing the card over gloo: every
    rank's B1 = L x prefills and B4 = L x decode steps of the load, the
    memory laws, the bf16 agreement with the one-card streams (reported),
    and f32 at 2 layers: each rank's kernels within 2e-2 of the plain
    versions at its shard shapes, and the streams token-identical to the
    unsharded engine. Times of (b) and (c)
    are of two processes sharing one card. Returns the record with the
    launches summed over every rank."""
    from deepspeed_tpu_torch import llama_config
    from deepspeed_tpu_torch.parallel.launch import run_group
    t_phase = time.perf_counter()
    checks = {}
    rec = {"card": smi}
    prompts, base_gens = served
    a, moe_gens, la = moe_single_card(served, plain_step)
    L = MOE_LAYERS
    checks["(a) flash_fwd == 8 x prefills"] = \
        la["flash_fwd"] == L * a["prefills"] > 0
    checks["(a) paged_decode == 8 x decode_steps"] = \
        la["paged_decode"] == L * a["decode_steps"] > 0
    log(f"phase 14 (a) MoE one card [{smi}] " + json.dumps(a))
    a["f32_kernels_vs_plain_rel_l2"] = errs = moe_f32_check()
    checks["(a) f32 kernels vs plain < 2e-2"] = max(errs.values()) < 2e-2
    log(f"phase 14 (a) f32 Mixtral width, 2 layers [{smi}] "
        + json.dumps(errs))
    rec["moe"] = a
    launches = {"flash_fwd": la["flash_fwd"],
                "paged_decode": la["paged_decode"]}
    rec["launches_by_part"] = {"moe_one_card": dict(launches)}
    f32_prompts = prompts[:4]
    for kind, what, ref, cfg in (
            ("tp", f"(b) llama-7b {TP_SERVE_LAYERS} layers tensor=2",
             base_gens, llama_config("7b", num_layers=TP_SERVE_LAYERS)),
            ("ep", f"(c) Mixtral {EP_SERVE_LAYERS} layers expert=2",
             moe_gens, _mixtral(EP_SERVE_LAYERS, torch.bfloat16).config)):
        _free()
        t0 = time.perf_counter()
        r = run_group(_sharded_rank, 2, kind, cfg.num_layers, prompts,
                      f32_prompts, timeout_s=900)
        r["group_s"] = time.perf_counter() - t0
        Lk = cfg.num_layers
        for i, rank in enumerate(r["ranks"]):
            checks[f"{what}: rank {i} flash_fwd == L x prefills"] = \
                rank["flash_fwd"] == Lk * r["prefills"] > 0
            checks[f"{what}: rank {i} paged_decode == L x decode_steps"] = \
                rank["paged_decode"] == Lk * r["decode_steps"] > 0
            checks[f"{what}: rank {i} f32 shard kernels vs plain < 2e-2"] = \
                max(rank["f32_kernels_vs_plain_rel_l2"].values()) < 2e-2
            # the pools shard over tensor only
            n = 2 if kind == "tp" else 1
            checks[f"{what}: rank {i} pool_bytes x {n} == logical"] = \
                rank["pool_bytes"] * n == rank["pool_bytes_logical"]
            launches["flash_fwd"] += rank["flash_fwd"]
            launches["paged_decode"] += rank["paged_decode"]
        rec["launches_by_part"][kind] = [
            {k: x[k] for k in ("flash_fwd", "paged_decode")}
            for x in r["ranks"]]
        full, experts = _layer_bytes_unsharded(cfg)
        same = all(x["layer_bytes"] == r["ranks"][0]["layer_bytes"]
                   for x in r["ranks"])
        if kind == "tp":
            norms = r["ranks"][0]["norm_bytes"]
            sharded = sum(x["layer_bytes"] - norms for x in r["ranks"])
            checks[f"{what}: layer bytes halved (norms replicated)"] = \
                same and sharded + norms == full
        else:
            checks[f"{what}: expert stacks halved"] = same and sum(
                x["expert_bytes"] for x in r["ranks"]) == experts
        r["layer_bytes_unsharded"] = full
        checks[f"{what}: f32 2 layers token-identical to unsharded"] = \
            r["f32_identical"]
        checks[f"{what}: pool empty after run"] = r["held_blocks_after"] == 0
        # rank 0 drives the engine: a recovered round would be its
        checks[f"{what}: no recovery"] = r["recoveries"] == 0
        r["agreement_with_one_card"] = _agreement(r.pop("gens"), ref)
        r["timing"] = SHARED_CARD
        rec[kind] = r
        log(f"phase 14 {what} [{smi}; {SHARED_CARD}] " + json.dumps(r))
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    failed = [k for k, v in checks.items() if not v]
    log(f"phase 14: {rec['phase_s']:.1f}s, launches {json.dumps(launches)}, "
        f"checks {json.dumps(checks)}")
    if failed:
        raise RuntimeError(f"phase 14: failed {failed}")
    return rec


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


def _train(cfg, name, config, steps, after_step=None, params=None,
           extra=None):
    """``initialize`` -> ``train_batch`` on one fixed batch: 1 warm-up
    step, then ``steps`` timed steps with the launch counts zeroed just
    before them; ``after_step(engine)`` runs after each step (inside the
    timed loop: it must not wait on the card). ``params``: a tree to
    start from instead of the seeded init; ``extra``: more batch entries
    (an ``attention_mask``). Returns (engine, batch, record)."""
    from deepspeed_tpu_torch import initialize, make_model
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    B, S = config["train_batch_size"], cfg.max_seq_len
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = initialize(model=make_model(cfg, name), config=dict(config),
                            params=params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(engine.params))
    log(f"training: {name} {n_params / 1e9:.4f}B params, B={B} S={S}, "
        f"{str(engine.compute_dtype).split('.')[-1]} + f32 masters, init "
        f"{time.perf_counter() - t0:.1f}s")
    ids = np.random.default_rng(0).integers(
        0, min(VOCAB, cfg.vocab_size), (B, S), dtype=np.int32)
    batch = {"input_ids": torch.from_numpy(ids).cuda(), **(extra or {})}
    t0 = time.perf_counter()
    losses = [engine.train_batch(batch)["loss"]]          # warm-up
    if after_step is not None:
        after_step(engine)
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
        if after_step is not None:
            after_step(engine)
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

    peaks = {}

    def value_and_grad(params, c, reference):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        loss = tf.lm_loss(params, batch, c, reference=reference)
        torch.cuda.synchronize()
        # what the forward left on the card for the backward
        kept = torch.cuda.memory_allocated() - base
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        peaks[c.remat_policy] = {
            "saved_by_forward_mib": kept / 2**20,
            "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20}
        return float(loss.detach()), grads, _build.launch_counts()

    recs = {}
    kern = "sparse" if sparse else "flash"
    cases = (("f32", "dots_saveable", 2 * L, 1e-5, 1e-4),
             ("f32", "dots_and_attn", 2 * L if sparse else L, 1e-5, 1e-4),
             ("bf16", "dots_saveable", 2 * L, 2e-2, 2e-2))
    if not sparse:
        # both replay B1 (its outputs are not dots); offload_dots keeps the
        # matmul outputs in pinned host memory between forward and backward
        cases += (("f32", "dots_with_no_batch_dims", 2 * L, 1e-5, 1e-4),
                  ("f32", "offload_dots", 2 * L, 1e-5, 1e-4))
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
                grad_rel_l2_max=err, launches=nk,
                device_mem_above_params=peaks[policy])
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
    if not sparse:
        # the peak comes at the end of the backward, where the grads of
        # every leaf exist: what a policy saves shows after the forward
        log("remat device memory, f32, MiB above the params "
            + json.dumps({p: recs[f"f32 {p}"]["device_mem_above_params"]
                          for p in ("dots_saveable", "dots_with_no_batch_dims",
                                    "offload_dots")}))
    del params32
    torch.cuda.empty_cache()
    return recs


# --------------------------------------------------------------------------
# resumable training
# --------------------------------------------------------------------------

RESUME_LAYERS = 2


def _tree_bytes(engine) -> int:
    from deepspeed_tpu_torch.runtime.checkpointing import flatten
    return sum(t.numel() * t.element_size()
               for t in flatten(engine.state).values()
               if isinstance(t, torch.Tensor))


def _dir_bytes(path) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _state_copy(engine):
    from deepspeed_tpu_torch.runtime.checkpointing import flatten
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten(engine.state).items()}


def _bit_diff(a, b):
    """Names of the leaves of two state copies that differ in any bit."""
    out = []
    for k, v in a.items():
        w = b[k]
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16:
                v, w = v.view(torch.int16), w.view(torch.int16)
            if not torch.equal(v, w):
                out.append(k)
        elif v != w:
            out.append(k)
    return out


def resume_phase(smi: str, S: int = 2048, B: int = 8):
    """llama-1b at full width, 2 layers, B=8 S=2048 (bf16, f32 masters,
    AdamW, dots_with_no_batch_dims, chunked loss, fused backward), data
    from random_token_batches through an attached DataLoader. Leg 1:
    train_batches for 3 steps (in_flight 2, prefetch), an async
    save_checkpoint, one step while the write is in flight,
    wait_checkpoint, 2 more steps (the uninterrupted record). Leg 2: a
    fresh engine, load_checkpoint(tag=None) (latest, deep validation), the
    same 3 steps from the restored loader position. The resumed losses and
    the whole final state must equal leg 1's bit for bit; the counters, lr
    and loader position too; zero_to_fp32 of the tag must equal the
    masters at save time and save_16bit_model -> load_16bit_model must
    round-trip, both bit for bit; launch counts, zeroed before each leg,
    B1 twice per layer per step (the policy replays it) and B2, B3 once.
    Space: a temporary directory on local disk, removed afterwards; too
    little free space fails the run."""
    import shutil
    import tempfile
    from deepspeed_tpu_torch import initialize, llama_config, make_model
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.runtime.checkpointing import flatten
    from deepspeed_tpu_torch.runtime.dataloader import (DataLoader,
                                                        RepeatingLoader,
                                                        random_token_batches)
    from deepspeed_tpu_torch.runtime.engine import load_16bit_model
    from deepspeed_tpu_torch.utils.zero_to_fp32 import \
        get_fp32_state_dict_from_zero_checkpoint
    L = RESUME_LAYERS
    cfg = llama_config("1b", num_layers=L, max_seq_len=S, remat=True,
                       remat_policy="dots_with_no_batch_dims", loss_chunk=S)
    config = dict(TRAIN_CONFIG, pipeline={"in_flight": 2, "prefetch": True},
                  checkpoint={"async_save": True})
    ids = next(random_token_batches(64, S, VOCAB, 1, seed=0))["input_ids"]
    rows = [{"input_ids": r} for r in ids]

    def engine_and_loader():
        engine, *_ = initialize(model=make_model(cfg, f"llama-1b x{L}"),
                                config=dict(config))
        loader = RepeatingLoader(DataLoader(rows, batch_size=B, shuffle=True,
                                            seed=0))
        engine.attach_dataloader(loader)
        return engine, loader

    def step(engine, loader):
        return engine.train_batches(loader, 1)["loss"]

    def counts(launches, steps):
        want = {"flash_fwd": 2 * steps * L, "flash_bwd_dq": steps * L,
                "flash_bwd_dkv": steps * L}
        got = {k: n for k, n in launches.items() if n}
        if got != want:
            raise RuntimeError(f"resume: launches {launches}, want {want}")
        return got

    tmp = tempfile.mkdtemp(prefix="dstpu_resume_")
    ckdir, syncdir = os.path.join(tmp, "ckpt"), os.path.join(tmp, "sync")
    rec = {"card": smi, "layers": L, "B": B, "S": S}
    try:
        e1, ld1 = engine_and_loader()
        state_bytes = _tree_bytes(e1)
        free = shutil.disk_usage(tmp).free
        need = 2 * state_bytes + (1 << 30)
        rec.update(state_bytes=state_bytes, disk_free_bytes=free)
        if free < need:
            raise RuntimeError(f"resume: {free} bytes free under {tmp}, the "
                               f"phase needs {need} (two saves)")
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        first = e1.train_batches(ld1, 3)["loss"]
        masters = {k: v.detach().clone() for k, v in
                   flatten(e1.state["opt"]["master"]).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = e1.save_checkpoint(ckdir)
        rec["save_async_return_s"] = time.perf_counter() - t0
        losses = [step(e1, ld1)]                  # the write is in flight
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e1.wait_checkpoint()
        rec["wait_checkpoint_s"] = time.perf_counter() - t0
        losses += [step(e1, ld1) for _ in range(2)]
        torch.cuda.synchronize()
        rec["launches_uninterrupted"] = counts(_build.launch_counts(), 6)
        want = _state_copy(e1)
        want_lr, want_pos = e1.get_lr(), ld1.state_dict()
        rec["checkpoint_bytes"] = _dir_bytes(path)
        # a synchronous save of the same engine, timed, then removed
        e1.config.checkpoint.async_save = False
        t0 = time.perf_counter()
        e1.save_checkpoint(syncdir)
        rec["save_sync_s"] = time.perf_counter() - t0
        shutil.rmtree(syncdir)
        t0 = time.perf_counter()
        f16 = e1.save_16bit_model(tmp)
        rec["save_16bit_s"] = time.perf_counter() - t0
        back = load_16bit_model(f16)
        diff = _bit_diff({k: v.cpu() for k, v in want.items()
                          if k.startswith("params/")},
                         {f"params/{k}": v for k, v in back.items()})
        if diff or len(back) != sum(k.startswith("params/") for k in want):
            raise RuntimeError(f"resume: 16-bit export round trip differs "
                               f"in {diff}")
        del e1
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        fp32 = get_fp32_state_dict_from_zero_checkpoint(ckdir)
        rec["zero_to_fp32_s"] = time.perf_counter() - t0
        diff = [k for k, v in masters.items()
                if not torch.equal(torch.from_numpy(fp32[k]), v.cpu())]
        if diff or len(fp32) != len(masters):
            raise RuntimeError(f"resume: zero_to_fp32 differs from the "
                               f"masters at save time in {diff}")
        del fp32, masters

        e2, ld2 = engine_and_loader()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, client = e2.load_checkpoint(ckdir)
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t0
        rec["restored"] = {k: client[k] for k in ("global_steps",
                                                  "micro_steps",
                                                  "data_position")}
        _build.reset_launch_counts()
        resumed = [step(e2, ld2) for _ in range(3)]
        torch.cuda.synchronize()
        rec["launches_resumed"] = counts(_build.launch_counts(), 3)
        rec["losses_uninterrupted"] = [float(first)] + [float(x)
                                                        for x in losses]
        rec["losses_resumed"] = [float(x) for x in resumed]
        diff = _bit_diff(want, _state_copy(e2))
        rec["state_leaves_differing"] = diff
        log("resume " + json.dumps(rec))
        if [float(x) for x in resumed] != [float(x) for x in losses]:
            raise RuntimeError("resume: losses after the resume differ from "
                               f"the uninterrupted run's: {resumed} vs "
                               f"{losses}")
        if diff:
            raise RuntimeError(f"resume: final state differs in {diff}")
        if (e2.global_steps, e2.get_lr(), ld2.state_dict()) != \
                (6, want_lr, want_pos):
            raise RuntimeError(
                f"resume: counters {e2.global_steps} lr {e2.get_lr()} "
                f"position {ld2.state_dict()}, want 6 {want_lr} {want_pos}")
        if not all(np.isfinite(rec["losses_uninterrupted"])):
            raise RuntimeError(f"resume: non-finite loss {rec}")
        del e2, want
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------------------
# phase 15: a block-sparse model served, fp16 training, f16 serving, the
# single-rank optimizers and dropout
# --------------------------------------------------------------------------

F16 = torch.float16
SPARSE_SERVING = dict(max_seqs=16, block_size=64, max_model_len=8192,
                      decode_quantum=8, prompt_bucket=128)
FP16_TRAIN_CONFIG = dict(TRAIN_CONFIG, bf16={"enabled": False},
                         fp16={"enabled": True, "initial_scale_power": 16,
                               "loss_scale_window": 1000, "hysteresis": 2})


def kernel_phase_f16():
    """B1-B4's f16 instantiations at the f16 serving and training paths'
    shapes, held against their plain versions as the bf16 cases are
    (within 2e-2, a second launch bit for bit), timed beside the plain
    version, SDPA in f16 and the bound."""
    flash = [flash_case("llama-7b f16 S=1024 (serving prefill bucket)",
                        1, 1024, 32, 32, 128, F16),
             flash_case("llama-1b f16 training B=8 S=2048", 8, 2048, 32, 8,
                        64, F16)]
    lens = [0, 1, 63, 64, 65, 100, 333, 500, 777, 1000, 1024, 1234, 1500,
            2000, 2047, 2048]
    decode = [decode_case("llama-7b f16 16 slots", 16, 32, 32, 128, 64, 32,
                          lens, F16)]
    bwd = [bwd_case("llama-1b f16 training B=8 S=2048", 8, 2048, 32, 8, 64,
                    F16)]
    torch.cuda.empty_cache()
    return flash, decode, bwd


def _clear_sparse_tables():
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    for cache in (sa._cached_adjacency, sa._cached_work,
                  sa.adjacency_tables, sa.work_tables):
        cache.cache_clear()


def _sparse_table_builds():
    """How often each cache of the layout's tables was filled since the
    last clear: the host tables, their device copies, the work lists."""
    from deepspeed_tpu_torch.ops import sparse_attention as sa
    return {"host": sa._cached_adjacency.cache_info().misses,
            "device": sa.adjacency_tables.cache_info().misses,
            "work": sa.work_tables.cache_info().misses}


def _exact_launches(what, got, want):
    """Exactly ``want`` launches of the kernels it names, none of any
    other."""
    have = {k: n for k, n in got.items() if n}
    need = {k: n for k, n in want.items() if n}
    if have != need:
        raise RuntimeError(f"{what}: launches {got}, want exactly {want}")


def _latency(st):
    return {k: st[k] for k in ("p50_ttft_ms", "p99_ttft_ms", "p50_itl_ms",
                               "p99_itl_ms", "tok_per_sec", "prefills",
                               "decode_steps", "preemptions", "wall_s")
            if k in st}


def sparse_serving(smi: str):
    """(a) llama-1b (16 layers) under the BigBird layout, bf16, float pool,
    prompt bucket = the layout's block: 16 requests of 2048-8064 tokens,
    32 new tokens each. Every prefill runs B5 (16 layers each), no B1, the
    decode B4; each bucket's tables are built once. The same load on the
    same weights without the layout (dense: B1). Then f32 at 2 layers:
    a prefill and 4 decode steps through the kernels against the plain
    versions."""
    from deepspeed_tpu_torch import init_serving, llama_config, make_model
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import _build
    rng = np.random.default_rng(SPARSE_PROMPT_SEED)
    prompts = [rng.integers(0, VOCAB, size=int(n)).astype(np.int32)
               for n in sparse_prompt_lengths(rng)]
    buckets = {-(-len(p) // 128) * 128 for p in prompts}
    cfg = llama_config("1b", max_seq_len=8192, sparse_attention=SPARSE_MODEL)
    L = cfg.num_layers
    rec = {}
    for kind, c in (("sparse", cfg),
                    ("dense", dataclasses.replace(cfg,
                                                  sparse_attention=None))):
        srv = init_serving(make_model(c, f"llama-1b {kind}"),
                           config={"kv_cache_bits": 0},
                           serving=SPARSE_SERVING, dtype=torch.bfloat16,
                           seed=0)
        gens, st, launches = _serve_counted(
            srv, prompts, 32, f"phase 15 (a) {kind}",
            before=_clear_sparse_tables)
        attn = "sparse_fwd" if kind == "sparse" else "flash_fwd"
        _exact_launches(f"phase 15 (a) {kind}", launches,
                        {attn: L * st["prefills"],
                         "paged_decode": L * st["decode_steps"]})
        rec[kind] = dict(_latency(st), launches=launches, gens=gens)
        if kind == "sparse":
            builds = _sparse_table_builds()
            rec[kind]["table_builds"] = builds
            rec[kind]["buckets"] = len(buckets)
            if st["preemptions"] or st["prefills"] != len(prompts) or \
                    builds != {"host": len(buckets), "device": len(buckets),
                               "work": len(buckets)}:
                raise RuntimeError(f"phase 15 (a): {len(buckets)} buckets "
                                   f"but table builds {builds} "
                                   f"({st['prefills']} prefills, "
                                   f"{st['preemptions']} preemptions)")
        del srv
        _free()
    rec["agreement_sparse_vs_dense"] = _agreement(rec["sparse"].pop("gens"),
                                                  rec["dense"].pop("gens"))
    # f32 at 2 layers: the kernels (B5 in the prefill, B4 in the decode)
    # against the plain versions on the same weights
    c32 = dataclasses.replace(cfg, num_layers=2, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(c32, gen, "cuda", dtype=torch.float32)
    n, P = 1000, 1024
    ids = torch.zeros((1, P), dtype=torch.long, device="cuda")
    ids[0, :n] = torch.from_numpy(rng.integers(0, VOCAB, size=n)).cuda()
    tokens = [torch.from_numpy(rng.integers(0, VOCAB, size=1)).cuda()
              for _ in range(4)]
    _build.reset_launch_counts()
    kern = _prefill_and_decode(params, c32, ids, n, tokens, False)
    kl = _build.launch_counts()
    plain = _prefill_and_decode(params, c32, ids, n, tokens, True)
    names = ["prefill"] + [f"decode{i}" for i in range(4)]
    errs = {k: rel_l2(a, b) for k, a, b in zip(names, kern, plain)}
    rec["f32_2_layers"] = {"rel_l2": errs, "launches": kl}
    _exact_launches("phase 15 (a) f32", kl, {"sparse_fwd": 2,
                                             "paged_decode": 2 * 4})
    if not max(errs.values()) < SERVING_F32_TOL:
        raise RuntimeError(f"phase 15 (a) f32: kernels vs plain {errs}")
    del params, kern, plain
    _free()
    log(f"phase 15 (a) sparse serving [{smi}] " + json.dumps(rec))
    return rec


def _scaler_snapshot(engine):
    return {"scale": engine.state["loss_scale"]["scale"].clone(),
            "good_steps": engine.state["loss_scale"]["good_steps"].clone(),
            "hysteresis": engine.state["loss_scale"]["hysteresis"].clone(),
            "skipped": engine.state["skipped"].clone()}


def fp16_cross_check(S=512, scale=2.0 ** 16):
    """lm_loss and the grad of every leaf at f16 (llama-1b width, 2
    layers, B=2, dots_saveable, fused backward) through B1-B3 in f16
    against their plain versions on the same weights, within 2e-2. The
    backward runs on the loss times the fp16 engine's initial scale, as
    fp16 training does: unscaled, the grads of a random model sit in
    f16's subnormal range, where both paths round to a few bits."""
    from deepspeed_tpu_torch import llama_config
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.optimizers import cast_tree, tree_leaves
    L = 2
    cfg = llama_config("1b", num_layers=L, max_seq_len=S, dtype=F16,
                       remat=True, remat_policy="dots_saveable",
                       loss_chunk=S, fused_backward=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = cast_tree(tf.init_params(cfg, gen, "cuda",
                                          dtype=torch.float32), F16)
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, S))
    batch = {"input_ids": torch.from_numpy(ids).cuda()}
    out = {}
    for reference in (False, True):
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        _build.reset_launch_counts()
        loss = tf.lm_loss(params, batch, cfg, reference=reference)
        grads = torch.autograd.grad(loss * scale, leaves)
        torch.cuda.synchronize()
        out[reference] = (float(loss.detach()),
                          [g.float() / scale for g in grads],
                          _build.launch_counts())
    (lk, gk, nk), (lp, gp, npl) = out[False], out[True]
    _exact_launches("phase 15 (b) f16 cross-check", nk,
                    {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                     "flash_bwd_dkv": L})
    _exact_launches("phase 15 (b) f16 cross-check plain", npl, {})
    rec = dict(loss_scale=scale, loss_kernels=lk, loss_plain=lp,
               loss_rel_err=abs(lk - lp) / abs(lp),
               grad_rel_l2_max=max(rel_l2(a, b) for a, b in zip(gk, gp)),
               grads_finite=all(bool(torch.isfinite(g).all()) for g in gk),
               launches=nk)
    if not (rec["loss_rel_err"] <= 2e-2 and rec["grad_rel_l2_max"] <= 2e-2
            and rec["grads_finite"]):
        raise RuntimeError(f"phase 15 (b) f16 cross-check: {rec}")
    del params, out, gk, gp
    _free()
    return rec


def forced_overflow():
    """An fp16 engine (llama-1b width, 2 layers, hysteresis 1): a good
    step, then the scale set to 2^40, so the next step's grads overflow
    f16: params, f32 masters and optimizer state bit for bit unchanged,
    the scale halved, the skip counted, the update count held."""
    from deepspeed_tpu_torch import initialize, llama_config, make_model
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    cfg = llama_config("1b", num_layers=2, max_seq_len=512, dtype=F16)
    config = dict(FP16_TRAIN_CONFIG, train_batch_size=2,
                  fp16={"enabled": True, "initial_scale_power": 8,
                        "hysteresis": 1})
    engine, *_ = initialize(model=make_model(cfg, "llama-1b 2 layers"),
                            config=config)
    ids = np.random.default_rng(3).integers(0, VOCAB, (2, 512))
    batch = {"input_ids": torch.from_numpy(ids).cuda()}
    first = engine.train_batch(batch)
    if bool(first["overflow"]):
        raise RuntimeError("phase 15 (b) overflow: the first step at 2^8 "
                           "overflowed")
    engine.state["loss_scale"]["scale"].fill_(2.0 ** 40)
    tree = {"params": engine.state["params"], "opt": engine.state["opt"]}
    before = [t.detach().clone() for t in tree_leaves(tree)
              if isinstance(t, torch.Tensor)]
    m = engine.train_batch(batch)
    after = [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]
    unchanged = all(torch.equal(a, b) for a, b in zip(after, before))
    rec = dict(overflow=bool(m["overflow"]), leaves=len(before),
               bitwise_unchanged=unchanged,
               scale_before=float(m["loss_scale"]),
               scale_after=engine.get_loss_scale(),
               skipped_steps=engine.skipped_steps,
               applied_updates=engine.state["step"],
               global_steps=engine.global_steps)
    if not (rec["overflow"] and unchanged and rec["scale_after"] == 2.0 ** 39
            and rec["skipped_steps"] == 1 and rec["applied_updates"] == 1):
        raise RuntimeError(f"phase 15 (b) overflow: {rec}")
    del engine, tree, before, after
    _free()
    return rec


def fp16_training(smi: str, bf16_rec):
    """(b) llama-1b at full width and depth in f16 with the dynamic loss
    scaler (the training phase's settings otherwise: B=8, S=2048,
    dots_saveable, AdamW): 1 + 8 steps, the scaler after each step, B1 =
    2 x 8 x 16 and B2 = B3 = 8 x 16 launches exactly (f16), step ms, tok/s
    and MFU beside the bf16 step of the training phase; then the f16
    cross-check and the forced overflow."""
    from deepspeed_tpu_torch import llama_config
    S = 2048
    cfg = llama_config("1b", max_seq_len=S, remat=True,
                       remat_policy="dots_saveable", loss_chunk=S, dtype=F16)
    states = []
    engine, batch, rec = _train(
        cfg, "llama-1b f16", FP16_TRAIN_CONFIG, TRAIN_STEPS,
        after_step=lambda e: states.append(_scaler_snapshot(e)))
    n, L = TRAIN_STEPS, cfg.num_layers
    rec["scaler_after_each_step"] = [
        {k: (float(v) if k == "scale" else int(v)) for k, v in s.items()}
        for s in states]
    # a skipped step has no update: the f16 step ms would flatter f16
    skipped = [s["skipped"] for s in rec["scaler_after_each_step"]]
    if any(skipped):
        raise RuntimeError(f"phase 15 (b): a step overflowed and was "
                           f"skipped (skipped after each step: {skipped})")
    _check_run("f16 training", rec, {})
    _exact_launches("phase 15 (b) f16 training", rec["launches"],
                    {"flash_fwd": 2 * n * L, "flash_bwd_dq": n * L,
                     "flash_bwd_dkv": n * L})
    del engine, batch
    _free()
    rec["vs_bf16"] = {
        "f16_step_ms": rec["step_ms_cuda_median"],
        "bf16_step_ms": bf16_rec["step_ms_cuda_median"],
        "f16_tokens_per_s": rec["tokens_per_s"],
        "bf16_tokens_per_s": bf16_rec["tokens_per_s"],
        "f16_mfu": rec["mfu"], "bf16_mfu": bf16_rec["mfu"]}
    rec["cross_check"] = fp16_cross_check()
    rec["forced_overflow"] = forced_overflow()
    log(f"phase 15 (b) fp16 training [{smi}] " + json.dumps(rec))
    return rec


def f16_serving(smi: str, served):
    """(c) llama-7b width, 4 layers, the serving phase's load in f16 (B1
    and B4 on f16, exactly 4 x prefills and 4 x decode steps), then the
    same weights in bf16; the agreement of the two (reported)."""
    from deepspeed_tpu_torch import init_serving, llama_config, make_model
    from deepspeed_tpu_torch.models import transformer as tf
    cfg = llama_config("7b", num_layers=4)
    L = cfg.num_layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    params32 = tf.init_params(cfg, gen, "cuda", dtype=torch.float32)
    prompts = served[0]
    rec, gens = {}, {}
    for dtype in (F16, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        srv = init_serving(make_model(cfg, f"llama-7b 4 layers {name}"),
                           config={"kv_cache_bits": 0},
                           serving=BREADTH_SERVING, params=params32,
                           dtype=dtype)
        if srv.pools["k"].dtype != dtype:
            raise RuntimeError(f"phase 15 (c): a {srv.pools['k'].dtype} "
                               f"pool under {dtype}")
        gens[name], st, launches = _serve_counted(
            srv, prompts, 32, f"phase 15 (c) {name}")
        _exact_launches(f"phase 15 (c) {name}", launches,
                        {"flash_fwd": L * st["prefills"],
                         "paged_decode": L * st["decode_steps"]})
        rec[name] = dict(_latency(st), launches=launches)
        del srv
        _free()
    del params32
    _free()
    rec["agreement_f16_vs_bf16"] = _agreement(gens["float16"],
                                              gens["bfloat16"])
    log(f"phase 15 (c) f16 serving [{smi}] " + json.dumps(rec))
    return rec


OPT_STEPS = 2             # updates on the card and on the CPU copies
OPT_CHECKS = (("sgd", {"lr": 1e-2, "momentum": 0.9}),
              ("adagrad", {"lr": 1e-2}),
              ("lion", {"lr": 1e-4, "weight_decay": 0.1}),
              ("lamb", {"lr": 1e-3, "weight_decay": 0.01}))


def _trust_ratio_f32(i, p, upd, min_trust, max_trust):
    """LAMB's trust ratio as it stood before the C3 repair: two f32
    ``vector_norm``s (timed beside the repaired one on the card)."""
    w, u = (torch.linalg.vector_norm(t, dtype=torch.float32)
            for t in (p, upd))
    return torch.where((w > 0) & (u > 0), (w / u).clamp(min_trust,
                                                         max_trust),
                       torch.ones_like(w))


def _grad_norm_f32(grads):
    """The global norm as it stood before the C3 repair (a norm of f32
    leaf norms)."""
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    return torch.linalg.vector_norm(torch.stack([
        torch.linalg.vector_norm(g, dtype=torch.float32)
        for g in tree_leaves(grads)]))


def _c3_cost(p0, grads):
    """The card cost of the C3 repair, both versions in this call, in
    turns (before, after, after, before): LAMB's update and the global
    grad norm over llama-1b's leaves at 2 layers."""
    from unittest import mock
    from deepspeed_tpu_torch.ops import lamb as lamb_mod
    from deepspeed_tpu_torch.ops.optimizers import (global_grad_norm,
                                                    tree_map)
    from deepspeed_tpu_torch.ops.registry import get_optimizer_builder
    opt = get_optimizer_builder("lamb")(use_master_weights=False,
                                        lr=1e-3, weight_decay=0.01)
    dev = tree_map(lambda t: t.clone(), p0)
    st = opt.init(dev)
    out = {"lamb_update_ms": {"before": [], "after": []},
           "grad_norm_ms": {"before": [], "after": []}}
    for which in ("before", "after", "after", "before"):
        ratio = _trust_ratio_f32 if which == "before" else \
            lamb_mod.trust_ratio
        norm = _grad_norm_f32 if which == "before" else global_grad_norm
        with mock.patch.object(lamb_mod, "trust_ratio", ratio):
            out["lamb_update_ms"][which].append(cuda_ms(
                lambda: opt.update(grads[0], st, dev), iters=5, warmup=1))
        out["grad_norm_ms"][which].append(cuda_ms(
            lambda: norm(grads[0]), iters=10, warmup=2))
    del dev, st
    return out


def optimizer_checks(smi: str):
    """(d) SGD (momentum), Adagrad, Lion and LAMB over llama-1b's leaves
    at 2 layers, f32: 2 updates on the card against the same updates on
    CPU copies (every param and state leaf within 1e-5 relative L2), and
    one update's ms beside the bytes it must move (params, grads and
    state read once, params and state written once) over the card's
    memory rate. LAMB's norms are f32 on the card, as JAX's, and
    two-level on the CPU (``ops/optimizers.sum_of_squares``: the C3
    repair; before it the CPU's f32 sum over the 65M-value embedding
    drifted 0.6 %); ``c3_cost`` times LAMB's update and the global norm
    before and after the repair."""
    from deepspeed_tpu_torch import llama_config
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves, tree_map
    from deepspeed_tpu_torch.ops.registry import get_optimizer_builder
    cfg = llama_config("1b", num_layers=2)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p0 = tf.init_params(cfg, gen, "cuda", dtype=torch.float32)
    grads = [tree_map(lambda t: torch.randn(
        t.shape, generator=gen, device="cuda") * 1e-2, p0)
        for _ in range(OPT_STEPS)]
    n_params = sum(t.numel() for t in tree_leaves(p0))
    recs = {}
    for name, kw in OPT_CHECKS:
        opt = get_optimizer_builder(name)(use_master_weights=False, **kw)
        dev = tree_map(lambda t: t.clone(), p0)
        host = tree_map(lambda t: t.cpu(), p0)
        sd, sh = opt.init(dev), opt.init(host)
        for g in grads:
            opt.update(g, sd, dev)
            opt.update(tree_map(lambda t: t.cpu(), g), sh, host)
        torch.cuda.synchronize()
        pairs = [(a, b) for a, b in zip(
            tree_leaves({"params": dev, "state": sd}),
            tree_leaves({"params": host, "state": sh}))
            if isinstance(a, torch.Tensor)]
        err = max(rel_l2(a.cpu(), b) for a, b in pairs)
        state_leaves = [t for t in tree_leaves(sd)
                        if isinstance(t, torch.Tensor)]
        ms = cuda_ms(lambda: opt.update(grads[0], sd, dev), iters=5,
                     warmup=1)
        moved = (2 * nbytes(*tree_leaves(dev)) + nbytes(*tree_leaves(
            grads[0])) + 2 * nbytes(*state_leaves))
        recs[name] = dict(kw=kw, steps=OPT_STEPS, max_rel_l2_vs_cpu=err,
                          leaves=len(pairs), update_ms=ms,
                          bound_ms=moved / HBM_BYTES_PER_S * 1e3)
        if not err <= 1e-5:
            raise RuntimeError(f"phase 15 (d) {name}: card vs CPU rel L2 "
                               f"{err:.3g}")
        del dev, host, sd, sh, pairs, state_leaves
        _free()
    rec = {"params": n_params, "optimizers": recs,
           "c3_cost": _c3_cost(p0, grads)}
    del p0, grads
    _free()
    log(f"phase 15 (d) optimizers [{smi}] " + json.dumps(rec))
    return rec


def dropout_checks(smi: str):
    """(e) dropout_rate 0.1 at llama-1b width, 2 layers, B=8, S=2048,
    bf16: the keep fraction of one mask of the layer's output shape
    within 5 sigma of 0.9 and the kept values 1 / 0.9; the loss and the
    grads under dots_saveable equal to those without remat for one seed;
    a training step beside the same step at rate 0."""
    from deepspeed_tpu_torch import llama_config
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops.optimizers import cast_tree, tree_leaves
    B, S, rate = 8, 2048, 0.1
    cfg = llama_config("1b", num_layers=2, max_seq_len=S, dropout_rate=rate,
                       remat=True, remat_policy="dots_saveable",
                       loss_chunk=S, fused_backward=True)
    x = torch.ones((B, S, cfg.hidden_size), dtype=torch.bfloat16,
                   device="cuda")
    y = tf._dropout(x, cfg, 1234, 0)
    kept = y != 0
    frac = float(kept.float().mean())
    sigma = float(np.sqrt(rate * (1 - rate) / x.numel()))
    scaled = bool(torch.all(y[kept] == torch.ones((), dtype=torch.bfloat16,
                                                  device="cuda")
                            / (1 - rate)))
    rec = {"keep_fraction": frac, "sigma": sigma,
           "within_5_sigma": abs(frac - (1 - rate)) <= 5 * sigma,
           "kept_values_are_1_over_keep": scaled}
    del x, y, kept
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        params = cast_tree(tf.init_params(cfg, gen, "cuda",
                                          dtype=torch.float32),
                           torch.bfloat16)
    ids = np.random.default_rng(4).integers(0, VOCAB, (B, S))
    batch = {"input_ids": torch.from_numpy(ids).cuda()}
    res = {}
    for policy in ("dots_saveable", "none"):
        c = dataclasses.replace(cfg, remat=policy != "none",
                                remat_policy=policy)
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        loss = tf.lm_loss(params, batch, c, dropout_seed=77)
        res[policy] = (loss.detach(), torch.autograd.grad(loss, leaves))
    (la, ga), (lb, gb) = res["dots_saveable"], res["none"]
    rec["remat_vs_none"] = {
        "loss_equal": bool(torch.equal(la, lb)),
        "grads_bitwise": all(torch.equal(a, b) for a, b in zip(ga, gb)),
        "grad_rel_l2_max": max(rel_l2(a, b) for a, b in zip(ga, gb))}
    del res, ga, gb, params
    _free()
    steps = {}
    for r in (rate, 0.0):
        engine, batch, tr = _train(dataclasses.replace(cfg, dropout_rate=r),
                                   f"llama-1b 2 layers dropout {r}",
                                   TRAIN_CONFIG, 3)
        steps[f"rate_{r}"] = {k: tr[k] for k in (
            "step_ms_cuda_median", "tokens_per_s", "losses")}
        del engine, batch
        _free()
    rec["train_step"] = steps
    log(f"phase 15 (e) dropout [{smi}] " + json.dumps(rec))
    if not (rec["within_5_sigma"] and scaled
            and rec["remat_vs_none"]["grad_rel_l2_max"] <= 1e-5):
        raise RuntimeError(f"phase 15 (e): {rec}")
    return rec


def phase15(smi: str, served, bf16_train):
    """Phase 15: (a) a block-sparse model served, (b) fp16 training, (c)
    f16 serving, (d) the single-rank optimizers, (e) dropout. Returns the
    f16 launches of B1-B4 and B5's serving launches for the kernel
    line."""
    t0 = time.perf_counter()
    _free()
    a = sparse_serving(smi)
    b = fp16_training(smi, bf16_train)
    c = f16_serving(smi, served)
    optimizer_checks(smi)
    dropout_checks(smi)
    f16 = {k: b["launches"][k] + c["float16"]["launches"][k]
           for k in FLASH_KERNELS + ("paged_decode",)}
    log(f"phase 15: {time.perf_counter() - t0:.1f}s, f16 launches "
        f"{json.dumps(f16)}, sparse serving launches "
        f"{a['sparse']['launches']['sparse_fwd']}")
    return {"f16": f16, "f16_by_path": {"training": b["launches"],
                                        "serving": c["float16"]["launches"]},
            "sparse_serving": a["sparse"]["launches"]["sparse_fwd"],
            "bf16_by_path": {"sparse_serving": a["sparse"]["launches"],
                             "sparse_serving_dense": a["dense"]["launches"],
                             "f16_serving_bf16": c["bfloat16"]["launches"]}}


# --------------------------------------------------------------------------
# multi-rank training (phase 16)
# --------------------------------------------------------------------------

ZERO_LAYERS = 4           # llama-1b's width, 4 of its 16 layers, 2 steps
ZERO_STEPS = 2            # (the run's time limit cuts depth, never width)
ZERO_SEQ = 2048
ZERO_SHARED = ("two processes on one card over gloo: not a data-parallel "
               "speed")
ZERO_F32 = dict(num_layers=2, max_seq_len=1024, dtype=torch.float32)
ZERO_F32_STEPS = 2        # each f32 run of (c) and (d)


def _zero_collectives(rank):
    """(a) Every facade collective on CUDA tensors over the 2-rank gloo
    group, each against its expected value: {name: max |error|}."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.comm.compressed import compressed_allreduce_1bit
    from deepspeed_tpu_torch.parallel import (MeshPlan, build_mesh,
                                              parallel_context)
    x = torch.arange(24, dtype=torch.float32, device="cuda").reshape(4, 6) \
        + 100 * rank
    both = [torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * r
            for r in range(2)]
    s = both[0] + both[1]
    y = torch.linspace(-1, 1, 11, device="cuda") * (rank + 1)
    mean_scale = float(torch.linspace(-1, 1, 11).abs().mean()) * 1.5
    cases = {
        "all_reduce": (lambda: comm.all_reduce(x.clone(), "data"), s),
        "all_reduce_max": (lambda: comm.all_reduce(x.clone(), "data",
                                                   op="max"), both[1]),
        "all_gather_dim1": (lambda: comm.all_gather(x, "data", dim=1),
                            torch.cat(both, 1)),
        "reduce_scatter_dim0": (lambda: comm.reduce_scatter(x, "data"),
                                s[2 * rank:2 * rank + 2]),
        "reduce_scatter_dim1": (lambda: comm.reduce_scatter(x, "data",
                                                            dim=1),
                                s[:, 3 * rank:3 * rank + 3]),
        "broadcast": (lambda: comm.broadcast(x.clone(), "data",
                                             src_index=1), both[1]),
        "all_gather_uint8": (lambda: comm.all_gather(torch.full(
            (1, 5), 3 + rank, dtype=torch.uint8, device="cuda"),
            "data").float(), torch.tensor([[3.0] * 5, [4.0] * 5])),
        "compressed_allreduce_1bit": (
            lambda: compressed_allreduce_1bit(y, "data"),
            torch.where(torch.linspace(-1, 1, 11) >= 0, 1.0, -1.0)
            * mean_scale)}
    out = {}
    with parallel_context(build_mesh(MeshPlan(data=2))):
        for name, (fn, want) in cases.items():
            got = fn()
            if got.device != x.device:
                raise RuntimeError(f"phase 16 (a): {name} left the card")
            out[name] = float((got.cpu() - want).abs().max())
    return out


def _zero_whole_params(engine, device="cpu"):
    """{path: whole f32 tensor on ``device``} of an engine's params
    (collective)."""
    from deepspeed_tpu_torch.parallel import parallel_context
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod
    out = {}
    with parallel_context(engine.mesh):
        for k, t in ckpt_mod.flatten(engine.state["params"]).items():
            if engine._part is not None:
                t = engine._part.whole(t.detach(),
                                       engine._part.layouts[k].pspec)
            out[k] = t.detach().to(device, torch.float32)
    return out


def _zero_bytes(engine):
    """This rank's resident bytes of params, optimizer state (f32 masters
    and moments) and the step's reduced grads."""
    from deepspeed_tpu_torch.parallel import sharded_bytes
    return {"params": sharded_bytes(engine.state["params"]),
            "opt": sharded_bytes(engine.state["opt"]),
            "grads": engine.last_grad_bytes}


def _zero_masters(engine):
    """{path: f32 CPU tensor} of this rank's slice of the f32 masters."""
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod
    return {k: t.detach().to("cpu", torch.float32, copy=True) for k, t in
            ckpt_mod.flatten(engine.state["opt"]["master"]).items()}


def _zero_model(cfg, config, reference=False):
    """(llama-1b's ModelSpec, the engine config). ``reference``: the loss
    through the plain versions of the kernels; the config's
    ``transformer`` section (which makes the engine rebuild the spec) is
    folded into the model config instead."""
    from deepspeed_tpu_torch import make_model
    from deepspeed_tpu_torch.models import transformer as tf
    if not reference:
        return make_model(cfg, "llama-1b"), config
    fused = config.get("transformer", {}).get("fused_backward", False)
    cfg = dataclasses.replace(cfg, fused_backward=fused)
    spec = dataclasses.replace(
        make_model(cfg, "llama-1b"),
        loss_fn=lambda params, batch, **kw: tf.lm_loss(
            params, batch, cfg, reference=True, **kw))
    return spec, {k: v for k, v in config.items() if k != "transformer"}


def _zero_run(cfg, config, batches, reference=False, masters=False):
    """initialize -> one train_batch a batch, each step's wall ms (ending
    in a synchronize); this rank's launches, bytes, peak memory and the
    facade's bytes, all zeroed just before the first step. ``masters``:
    also this rank's slice of the f32 masters' change over the steps
    (``masters_delta``)."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops import _build
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    spec, config = _zero_model(cfg, config, reference)
    engine, *_ = initialize(model=spec, config=dict(config))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = _zero_masters(engine) if masters else None
    _build.reset_launch_counts()
    comm.reset_counts()
    losses, step_ms = [], []
    for b in batches:
        t1 = time.perf_counter()
        losses.append(float(engine.train_batch(b)["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    rec = {"init_s": init_s, "losses": losses, "step_ms_wall": step_ms,
           "launches": _build.launch_counts(), "bytes": _zero_bytes(engine),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "wire": comm.counts()}
    if masters:
        rec["masters_delta"] = {k: t - before[k] for k, t in
                                _zero_masters(engine).items()}
    mark_part(f"zero run {config.get('zero_optimization')} "
         f"{config.get('optimizer', {}).get('type')} {len(batches)} steps "
         f"{'plain' if reference else ''}")
    return engine, rec


def _zero_delta_vs(engine, delta, whole0):
    """Relative L2 and the largest absolute difference, over this rank's
    slices, of a stage's masters' change ``delta`` against stage 0's whole
    change ``whole0`` cut to the same slices."""
    num = den = top = 0.0
    for k, d in delta.items():
        w = engine._part.slice_of(whole0[k], engine._part.layouts[k].ospec)
        num += float((d.double() - w.double()).square().sum())
        den += float(w.double().square().sum())
        top = max(top, float((d - w).abs().max()))
    return (num / den) ** 0.5, top


def _zero_batches(B, S, n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_ids": torch.from_numpy(rng.integers(
        0, VOCAB, (B, S), dtype=np.int32)).cuda()} for _ in range(n)]


def _zero_rank(rank, world, layers, steps, S, ckpt_dir):
    """One rank of phase 16, both ranks on cuda:0 over gloo: (a) the
    collectives; (b) llama-1b (``layers`` deep) bf16 at stages 0-3; (c)
    f32 at 2 layers, stages 0-3; (d) onebitadam at 2 layers; (e) a stage-3
    save into ``ckpt_dir`` and the next loss. Returns every rank's
    record (on rank 0)."""
    import torch.distributed as dist
    from deepspeed_tpu_torch import llama_config
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {"collectives": _zero_collectives(rank)}
    cfg = llama_config("1b", num_layers=layers, max_seq_len=S, remat=True,
                       remat_policy="dots_saveable", loss_chunk=S)
    batches = _zero_batches(8, S, steps)
    # the f32 masters' change over the steps, whole at stage 0, then each
    # stage against it (no rounding by the check: the engine rounds each
    # bf16 param's reduced grad at every stage)
    whole0 = None
    for stage in range(4):
        conf = dict(TRAIN_CONFIG, zero_optimization={"stage": stage})
        engine, r = _zero_run(cfg, conf, batches, masters=True)
        delta = r.pop("masters_delta")
        if stage == 0:
            whole0 = delta
        (r["masters_change_rel_l2_vs_stage0"],
         r["masters_change_max_abs_vs_stage0"]) = _zero_delta_vs(
            engine, delta, whole0)
        rec[f"bf16_stage{stage}"] = r
        del engine, delta
        _free()
    del whole0
    cfg32 = llama_config("1b", remat=True, remat_policy="dots_saveable",
                         loss_chunk=ZERO_F32["max_seq_len"], **ZERO_F32)
    b32 = _zero_batches(8, cfg32.max_seq_len, 3, seed=1)
    conf32 = dict(TRAIN_CONFIG, bf16={"enabled": False})
    # the plain versions of the kernels at this rank's shapes (4 rows of
    # the same batches), stage 0: the yardstick of every stage below
    engine, plain = _zero_run(cfg32, dict(conf32, zero_optimization={
        "stage": 0}), b32[:ZERO_F32_STEPS], reference=True)
    whole = _zero_whole_params(engine)
    rec["f32_plain_stage0"] = plain
    del engine
    _free()
    for stage in range(4):
        engine, r = _zero_run(cfg32, dict(
            conf32, zero_optimization={
                "stage": stage, "stage3_param_persistence_threshold": 0}),
            b32[:ZERO_F32_STEPS])
        p = _zero_whole_params(engine)
        r["params_rel_l2_vs_plain"] = max(rel_l2(p[k], whole[k])
                                          for k in whole)
        rec[f"f32_stage{stage}"] = r
        del engine, p
        _free()
    del whole
    # stage 0 on a pure data-parallel plan: the 1-bit compressed path
    adam = dict(conf32, gradient_clipping=0.0,
                zero_optimization={"stage": 0},
                optimizer={"type": "adam", "params": {"lr": 1e-4}})
    onebit = dict(adam, optimizer={
        "type": "onebitadam", "params": {"lr": 1e-4, "freeze_step": 100}})
    for name, conf, n in (("adam", adam, ZERO_F32_STEPS),
                          ("onebit_warm", onebit, ZERO_F32_STEPS)):
        engine, r = _zero_run(cfg32, conf, b32[:n])
        rec[name] = r
        del engine
        _free()
    onebit["optimizer"]["params"]["freeze_step"] = 2
    engine, r = _zero_run(cfg32, onebit, _zero_batches(
        8, cfg32.max_seq_len, 4, seed=2))
    rec["onebit_compressed"] = dict(r, compressed=engine._onebit)
    del engine
    _free()
    engine, r = _zero_run(cfg32, dict(conf32, zero_optimization={
        "stage": 3}), b32[:2])
    engine.save_checkpoint(ckpt_dir, tag="zero3")
    rec["ckpt_next_loss"] = float(engine.train_batch(b32[2])["loss"])
    del engine
    _free()
    out = [None] * world
    dist.all_gather_object(out, rec)
    return out if rank == 0 else None


def _zero_laws(ranks, what):
    """The ZeRO memory laws on each rank's bytes, against stage 0's:
    stage 1 halves the optimizer state (every llama-1b leaf splits over
    2), stage 2 also the grads, stage 3 also the params of every leaf
    over the persistence threshold (the norms stay whole)."""
    from deepspeed_tpu_torch import llama_config
    checks = {}
    cfg = llama_config("1b", num_layers=ZERO_LAYERS)
    norms = (2 * cfg.num_layers + 1) * cfg.hidden_size      # values
    for i, r in enumerate(ranks):
        b = {s: r[f"{what}_stage{s}"]["bytes"] for s in range(4)}
        full = b[0]
        checks[f"rank {i}: stage 1 opt x 2 == stage 0"] = \
            b[1]["opt"] * 2 == full["opt"] and \
            b[1]["params"] == full["params"]
        checks[f"rank {i}: stage 2 opt and grads x 2 == stage 0"] = \
            b[2]["opt"] * 2 == full["opt"] and \
            b[2]["grads"] * 2 == full["grads"]
        whole_norms = norms * 2                     # bf16 params
        checks[f"rank {i}: stage 3 params halved but the norms"] = \
            (b[3]["params"] - whole_norms) * 2 + whole_norms == \
            full["params"]
    return checks


def zero_training_phase(smi: str):
    """Phase 16: multi-rank training, two processes sharing the card over
    gloo. First, here, B1-B3 in bf16 against their plain versions at a
    rank's shapes (B = 4, S = 2048). Then on the ranks: (a) every facade
    collective on CUDA tensors; (b) llama-1b at full width, 4 of its 16
    layers, bf16 with f32 masters, AdamW, global B = 8, S = 2048 (4 rows
    a rank), ZeRO stages 0-3, 2 steps each: losses within 2e-2 of stage
    0's, the f32 masters' change over the 2 steps within 1e-6 relative L2
    of stage 0's and equal to it bit for bit (a stage that skipped an
    update or lost rows moves its masters by another half or more), B1 = 2 x
    steps x L and B2 = B3 = steps x L on
    each rank, the memory laws, peak memory and step times; (c) f32 at 2
    layers, S = 1024: stages 0-3 through the kernels against stage 0
    through their plain versions on the same inputs (losses within 1e-5,
    params within 1e-4, the training cross-check's bars); (d) onebitadam
    at 2 layers: its warm-up equal to Adam, the compressed phase's wire
    about 1/32 of the dense one; (e) a stage-3 save at world 2, loaded
    here at world 1, stage 0: the next loss equal. Returns the record;
    its launches are of (b), summed over the ranks, and the kernel cases
    at the rank's shapes."""
    import tempfile
    from deepspeed_tpu_torch import initialize, llama_config, make_model
    from deepspeed_tpu_torch.parallel.launch import run_group
    t_phase = time.perf_counter()
    _free()
    bf = torch.bfloat16
    fwd_case = flash_case("llama-1b ZeRO rank B=4 S=2048", 4, ZERO_SEQ, 32,
                          8, 64, bf)
    back_case = bwd_case("llama-1b ZeRO rank B=4 S=2048", 4, ZERO_SEQ, 32,
                         8, 64, bf)
    _free()
    tmp = tempfile.mkdtemp(prefix="phase16_")
    ranks = run_group(_zero_rank, 2, ZERO_LAYERS, ZERO_STEPS, ZERO_SEQ, tmp,
                      timeout_s=900)
    checks, L, n = {}, ZERO_LAYERS, ZERO_STEPS
    for i, r in enumerate(ranks):
        for name, err in r["collectives"].items():
            checks[f"(a) rank {i} {name} on cuda"] = err <= 1e-6
        base = r["bf16_stage0"]["losses"]
        for s in range(4):
            x = r[f"bf16_stage{s}"]
            la = x["launches"]
            checks[f"(b) rank {i} stage {s} finite"] = \
                all(np.isfinite(x["losses"]))
            checks[f"(b) rank {i} stage {s} within 2e-2 of stage 0"] = max(
                abs(a - b) / abs(b) for a, b in zip(x["losses"], base)) \
                <= 2e-2
            # every stage rounds a bf16 leaf's reduced grad to bf16, as
            # JAX does: the masters agree with plain stage 0's
            checks[f"(b) rank {i} stage {s} masters' change within 1e-6 "
                   "of stage 0's"] = \
                x["masters_change_rel_l2_vs_stage0"] <= 1e-6
            checks[f"(b) rank {i} stage {s} masters' change equals stage "
                   "0's bit for bit"] = \
                x["masters_change_max_abs_vs_stage0"] == 0.0
            checks[f"(b) rank {i} stage {s} B1 == 2 x steps x L"] = \
                la["flash_fwd"] == 2 * n * L
            checks[f"(b) rank {i} stage {s} B2 == B3 == steps x L"] = \
                la["flash_bwd_dq"] == la["flash_bwd_dkv"] == n * L
        plain = r["f32_plain_stage0"]
        checks[f"(c) rank {i} plain run launched no kernel"] = \
            not any(plain["launches"].values())
        for s in range(4):
            x = r[f"f32_stage{s}"]
            checks[f"(c) rank {i} f32 stage {s} kernels within 1e-5 (loss) "
                   "and 1e-4 (params) of the plain stage 0"] = \
                max(abs(a - b) / abs(b) for a, b in
                    zip(x["losses"], plain["losses"])) <= 1e-5 and \
                x["params_rel_l2_vs_plain"] <= 1e-4
            checks[f"(c) rank {i} f32 stage {s} B1 == 2 x steps x 2"] = \
                x["launches"]["flash_fwd"] == 2 * ZERO_F32_STEPS * 2
        checks[f"(d) rank {i} onebit warm-up == adam"] = max(
            abs(a - b) / abs(b) for a, b in zip(
                r["onebit_warm"]["losses"], r["adam"]["losses"])) <= 1e-5
    checks.update({f"(b) {k}": v for k, v in _zero_laws(ranks,
                                                         "bf16").items()})
    comp = ranks[0]["onebit_compressed"]
    wire = comp["wire"]
    dense = ranks[0]["adam"]["wire"]["all_reduce"]["data"]["bytes"] \
        / ZERO_F32_STEPS
    packed = wire["all_gather"]["data"]["bytes"] / 2   # 2 compressed steps
    checks["(d) compressed path taken"] = comp["compressed"]
    checks["(d) compressed wire ~ 1/32 of dense"] = \
        1 / 33 < packed / dense < 1 / 31
    cfg32 = llama_config("1b", remat=True, remat_policy="dots_saveable",
                         loss_chunk=ZERO_F32["max_seq_len"], **ZERO_F32)
    one, *_ = initialize(model=make_model(cfg32, "llama-1b"), config=dict(
        TRAIN_CONFIG, bf16={"enabled": False},
        zero_optimization={"stage": 0}))
    one.load_checkpoint(tmp, tag="zero3")
    b = _zero_batches(8, cfg32.max_seq_len, 3, seed=1)[2]
    next_loss = float(one.train_batch(b)["loss"])
    want = ranks[0]["ckpt_next_loss"]
    checks["(e) world 2 stage 3 -> world 1 stage 0: next loss equal"] = \
        abs(next_loss - want) <= 2e-4 * abs(want) + 1e-5
    del one
    _free()
    shutil.rmtree(tmp, ignore_errors=True)
    launches = {k: sum(r[f"bf16_stage{s}"]["launches"][k] for r in ranks
                       for s in range(4)) for k in FLASH_KERNELS}
    rec = {"card": smi, "timing": ZERO_SHARED, "layers": L, "steps": n,
           "ranks": [{k: v for k, v in r.items()} for r in ranks],
           "flash_case": fwd_case, "bwd_case": back_case,
           "ckpt": {"next_loss_world1": next_loss, "next_loss_world2": want},
           "onebit_wire_ratio": packed / dense, "launches": launches}
    rec["phase_s"] = time.perf_counter() - t_phase
    summary = {f"stage{s}": {
        "losses": ranks[0][f"bf16_stage{s}"]["losses"],
        "step_ms_wall": [r[f"bf16_stage{s}"]["step_ms_wall"] for r in ranks],
        "peak_mem_gib": [r[f"bf16_stage{s}"]["peak_mem_gib"] for r in ranks],
        "bytes": [r[f"bf16_stage{s}"]["bytes"] for r in ranks],
        **{key: [r[f"bf16_stage{s}"][key] for r in ranks]
           for key in ("masters_change_rel_l2_vs_stage0",
                       "masters_change_max_abs_vs_stage0")}}
        for s in range(4)}
    log(f"phase 16 llama-1b bf16 [{smi}; {ZERO_SHARED}] "
        + json.dumps(summary))
    log(f"phase 16 f32 2 layers [{smi}] " + json.dumps({
        "plain_stage0": {k: [r["f32_plain_stage0"][k] for r in ranks]
                         for k in ("losses", "step_ms_wall")},
        **{f"stage{s}": {k: [r[f"f32_stage{s}"].get(k) for r in ranks]
                         for k in ("losses", "params_rel_l2_vs_plain",
                                   "step_ms_wall")}
           for s in range(4)}}))
    log(f"phase 16 onebit [{smi}] " + json.dumps({
        "adam": ranks[0]["adam"]["losses"],
        "onebit_warm": ranks[0]["onebit_warm"]["losses"],
        "compressed": comp["losses"], "wire_ratio": packed / dense,
        "wire": wire}))
    log(f"phase 16: {rec['phase_s']:.1f}s, launches {json.dumps(launches)}, "
        f"checks {json.dumps(checks)}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"phase 16: failed {failed}")
    return rec


# --------------------------------------------------------------------------
# the fleet (phase 17)
# --------------------------------------------------------------------------

# each replica: 8 slots and the serving phase's block and buckets; a queue
# watermark of 8 makes the router spill a burst over the replicas instead
# of queueing it all on the first
FLEET_SERVING = dict(BREADTH_SERVING, max_seqs=8, max_queue=8)
FLEET_F32_LAYERS = 2
FLEET_F32_LOAD = (16, 24)            # the serving phase's first 16, 24 new


def _fleet_router(tmp, t):
    """A router on a simulated clock (1 s a round): a dead replica is
    detected in rounds, not seconds."""
    from deepspeed_tpu_torch.inference import RouterConfig, ServingRouter
    return ServingRouter(RouterConfig(
        store_dir=os.path.join(tmp, "store"),
        drain_dir=os.path.join(tmp, "drains"), dead_after_s=2.5,
        breaker_faults=2, breaker_probe_after=2, clock=lambda: t[0]))


def _count_rounds(handle, into):
    """Add the kernels launched inside each of the replica's rounds to
    ``into``: the router steps its replicas one after another, and a
    handoff or a failover launches nothing until the receiver's round."""
    from deepspeed_tpu_torch.ops import _build
    step = handle.step

    def counted():
        before = _build.launch_counts()
        try:
            return step()
        finally:
            for k, v in _build.launch_counts().items():
                into[k] = into.get(k, 0) + v - before.get(k, 0)
    handle.step = counted


def _fleet_drive(router, load, t, launches, tick=None, lull=0):
    """Submit ``load`` (a shed is retried the next round) and step until
    every request finished, then ``lull`` idle rounds: ({rid: generated
    tokens}, rounds, wall s). The kernel counts are zeroed just before
    and added to ``launches`` just after, so they hold the fleet's
    launches and nothing of a reference run or a check."""
    from deepspeed_tpu_torch.inference import AdmissionRejected
    from deepspeed_tpu_torch.ops import _build
    pending, outs, rounds = list(load), {}, 0
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    while pending or not router.done:
        while pending:
            try:
                router.add_request(*pending[0])
            except AdmissionRejected:
                break
            pending.pop(0)
        for r in router.step():
            outs[r.rid] = r.output[len(r.prompt):]
        if tick is not None:
            tick()
        t[0] += 1.0
        rounds += 1
        if rounds > 4000:
            raise RuntimeError("phase 17: the router did not converge")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for _ in range(lull):
        router.step()
        if tick is not None:
            tick()
        t[0] += 1.0
    torch.cuda.synchronize()
    for k, v in _build.launch_counts().items():
        launches[k] = launches.get(k, 0) + v
    return outs, rounds, wall


def _fleet_latency(router, gens, wall):
    """TTFT (the router's, of every finished request), ITL (every
    replica's samples) and generated tokens a second of the whole run."""
    st = router.stats()
    itl = [x for h in router.replicas.values() for x in h.engine._itl_ms]
    return {"p50_ttft_ms": st.get("p50_ttft_ms"),
            "p99_ttft_ms": st.get("p99_ttft_ms"),
            "p50_itl_ms": float(np.percentile(itl, 50)) if itl else None,
            "p99_itl_ms": float(np.percentile(itl, 99)) if itl else None,
            "tok_per_sec": sum(len(g) for g in gens.values()) / wall,
            "wall_s": wall}


def _rounds_hold_all(checks, what, drive, counts):
    """Every launch of the drive was made inside a replica's round."""
    for k in ("flash_fwd", "paged_decode"):
        checks[f"{what} {k}: the replicas' rounds hold all launches"] = \
            drive.get(k, 0) == sum(c.get(k, 0) for c in counts.values())


def _replica_checks(checks, what, name, srv, counts, L):
    """The replica's kernels against its own dispatch counts, and no
    recovery: a kernel failure recovered in a fault-free run must fail
    the phase, not pass unseen."""
    st = srv.stats()
    checks[f"{what} {name}: flash_fwd == {L} x prefills"] = \
        counts.get("flash_fwd", 0) == L * st["prefills"]
    checks[f"{what} {name}: paged_decode == {L} x decode_steps"] = \
        counts.get("paged_decode", 0) == L * st["decode_steps"]
    return {"prefills": st["prefills"], "decode_steps": st["decode_steps"],
            "flash_fwd": counts.get("flash_fwd", 0),
            "paged_decode": counts.get("paged_decode", 0),
            "recoveries": st["recoveries"], "degraded": st["degraded"]}


def fleet_full_width(smi, eng, served, drift, checks, launches):
    """(a) two ``both`` replicas over one copy of llama-7b's weights behind
    the router, the serving phase's 24 prompts x 32 new tokens, r0 killed
    at router round 3; (b) a ``prefill`` and a ``decode`` replica on the
    same weights, ``handoff_kv`` on. The drives' launches are added to
    ``launches``."""
    import tempfile
    from deepspeed_tpu_torch.inference import ServingConfig, ServingEngine
    from deepspeed_tpu_torch.inference.serving import kv_payload_crc
    from deepspeed_tpu_torch.robustness import faults
    prompts, base_gens = served
    L = eng.model.config.num_layers
    load = [(p, 32) for p in prompts]
    out = {}
    # (a) failover
    t = [0.0]
    router = _fleet_router(tempfile.mkdtemp(prefix="phase17a_"), t)
    counts = {"r0": {}, "r1": {}}
    for name in counts:
        srv = ServingEngine(eng, ServingConfig(**FLEET_SERVING))
        _count_rounds(router.register(name, srv), counts[name])
    faults.install(faults.FaultInjector(faults.FaultSchedule(
        [{"kind": "replica_kill", "at": 3, "replica": 0}], seed=0)))
    drive = {}
    try:
        outs, rounds, wall = _fleet_drive(router, load, t, drive)
    finally:
        faults.clear()
    _rounds_hold_all(checks, "(a)", drive, counts)
    for k, v in drive.items():
        launches[k] = launches.get(k, 0) + v
    gens = [outs[i] for i in range(len(prompts))]
    _check_generated("phase 17 (a)", gens, 32)
    st = router.stats()
    a = {**_fleet_latency(router, outs, wall), "rounds": rounds,
         "failover_ms": st["failover_ms"], "failovers": st["failovers"],
         "migrated": st["migrated"], "resubmitted": st["resubmitted"],
         "lost_requests": st["lost_requests"], "replicas": {}}
    for name, h in router.replicas.items():
        a["replicas"][name] = _replica_checks(checks, "(a)", name, h.engine,
                                              counts[name], L)
    checks["(a) one failover, every request placed, none lost"] = \
        st["failovers"] == 1 and st["migrated"] >= 1 \
        and st["lost_requests"] == 0 and len(outs) == len(prompts)
    checks["(a) survivor's pool empty"] = \
        router.replicas["r1"].engine.allocator.used_blocks == 0
    a["agreement_with_one_replica"] = _agreement(gens, base_gens)
    a["first_divergence"] = _first_divergence(gens, base_gens)
    a["divergence_gaps"] = _divergence_gaps(eng, prompts, gens, base_gens,
                                            drift)
    out["a"] = a
    log(f"phase 17 (a) failover [{smi}] " + json.dumps(a))
    del router
    _free()
    # (b) disaggregated
    t = [0.0]
    router = _fleet_router(tempfile.mkdtemp(prefix="phase17b_"), t)
    pre = ServingEngine(eng, ServingConfig(**FLEET_SERVING, role="prefill"))
    dec = ServingEngine(eng, ServingConfig(**FLEET_SERVING, role="decode"))
    counts = {"pre0": {}, "dec0": {}}
    _count_rounds(router.register("pre0", pre), counts["pre0"])
    _count_rounds(router.register("dec0", dec), counts["dec0"])
    costs = {"export_ms": [], "crc_ms": [], "import_ms": []}
    export, kv_import = pre.export_kv, dec._dispatch_kv_import

    def timed_export(rids):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = export(rids)            # gather, copy to the host, crc32
        costs["export_ms"].append((time.perf_counter() - t0) * 1e3)
        for payload in got.values():
            t1 = time.perf_counter()
            kv_payload_crc(payload["data"])
            costs["crc_ms"].append((time.perf_counter() - t1) * 1e3)
        return got

    def timed_import(req):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kv_import(req)                # copy to the card, scatter
        torch.cuda.synchronize()
        costs["import_ms"].append((time.perf_counter() - t0) * 1e3)

    pre.export_kv, dec._dispatch_kv_import = timed_export, timed_import
    drive = {}
    outs, rounds, wall = _fleet_drive(router, load, t, drive)
    _rounds_hold_all(checks, "(b)", drive, counts)
    for k, v in drive.items():
        launches[k] = launches.get(k, 0) + v
    gens = [outs[i] for i in range(len(prompts))]
    _check_generated("phase 17 (b)", gens, 32)
    st = router.stats()
    b = {**_fleet_latency(router, outs, wall), "rounds": rounds,
         "handoffs": st["handoffs"], "handoff_bytes": st["handoff_bytes"],
         "handoff_fallbacks": st["handoff_fallbacks"],
         "handoff_ms": st["handoff_ms"],
         "bytes_per_handoff": st["handoff_bytes"] / max(1, st["handoffs"]),
         **{k: {"p50": float(np.percentile(v, 50)),
                "max": float(np.max(v))} for k, v in costs.items() if v},
         "replicas": {}}
    for name, srv in (("pre0", pre), ("dec0", dec)):
        b["replicas"][name] = _replica_checks(checks, "(b)", name, srv,
                                              counts[name], L)
    checks["(b) prefill replica: paged_decode == 0"] = \
        counts["pre0"].get("paged_decode", 0) == 0
    checks["(b) prefill replica: flash_fwd == L x 24"] = \
        counts["pre0"].get("flash_fwd", 0) == L * len(prompts)
    checks["(b) decode replica: flash_fwd == L x fallbacks"] = \
        counts["dec0"].get("flash_fwd", 0) == L * st["handoff_fallbacks"]
    checks["(b) every request handed off, none lost"] = \
        st["handoffs"] == len(prompts) and st["lost_requests"] == 0
    b["agreement_with_one_replica"] = _agreement(gens, base_gens)
    out["b"] = b
    log(f"phase 17 (b) disaggregated [{smi}] " + json.dumps(b))
    del router, pre, dec
    _free()
    return out


def _recovery_peak(eng, prompts, checks):
    """A round failure at llama-7b width: a replica's 8 requests are
    prefilled, their round's decode dispatch fails, the engine recovers
    and re-prefills. The card's peak over the recovery alone, above what
    it held before, against one pool's bytes: a second pool would show
    as a whole pool."""
    from deepspeed_tpu_torch.inference import ServingConfig, ServingEngine
    from deepspeed_tpu_torch.robustness import faults
    srv = ServingEngine(eng, ServingConfig(**FLEET_SERVING))
    recover, seen = srv._recover, {}

    def measured(reason):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ok = recover(reason)
        torch.cuda.synchronize()
        seen["extra_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
        return ok
    srv._recover = measured
    load = [(p, 16) for p in prompts[:8]]
    faults.install(faults.FaultInjector(faults.FaultSchedule(
        [{"kind": "decode_dispatch", "at": 0}], seed=0)))
    try:
        outs = srv.run(load)
    finally:
        faults.clear()
    _check_generated("phase 17 recovery", [
        outs[k][len(p):] for k, (p, _) in zip(sorted(outs), load)], 16)
    st = srv.stats()
    rec = {"pool_gib": srv.pool_bytes / 2**30,
           "extra_gib": seen.get("extra_gib"),
           "recoveries": st["recoveries"], "recovery_ms": st["recovery_ms"]}
    checks["full-width recovery: one, and no second pool"] = \
        st["recoveries"] == 1 and rec["extra_gib"] is not None \
        and rec["extra_gib"] < 0.05 * rec["pool_gib"]
    del srv, recover
    _free()
    return rec


def _f32_fleet_engine():
    from deepspeed_tpu_torch import llama_config, make_model
    from deepspeed_tpu_torch.inference import init_inference
    cfg = llama_config("7b", num_layers=FLEET_F32_LAYERS,
                       dtype=torch.float32)
    return init_inference(make_model(cfg, "llama-7b"),
                          config={"kv_cache_bits": 0, "max_tokens": 2048},
                          dtype=torch.float32, seed=0)


def fleet_f32(smi, prompts, checks, launches):
    """(c) the fault soak, (d) tracing on / off and (e) the autoscaler,
    f32 at llama-7b width and 2 layers, every replica over one copy of
    the weights; every stream against a fault-free single replica's.
    The drives' launches are added to ``launches``."""
    import tempfile
    from deepspeed_tpu_torch.inference import (ServingConfig, ServingEngine,
                                               FleetConfig, FleetController)
    from deepspeed_tpu_torch.robustness import events as rb_events
    from deepspeed_tpu_torch.robustness import faults
    from deepspeed_tpu_torch.robustness.preemption import PreemptionHandler
    from deepspeed_tpu_torch.telemetry import (merge_chrome_trace,
                                               parse_exposition)
    n, new = FLEET_F32_LOAD
    load = [(p, new) for p in prompts[:n]]
    eng = _f32_fleet_engine()
    cfg = dict(BREADTH_SERVING, max_seqs=4, max_queue=4)
    base = ServingEngine(eng, ServingConfig(**dict(cfg, max_seqs=16,
                                                   max_queue=None)))
    want = base.run(load)
    want = [want[k][len(p):] for k, (p, _) in zip(sorted(want), load)]
    del base
    out = {}
    # (c) every serving, router and handoff kind
    t = [0.0]
    tmp = tempfile.mkdtemp(prefix="phase17c_")
    router = _fleet_router(tmp, t)
    # a short quantum: more rounds for the schedule to land in
    soak = dict(cfg, decode_quantum=2, dispatch_timeout_s=2.0)
    engines = {
        "pre0": ServingEngine(eng, ServingConfig(**soak, role="prefill")),
        "dec0": ServingEngine(eng, ServingConfig(**soak, role="decode")),
        "both0": ServingEngine(eng, ServingConfig(**soak)),
        "both1": ServingEngine(eng, ServingConfig(**soak))}
    handler = PreemptionHandler().install()
    for name, srv in engines.items():
        router.register(name, srv,
                        preemption=handler if name == "both0" else None)
    schedule = [
        {"kind": "heartbeat_loss", "at": 2, "replica": 3, "times": 3},
        {"kind": "router_partition", "at": 4, "replica": 1, "times": 2},
        {"kind": "replica_kill", "at": 9, "replica": 3},
        {"kind": "decode_dispatch", "at": 3},
        {"kind": "decode_dispatch", "at": 11, "mode": "hang",
         "hang_s": 3.0},
        {"kind": "pool_exhaust", "at": 5, "times": 3, "keep": 0},
        {"kind": "backend_fault", "at": 14},
        {"kind": "preempt", "round": 20},
        {"kind": "kv_handoff", "at": 0, "mode": "corrupt"},
        {"kind": "kv_handoff", "at": 2}]
    inj = faults.install(faults.FaultInjector(faults.FaultSchedule(
        schedule, seed=0)))
    try:
        outs, rounds, wall = _fleet_drive(router, load, t, launches)
    finally:
        faults.clear()
        handler.restore()
    gens = [outs[i] for i in range(n)]
    fired = [f["kind"] for f in inj.fired]
    st = router.stats()
    injected = sum(k in ("decode_dispatch", "backend_fault") for k in fired)
    recoveries = sum(s.stats()["recoveries"] for s in engines.values())
    c = {"rounds": rounds, "wall_s": wall, "fired": fired,
         "recoveries": recoveries, "injected_round_failures": injected,
         "degraded": sum(s.stats()["degraded"] for s in engines.values()),
         **{k: st[k] for k in ("failovers", "migrated", "resubmitted",
                               "lost_requests", "handoffs",
                               "handoff_fallbacks", "dispatch_faults")},
         "breaker_episodes": sorted({e["reason"] for e in
                                     rb_events.history("replica_degraded")})}
    checks["(c) every kind fired"] = set(fired) == {
        "heartbeat_loss", "router_partition", "replica_kill",
        "decode_dispatch", "pool_exhaust", "backend_fault", "preempt",
        "kv_handoff"}
    checks["(c) every stream token-identical to one replica"] = \
        all(np.array_equal(a, b) for a, b in zip(gens, want)) \
        and len(outs) == n
    checks["(c) recoveries == injected round failures"] = \
        recoveries == injected > 0
    checks["(c) degraded == 0, no backend_degraded"] = \
        c["degraded"] == 0 and not rb_events.history("backend_degraded")
    checks["(c) none lost"] = st["lost_requests"] == 0
    checks["(c) the two deaths failed over"] = st["failovers"] == 2
    out["c"] = c
    log(f"phase 17 (c) f32 fault soak [{smi}] " + json.dumps(c))
    for srv in engines.values():
        srv.close(timeout=10)
    del router, engines
    _free()
    # (d) tracing on and off on the same engines
    t = [0.0]
    tmp = tempfile.mkdtemp(prefix="phase17d_")
    router = _fleet_router(tmp, t)
    pair = [ServingEngine(eng, ServingConfig(**cfg)) for _ in range(2)]
    for i, srv in enumerate(pair):
        router.register(f"r{i}", srv)
    plain, _, plain_s = _fleet_drive(router, load, t, launches)
    for i, srv in enumerate(pair):
        srv.enable_request_trace(replica=f"r{i}")
    traced, _, traced_s = _fleet_drive(router, load, t, launches)
    path = os.path.join(tmp, "fleet_trace.json")
    merge_chrome_trace([s.export_trace() for s in pair], path=path)
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    ids = {e["args"]["trace"] for e in trace if e["ph"] != "M"}
    parsed = parse_exposition(router.exposition())
    d = {"untraced_s": plain_s, "traced_s": traced_s,
         "trace_events": len(trace), "trace_ids": len(ids),
         "device_syncs": sum(s.tracer.device_syncs for s in pair),
         "exposition_completed": parsed.get("dstpu_fleet_completed"),
         "recoveries": sum(s.stats()["recoveries"] for s in pair)}
    checks["(d) traced streams == untraced == one replica"] = all(
        np.array_equal(plain[i], traced[i + n]) and
        np.array_equal(plain[i], want[i]) for i in range(n))
    checks["(d) zero device syncs, a trace id a request"] = \
        d["device_syncs"] == 0 and d["trace_ids"] == n
    checks["(d) exposition parses back"] = \
        parsed.get("dstpu_fleet_live") == 2.0 \
        and parsed["dstpu_fleet_ttft_ms"].count \
        == router.fleet_stats()["fleet_ttft_ms"].count
    out["d"] = d
    log(f"phase 17 (d) tracing on / off [{smi}] " + json.dumps(d))
    del router, pair
    _free()
    # (e) the autoscaler's burst and lull
    t = [0.0]
    router = _fleet_router(tempfile.mkdtemp(prefix="phase17e_"), t)
    small = dict(cfg, max_seqs=2, max_queue=2)
    spawned = []

    def spawn(name, role):
        spawned.append(ServingEngine(eng, ServingConfig(**small)))
        return spawned[-1]

    first = ServingEngine(eng, ServingConfig(**small))
    router.register("r0", first)
    ctl = FleetController(router, spawn, FleetConfig(
        role="both", min_replicas=1, max_replicas=3, scale_up_load=1.0,
        scale_up_after=2, scale_down_load=0.05, scale_down_after=2,
        cooldown_ticks=1))
    outs, rounds, wall = _fleet_drive(router, load, t, launches,
                                      tick=ctl.tick, lull=12)
    gens = [outs[i] for i in range(n)]
    cs, st = ctl.stats(), router.stats()
    e = {"rounds": rounds, "wall_s": wall, **cs,
         "lost_requests": st["lost_requests"],
         "migrated": st["migrated"],
         "live_after_lull": router.fleet_stats()["fleet_live"],
         "recoveries": sum(s.stats()["recoveries"]
                           for s in [first] + spawned)}
    checks["(e) scaled up and back down, none lost"] = \
        cs["scale_ups"] >= 1 and cs["scale_downs"] >= 1 \
        and st["lost_requests"] == 0 and len(outs) == n \
        and e["live_after_lull"] == 1
    checks["(e) streams == one replica"] = all(
        np.array_equal(a, b) for a, b in zip(gens, want))
    out["e"] = e
    log(f"phase 17 (e) autoscaler [{smi}] " + json.dumps(e))
    for what in ("d", "e"):
        checks[f"({what}) no recovery"] = out[what]["recoveries"] == 0
    del router, first, spawned, eng
    _free()
    return out


def fleet_phase(smi: str, served, drift: float):
    """Phase 17: the fleet's host layer (router, failover, disaggregated
    roles, round recovery, tracing, autoscaler) over the port's engines,
    each replica's kernels counted in its own rounds. Returns the record
    with B1 / B4 launches by path: those of the fleet's drives only."""
    from deepspeed_tpu_torch import llama_config, make_model
    from deepspeed_tpu_torch.inference import init_inference
    from deepspeed_tpu_torch.robustness import events as rb_events
    t_phase = time.perf_counter()
    _free()
    checks = {}
    rb_events.clear()
    eng = init_inference(make_model(llama_config("7b"), "llama-7b"),
                         config={"kv_cache_bits": 0, "max_tokens": 2048},
                         dtype=torch.bfloat16, seed=0)
    bf16, f32_counts = {}, {}
    full = fleet_full_width(smi, eng, served, drift, checks, bf16)
    full["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    full["recovery"] = _recovery_peak(eng, served[0], checks)
    log(f"phase 17 full-width recovery [{smi}] "
        + json.dumps(full["recovery"]))
    for part in ("a", "b"):
        for name, r in full[part]["replicas"].items():
            checks[f"({part}) {name}: no recovery"] = \
                r["recoveries"] == 0 and r["degraded"] == 0
    del eng
    _free()
    f32 = fleet_f32(smi, served[0], checks, f32_counts)
    rec = {"card": smi, **full, **f32,
           "launches": {"fleet": {k: bf16.get(k, 0) for k in
                                  ("flash_fwd", "paged_decode")},
                        "fleet_f32": {k: f32_counts.get(k, 0) for k in
                                      ("flash_fwd", "paged_decode")}},
           "phase_s": time.perf_counter() - t_phase}
    failed = [k for k, v in checks.items() if not v]
    log(f"phase 17: {rec['phase_s']:.1f}s, launches "
        f"{json.dumps(rec['launches'])}, checks {json.dumps(checks)}")
    if failed:
        raise RuntimeError(f"phase 17: failed {failed}")
    return rec


# --------------------------------------------------------------------------
# the capacity tier (phase 18)
# --------------------------------------------------------------------------

CAPACITY_STEPS = 3                   # 1 + 2
CAPACITY_LAYERS = 4                  # llama-1b's width, 4 of its 16 layers
# the nvme tier's directory: inside the checkout, gitignored, emptied after
CAPACITY_SCRATCH = "offload_scratch"
CAPACITY_F32 = dict(layers=2, S=512, B=2, steps=2)


def _filesystem(path):
    """(type, mount point, free bytes) of the filesystem holding ``path``
    (the longest mount point of /proc/mounts that contains it)."""
    real, best = os.path.realpath(path), ("?", "/")
    with open("/proc/mounts") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            mnt = parts[1].replace("\\040", " ")
            inside = real == mnt or real.startswith(mnt.rstrip("/") + "/")
            if inside and len(mnt) >= len(best[1]):
                best = (parts[2], mnt)
    return best[0], best[1], shutil.disk_usage(path).free


def _capacity_configs(path, base, eps=None):
    """The on-device run and routes (i)-(iv), each on ``base``."""
    opt = dict(base["optimizer"])
    if eps is not None:
        opt = {"type": opt["type"], "params": dict(opt["params"], eps=eps)}
    base = dict(base, optimizer=opt)

    def swap(**kw):
        return dict(base, zero_optimization={"stage": 1,
                                             "offload_optimizer": kw})
    nvme = {"device": "nvme", "nvme_path": path}
    return {"on_device": base,
            "(i) pinned": swap(device="cpu"),
            "(ii) cpu_adam": swap(device="cpu", use_cpu_adam=True),
            "(iii) nvme": swap(**nvme),
            "(iv) infinity": dict(base, zero_optimization={
                "stage": 3, "offload_param": nvme,
                "offload_optimizer": nvme})}


def _seeded_params(cfg, seed=0):
    """The on-device engine's seeded f32 init (``Engine._init_state``'s
    draw), as a JAX-layout tree of numpy arrays."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = cfg_model(cfg).init(gen, torch.device("cuda"), dtype=torch.float32)
    out = {k: v.cpu().numpy() for k, v in p.items() if k != "layers"}
    out["layers"] = {k: v.cpu().numpy() for k, v in p["layers"].items()}
    return out


def cfg_model(cfg, name="llama-1b"):
    from deepspeed_tpu_torch import make_model
    return make_model(cfg, name)


def _capacity_run(name, cfg, config, batches, params=None,
                  after_step=None):
    """``initialize`` -> ``train_batch`` over ``batches`` with the launch
    counts zeroed just before the steps (the host libraries' calls just
    before the engine is built); returns (engine, record)."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.ops import _build, host_build
    _free()
    host_build.reset_call_counts()
    t0 = time.perf_counter()
    engine = initialize(model=cfg_model(cfg), config=dict(config),
                        params=params)[0]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()      # the steps' peak
    _build.reset_launch_counts()
    losses, step_ms = [], []
    for b in batches:
        t1 = time.perf_counter()
        losses.append(float(engine.train_batch(b)["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        if after_step is not None:
            after_step(engine)
    rec = {"init_s": init_s, "step_ms": step_ms, "losses": losses,
           "launches": {k: v for k, v in _build.launch_counts().items()
                        if k in FLASH_KERNELS},
           "host_calls": {k: v for k, v in host_build.call_counts().items()
                          if v},
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "bytes": engine.offload_bytes()}
    mark_part(f"capacity run {name}")
    return engine, rec


def _capacity_laws(route, engine, n):
    """The bytes of state by tier the config says: 2 a param of bf16
    params and 12 of f32 masters, m and v, each where its route keeps it
    (the swappers' chunks padded to whole chunks)."""
    law = {"device": 14 * n, "host": 0, "disk": 0}
    if route in ("(i) pinned", "(iii) nvme"):
        sw = engine._swapper
        law = {"device": 2 * n, "host": 0, "disk": 0}
        law["host" if route == "(i) pinned" else "disk"] = \
            12 * sw.n_chunks * sw.chunk
    elif route == "(ii) cpu_adam":
        law = {"device": 2 * n, "host": 12 * n, "disk": 0}
    elif route == "(iv) infinity":
        ex = engine._infinity
        nl = sum(t.numel() for t in ex.nl_params.values())
        cached = min(ex.cfg.num_layers, ex._cache_layers)
        law = {"device": 14 * nl, "host": cached * 2 * ex.chunk,
               "disk": ex.cfg.num_layers * 14 * ex.chunk}
    return law


def _capacity_io(route, engine, rec, steps):
    """The host libraries' calls against what the route must have made:
    the fused update once a step, and every chunk read and written once a
    step (the swapper's first writes at init; the executor's layer chunks
    by its cache rule)."""
    calls, checks = rec["host_calls"], {}
    if route == "(ii) cpu_adam":
        checks["cpu_adam_calls"] = (
            calls.get("dstpu_adam_step_bf16", 0) == steps
            and calls.get("dstpu_sq_norm_bf16", 0) == steps)
    if route == "(iii) nvme":
        n = engine._swapper.n_chunks
        checks["aio_preads"] = calls.get("dstpu_aio_pread", 0) == n * steps
        checks["aio_pwrites"] = \
            calls.get("dstpu_aio_pwrite", 0) == n * (steps + 1)
    if route == "(iv) infinity":
        ex = engine._infinity
        L, c = ex.cfg.num_layers, min(ex.cfg.num_layers, ex._cache_layers)
        want = {"opt_read": L * (steps - 1), "opt_write": L * steps,
                "param_write": L * (steps + 1),
                # step 1's forward reads every layer; each sweep after
                # that (the backward, the update, and each later step's
                # forward) reads the L - c layers the cache does not hold
                "param_read": L + 2 * (L - c) + 3 * (L - c) * (steps - 1)}
        rec["store_io"], rec["store_io_want"] = dict(ex.store.io), want
        checks["store_io"] = ex.store.io == want
        checks["aio_preads"] = calls.get("dstpu_aio_pread", 0) == \
            want["opt_read"] + want["param_read"]
        checks["aio_pwrites"] = calls.get("dstpu_aio_pwrite", 0) == \
            want["opt_write"] + want["param_write"]
    return checks


def _round_layers(engine):
    """The on-device reference of the layer executor: after each update
    the layers' params are rounded to bf16, as its store keeps them (the
    f32 masters carry the precision)."""
    with torch.no_grad():
        for t in engine.state["params"]["layers"].values():
            t.copy_(t.to(torch.bfloat16).float())


def _masters_of(engine):
    """Every f32 master of an engine, flat in the leaf order (the layer
    executor's: layer by layer, each layer's leaves in sorted order; the
    others: the param tree's)."""
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    if engine._infinity is not None:
        ex = engine._infinity
        n = ex.layer_params
        layers = [ex.store.read("opt", i)[0][:n].float()
                  for i in range(ex.cfg.num_layers)]
        return torch.cat(layers + [ex.nl_opt[k]["master"].cpu().ravel()
                                   for k in sorted(ex.nl_opt)])
    if engine._swapper is not None:
        st = engine._swapper.export_state()
        if "master" in st:
            return torch.from_numpy(st["master"])
        flat = np.concatenate([st[f"chunk_{i}"][0] for i in range(len(st))])
        return torch.from_numpy(flat[:engine._swapper.num_params])
    opt = engine.state["opt"]
    masters = opt.get("master") or engine.state["params"]
    return torch.cat([t.detach().float().cpu().ravel()
                      for t in tree_leaves(masters)])


def _executor_order(engine):
    """The on-device masters in the layer executor's order."""
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    m = engine.state["opt"]["master"]
    names = sorted(m["layers"])
    L = m["layers"][names[0]].shape[0]
    parts = [m["layers"][n][i].reshape(-1) for i in range(L) for n in names]
    parts += [m[k].reshape(-1) for k in sorted(m) if k != "layers"]
    return torch.cat([p.detach().float().cpu() for p in parts])


def capacity_f32_checks(path, checks):
    """Phase 18 (c): llama-1b width at 2 layers in f32, 2 steps of each
    route (and the host CPU-Adagrad beside the on-device Adagrad) against
    the on-device run (the layer executor's with its layers rounded to
    bf16 after each update): every master within 1e-6 relative L2; then a save under (iii) and (iv), one more step, and a fresh
    engine that loads the tag and takes that step: the same loss and
    masters bit for bit."""
    from deepspeed_tpu_torch import llama_config
    k = CAPACITY_F32
    cfg = llama_config("1b", num_layers=k["layers"], max_seq_len=k["S"],
                       dtype=torch.float32, remat=True,
                       remat_policy="dots_saveable")
    base = dict(TRAIN_CONFIG, train_batch_size=k["B"],
                bf16={"enabled": False})
    params = _seeded_params(cfg)
    params["layers"] = {n: torch.from_numpy(v).to(torch.bfloat16).float()
                        .numpy() for n, v in params["layers"].items()}
    rng = np.random.default_rng(3)
    batches = [{"input_ids": torch.from_numpy(rng.integers(
        0, VOCAB, (k["B"], k["S"]), dtype=np.int32)).cuda()}
        for _ in range(4)]
    confs = _capacity_configs(path, base, eps=1e-3)
    adagrad = {"type": "adagrad", "params": {"lr": 1e-3, "eps": 1e-3}}
    confs["(ii) cpu_adagrad"] = dict(confs["(ii) cpu_adam"],
                                     optimizer=adagrad)
    ref = {}
    for name, conf in (("swap", confs["on_device"]),
                       ("adagrad", dict(confs["on_device"],
                                        optimizer=adagrad))):
        plain = _capacity_run(f"f32 on_device {name}", cfg, conf,
                              batches[:k["steps"]], params=params)[0]
        ref[name] = _masters_of(plain)
        del plain
    rounded_conf = dict(confs["on_device"], optimizer={
        "type": "adamw", "params": dict(confs["on_device"]["optimizer"]
                                        ["params"], use_master_weights=True)})
    plain = _capacity_run("f32 on_device bf16 layers", cfg, rounded_conf,
                          batches[:k["steps"]], params=params,
                          after_step=_round_layers)[0]
    ref["infinity"] = _executor_order(plain)
    del plain
    out = {}
    for route in ("(i) pinned", "(ii) cpu_adam", "(ii) cpu_adagrad",
                  "(iii) nvme", "(iv) infinity"):
        eng, rec = _capacity_run(f"f32 {route}", cfg, confs[route],
                                 batches[:k["steps"]], params=params)
        want = ref[{"(iv) infinity": "infinity",
                    "(ii) cpu_adagrad": "adagrad"}.get(route, "swap")]
        err = rel_l2(_masters_of(eng), want)
        out[route] = {"masters_rel_l2": err, "losses": rec["losses"],
                      "host_calls": rec["host_calls"]}
        checks[f"f32 {route} masters"] = err <= 1e-6
        fn = {"(ii) cpu_adam": "dstpu_adam_step_f32",
              "(ii) cpu_adagrad": "dstpu_adagrad_step_f32"}.get(route)
        if fn:
            checks[f"f32 {route} host calls"] = \
                rec["host_calls"].get(fn, 0) == k["steps"]
        if route in ("(iii) nvme", "(iv) infinity"):
            ck = os.path.join(path, "ckpt")
            eng.save_checkpoint(ck, tag="t")
            want_loss = float(eng.train_batch(batches[3])["loss"])
            want_m = _masters_of(eng)
            eng.close()
            fresh = _capacity_run(f"f32 {route} resumed", cfg,
                                  confs[route], [], params=params)[0]
            fresh.load_checkpoint(ck)
            got_loss = float(fresh.train_batch(batches[3])["loss"])
            same = got_loss == want_loss and torch.equal(
                _masters_of(fresh), want_m)
            out[route]["resume_bit_for_bit"] = same
            mark_part(f"f32 {route} save, step, load, step")
            checks[f"f32 {route} resume"] = same
            fresh.close()
            shutil.rmtree(ck, ignore_errors=True)
        else:
            eng.close()
        del eng
    log("phase 18 (c) f32 2 layers " + json.dumps(out))
    return out


def capacity_phase(smi: str):
    """Phase 18: the capacity tier. (a) the host libraries built from
    ``deepspeed_tpu_torch/csrc/host/`` with their g++ flags, and the fused
    CPU-Adam's host traffic over the model's values (after (b)'s route
    (ii), on its buffers). (b) llama-1b at full width, 4 of its 16
    layers (the run's time limit cuts depth, never width), B=8
    S=2048 bf16, 1 + 2 steps on the on-device run and then routes (i)
    chunk-streamed pinned tier, (ii) host CPU-Adam, (iii) the nvme swap,
    (iv) ZeRO-Infinity layer streaming (nvme), each from the on-device
    run's seeded weights: step ms, the card's peak over the steps, the state's bytes on
    the card / host / disk against the config's law, losses within 2e-2
    of the on-device run's, B1 = 2 x L x steps and B2 = B3 = L x steps,
    the host libraries' calls and the files' reads and writes against
    their counts, io_uring or the thread pool; the peak below the on-device
    run's by the optimizer state's bytes under (i)-(iii) and lower still
    under (iv). (c) ``capacity_f32_checks``. The nvme tier writes into
    ``offload_scratch/`` inside the checkout (its free space and
    filesystem type printed first), deleted after the phase."""
    from deepspeed_tpu_torch import llama_config
    from deepspeed_tpu_torch.ops import aio, host_build
    from deepspeed_tpu_torch.ops.cpu_adam import adam_step_flat
    t_phase = time.perf_counter()
    checks, rec = {}, {"card": smi}
    root = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(root, CAPACITY_SCRATCH)
    os.makedirs(path, exist_ok=True)
    fs, mnt, free = _filesystem(path)
    rec["disk"] = {"path": path, "fs": fs, "mount": mnt, "free_bytes": free,
                   "tmpfs": fs == "tmpfs"}
    log("phase 18 disk " + json.dumps(rec["disk"]))
    # (a) the host libraries
    t0 = time.perf_counter()
    libs = host_build.build_all(force=True)
    rec["build"] = {"seconds": time.perf_counter() - t0,
                    "flags": {n: [host_build.CXX] + lib.flags
                              for n, lib in host_build.LIBRARIES.items()},
                    "libraries": {n: str(p) for n, p in libs.items()},
                    "uses_io_uring": aio.uses_io_uring()}
    log("phase 18 (a) host build " + json.dumps(rec["build"]))
    # (b) the cell
    S, L = 2048, CAPACITY_LAYERS
    cfg = llama_config("1b", num_layers=L, max_seq_len=S, remat=True,
                       remat_policy="dots_saveable", loss_chunk=S)
    params = _seeded_params(cfg, TRAIN_CONFIG["seed"])
    n = sum(a.size for k, a in params.items() if k != "layers") + sum(
        a.size for a in params["layers"].values())
    ids = np.random.default_rng(0).integers(0, VOCAB, (8, S), dtype=np.int32)
    batches = [{"input_ids": torch.from_numpy(ids).cuda()}] * CAPACITY_STEPS
    want_launch = {"flash_fwd": 2 * L * CAPACITY_STEPS,
                   "flash_bwd_dq": L * CAPACITY_STEPS,
                   "flash_bwd_dkv": L * CAPACITY_STEPS}
    runs, launches = {}, {k: 0 for k in FLASH_KERNELS}
    for route, conf in _capacity_configs(path, TRAIN_CONFIG).items():
        t_route = time.perf_counter()
        eng, r = _capacity_run(route, cfg, conf, batches, params=params)
        r["law"] = _capacity_laws(route, eng, n)
        checks[f"{route} bytes"] = r["bytes"] == r["law"]
        checks[f"{route} launches"] = r["launches"] == want_launch
        checks.update({f"{route} {k}": v for k, v in
                       _capacity_io(route, eng, r, CAPACITY_STEPS).items()})
        for k in FLASH_KERNELS:
            launches[k] += r["launches"][k]
        if route == "(ii) cpu_adam":
            cpu = eng._swapper.cpu
            t1 = time.perf_counter()
            adam_step_flat(cpu.master, cpu.m, cpu.v, eng._swapper._gbuf,
                           step_num=CAPACITY_STEPS + 1, lr=1e-4,
                           out=eng._swapper._pbuf)
            sec = time.perf_counter() - t1
            traffic = n * (12 + 12 + 2 + 2)
            rec["cpu_adam_sweep"] = {
                "values": n, "ms": sec * 1e3, "host_bytes": traffic,
                "host_GBps": traffic / sec / 1e9,
                "threads": torch.get_num_threads()}
            log("phase 18 (a) cpu_adam sweep " +
                json.dumps(rec["cpu_adam_sweep"]))
        eng.close()
        del eng
        if hasattr(torch._C, "_host_emptyCache"):
            torch._C._host_emptyCache()
        r["route_s"] = time.perf_counter() - t_route
        runs[route] = r
        log(f"phase 18 (b) {route} " + json.dumps(r))
    dev = runs["on_device"]
    opt_bytes = 12 * n
    for route, r in runs.items():
        if route == "on_device":
            continue
        r["losses_rel_vs_on_device"] = [
            abs(a - b) / abs(b) for a, b in zip(r["losses"], dev["losses"])]
        checks[f"{route} losses"] = max(r["losses_rel_vs_on_device"]) <= 2e-2
        drop = (dev["peak_mem_gib"] - r["peak_mem_gib"]) * 2 ** 30
        r["peak_drop_bytes"] = drop
        checks[f"{route} peak"] = drop >= opt_bytes
    checks["(iv) below (i)-(iii)"] = runs["(iv) infinity"]["peak_mem_gib"] < \
        min(runs[r]["peak_mem_gib"] for r in runs
            if r not in ("on_device", "(iv) infinity"))
    rec["routes"] = runs
    t_f32 = time.perf_counter()
    rec["f32"] = capacity_f32_checks(path, checks)
    rec["f32_s"] = time.perf_counter() - t_f32
    shutil.rmtree(path, ignore_errors=True)
    rec["launches"] = launches
    rec["phase_s"] = time.perf_counter() - t_phase
    failed = [k for k, v in checks.items() if not v]
    log(f"phase 18: {rec['phase_s']:.1f}s, launches {json.dumps(launches)}, "
        f"checks {json.dumps(checks)}")
    if failed:
        raise RuntimeError(f"phase 18: failed {failed}")
    return rec


# --------------------------------------------------------------------------
# model-parallel training (phase 19)
# --------------------------------------------------------------------------

MP_SEQ = 2048
MOE_STEPS = 3             # after 1 warm-up step
MP_STEPS = 1              # the two-rank runs, after 1 warm-up step
TP_LAYERS = 4             # llama-7b width, cut to 4 of its 32 layers
MOE_CONFIG = {"train_batch_size": 2,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-4}},
              "bf16": {"enabled": True},
              "transformer": {"fused_backward": True}, "seed": 0}
MP_F32 = dict(max_seq_len=512, dtype=torch.float32)       # at 2 layers
MP_F32_STEPS = 2          # each run of an f32 identity (phases 19, 20)
# SGD with momentum for the f32 identities: linear in the grads, so runs
# that sum their grads in another order agree to rounding, where Adam's
# first steps (nearly the grads' signs) flip elements whose grad is 0 to
# within rounding
MP_SGD = {"type": "sgd", "params": {"lr": 1e-2, "momentum": 0.9}}
MP_F32_CONFIG = {"train_batch_size": 2, "optimizer": MP_SGD,
                 "bf16": {"enabled": False}, "seed": 0}
EP2 = {"moe": {"enabled": True, "expert_parallel_size": 2}}
TP2 = {"tensor_parallel": {"tp_size": 2}}


def _mixtral_train(layers, **over):
    from deepspeed_tpu_torch.models.transformer import mixtral_config
    kw = dict(num_layers=layers, max_seq_len=MP_SEQ, remat=True,
              remat_policy="dots_saveable", loss_chunk=MP_SEQ,
              moe_aux_loss_weight=0.01)
    kw.update(over)
    return mixtral_config("8x7b", **kw)


def _llama7b_train(layers, **over):
    from deepspeed_tpu_torch import llama_config
    kw = dict(num_layers=layers, max_seq_len=MP_SEQ, remat=True,
              remat_policy="dots_saveable", loss_chunk=MP_SEQ)
    kw.update(over)
    return llama_config("7b", **kw)


def active_params(cfg) -> int:
    """The params a token's forward multiplies by: attention, the gate,
    top_k of the experts' FFNs, and the head (the embedding is a
    lookup)."""
    H, hd = cfg.hidden_size, cfg.dim_per_head
    attn = H * cfg.num_heads * hd * 2 + H * cfg.kv_heads * hd * 2
    ffn = 3 * H * cfg.ffn_dim * (cfg.top_k if cfg.num_experts > 1 else 1)
    gate = H * cfg.num_experts if cfg.num_experts > 1 else 0
    return cfg.num_layers * (attn + ffn + gate) + H * cfg.vocab_size


def _routing(engine, batch):
    """Each MoE layer's aux loss and dropped fraction on ``batch`` with
    the training capacity (one pass without a graph)."""
    from deepspeed_tpu_torch.moe import record_routing
    from deepspeed_tpu_torch.parallel import parallel_context
    with torch.no_grad(), parallel_context(engine.mesh), \
            record_routing() as rec:
        engine.model.loss_fn(engine.params, batch, train=True)
    return [{k: float(v) for k, v in r.items()} for r in rec]


def moe_cell(smi: str):
    """(a) Mixtral 8x7b at full width, 2 of its 32 layers, one card:
    bf16 with f32 masters, AdamW, B=2, S=2048, dots_saveable, aux weight
    0.01, no gate noise, capacity ceil(4096 / 8 x 1.25) = 640."""
    cfg = _mixtral_train(2)
    engine, batch, rec = _train(cfg, "mixtral-8x7b 2 layers", MOE_CONFIG,
                                MOE_STEPS)
    n, L = MOE_STEPS, cfg.num_layers
    B, S = MOE_CONFIG["train_batch_size"], MP_SEQ
    n_active = active_params(cfg)
    flops_per_token = 6.0 * n_active + 12.0 * L * cfg.hidden_size * S
    rec.update(
        card=smi, n_active=n_active,
        mfu_active=rec["tokens_per_s"] * flops_per_token
        / PEAK_FLOPS[torch.bfloat16],
        mfu_formula="tok/s x (6 N_active + 12 L H S) / 989e12",
        capacity=int(np.ceil(B * S / cfg.num_experts
                             * cfg.capacity_factor)),
        routing=_routing(engine, batch))
    del rec["mfu"]          # over all params: not the MoE's work
    log(f"phase 19 (a) MoE training [{smi}] " + json.dumps(rec))
    _check_run("phase 19 (a)", rec, {"flash_bwd_dq": n * L,
                                     "flash_bwd_dkv": n * L,
                                     "flash_fwd": 2 * n * L})
    del engine, batch
    _free()
    return rec


def _leaf_bytes(cfg, halved, itemsize):
    """A rank's bytes of a tree of ``cfg``'s leaves at ``itemsize`` a
    value: the leaves ``halved(path)`` names cut in two, the rest whole."""
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod
    from deepspeed_tpu_torch.models.transformer import init_params
    meta = init_params(cfg, None, "meta", dtype=torch.float32)
    return sum(t.numel() // (2 if halved(k) else 1) * itemsize
               for k, t in ckpt_mod.flatten(meta).items())


def _mp_run(cfg, config, batches, name, mesh=None, logged=False,
            params=None):
    """initialize -> one train_batch a batch (the first a warm-up): the
    losses, each step's wall ms, this rank's launches (zeroed after the
    warm-up), bytes and peak memory. ``mesh``: the engine's (None: the
    plan of the config over the process group). ``logged``: the comms
    logger and the facade's counts are zeroed after the warm-up too, and
    the record carries both (``logger``). ``params``: a whole tree to
    start from instead of the seeded init (each rank takes its slice)."""
    from deepspeed_tpu_torch import initialize, make_model
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops import _build
    torch.cuda.reset_peak_memory_stats()
    engine, *_ = initialize(model=make_model(cfg, name), config=dict(config),
                            mesh=mesh, params=params)
    losses = [float(engine.train_batch(batches[0])["loss"])]
    _build.reset_launch_counts()
    if logged:
        comm.comms_logger.reset()
        comm.reset_counts()
    step_ms = []
    for b in batches[1:]:
        t1 = time.perf_counter()
        losses.append(float(engine.train_batch(b)["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    rec = {"losses": losses, "step_ms_wall": step_ms,
           "launches": _build.launch_counts(), "bytes": _zero_bytes(engine),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "plan": engine.plan.describe()}
    if logged:
        rec["logger"] = {"summary": comm.comms_logger.summary(),
                         "counts": dict(comm.comms_logger.counts),
                         "bytes": dict(comm.comms_logger.bytes),
                         "facade": comm.counts()}
    mark_part(f"run {name} {rec['plan']} {len(batches)} steps")
    return engine, rec


def _f32_identity(rank, cfg, config, batches, name, params=None):
    """(d) An f32 run of one step a batch over the ranks, then on rank 0
    the same run at world 1 (``single_mesh``, the whole batch): the
    losses of both, the largest loss difference and the params' relative
    L2 (the ranks' params made whole on the card first). ``params``: the
    whole tree both runs start from (None: the seeded init)."""
    from deepspeed_tpu_torch.parallel import single_mesh
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}

    def start():
        # a fresh copy a run: an engine trains a whole leaf of the tree it
        # was given in place (only a sliced leaf is a copy)
        return None if params is None else clone(params)
    engine, rec = _mp_run(cfg, config, batches, name, params=start())
    whole = _zero_whole_params(engine, "cuda")
    del engine
    if rank:
        del whole
        _free()
        return None
    _free()
    engine, one = _mp_run(cfg, {k: v for k, v in config.items()
                                if k not in ("moe", "tensor_parallel",
                                             "pipeline", "sequence_parallel")},
                          batches, name, mesh=single_mesh(),
                          params=start())
    # leaf by leaf on the card, in f32 (the leaves reach 0.94 B values)
    err = 0.0
    for k, t in ckpt_mod.flatten(engine.state["params"]).items():
        want = t.detach().float()
        err = max(err, float(torch.linalg.vector_norm(whole.pop(k) - want)
                             / torch.linalg.vector_norm(want)))
    del engine
    _free()
    return {"losses": rec["losses"], "losses_world1": one["losses"],
            "plan": rec["plan"],
            "loss_rel_err": max(abs(a - b) / abs(b) for a, b in
                                zip(rec["losses"], one["losses"])),
            "params_rel_l2": err}


def _mp_rank(rank, world):
    """One rank of phase 19 (b)-(d), both ranks on cuda:0 over gloo: (b)
    expert=2, (c) tensor=2 with and without the chunked row-parallel sum,
    (d) the f32 runs of the identities. Returns every rank's record (on
    rank 0)."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = {}
    # (b) Mixtral width, 1 layer, 4 experts a rank, B=1 a rank
    cfg = _mixtral_train(1)
    eb = _zero_batches(2, MP_SEQ, 1 + MP_STEPS, seed=0)
    engine, rec["ep2"] = _mp_run(cfg, dict(MOE_CONFIG, **EP2), eb,
                                 "mixtral-8x7b 1 layer")
    del engine
    _free()
    # (c) llama-7b width, TP_LAYERS layers, B=2 shared by the tensor ranks
    cfg = _llama7b_train(TP_LAYERS)
    tb = _zero_batches(2, MP_SEQ, 1 + MP_STEPS, seed=1)
    for chunks in (0, 4):
        engine, rec[f"tp2_chunks{chunks}"] = _mp_run(
            cfg, dict(MOE_CONFIG, transformer={
                "fused_backward": True, "tp_overlap_chunks": chunks},
                **TP2), tb, f"llama-7b {TP_LAYERS} layers")
        del engine
        _free()
    # (d) f32 at S=512: expert=2 where tokens drop (1 layer), tensor=2 (2
    # layers), each against world 1 (on rank 0)
    b32 = _zero_batches(2, MP_F32["max_seq_len"], MP_F32_STEPS, seed=2)
    rec["f32_ep2"] = _f32_identity(
        rank, _mixtral_train(1, capacity_factor=0.5, **MP_F32),
        dict(MP_F32_CONFIG, **EP2), b32, "mixtral f32")
    rec["f32_tp2"] = _f32_identity(
        rank, _llama7b_train(2, **MP_F32), dict(MP_F32_CONFIG, **TP2), b32,
        "llama-7b f32")
    out = [None] * world
    dist.all_gather_object(out, rec)
    return out if rank == 0 else None


def _moe_grads_vs_plain():
    """(d) One f32 MoE step's loss and grads at Mixtral width, 2 layers,
    S=512, B=2 (capacity 0.5: tokens drop), through the kernels and
    through their plain versions: {leaf: relative L2}, the loss pair and
    the kernels' launches."""
    from deepspeed_tpu_torch.models import transformer as tf
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod
    cfg = _mixtral_train(2, capacity_factor=0.5, **MP_F32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen, "cuda", dtype=torch.float32)
    leaves = list(ckpt_mod.flatten(params).items())
    for _, t in leaves:
        t.requires_grad_(True)
    batch = _zero_batches(2, MP_F32["max_seq_len"], 1, seed=3)[0]
    out = {}
    _build.reset_launch_counts()
    for ref in (False, True):
        loss = tf.lm_loss(params, batch, cfg, reference=ref, train=True)
        grads = torch.autograd.grad(loss, [t for _, t in leaves])
        out[ref] = (float(loss), grads)
        if not ref:
            launches = _build.launch_counts()
    errs = {k: rel_l2(g, w) for (k, _), g, w in
            zip(leaves, out[False][1], out[True][1])}
    losses = (out[False][0], out[True][0])
    del params, leaves, out
    _free()
    return errs, losses, launches


def _laws(ranks):
    """Each rank's bytes of params (bf16), f32 optimizer state (masters,
    m, v) and f32 grads against the law: at expert=2 the expert stacks
    halved; at tensor=2 the column, row and vocab leaves halved, the
    norms whole."""
    checks = {}
    ep_cfg, tp_cfg = _mixtral_train(1), _llama7b_train(TP_LAYERS)
    for what, cfg, halved in (
            ("ep2", ep_cfg, lambda k: "moe_w_" in k),
            ("tp2_chunks0", tp_cfg,
             lambda k: "norm" not in k and "ln" not in k)):
        want = {"params": _leaf_bytes(cfg, halved, 2),
                "opt": _leaf_bytes(cfg, halved, 12),
                "grads": _leaf_bytes(cfg, halved, 4)}
        for i, r in enumerate(ranks):
            checks[f"({'b' if what == 'ep2' else 'c'}) rank {i} {what} "
                   "bytes of params, opt, grads == the law"] = \
                r[what]["bytes"] == want
    return checks


def model_parallel_phase(smi: str):
    """Phase 19: MoE training at one rank, over the expert axis, and
    tensor-parallel training, with their kernel cases."""
    from deepspeed_tpu_torch import initialize, make_model
    from deepspeed_tpu_torch.parallel.launch import run_group
    t_phase = time.perf_counter()
    _free()
    bf = torch.bfloat16
    cases = {
        "moe": ("Mixtral MoE cell B=2 S=2048", 2, MP_SEQ, 32, 8, 128, bf),
        "tp2": ("llama-7b tensor=2 rank B=2 S=2048", 2, MP_SEQ, 16, 16, 128,
                bf)}
    fwd_cases = [flash_case(*c) for c in cases.values()]
    bwd_cases = [bwd_case(*c) for c in cases.values()]
    _free()
    checks = {}
    moe = moe_cell(smi)
    la = moe["launches"]
    checks["(a) B1 == 2 x steps x L, B2 == B3 == steps x L"] = \
        la["flash_fwd"] == 2 * MOE_STEPS * 2 and \
        la["flash_bwd_dq"] == la["flash_bwd_dkv"] == MOE_STEPS * 2
    checks["(a) tokens dropped are a fraction in [0, 1)"] = all(
        0 <= r["dropped_fraction"] < 1 for r in moe["routing"])
    ranks = run_group(_mp_rank, 2, timeout_s=900)
    L_tp = TP_LAYERS
    for i, r in enumerate(ranks):
        for what, L in (("ep2", 1), ("tp2_chunks0", L_tp),
                        ("tp2_chunks4", L_tp)):
            x = r[what]
            la = x["launches"]
            part = "b" if what == "ep2" else "c"
            checks[f"({part}) rank {i} {what} finite"] = \
                all(np.isfinite(x["losses"]))
            checks[f"({part}) rank {i} {what} B1 == 2 x steps x L"] = \
                la["flash_fwd"] == 2 * MP_STEPS * L
            checks[f"({part}) rank {i} {what} B2 == B3 == steps x L"] = \
                la["flash_bwd_dq"] == la["flash_bwd_dkv"] == MP_STEPS * L
        checks[f"(c) rank {i} tp_overlap_chunks 4 == 0, bit for bit"] = \
            r["tp2_chunks4"]["losses"] == r["tp2_chunks0"]["losses"]
    checks.update(_laws(ranks))
    # (d) the f32 identities (on rank 0), and the one-rank MoE step's
    # grads against the plain path
    ident = {}
    for what in ("ep2", "tp2"):
        got = ranks[0][f"f32_{what}"]
        ident[what] = got
        checks[f"(d) f32 {what} == world 1: losses 1e-5, params 1e-5"] = \
            got["loss_rel_err"] <= 1e-5 and got["params_rel_l2"] <= 1e-5
    errs, (loss_k, loss_p), la = _moe_grads_vs_plain()
    checks["(d) f32 MoE grads through the kernels within 1e-4 of the plain "
           "path"] = max(errs.values()) <= 1e-4 and \
        abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    checks["(d) f32 MoE step launched B1-B3"] = \
        la["flash_fwd"] > 0 and la["flash_bwd_dq"] > 0
    ident["moe_grads_vs_plain"] = {"max_rel_l2": max(errs.values()),
                                   "losses": [loss_k, loss_p]}
    launches = {
        "moe_training": {k: moe["launches"][k] for k in FLASH_KERNELS},
        "expert_parallel": {k: sum(r["ep2"]["launches"][k] for r in ranks)
                            for k in FLASH_KERNELS},
        "tensor_parallel": {k: sum(r[f"tp2_chunks{c}"]["launches"][k]
                                   for r in ranks for c in (0, 4))
                            for k in FLASH_KERNELS}}
    rec = {"card": smi, "timing": ZERO_SHARED, "moe": moe,
           "ranks": ranks, "identities": ident,
           "flash_cases": fwd_cases, "bwd_cases": bwd_cases,
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    log(f"phase 19 (b, c) [{smi}; {ZERO_SHARED}] " + json.dumps({
        what: {k: [r[what][k] for r in ranks]
               for k in ("losses", "step_ms_wall", "peak_mem_gib", "bytes",
                         "launches", "plan")}
        for what in ("ep2", "tp2_chunks0", "tp2_chunks4")}))
    log(f"phase 19 (d) [{smi}] " + json.dumps(ident))
    log(f"phase 19: {rec['phase_s']:.1f}s, launches {json.dumps(launches)}, "
        f"checks {json.dumps(checks)}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"phase 19: failed {failed}")
    return rec


# --------------------------------------------------------------------------
# phase 20: the pipeline (1F1B over pipe), ring attention over seq,
# data-mesh generate and the comms logger
# --------------------------------------------------------------------------

PP_LAYERS = 4             # llama-1b width, 4 of its 16 layers
PP_M = 4                  # micro-batches a step (gradient_accumulation_steps)
PP_STEPS = 2              # after 1 warm-up step
RING_LAYERS = 4           # llama-1b width, 4 of its 16 layers
RING_SEQ = 16384          # 8192 positions a rank
DP_LAYERS = 4             # llama-7b width, 4 of its 32 layers
DP_PROMPT, DP_NEW = 512, 32
PP_CONFIG = dict(TRAIN_CONFIG, gradient_accumulation_steps=PP_M,
                 pipeline={"stages": 2}, comms_logger={"enabled": True})
SEQ_CONFIG = dict(TRAIN_CONFIG, train_batch_size=1,
                  sequence_parallel={"sp_size": 2},
                  comms_logger={"enabled": True})
PP_F32 = dict(max_seq_len=512, dtype=torch.float32)        # at 2 layers


def _llama1b_train(layers, S, **over):
    from deepspeed_tpu_torch import llama_config
    kw = dict(num_layers=layers, max_seq_len=S, remat=True,
              remat_policy="dots_saveable", loss_chunk=2048)
    kw.update(over)
    return llama_config("1b", **kw)


def _dp_generate(rank):
    """(d) ``InferenceEngine.generate`` on a data=2 mesh: llama-7b width,
    DP_LAYERS layers, bf16, 4 prompts of DP_PROMPT (2 a rank), DP_NEW new
    tokens: wall ms and this rank's launches (zeroed after a warm-up);
    then f32 at 2 layers, the data=2 stream against one rank's (on rank
    0)."""
    from deepspeed_tpu_torch import init_inference, llama_config, make_model
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.parallel import MeshPlan
    prompts = np.random.default_rng(7).integers(
        0, VOCAB, (4, DP_PROMPT), dtype=np.int64)
    cfg = llama_config("7b", num_layers=DP_LAYERS,
                       max_seq_len=DP_PROMPT + DP_NEW)
    eng = init_inference(make_model(cfg, "llama-7b"),
                         config={"kv_cache_bits": 0}, mesh=MeshPlan(data=2))
    eng.generate(prompts, 2)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, DP_NEW)
    torch.cuda.synchronize()
    rec = {"wall_ms": (time.perf_counter() - t0) * 1e3,
           "launches": _build.launch_counts(),
           "shape": list(out.shape),
           "in_vocab": bool(((out >= 0) & (out < VOCAB)).all()),
           "prompts_kept": bool((out[:, :DP_PROMPT].cpu().numpy()
                                 == prompts).all()),
           "rows": [eng._data_rows(4).start, eng._data_rows(4).stop]}
    del eng
    _free()
    cfg32 = llama_config("7b", num_layers=2, max_seq_len=DP_PROMPT + DP_NEW,
                         dtype=torch.float32)
    eng = init_inference(make_model(cfg32, "llama-7b f32"),
                         dtype=torch.float32, config={"kv_cache_bits": 0},
                         mesh=MeshPlan(data=2))
    split = eng.generate(prompts, DP_NEW).cpu().numpy()
    del eng
    _free()
    if rank == 0:
        one = init_inference(make_model(cfg32, "llama-7b f32"),
                             dtype=torch.float32, config={"kv_cache_bits": 0})
        whole = one.generate(prompts, DP_NEW).cpu().numpy()
        del one
        _free()
        rec["f32_token_identical"] = bool((whole == split).all())
        rec["f32_agreement"] = float((whole == split).mean())
    return rec


def _pp_rank(rank, world):
    """One rank of phase 20 (a)-(e), both ranks on cuda:0 over gloo: (a)
    pipe=2, (c) seq=2, (b) the f32 identities of both, (d) data=2
    generate; the comms logger on throughout. Returns every rank's record
    (on rank 0)."""
    import torch.distributed as dist
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.parallel import MeshPlan, build_mesh
    from deepspeed_tpu_torch.parallel.pipeline import bubble_fraction
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    comm.configure(enabled=True)
    rec = {}
    # (a) llama-1b width, 4 layers, B=8 S=2048 in 4 micro-batches, pipe=2
    bs = _zero_batches(8, ZERO_SEQ, 1 + PP_STEPS, seed=0)
    engine, rec["pipe"] = _mp_run(_llama1b_train(PP_LAYERS, ZERO_SEQ),
                                  PP_CONFIG, bs, "llama-1b", logged=True)
    rec["pipe"]["bubble"] = bubble_fraction(PP_M, engine.plan.pipe)
    rec["pipe"]["transport"] = engine.mesh.p2p
    rec["pipe"]["stage"] = engine.mesh.index("pipe")
    del engine, bs
    _free()
    # (c) llama-1b width, 4 layers, B=1 S=16384, seq=2
    bs = _zero_batches(1, RING_SEQ, 1 + PP_STEPS, seed=1)
    engine, rec["ring"] = _mp_run(_llama1b_train(RING_LAYERS, RING_SEQ),
                                  SEQ_CONFIG, bs, "llama-1b", logged=True)
    rec["ring"]["seq_index"] = engine.mesh.index("seq")
    del engine, bs
    _free()
    # (c) the ring itself at those attention shapes, against one call
    seq2 = build_mesh(MeshPlan(seq=2))
    rec["ring_case"] = {str(dt)[6:]: _ring_local_case(rank, seq2, dt)
                        for dt in (torch.bfloat16, torch.float32)}
    # (b) f32 at 2 layers, S=512: pipe=2 and seq=2 against world 1
    cfg32 = _llama1b_train(2, 512, loss_chunk=0, **PP_F32)
    rec["f32_pipe"] = _f32_identity(
        rank, cfg32, dict(MP_F32_CONFIG, train_batch_size=8,
                          gradient_accumulation_steps=PP_M,
                          pipeline={"stages": 2}),
        _zero_batches(8, 512, MP_F32_STEPS, seed=2), "llama-1b f32")
    rec["f32_seq"] = _f32_identity(
        rank, cfg32, dict(MP_F32_CONFIG, sequence_parallel={"sp_size": 2}),
        _zero_batches(2, 512, MP_F32_STEPS, seed=3), "llama-1b f32")
    # (d)
    rec["dp"] = _dp_generate(rank)
    comm.configure(enabled=False)
    out = [None] * world
    dist.all_gather_object(out, rec)
    return out if rank == 0 else None


def _chunked_plain(q, k, v, do, sm, qb=1024):
    """The plain version of causal attention and its backward, in f32, a
    block of ``qb`` query rows at a time (a [B, S, S] score matrix at
    S=16384 does not fit): O, LSE [B, N, S, 1], dQ, dK, dV."""
    B, S, N, D = q.shape
    Nkv = k.shape[2]
    rep = N // Nkv
    kf, vf = k.float(), v.float()
    o = torch.empty((B, S, N, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, N, S, 1), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(o)
    dk = torch.zeros((B, S, Nkv, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    cols = torch.arange(S, device=q.device)
    for s0 in range(0, S, qb):
        rows = torch.arange(s0, s0 + qb, device=q.device)
        qg = q[:, s0:s0 + qb].float().reshape(B, qb, Nkv, rep, D)
        dog = do[:, s0:s0 + qb].float().reshape(B, qb, Nkv, rep, D)
        s = torch.einsum("bsgrd,btgd->bgrst", qg, kf) * sm
        s = s.masked_fill(~(rows[:, None] >= cols[None]), -1e30)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        del s
        lsum = p.sum(-1, keepdim=True)
        p = p / lsum
        ob = torch.einsum("bgrst,btgd->bsgrd", p, vf)
        o[:, s0:s0 + qb] = ob.reshape(B, qb, N, D)
        lse[:, :, s0:s0 + qb] = (m + torch.log(lsum)).reshape(B, N, qb, 1)
        delta = (dog * ob).sum(-1).permute(0, 2, 3, 1)[..., None]
        ds = p * (torch.einsum("bsgrd,btgd->bgrst", dog, vf) - delta) * sm
        dq[:, s0:s0 + qb] = torch.einsum("bgrst,btgd->bsgrd", ds,
                                         kf).reshape(B, qb, N, D)
        dk += torch.einsum("bgrst,bsgrd->btgd", ds, qg)
        dv += torch.einsum("bgrst,bsgrd->btgd", p, dog)
        del p, ds
    return o, lse, dq, dk, dv


def _ring_inputs(dtype, S=RING_SEQ, B=1, N=32, Nkv=8, D=64):
    """(c)'s attention inputs at the seq=2 run's shapes (llama-1b's
    heads), the same on every process: q, k, v, dO."""
    g = torch.Generator(device="cuda").manual_seed(11)
    q, do = (torch.randn((B, S, N, D), generator=g, device="cuda",
                         dtype=dtype) for _ in range(2))
    k, v = (torch.randn((B, S, Nkv, D), generator=g, device="cuda",
                        dtype=dtype) for _ in range(2))
    return q, k, v, do


def _ring_local_case(rank, mesh, dtype):
    """(c) ``ring_attention_local`` on the two seq=2 ranks at the
    training run's attention shapes (S=RING_SEQ, RING_SEQ / 2 a rank):
    this rank's launches of one call (causal: rank j runs j + 1 pairs),
    two calls bit for bit, and the wall time of a forward and of a
    forward + backward on this rank (two processes sharing the card over
    gloo: the pairs' kernels and the exchanges of K/V and dK/dV) over
    ``mesh`` (seq=2). On rank
    0, the gathered O, dQ, dK and dV against one B1 / B2 / B3 call over
    the whole sequence and against the plain version (chunked by query
    rows)."""
    from deepspeed_tpu_torch.comm import comm
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                         flash_attention_fwd)
    from deepspeed_tpu_torch.ops.ring_attention import ring_attention_local
    q, k, v, do = _ring_inputs(dtype)
    S, D = q.shape[1], q.shape[3]
    sm, Sl = 1.0 / math.sqrt(D), S // 2
    mine = slice(rank * Sl, (rank + 1) * Sl)

    def call(backward=True):
        piece = [t[:, mine].clone().requires_grad_(backward)
                 for t in (q, k, v)]
        with torch.set_grad_enabled(backward):
            o = ring_attention_local(*piece, causal=True, sm_scale=sm,
                                     mesh=mesh)
        if not backward:
            return [o]
        o.backward(do[:, mine])
        return [o.detach()] + [p.grad for p in piece]

    _build.reset_launch_counts()
    got = call()
    torch.cuda.synchronize()
    rec = {"launches": _build.launch_counts(),
           "bitwise_repeat": all(torch.equal(a, b)
                                 for a, b in zip(got, call())),
           "fwd_ms": cuda_ms(lambda: call(False), iters=5),
           "fwd_bwd_ms": cuda_ms(call, iters=5)}
    whole = [comm.all_gather(t.contiguous(), "seq", dim=1, mesh=mesh)
             for t in got]
    del got
    if rank == 0:
        o_one, lse_one = flash_attention_fwd(q, k, v, causal=True,
                                             sm_scale=sm)
        one = [o_one, *flash_attention_bwd(q, k, v, o_one, lse_one, do,
                                           causal=True, sm_scale=sm)]
        o_p, _, *g_p = _chunked_plain(q, k, v, do, sm)
        plain = [o_p, *g_p]
        names = ("o", "dq", "dk", "dv")
        rec["ring_vs_plain"] = {n: rel_l2(a, b)
                                for n, a, b in zip(names, whole, plain)}
        rec["one_vs_plain"] = {n: rel_l2(a, b)
                               for n, a, b in zip(names, one, plain)}
        rec["ring_vs_one"] = {n: rel_l2(a, b)
                              for n, a, b in zip(names, whole, one)}
        rec["max_abs_err"] = max(max_abs(a, b) for a, b in zip(whole, plain))
        del one, plain, o_p, g_p, o_one, lse_one
    del whole, q, k, v, do
    _free()
    return rec


def ring_timing_case(dtype):
    """(c) The kernels' times at the ring's shapes: B1 and B2 / B3 on one
    (query piece, key piece) pair of S / 2 each, causal (the diagonal)
    and not (a past piece), the causal ring's three pairs summed, beside
    one call over the whole sequence, SDPA and the bound."""
    import torch.nn.functional as F
    from deepspeed_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                         flash_attention_fwd)
    q, k, v, do = _ring_inputs(dtype)
    B, S, N, D = q.shape
    sm, Sl = 1.0 / math.sqrt(D), S // 2
    qp, kp, vp, dop = (t[:, :Sl].contiguous() for t in (q, k, v, do))
    rec = {"shape": f"B={B} S={S} Nq={N} Nkv={k.shape[2]} D={D} "
                    f"{str(dtype)[6:]} causal, pairs of {Sl}"}
    for name, causal in (("diag", True), ("past", False)):
        o, lse = flash_attention_fwd(qp, kp, vp, causal=causal, sm_scale=sm)
        rec[f"pair_{name}_fwd_ms"] = cuda_ms(lambda: flash_attention_fwd(
            qp, kp, vp, causal=causal, sm_scale=sm), iters=5)
        rec[f"pair_{name}_bwd_ms"] = cuda_ms(lambda: flash_attention_bwd(
            qp, kp, vp, o, lse, dop, causal=causal, sm_scale=sm), iters=5)
    # rank 0 runs its diagonal, rank 1 a past piece and its diagonal
    for what in ("fwd", "bwd"):
        rec[f"pairs_{what}_ms"] = (2 * rec[f"pair_diag_{what}_ms"]
                                   + rec[f"pair_past_{what}_ms"])
    o_one, lse_one = flash_attention_fwd(q, k, v, causal=True, sm_scale=sm)
    g_one = flash_attention_bwd(q, k, v, o_one, lse_one, do, causal=True,
                                sm_scale=sm)
    rec["one_fwd_ms"] = cuda_ms(
        lambda: flash_attention_fwd(q, k, v, causal=True, sm_scale=sm),
        iters=5)
    rec["one_bwd_ms"] = cuda_ms(lambda: flash_attention_bwd(
        q, k, v, o_one, lse_one, do, causal=True, sm_scale=sm), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    rec["sdpa_fwd_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, scale=sm, enable_gqa=True), iters=5)
    # the pairs' work is the one call's (a causal ring skips the future
    # piece): the same bound
    fwd_flops = 4 * B * N * D * S * S / 2
    rec["fwd_bound_ms"], rec["fwd_bound_by"] = bound(
        nbytes(q, k, v, o_one) + lse_one.numel() * 4, fwd_flops, dtype)
    rec["bwd_bound_ms"], rec["bwd_bound_by"] = bound(
        nbytes(q, k, v, o_one, do, *g_one) + lse_one.numel() * 4,
        2.5 * fwd_flops, dtype)
    del q, k, v, do, qp, kp, vp, dop, o, lse, o_one, lse_one, g_one
    _free()
    return rec


def pipeline_ring_phase(smi: str):
    """Phase 20: pipeline parallelism, ring attention, data-mesh generate
    and the comms logger (module docstring, item 20)."""
    from deepspeed_tpu_torch.parallel.launch import run_group
    t_phase = time.perf_counter()
    _free()
    checks = {}
    kcases = {str(dt)[6:]: ring_timing_case(dt)
              for dt in (torch.bfloat16, torch.float32)}
    ranks = run_group(_pp_rank, 2, timeout_s=900)
    n, L = PP_STEPS, PP_LAYERS
    cfg = _llama1b_train(PP_LAYERS, ZERO_SEQ)
    want = {"params": _leaf_bytes(cfg, lambda k: k.startswith("layers/"), 2),
            "opt": _leaf_bytes(cfg, lambda k: k.startswith("layers/"), 12),
            "grads": _leaf_bytes(cfg, lambda k: k.startswith("layers/"), 4)}
    for i, r in enumerate(ranks):
        p, g = r["pipe"], r["ring"]
        checks[f"(a) rank {i} finite"] = all(np.isfinite(p["losses"]))
        checks[f"(a) rank {i} bytes of params, opt, grads == the law"] = \
            p["bytes"] == want
        # each micro-batch of a stage's L / 2 layers: the forward tick,
        # the backward tick's recompute and dots_saveable's replay of it;
        # the last stage forwards once, under autograd, and replays
        fwds = 2 if p["stage"] == 1 else 3
        checks[f"(a) rank {i} B1 == {fwds} x M x L / P a step"] = \
            p["launches"]["flash_fwd"] == fwds * PP_M * L // 2 * n
        checks[f"(a) rank {i} B2 == B3 == M x L / P a step"] = \
            p["launches"]["flash_bwd_dq"] == p["launches"]["flash_bwd_dkv"] \
            == PP_M * L // 2 * n
        checks[f"(a) rank {i} bubble == (P - 1) / (M + P - 1)"] = \
            p["bubble"] == 1 / (PP_M + 1)
        checks[f"(c) rank {i} finite"] = all(np.isfinite(g["losses"]))
        j = g["seq_index"]
        # rank j of a causal ring runs j + 1 pairs a layer; the remat
        # replays the forward
        checks[f"(c) rank {i} B1 == 2 x (j + 1) x L a step"] = \
            g["launches"]["flash_fwd"] == 2 * (j + 1) * RING_LAYERS * n
        checks[f"(c) rank {i} B2 == B3 == (j + 1) x L a step"] = \
            g["launches"]["flash_bwd_dq"] == g["launches"]["flash_bwd_dkv"] \
            == (j + 1) * RING_LAYERS * n
        for what, x in (("(a)", p), ("(c)", g)):
            lg = x["logger"]
            flat = {f"{op}[{ax}]": v for op, d in lg["facade"].items()
                    for ax, v in d.items()}
            checks[f"(e) rank {i} {what} logger == the facade's counts"] = \
                set(flat) == set(lg["counts"]) and all(
                    lg["counts"][k] == v["calls"]
                    and lg["bytes"][k] == v["bytes"]
                    for k, v in flat.items())
        checks[f"(a) rank {i} ppermutes == 2 x (M + 2) a step"] = \
            p["logger"]["counts"].get("ppermute[pipe]") == \
            2 * (PP_M + 2) * n
        for name, c in r["ring_case"].items():
            checks[f"(c) rank {i} {name} ring call: B1 = B2 = B3 = j + 1"] \
                = c["launches"]["flash_fwd"] == c["launches"][
                    "flash_bwd_dq"] == c["launches"]["flash_bwd_dkv"] == j + 1
            checks[f"(c) rank {i} {name} ring call bit for bit on repeat"] \
                = c["bitwise_repeat"]
        d = r["dp"]
        checks[f"(d) rank {i} shape, in vocab, prompts kept"] = \
            d["shape"] == [4, DP_PROMPT + DP_NEW] and d["in_vocab"] \
            and d["prompts_kept"]
        checks[f"(d) rank {i} rows"] = d["rows"] == [2 * i, 2 * i + 2]
        checks[f"(d) rank {i} B1 == L (one prefill)"] = \
            d["launches"]["flash_fwd"] == DP_LAYERS
    checks["(b) f32 pipe=2 == world 1: losses 1e-5, params 1e-5"] = \
        ranks[0]["f32_pipe"]["loss_rel_err"] <= 1e-5 and \
        ranks[0]["f32_pipe"]["params_rel_l2"] <= 1e-5
    checks["(b) f32 seq=2 == world 1: losses 1e-5, params 1e-5"] = \
        ranks[0]["f32_seq"]["loss_rel_err"] <= 1e-5 and \
        ranks[0]["f32_seq"]["params_rel_l2"] <= 1e-5
    checks["(d) f32 data=2 generate token-identical to one rank"] = \
        ranks[0]["dp"]["f32_token_identical"]
    for name, c in ranks[0]["ring_case"].items():
        tol = TOL[getattr(torch, name)]
        checks[f"(c) {name} ring (gathered O, dQ, dK, dV) vs plain within "
               f"{tol}"] = max(c["ring_vs_plain"].values()) <= tol
        checks[f"(c) {name} one call vs plain within {tol}"] = \
            max(c["one_vs_plain"].values()) <= tol
        kcases[name].update(
            {k: c[k] for k in ("ring_vs_plain", "one_vs_plain",
                               "ring_vs_one", "max_abs_err")},
            ring_rank_ms={w: [r["ring_case"][name][w] for r in ranks]
                          for w in ("fwd_ms", "fwd_bwd_ms")})
    launches = {
        "pipeline": {k: sum(r["pipe"]["launches"][k] for r in ranks)
                     for k in FLASH_KERNELS},
        "ring": {k: sum(r["ring"]["launches"][k] for r in ranks)
                 for k in FLASH_KERNELS},
        "dp_generate": {k: sum(r["dp"]["launches"].get(k, 0) for r in ranks)
                        for k in FLASH_KERNELS}}
    rec = {"card": smi, "timing": ZERO_SHARED, "ranks": ranks,
           "kernel_cases": kcases, "launches": launches,
           "phase_s": time.perf_counter() - t_phase}
    log(f"phase 20 (c) ring kernel cases [{smi}] " + json.dumps(kcases))
    for what in ("pipe", "ring"):
        log(f"phase 20 ({'a' if what == 'pipe' else 'c'}) {what} [{smi}; "
            f"{ZERO_SHARED}] " + json.dumps({
                k: [r[what][k] for r in ranks]
                for k in ("losses", "step_ms_wall", "peak_mem_gib", "bytes",
                          "launches", "plan")
                + (("bubble", "transport") if what == "pipe" else ())}))
        for i, r in enumerate(ranks):
            log(f"phase 20 (e) comms logger rank {i} {what}:\n"
                + r[what]["logger"]["summary"])
    log(f"phase 20 (b) f32 [{smi}] " + json.dumps(
        {k: ranks[0][k] for k in ("f32_pipe", "f32_seq")}))
    log(f"phase 20 (d) data=2 generate [{smi}; {ZERO_SHARED}] "
        + json.dumps([r["dp"] for r in ranks]))
    log(f"phase 20: {rec['phase_s']:.1f}s, launches {json.dumps(launches)}, "
        f"checks {json.dumps(checks)}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"phase 20: failed {failed}")
    return rec


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
    "bulk_ops": [...], "f16_packs": n, "saturating_cvt": n}} from
    ``cuobjdump -sass`` of a library (wgmma, TMA tile loads, plain bulk
    copies, and ATOM, ATOMS, ATOMG, RED, REDG; bulk_ops: every distinct
    UBLK* / UTMA* opcode, to show what the bulk copies compile to;
    f16_packs: F2FP conversions to f16 pairs; saturating_cvt: any F2F /
    F2FP with SAT in its opcode, which would hide an f16 overflow)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    atomics = {"ATOM", "ATOMS", "ATOMG", "RED", "REDG"}
    out = {}
    for chunk in text.split("Function : ")[1:]:
        name, body = chunk.split("\n", 1)
        ops, full = [], []
        for ln in body.splitlines():
            toks = ln.split("*/", 1)[-1].split() if "*/" in ln else []
            if toks and toks[0].startswith("@"):     # a predicate guard
                toks = toks[1:]
            if toks and not toks[0].startswith("/*"):
                ops.append(toks[0].split(".")[0])
                full.append(toks[0])
        counts = {op: ops.count(op) for op in ("HGMMA", "UTMALDG", "UBLKCP")}
        counts["atomics"] = sum(o in atomics for o in ops)
        counts["bulk_ops"] = sorted({o for o in ops
                                     if o.startswith(("UBLK", "UTMA"))})
        counts["f16_packs"] = sum(o.startswith("F2FP") and ".F16." in o
                                  for o in full)
        counts["saturating_cvt"] = sum(o.startswith("F2F") and "SAT" in o
                                       for o in full)
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
        # B1-B3's f16 instantiations: on wgmma too (above), packing f16
        # pairs by round-to-nearest conversions that never saturate
        f16 = {f: c for f, c in wg.items() if "__half" in f}
        if name in FLASH_KERNELS and (
                len(f16) < 2 or not all(c["f16_packs"] > 0
                                        for c in f16.values())):
            raise RuntimeError(f"{name}: no f16 wgmma instantiations "
                               f"packing f16 pairs: {sass}")
        if any(c["saturating_cvt"] for c in sass.values()):
            raise RuntimeError(f"{name}: saturating conversions in {sass}")
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
        if not any("__half" in f for f in split) or \
                any(c["saturating_cvt"] for c in sass.values()):
            raise RuntimeError(f"{name}: no f16 instantiation, or a "
                               f"saturating conversion: {sass}")
        if any(c["atomics"] for c in sass.values()):
            raise RuntimeError(f"{name}: atomics in {sass}")
    return seconds, info


# --------------------------------------------------------------------------
# phase 21: the model families
# --------------------------------------------------------------------------

# the published config.json fields of the families phase 21 drives beside
# GPT-2 1.3b (the port's ``gpt2_config("1.3b")``), read by
# ``models.hf_import.hf_config_to_transformer``
FAMILY_HF = {
    "bert-large": dict(model_type="bert", vocab_size=30522,
                       hidden_size=1024, num_hidden_layers=24,
                       num_attention_heads=16, intermediate_size=4096,
                       max_position_embeddings=512, type_vocab_size=2,
                       layer_norm_eps=1e-12),
    "pythia-1.4b": dict(model_type="gpt_neox", vocab_size=50304,
                        hidden_size=2048, num_hidden_layers=24,
                        num_attention_heads=16, intermediate_size=8192,
                        max_position_embeddings=2048, rotary_pct=0.25,
                        rotary_emb_base=10000, layer_norm_eps=1e-5,
                        use_parallel_residual=True,
                        tie_word_embeddings=False),
    "gpt-neo-1.3b": dict(model_type="gpt_neo", vocab_size=50257,
                         hidden_size=2048, num_layers=24, num_heads=16,
                         max_position_embeddings=2048,
                         attention_types=[[["global", "local"], 12]],
                         window_size=256, layer_norm_epsilon=1e-5),
    "bloom-1b7": dict(model_type="bloom", vocab_size=250880,
                      hidden_size=2048, n_layer=24, n_head=16,
                      layer_norm_epsilon=1e-5),
}
FAMILY_LAYERS = 4         # Pythia, GPT-Neo, BLOOM: 4 of their 24 layers
FAMILY_STEPS = 2          # training steps after 1 warm-up step
FAMILY_SERVING = dict(max_seqs=16, block_size=64, max_model_len=1024,
                      decode_quantum=8)
FAMILY_NEW = 32           # new tokens a request (GPT-2 1.3b)
BERT_B, BERT_S = 8, 512
# (e) f32 identities: 2 layers, a 300-token greedy prompt (past GPT-Neo's
# 256-token window), a B=2 S=256 loss
ID_LAYERS, ID_PROMPT, ID_NEW, ID_B, ID_S = 2, 300, 12, 2, 256


def _is_bias_or_norm(name: str) -> bool:
    leaf = name.rsplit("/", 1)[-1]
    return leaf.startswith("b") or leaf.endswith(("_bias", "_scale"))


def _family_cfg(name, layers=None, **over):
    """A family's config from its ``config.json`` fields (GPT-2 1.3b from
    ``gpt2_config``), cut to ``layers`` (GPT-Neo's window pattern with
    it)."""
    from deepspeed_tpu_torch.models.hf_import import hf_config_to_transformer
    from deepspeed_tpu_torch.models.transformer import gpt2_config
    cfg = (gpt2_config("1.3b") if name == "gpt2-1.3b"
           else hf_config_to_transformer(FAMILY_HF[name]))
    if layers is not None:
        over["num_layers"] = layers
        if cfg.attn_windows:
            over["attn_windows"] = cfg.attn_windows[:layers]
    return dataclasses.replace(cfg, **over)


def _family_params(cfg, seed, dtype):
    """The seeded init on the card with every bias and norm leaf redrawn
    nonzero (biases N(0, 0.02), norm scales 1 + N(0, 0.02)): the init
    makes them 0 and 1, where a dropped bias would go unseen."""
    from deepspeed_tpu_torch.models import transformer as tt
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = tt.init_params(cfg, gen, "cuda", dtype=dtype)
    leaves = [(k, v) for k, v in p.items() if k != "layers"]
    leaves += [("layers/" + k, v) for k, v in p["layers"].items()]
    for name, t in leaves:
        if _is_bias_or_norm(name):
            t.normal_(1.0 if name.endswith("_scale") else 0.0, 0.02,
                      generator=gen)
    return p


def _serve_family(name, cfg, prompts, n_new, seed=0):
    """``init_serving`` (bf16, float pool) on ``_family_params``, one
    warm-up request, then ``prompts`` with the launch counts zeroed just
    before them. Every stream must keep its prompt and add ``n_new``
    in-vocab tokens, and the pool must be empty after. Returns (stats,
    launches)."""
    from deepspeed_tpu_torch import init_serving, make_model
    from deepspeed_tpu_torch.ops import _build
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    srv = init_serving(make_model(cfg, name), config={"kv_cache_bits": 0},
                       serving=FAMILY_SERVING,
                       params=_family_params(cfg, seed, torch.bfloat16),
                       dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    srv.run([(prompts[0][:64], 4)])                         # warm-up
    srv.reset_stats()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = srv.run([(p, n_new) for p in prompts])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    st = srv.stats()
    V = cfg.vocab_size
    for (rid, out), p in zip(sorted(outs.items()), prompts):
        gen = out[len(p):]
        if not np.array_equal(out[:len(p)], p) or gen.size != n_new \
                or gen.min() < 0 or gen.max() >= V:
            raise RuntimeError(f"{name}: request {rid} returned {gen.size} "
                               f"tokens in [{gen.min()}, {gen.max()}]")
    if len(outs) != len(prompts) or srv.allocator.used_blocks:
        raise RuntimeError(f"{name}: {len(outs)} of {len(prompts)} "
                           f"finished, {srv.allocator.used_blocks} blocks "
                           "held")
    st.update(wall_s=wall, init_s=init_s,
              tokens_per_s=n_new * len(prompts) / wall,
              decode_backend=srv.decode_backend,
              backend_reason=srv.backend_bench["reason"],
              peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    del srv
    _free()
    return st, launches


def _greedy_paged(params, cfg, prompt, n, reference):
    """One slot's greedy stream through the paged protocol the serving
    engine runs (``prefill_paged``, then ``decode_step_paged``): the
    kernels (B1, B4 where the route takes them) or, with ``reference``,
    their plain versions."""
    from deepspeed_tpu_torch.models import transformer as tt
    bs, L = 64, len(prompt)
    P = -(-L // bs) * bs
    MB = -(-(P + n) // bs)
    pools = tt.init_paged_cache(cfg, MB + 1, bs, device="cuda")
    tables = torch.arange(1, MB + 1, dtype=torch.int32, device="cuda")[None]
    ids = torch.zeros((1, P), dtype=torch.long, device="cuda")
    ids[0, :L] = torch.as_tensor(prompt, device="cuda")
    with torch.no_grad():
        logits = tt.prefill_paged(params, ids, cfg, pools,
                                  tables[0, :P // bs], length=L,
                                  reference=reference)
        toks = [int(logits[0].argmax())]
        lens = torch.tensor([L], dtype=torch.int32, device="cuda")
        for _ in range(n - 1):
            logits = tt.decode_step_paged(
                params, torch.tensor([toks[-1]], device="cuda"), cfg, pools,
                tables, lens, reference=reference)
            toks.append(int(logits[0].argmax()))
            lens = lens + 1
    return toks


def _family_identity(name, rng):
    """(e) f32, 2 layers: the greedy stream through the kernels
    token-identical to the plain versions', and ``lm_loss`` and every
    leaf's grad (B=2, S=256; BERT's batch padded) within 1e-5 / 1e-4 of
    the plain versions' (a grad's relative L2 over max(|plain|, 1e-3 x
    the whole grad's norm): a key bias's grad is zero up to rounding)."""
    from deepspeed_tpu_torch.models import transformer as tt
    from deepspeed_tpu_torch.runtime import checkpointing as ckpt_mod
    cfg = _family_cfg(name, ID_LAYERS, dtype=torch.float32)
    params = _family_params(cfg, 5, torch.float32)
    prompt = rng.integers(0, cfg.vocab_size, ID_PROMPT).astype(np.int32)
    streams = {ref: _greedy_paged(params, cfg, prompt, ID_NEW, ref)
               for ref in (False, True)}
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (ID_B, ID_S))
                           ).cuda()
    batch = {"input_ids": ids}
    if not cfg.causal:
        mask = torch.ones((ID_B, ID_S), dtype=torch.int32, device="cuda")
        mask[1, ID_S - 40:] = 0
        batch["attention_mask"] = mask
    leaves = list(ckpt_mod.flatten(params).values())
    for t in leaves:
        t.requires_grad_(True)
    out = {}
    for ref in (False, True):
        loss = tt.lm_loss(params, batch, cfg, reference=ref)
        out[ref] = (loss.item(), torch.autograd.grad(loss, leaves))
    (lk, gk), (lp, gp) = out[False], out[True]
    total = float(torch.sqrt(sum(g.double().square().sum() for g in gp)))
    grad_err = max(float((a.double() - b.double()).norm()
                         / max(float(b.double().norm()), 1e-3 * total))
                   for a, b in zip(gk, gp))
    del params, leaves, out, gk, gp
    _free()
    return {"token_identical": streams[False] == streams[True],
            "stream": streams[False],
            "loss_rel_err": abs(lk - lp) / abs(lp), "grad_rel_l2": grad_err}


def model_families_phase(smi: str):
    """Phase 21: the model families (module docstring, item 21)."""
    from deepspeed_tpu_torch import init_inference, make_model
    from deepspeed_tpu_torch.ops import _build
    t_phase = time.perf_counter()
    _free()
    bf, f32 = torch.bfloat16, torch.float32
    checks, launches, rec = {}, {}, {"card": smi}
    # the kernels at the phase's shapes: GPT-2 1.3b's 32/32 heads of 64
    # (prefill bucket, decode, training) and BERT-large's bidirectional
    # padded batch (16/16 heads of 64)
    flash = [flash_case("gpt2-1.3b S=1024", 1, 1024, 32, 32, 64, bf),
             flash_case(f"bert-large B={BERT_B} S={BERT_S} bidirectional "
                        "kv_mask", BERT_B, BERT_S, 16, 16, 64, bf,
                        masked=True, causal=False),
             flash_case(f"bert-large f32 B={BERT_B} S={BERT_S} "
                        "bidirectional kv_mask", BERT_B, BERT_S, 16, 16, 64,
                        f32, masked=True, causal=False)]
    decode = [decode_case("gpt2-1.3b 32/32 D=64 16 slots", 16, 32, 32, 64,
                          64, 16, [0, 1, 63, 64, 65, 200, 333, 500, 640,
                                   777, 896, 900, 927, 960, 1000, 1024], bf)]
    bwd = [bwd_case("gpt2-1.3b training B=8 S=1024", 8, 1024, 32, 32, 64,
                    bf),
           bwd_case(f"bert-large B={BERT_B} S={BERT_S} bidirectional "
                    "kv_mask", BERT_B, BERT_S, 16, 16, 64, bf, masked=True,
                    causal=False),
           bwd_case(f"bert-large f32 B={BERT_B} S={BERT_S} bidirectional "
                    "kv_mask", BERT_B, BERT_S, 16, 16, 64, f32, masked=True,
                    causal=False)]
    _free()
    rng = np.random.default_rng(21)

    # (a) GPT-2 1.3b served: 16 requests of 64..896 tokens, 32 new each
    cfg = _family_cfg("gpt2-1.3b")
    L = cfg.num_layers
    lengths = [(64, 192, 320, 448, 576, 704, 832, 896)[i % 8]
               for i in range(16)]
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    st, ln = _serve_family("gpt2-1.3b", cfg, prompts, FAMILY_NEW)
    launches["gpt2_serving"] = ln
    rec["a"] = st
    checks["(a) B1 == prefills x 24"] = \
        ln["flash_fwd"] == st["prefills"] * L and st["prefills"] == 16
    checks["(a) B4 == decode steps x 24"] = \
        ln["paged_decode"] == st["decode_steps"] * L > 0
    checks["(a) decode route: the paged kernel"] = \
        st["decode_backend"] == "pallas"
    log(f"phase 21 (a) gpt2-1.3b serving [{smi}] " + json.dumps(
        {k: st.get(k) for k in ("p50_ttft_ms", "p99_ttft_ms", "p50_itl_ms",
                                "p99_itl_ms", "tokens_per_s", "wall_s",
                                "prefills", "decode_steps", "decode_backend",
                                "peak_mem_gib", "init_s")}
        | {"launches": {k: ln[k] for k in FLASH_KERNELS + ("paged_decode",)}}))

    # (b) the same config trained, B=8 S=1024, 1 + 2 steps
    tcfg = dataclasses.replace(cfg, max_seq_len=1024, remat=True,
                               remat_policy="dots_saveable", loss_chunk=1024)
    engine, _, tr = _train(tcfg, "gpt2-1.3b", TRAIN_CONFIG, FAMILY_STEPS,
                           params=_family_params(tcfg, 1, f32))
    del engine
    _free()
    n = FAMILY_STEPS
    launches["gpt2_training"] = tr["launches"]
    rec["b"] = tr
    checks["(b) losses finite"] = bool(np.all(np.isfinite(tr["losses"])))
    checks["(b) B2 == B3 == 24 a step"] = \
        tr["launches"]["flash_bwd_dq"] == tr["launches"]["flash_bwd_dkv"] \
        == n * L
    checks["(b) B1 == 2 x 24 a step (dots_saveable replays it)"] = \
        tr["launches"]["flash_fwd"] == 2 * n * L
    log(f"phase 21 (b) gpt2-1.3b training [{smi}] " + json.dumps(
        {k: tr[k] for k in ("step_ms_cuda_median", "step_ms_wall",
                            "tokens_per_s", "mfu", "peak_mem_gib", "losses",
                            "n_params", "launches")}))

    # (c) BERT-large: a padded forward, then 2 training steps
    bcfg = _family_cfg("bert-large", dtype=bf, remat=True,
                       remat_policy="dots_saveable")
    BL = bcfg.num_layers
    eng = init_inference(make_model(bcfg, "bert-large"),
                         config={"kv_cache_bits": 0}, dtype=bf,
                         params=_family_params(bcfg, 2, bf))
    ids = torch.from_numpy(rng.integers(0, bcfg.vocab_size,
                                        (BERT_B, BERT_S))).cuda()
    mask = (torch.arange(BERT_S, device="cuda")[None, :]
            < torch.tensor([BERT_S - 37 * i for i in range(BERT_B)],
                           device="cuda")[:, None]).to(torch.int32)
    types = torch.from_numpy(rng.integers(0, 2, (BERT_B, BERT_S))).cuda()
    eng.forward(ids[:1, :64], attention_mask=mask[:1, :64])     # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    logits = eng.forward(ids, attention_mask=mask, token_type_ids=types)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) * 1e3
    ln = _build.launch_counts()
    launches["bert_forward"] = ln
    checks["(c) forward: finite [8, 512, 30522] logits"] = \
        tuple(logits.shape) == (BERT_B, BERT_S, bcfg.vocab_size) \
        and bool(torch.isfinite(logits).all())
    checks["(c) forward: B1 == 24 (bidirectional, key mask)"] = \
        ln["flash_fwd"] == BL and ln["paged_decode"] == 0
    del eng, logits
    _free()
    bcfg_t = dataclasses.replace(bcfg, max_seq_len=BERT_S)
    engine, _, bt = _train(bcfg_t, "bert-large",
                           dict(TRAIN_CONFIG, train_batch_size=BERT_B),
                           FAMILY_STEPS, params=_family_params(bcfg, 3, f32),
                           extra={"attention_mask": mask})
    del engine
    _free()
    launches["bert_training"] = bt["launches"]
    rec["c"] = {"forward_ms_wall": fwd_ms, "training": bt}
    checks["(c) training: losses finite"] = \
        bool(np.all(np.isfinite(bt["losses"])))
    checks["(c) training: B2 == B3 == 24, B1 == 2 x 24 a step"] = \
        bt["launches"]["flash_bwd_dq"] == bt["launches"]["flash_bwd_dkv"] \
        == n * BL and bt["launches"]["flash_fwd"] == 2 * n * BL
    log(f"phase 21 (c) bert-large [{smi}] " + json.dumps(
        {"forward_ms_wall": fwd_ms, "forward_launches": ln}
        | {k: bt[k] for k in ("step_ms_cuda_median", "tokens_per_s", "mfu",
                              "peak_mem_gib", "losses", "launches")}))

    # (d) Pythia-1.4b, GPT-Neo-1.3B, BLOOM-1b7 at 4 layers, served: 4
    # requests of 300..900 tokens (past GPT-Neo's 256-token window), 16
    # new each
    rec["d"] = {}
    for name, b1_layers, b4 in (("pythia-1.4b", FAMILY_LAYERS, True),
                                ("gpt-neo-1.3b", FAMILY_LAYERS // 2, False),
                                ("bloom-1b7", 0, False)):
        fcfg = _family_cfg(name, FAMILY_LAYERS)
        prompts = [rng.integers(0, fcfg.vocab_size, k).astype(np.int32)
                   for k in (300, 520, 700, 900)]
        st, ln = _serve_family(name, fcfg, prompts, 16)
        launches[name] = ln
        rec["d"][name] = st
        checks[f"(d) {name}: B1 == prefills x {b1_layers}"] = \
            ln["flash_fwd"] == st["prefills"] * b1_layers \
            and st["prefills"] == 4
        want_b4 = st["decode_steps"] * FAMILY_LAYERS if b4 else 0
        checks[f"(d) {name}: B4 == "
               f"{f'decode steps x {FAMILY_LAYERS}' if b4 else 0}"] = \
            ln["paged_decode"] == want_b4
        checks[f"(d) {name}: decode route"] = \
            st["decode_backend"] == ("pallas" if b4 else "xla")
        log(f"phase 21 (d) {name} {FAMILY_LAYERS} layers [{smi}] "
            + json.dumps({k: st.get(k) for k in (
                "p50_ttft_ms", "p50_itl_ms", "tokens_per_s", "prefills",
                "decode_steps", "decode_backend", "backend_reason")}
                | {"launches": {k: ln[k] for k in
                                FLASH_KERNELS + ("paged_decode",)}}))

    # (e) f32, 2 layers: the kernels against their plain versions
    rec["e"] = {}
    for name in ("gpt2-1.3b", "bert-large", "pythia-1.4b", "gpt-neo-1.3b",
                 "bloom-1b7"):
        r = _family_identity(name, rng)
        rec["e"][name] = r
        checks[f"(e) {name}: greedy stream token-identical"] = \
            r["token_identical"]
        checks[f"(e) {name}: loss 1e-5, grads 1e-4"] = \
            r["loss_rel_err"] <= 1e-5 and r["grad_rel_l2"] <= 1e-4
    log(f"phase 21 (e) f32 {ID_LAYERS} layers [{smi}] " + json.dumps(
        {k: {kk: v[kk] for kk in ("token_identical", "loss_rel_err",
                                  "grad_rel_l2")}
         for k, v in rec["e"].items()}))
    rec.update(flash_cases=flash, decode_cases=decode, bwd_cases=bwd,
               launches=launches, phase_s=time.perf_counter() - t_phase)
    total = {k: sum(v.get(k, 0) for v in launches.values())
             for k in FLASH_KERNELS + ("paged_decode",)}
    log(f"phase 21: {rec['phase_s']:.1f}s, launches {json.dumps(total)}, "
        f"checks {json.dumps(checks)}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"phase 21: failed {failed}")
    return rec


# --------------------------------------------------------------------------
# phase 22: the training extras
# --------------------------------------------------------------------------

EXTRAS_STEPS = 4          # each run's steps (the curriculum's four stages)
EXTRAS_PLD_STEPS = 6      # (c): the seeded coins drop layers at steps 4, 5
EXTRAS_MOQ_LAYERS = 4     # (f): llama-1b's width, 4 of its 16 layers
EXTRAS_MOQ_ITERS = 2      # (f): the probe's power iterations (+ 1 product)
EXTRAS_STUDENT = tuple(range(0, 16, 2))     # (e): the teacher's layers kept
EXTRAS_ID_STEPS = 3       # the f32 identities' steps
EXTRAS_ID_S = 512


def _extras_grp(params, modules, offset):
    return {"shared_parameters": {"enabled": True, "schedule_offset": offset},
            "different_groups": {"g": {"params": params,
                                       "modules": modules}}}


def _extras_sections(S):
    """Each run's config sections (``S``: the batch's sequence)."""
    return {
        "a_curriculum": {"curriculum_learning": {
            "enabled": True, "min_difficulty": S // 4, "max_difficulty": S,
            "schedule_config": {"total_curriculum_step": EXTRAS_STEPS,
                                "difficulty_step": S // 8}}},
        "b_random_ltd": {"data_efficiency": {
            "enabled": True, "data_routing": {"random_ltd": {
                "enabled": True, "min_value": S // 2, "max_value": S // 2,
                "seq_step": S // 8}}}},
        "c_pld": {"progressive_layer_drop": {"enabled": True, "theta": 0.5,
                                             "gamma": 0.1}},
        "d_compression": {"compression_training": {
            "weight_quantization": _extras_grp({"target_bits": 8},
                                               ["layers/w"], 1),
            "sparse_pruning": _extras_grp({"dense_ratio": 0.5},
                                          ["layers/w"], 1),
            "activation_quantization": _extras_grp({"bits": 8}, ["*"], 3)}},
        "e_distillation": {},
        "f_moq": {"quantize_training": {
            "enabled": True,
            "quantize_bits": {"start_bits": 16, "target_bits": 8},
            "quantize_schedule": {"quantize_period": 1},
            "eigenvalue": {"enabled": True, "max_iter": EXTRAS_MOQ_ITERS,
                           "gas_boundary_resolution": 2}}},
    }


def _pass_flops(cfg, n_params, B, layer_S, S, fwd_only=False):
    """A training pass's FLOPs (bench.py's 6N + 12 L H S a token) over the
    work done: the non-layer params over B x S tokens, each run layer's
    params and attention over its own ``layer_S`` tokens a row; a
    forward alone a third."""
    n_layer = (n_params - cfg.vocab_size * cfg.hidden_size
               * (1 if cfg.tie_embeddings else 2)) / cfg.num_layers
    flops = 6.0 * (n_params - n_layer * cfg.num_layers) * B * S
    for s in layer_S:
        flops += 6.0 * n_layer * B * s + 12.0 * cfg.hidden_size * B * s * s
    return flops / 3.0 if fwd_only else flops


def _extras_run(name, spec, config, batch, steps, params=None):
    """``initialize`` -> ``steps`` x ``train_batch`` with the launch counts
    zeroed just before the first (no warm-up step: a schedule starts at
    step 1); each step's CUDA-event ms and the engine's draws and
    curriculum length after it."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.ops.optimizers import tree_leaves
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, *_ = initialize(model=spec, config=dict(config), params=params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _build.reset_launch_counts()
    marks, losses, draws, seqs = [], [], [], []
    t0 = time.perf_counter()
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(engine.train_batch(batch)["loss"])
        b.record()
        marks.append((a, b))
        draws.append(list(engine.step_draws))
        if engine._curriculum is not None:
            seqs.append(engine._curriculum.get_current_difficulty())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = dict(init_s=init_s, wall_s=wall,
               step_ms_cuda=[a.elapsed_time(b) for a, b in marks],
               losses=[float(x) for x in losses],
               launches=_build.launch_counts(), draws=draws, seqs=seqs,
               n_params=sum(t.numel() for t in tree_leaves(engine.params)),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    rec["step_ms_cuda_median"] = float(np.median(rec["step_ms_cuda"]))
    mark_part(f"22 {name}")
    return engine, rec


def _extras_rates(rec, tokens, flops):
    rec["tokens_per_s"] = tokens / rec["wall_s"]
    rec["mfu"] = flops / rec["wall_s"] / PEAK_FLOPS[torch.bfloat16]
    rec["flops"] = flops


@contextlib.contextmanager
def _plain_lm_loss():
    """Every ``lm_loss`` of the block through the plain versions of the
    kernels (the engines' model specs and MoQ's probe call it by name)."""
    from deepspeed_tpu_torch.models import transformer as tt
    orig = tt.lm_loss
    tt.lm_loss = functools.partial(orig, reference=True)
    try:
        yield
    finally:
        tt.lm_loss = orig


ACT_FLIP_TOL = 1e-3       # (g): a flip's unrounded levels, this near


class _ActQuantTape:
    """The activation fake-quant of the (g) d_compression identity
    (``transformer.fake_quant``, called by name; 8-bit, symmetric, one
    scale a tensor). It rounds x / scale, so the last-bit differences
    between B1-B3 and their plain versions carry some values across a
    rounding boundary, and each such flip is a whole level's jump that
    spreads through every later grad. "record" keeps each call's
    unrounded levels, levels and output (the kernel side); "replay"
    hands each call the recorded output, after checking that its own
    levels differ from the recorded ones only by flips: one level apart,
    both unrounded values within ACT_FLIP_TOL of the boundary between
    (``faults`` lists every call that breaks this)."""

    def __init__(self):
        self.mode, self.calls, self.i = "record", [], 0
        self.flips, self.values, self.faults = 0, 0, []

    def __call__(self, x, bits=8, symmetric=True, num_groups=1):
        from deepspeed_tpu_torch.ops.quantizer import dequantize, quantize
        if bits != 8 or not symmetric:
            raise ValueError("the tape takes 8-bit symmetric fake-quant")
        qt = quantize(x, bits=bits, symmetric=True, num_groups=num_groups)
        u = x.detach().float().reshape(qt.q.shape) / qt.scale
        xq = dequantize(qt).to(x.dtype)
        if self.mode == "record":
            self.calls.append((u, qt.q, xq))
        elif self.i >= len(self.calls) \
                or self.calls[self.i][0].shape != u.shape:
            self.faults.append(f"call {self.i}: no recorded call of shape "
                               f"{tuple(u.shape)}")
        else:
            uk, qk, xq = self.calls[self.i]
            diff = qk != qt.q
            n = int(diff.sum())
            if n:
                a, b = qk[diff].float(), qt.q[diff].float()
                mid = (a + b) / 2
                ok = (((a - b).abs() == 1)
                      & ((uk[diff] - mid).abs() <= ACT_FLIP_TOL)
                      & ((u[diff] - mid).abs() <= ACT_FLIP_TOL))
                if not bool(ok.all()):
                    self.faults.append(f"call {self.i}: {int((~ok).sum())}"
                                       f" of {n} differing levels are not "
                                       "boundary flips")
            self.flips += n
            self.values += u.numel()
        self.i += 1
        return x + (xq - x).detach()


def _rel_errs(k, pl):
    """Per step: the loss's relative error and the grads' (leaf by leaf,
    relative L2 over max(|plain|, 1e-3 x the whole grad's norm))."""
    loss_err = [abs(a - b) / abs(b) for a, b in zip(k["losses"],
                                                    pl["losses"])]
    grad_err = []
    for sk, sp in zip(k["grads"], pl["grads"]):
        total = float(torch.sqrt(sum(g.double().square().sum() for g in sp)))
        grad_err.append(max(
            float((a.double() - b.double()).norm()
                  / max(float(b.double().norm()), 1e-3 * total))
            for a, b in zip(sk, sp)))
    return loss_err, grad_err


def _extras_identity(name, sections):
    """(g) f32, 2 layers (random-LTD 3: its layers 1 .. L - 2; the
    distilled student 1 of its teacher's 2), B=2, S=512, SGD, 3 steps:
    the run through the kernels against the same run through the plain
    versions, the launch counts zeroed just before each side. Per step:
    ``_rel_errs`` (grads captured at the update). The kernel side's
    B1-B3 launches against the law of its draws (B1 = 2 x the layers run
    + the teacher's forward, B2 = B3 = the layers run, the probe's
    passes each a training pass), the plain side's launches (all
    kernels; must be 0). d_compression's plain side takes the kernel
    side's activation levels (``_ActQuantTape``), and a third run, the
    plain versions on their own levels, gives the errors the flips make
    (reported, not held)."""
    from unittest import mock

    from deepspeed_tpu_torch import initialize, make_model
    from deepspeed_tpu_torch.compression import (make_distillation_loss,
                                                 student_params_from_teacher)
    from deepspeed_tpu_torch.models import params_from_numpy
    from deepspeed_tpu_torch.models import transformer as tt
    from deepspeed_tpu_torch.ops import _build
    f32 = torch.float32
    layers = {"b_random_ltd": 3, "e_distillation": 2}.get(name, ID_LAYERS)
    cfg = _llama1b_train(layers, EXTRAS_ID_S, dtype=f32,
                         loss_chunk=EXTRAS_ID_S)
    sections = dict(sections)
    if name == "a_curriculum":
        # S = 264, off every tile, then 512
        sections = {"curriculum_learning": {
            "enabled": True, "min_difficulty": 8, "max_difficulty": 512,
            "schedule_type": "fixed_discrete", "schedule_config": {
                "difficulty": [264, 512], "max_step": [1, 2]}}}
    config = {"train_batch_size": ID_B, "bf16": {"enabled": False},
              "optimizer": MP_SGD, "zero_optimization": {"stage": 1},
              "seed": 0, **sections}
    params = _seeded_params(cfg, 22)
    rng = np.random.default_rng(22)
    batches = [{"input_ids": torch.from_numpy(rng.integers(
        0, VOCAB, (ID_B, EXTRAS_ID_S), dtype=np.int32)).cuda()}
        for _ in range(EXTRAS_ID_STEPS)]
    tape = _ActQuantTape() if name == "d_compression" else None
    sides = {"kernels": False, "plain": True}
    if tape is not None:
        sides["plain_own_levels"] = True
    out = {}
    for side, ref in sides.items():
        spec, p = make_model(cfg, "llama-1b"), params
        if name == "e_distillation":
            scfg = dataclasses.replace(cfg, num_layers=1)
            teacher = params_from_numpy(params, cfg, device="cuda",
                                        dtype=f32)
            spec = dataclasses.replace(
                make_model(scfg, "llama-1b-student"),
                loss_fn=make_distillation_loss(scfg, teacher, cfg,
                                               reference=ref))
            p = student_params_from_teacher(params, [1])
        with contextlib.ExitStack() as ctx:
            if ref:
                ctx.enter_context(_plain_lm_loss())
            if tape is not None and side != "plain_own_levels":
                tape.mode, tape.i = ("replay" if ref else "record"), 0
                ctx.enter_context(mock.patch.object(tt, "fake_quant", tape))
            engine, *_ = initialize(model=spec, config=dict(config),
                                    params=p)
            grads, probes, apply = [], [], engine._apply_grads

            def capture(g, loss, apply=apply, grads=grads):
                grads.append([x.detach().clone() for x in g])
                return apply(g, loss)
            engine._apply_grads = capture
            if engine._moq is not None:
                def probe(batch, run=engine._moq_probe, probes=probes):
                    probes.append(len(probes))
                    return run(batch)
                engine._moq_probe = probe
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            losses, draws = [], []
            for b in batches:
                losses.append(float(engine.train_batch(b)["loss"]))
                draws.append(list(engine.step_draws))
            torch.cuda.synchronize()
            counts = _build.launch_counts()
        out[side] = dict(losses=losses, grads=grads, draws=draws,
                         counts=counts, probes=len(probes),
                         layers=engine.model.config.num_layers,
                         act_quant_on=bool(engine._act_quant_on))
        del engine
        _free()
    k, pl = out["kernels"], out["plain"]
    loss_err, grad_err = _rel_errs(k, pl)
    # the law of the kernel side's draws
    run = [sum(sum(d["pld_keep"]) if "pld_keep" in d else k["layers"]
               for d in step) if step else k["layers"]
           for step in k["draws"]]
    teacher = layers if name == "e_distillation" else 0
    passes = k["probes"] * 2 * (EXTRAS_MOQ_ITERS + 1)
    b1 = sum(2 * r + teacher for r in run) + passes * 2 * k["layers"]
    b23 = sum(run) + passes * k["layers"]
    got = k["counts"]
    rec = {"losses": k["losses"], "loss_rel_err": loss_err,
           "grad_rel_l2": grad_err, "draws_equal": k["draws"] ==
           pl["draws"], "layers": layers, "layers_run": run,
           "probes": k["probes"], "law": {"B1": b1, "B2": b23, "B3": b23},
           "launches": {n: got[n] for n in FLASH_KERNELS},
           "law_ok": (got["flash_fwd"] == b1 and got["flash_bwd_dq"] == b23
                      and got["flash_bwd_dkv"] == b23),
           "plain_launches": sum(sum(o["counts"].values()) for s, o in
                                 out.items() if s != "kernels"),
           "act_quant_on": k["act_quant_on"] and pl["act_quant_on"]}
    if tape is not None:
        if tape.i != len(tape.calls):
            tape.faults.append(f"{len(tape.calls)} calls recorded, "
                               f"{tape.i} replayed")
        own = _rel_errs(k, out["plain_own_levels"])
        rec.update(act_calls=len(tape.calls), act_flips=tape.flips,
                   act_values=tape.values, act_faults=tape.faults[:4],
                   own_levels_loss_rel_err=own[0],
                   own_levels_grad_rel_l2=own[1])
    return rec


def training_extras_phase(smi: str):
    """Phase 22: the training extras (module docstring, item 22)."""
    from deepspeed_tpu_torch import make_model
    from deepspeed_tpu_torch.compression import (compress,
                                                 make_distillation_loss)
    from deepspeed_tpu_torch.models import params_from_numpy
    t_phase = time.perf_counter()
    _free()
    bf = torch.bfloat16
    checks, launches, rec = {}, {}, {"card": smi}
    B, S, L = TRAIN_CONFIG["train_batch_size"], 2048, 16
    # B1-B3 at the runs' new sequences: the curriculum's S = 264 (off
    # every tile; the f32 identity's first step) and random-LTD's 1024
    flash = [flash_case("llama-1b curriculum B=8 S=264", 8, 264, 32, 8, 64,
                        bf),
             flash_case("llama-1b random-LTD kept B=8 S=1024", 8, 1024, 32,
                        8, 64, bf)]
    bwd = [bwd_case("llama-1b curriculum B=8 S=264", 8, 264, 32, 8, 64, bf),
           bwd_case("llama-1b random-LTD kept B=8 S=1024", 8, 1024, 32, 8,
                    64, bf)]
    _free()
    sections = _extras_sections(S)
    cfg = _llama1b_train(L, S)
    ids = np.random.default_rng(22).integers(0, VOCAB, (B, S),
                                             dtype=np.int32)
    batch = {"input_ids": torch.from_numpy(ids).cuda()}
    spec = make_model(cfg, "llama-1b")

    def law(name, got, b1, b23):
        ok = (got["flash_fwd"] == b1 and got["flash_bwd_dq"] == b23
              and got["flash_bwd_dkv"] == b23)
        checks[f"({name[0]}) B1 == {b1}, B2 == B3 == {b23}"] = ok

    def report(name, r, **extra):
        launches[name] = r["launches"]
        rec[name] = r
        checks[f"({name[0]}) losses finite"] = \
            bool(np.all(np.isfinite(r["losses"])))
        log(f"phase 22 ({name}) [{smi}] " + json.dumps(
            {k: r[k] for k in ("step_ms_cuda", "step_ms_cuda_median",
                               "tokens_per_s", "mfu", "peak_mem_gib",
                               "losses", "init_s")}
            | {"launches": {k: r["launches"][k] for k in FLASH_KERNELS}}
            | extra))

    # (a) the seqlen curriculum: S = 1024, 1280, 1792, 2048
    config = dict(TRAIN_CONFIG, **sections["a_curriculum"])
    engine, r = _extras_run("a_curriculum", spec, config, batch,
                            EXTRAS_STEPS)
    del engine
    _free()
    _extras_rates(r, B * sum(r["seqs"]), sum(
        _pass_flops(cfg, r["n_params"], B, [s] * L, s) for s in r["seqs"]))
    checks["(a) S = 1024, 1280, 1792, 2048"] = \
        r["seqs"] == [1024, 1280, 1792, 2048]
    law("a_curriculum", r["launches"], 2 * L * EXTRAS_STEPS,
        L * EXTRAS_STEPS)
    report("a_curriculum", r, seqs=r["seqs"])

    # (b) random-LTD: layers 1 .. 14 on 1024 of the 2048 tokens
    config = dict(TRAIN_CONFIG, **sections["b_random_ltd"])
    engine, r = _extras_run("b_random_ltd", spec, config, batch,
                            EXTRAS_STEPS)
    del engine
    _free()
    keep = S // 2
    _extras_rates(r, B * S * EXTRAS_STEPS, EXTRAS_STEPS * _pass_flops(
        cfg, r["n_params"], B, [S] + [keep] * (L - 2) + [S], S))
    checks["(b) every step keeps 1024 tokens"] = \
        r["draws"] == [[{"ltd_keep": keep}]] * EXTRAS_STEPS
    law("b_random_ltd", r["launches"], 2 * L * EXTRAS_STEPS,
        L * EXTRAS_STEPS)
    report("b_random_ltd", r, kept_tokens=keep)

    # (c) progressive layer drop: theta 0.5, gamma 0.1
    config = dict(TRAIN_CONFIG, **sections["c_pld"])
    engine, r = _extras_run("c_pld", spec, config, batch, EXTRAS_PLD_STEPS)
    del engine
    _free()
    kept = [sum(d[0]["pld_keep"]) for d in r["draws"]]
    _extras_rates(r, B * S * EXTRAS_PLD_STEPS, sum(
        _pass_flops(cfg, r["n_params"], B, [S] * k, S) for k in kept))
    checks["(c) layers dropped"] = sum(kept) < L * EXTRAS_PLD_STEPS
    law("c_pld", r["launches"], 2 * sum(kept), sum(kept))
    report("c_pld", r, kept_layers=kept)

    # (d) compression: 8-bit weights and 50 % sparse on every layer
    # matmul from the second step, 8-bit activations from the third
    config = dict(TRAIN_CONFIG, **sections["d_compression"])
    engine, r = _extras_run("d_compression", spec, config, batch,
                            EXTRAS_STEPS)
    checks["(d) activation quant on"] = \
        engine._act_quant_on and engine.model.config.activation_quant_bits == 8
    w_in = engine.params["layers"]["w_in"]
    with torch.no_grad():
        sort_ms = cuda_ms(lambda: torch.sort(w_in.float().abs().reshape(-1)),
                          iters=3, warmup=1)
        transform_ms = cuda_ms(lambda: engine._compression.apply(
            engine.params, 10 ** 9), iters=3, warmup=1)
        out = engine._compression.apply(engine.params, 10 ** 9)
        dense = float((out["layers"]["w_in"] != 0).float().mean())
    del engine, out
    _free()
    _extras_rates(r, B * S * EXTRAS_STEPS, EXTRAS_STEPS * _pass_flops(
        cfg, r["n_params"], B, [S] * L, S))
    # the threshold's 8-bit level is kept whole (ties: >=)
    checks["(d) w_in about half dense"] = 0.5 <= dense < 0.55
    law("d_compression", r["launches"], 2 * L * EXTRAS_STEPS,
        L * EXTRAS_STEPS)
    report("d_compression", r, w_in_sort_ms=sort_ms,
           transform_ms=transform_ms, w_in_values=w_in.numel(),
           w_in_dense=dense)

    # (e) layer reduction to 8 of 16 layers, distilled from the 16-layer
    # teacher (frozen, bf16)
    teacher_np = _seeded_params(cfg, 0)
    teacher = params_from_numpy(teacher_np, cfg, device="cuda", dtype=bf)
    student_np = compress.student_params_from_teacher(
        teacher_np, list(EXTRAS_STUDENT))
    del teacher_np
    # the config's ``transformer`` section would make the engine rebuild
    # the spec from its config (dropping the distillation loss, as JAX's
    # does): fused_backward goes into the student's config instead
    scfg = dataclasses.replace(cfg, num_layers=len(EXTRAS_STUDENT),
                               fused_backward=True)
    kd = dataclasses.replace(make_model(scfg, "llama-1b-student"),
                             loss_fn=make_distillation_loss(scfg, teacher,
                                                            cfg))
    config = {k: v for k, v in TRAIN_CONFIG.items() if k != "transformer"}
    engine, r = _extras_run("e_distillation", kd, config, batch,
                            EXTRAS_STEPS, params=student_np)
    del engine, teacher, student_np, kd
    _free()
    Ls = len(EXTRAS_STUDENT)
    t_params = r["n_params"] + (L - Ls) * (
        r["n_params"] - 2 * cfg.vocab_size * cfg.hidden_size) / Ls
    _extras_rates(r, B * S * EXTRAS_STEPS, EXTRAS_STEPS * (
        _pass_flops(scfg, r["n_params"], B, [S] * Ls, S)
        + _pass_flops(cfg, t_params, B, [S] * L, S, fwd_only=True)))
    law("e_distillation", r["launches"], (2 * Ls + L) * EXTRAS_STEPS,
        Ls * EXTRAS_STEPS)
    report("e_distillation", r, student_layers=Ls, teacher_layers=L)

    # (f) MoQ 16 -> 8 bits with the eigenvalue probe, 4 layers
    mcfg = _llama1b_train(EXTRAS_MOQ_LAYERS, S)
    config = dict(TRAIN_CONFIG, **sections["f_moq"])
    engine, r = _extras_run("f_moq", make_model(mcfg, "llama-1b"), config,
                            batch, EXTRAS_STEPS)
    moq = engine._moq
    probes = 2                        # steps 0 and 2 (every 2 x period)
    checks["(f) probes at steps 0 and 2"] = moq._last_ev_step == 2
    bits = moq.bits(EXTRAS_STEPS).tolist()
    scales = moq._period_scale.tolist()
    del engine
    _free()
    Lm, passes = EXTRAS_MOQ_LAYERS, 2 * (EXTRAS_MOQ_ITERS + 1)
    _extras_rates(r, B * S * EXTRAS_STEPS, (EXTRAS_STEPS + probes * passes)
                  * _pass_flops(mcfg, r["n_params"], B, [S] * Lm, S))
    law("f_moq", r["launches"],
        2 * Lm * (EXTRAS_STEPS + probes * passes),
        Lm * (EXTRAS_STEPS + probes * passes))
    report("f_moq", r, layers=Lm, probe_passes=probes * passes,
           period_scales=scales, bits_after=bits)

    # (g) f32 identities: each run through the kernels and the plain
    # versions
    rec["g"] = {}
    id_sections = _extras_sections(EXTRAS_ID_S)
    # steps 1 and 2 must drop a layer of two (the seeded coins drop
    # layer 1 at both), and every transform must be on from step 1
    id_sections["c_pld"] = {"progressive_layer_drop": {
        "enabled": True, "theta": 0.1, "gamma": 5.0}}
    act = id_sections["d_compression"]["compression_training"][
        "activation_quantization"]
    act["shared_parameters"]["schedule_offset"] = 2
    for name, sec in id_sections.items():
        ident = _extras_identity(name, sec)
        rec["g"][name] = ident
        checks[f"(g) {name}: every step's loss 1e-5, grads 1e-4"] = \
            max(ident["loss_rel_err"]) <= 1e-5 \
            and max(ident["grad_rel_l2"]) <= 1e-4
        checks[f"(g) {name}: the same draws"] = ident["draws_equal"]
        law = ident["law"]
        checks[f"(g) {name}: kernels B1 == {law['B1']}, B2 == B3 == "
               f"{law['B2']}"] = ident["law_ok"]
        checks[f"(g) {name}: plain run launched no kernel"] = \
            ident["plain_launches"] == 0
    checks["(g) c_pld: a layer dropped"] = \
        sum(rec["g"]["c_pld"]["layers_run"]) < ID_LAYERS * EXTRAS_ID_STEPS
    comp = rec["g"]["d_compression"]
    checks["(g) d_compression: activation quant on"] = \
        comp["act_quant_on"] and comp["act_calls"] > 0
    checks["(g) d_compression: activation levels equal but for boundary "
           "flips"] = not comp["act_faults"]
    log(f"phase 22 (g) f32 [{smi}] " + json.dumps(
        {k: {kk: v[kk] for kk in ("layers", "layers_run", "probes",
                                  "loss_rel_err", "grad_rel_l2",
                                  "draws_equal", "launches", "law",
                                  "plain_launches", "act_calls",
                                  "act_flips", "act_values", "act_faults",
                                  "own_levels_loss_rel_err",
                                  "own_levels_grad_rel_l2") if kk in v}
         for k, v in rec["g"].items()}))
    rec.update(flash_cases=flash, bwd_cases=bwd, launches=launches,
               phase_s=time.perf_counter() - t_phase)
    total = {k: sum(v.get(k, 0) for v in launches.values())
             for k in FLASH_KERNELS}
    log(f"phase 22: {rec['phase_s']:.1f}s, launches {json.dumps(total)}, "
        f"checks {json.dumps(checks)}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"phase 22: failed {failed}")
    return rec


# --------------------------------------------------------------------------
# phase 23: the model families and the block-sparse model on a mesh
# --------------------------------------------------------------------------

FM_LAYERS = 4             # Pythia-1.4b, the BigBird model: 4 of their layers
FM_BLOOM_LAYERS = 2       # BLOOM-1b7 width, 2 of its 24 layers
FM_STEPS = 2              # Pythia's training steps after 1 warm-up step
FM_NEW = 32
FM_B, FM_S = 4, 2048
FM_SERVING = dict(max_seqs=8, block_size=64, max_model_len=1088,
                  decode_quantum=8)
FM_ID_B, FM_ID_S, FM_ID_NEW = 2, 256, 12


def _fm_batches(cfg, B, S, n, seed, masked=False):
    """``n`` batches of in-vocab ids on the card; ``masked``: each row r
    of the batch padded past S - 37 r (a key mask)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"input_ids": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S), dtype=np.int32)).cuda()}
        if masked:
            b["attention_mask"] = (
                torch.arange(S, device="cuda")[None, :]
                < torch.tensor([S - 37 * r for r in range(B)],
                               device="cuda")[:, None]).to(torch.int32)
        out.append(b)
    return out


def _fm_halved(path: str) -> bool:
    """Which leaves a tensor=2 rank holds half of: every column, row and
    vocab leaf; the row biases (``bo``, ``b_out``) and the norms stay
    whole."""
    leaf = path.rsplit("/", 1)[-1]
    return not (leaf in ("bo", "b_out") or leaf.startswith("ln")
                or "norm" in leaf)


def _fm_serve(rank, cfg, name, prompts, n_new, serving, plan, params=None,
              seed=0, before=None):
    """A warm-up request on a first serving engine, then ``prompts`` on a
    fresh one over the same weights (every rank's launch counts zeroed
    just before; rank 0 drives, the other serves its device calls).
    Every rank: its launches and resident param bytes; rank 0: the
    generated streams (checked) and the stats."""
    from deepspeed_tpu_torch import init_serving, make_model
    from deepspeed_tpu_torch.inference.serving import ServingEngine
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.parallel import sharded_bytes
    dtype = cfg.dtype
    warm = init_serving(make_model(cfg, name), config={"kv_cache_bits": 0},
                        serving=serving, params=params, dtype=dtype,
                        seed=seed, mesh=plan)
    if rank == 0:
        warm.run([(prompts[0][:64], 4)])
        warm.close()
    else:
        warm.run_worker()
    srv = ServingEngine(warm.engine, warm.config, seed=seed)
    del warm
    rec = {"param_bytes": sharded_bytes(srv.engine.params)}
    if before is not None:
        before()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    if rank == 0:
        t0 = time.perf_counter()
        outs = srv.run([(p, n_new) for p in prompts])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        gens = [np.asarray(outs[k][len(p):])
                for k, p in zip(sorted(outs), prompts)]
        bad = [i for i, g in enumerate(gens) if g.size != n_new
               or g.min() < 0 or g.max() >= cfg.vocab_size]
        if bad:
            raise RuntimeError(f"phase 23 {name}: requests {bad} returned "
                               f"{[gens[i].size for i in bad]} tokens or "
                               f"tokens past the vocabulary of "
                               f"{cfg.vocab_size}")
        st = srv.stats()
        rec.update(streams=[outs[k] for k in sorted(outs)], wall_s=wall,
                   held_blocks_after=srv.allocator.used_blocks,
                   decode_backend=srv.decode_backend,
                   **{k: st.get(k) for k in (
                       "p50_ttft_ms", "p50_itl_ms", "tok_per_sec",
                       "prefills", "decode_steps", "preemptions", "tp",
                       "recoveries")})
        srv.close()
    else:
        srv.run_worker()
    rec["launches"] = _build.launch_counts()
    del srv
    _free()
    return rec


def _fm_streams(rank, cfg, name, prompts, plan):
    """f32 greedy streams at ``plan`` (every rank) and, on rank 0, at
    world 1 on the same seeded weights: whether they are identical."""
    params = _family_params(cfg, 7, torch.float32)
    got = _fm_serve(rank, cfg, name, prompts, FM_ID_NEW, FM_SERVING, plan,
                    params=params)
    if rank:
        del params
        _free()
        return None
    one = _fm_serve(0, cfg, name, prompts, FM_ID_NEW, FM_SERVING, None,
                    params=params)
    del params
    _free()
    return all(np.array_equal(a, b)
               for a, b in zip(got["streams"], one["streams"]))


def _fm_rank(rank, world, prompts, sparse_prompts, bloom_ids):
    """One rank of phase 23 (a)-(d), both ranks on cuda:0 over gloo.
    Returns every rank's record (on rank 0)."""
    import torch.distributed as dist
    from deepspeed_tpu_torch import init_inference, llama_config, make_model
    from deepspeed_tpu_torch.ops import _build
    from deepspeed_tpu_torch.parallel import MeshPlan
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    bf, f32 = torch.bfloat16, torch.float32
    tp2 = MeshPlan(tensor=2)
    rec = {}
    # (a) Pythia-1.4b at full width, 4 layers, tensor=2: served, trained
    cfg = _family_cfg("pythia-1.4b", FM_LAYERS)
    rec["a_serving"] = _fm_serve(rank, cfg, "pythia-1.4b", prompts, FM_NEW,
                                 FM_SERVING, tp2,
                                 params=_family_params(cfg, 0, bf))
    mark_part("(a) pythia-1.4b served at tensor=2")
    tcfg = dataclasses.replace(cfg, max_seq_len=FM_S, remat=True,
                               remat_policy="dots_saveable", loss_chunk=FM_S)
    engine, rec["a_training"] = _mp_run(
        tcfg, dict(TRAIN_CONFIG, train_batch_size=FM_B, **TP2),
        _fm_batches(tcfg, FM_B, FM_S, 1 + FM_STEPS, 1), "pythia-1.4b",
        params=_family_params(tcfg, 1, f32))
    del engine
    _free()
    # (b) BLOOM-1b7 width, 2 layers, tensor=2: bf16 logits against world 1
    bcfg = _family_cfg("bloom-1b7", FM_BLOOM_LAYERS)
    bparams = _family_params(bcfg, 2, bf)
    ids = torch.as_tensor(bloom_ids).cuda()
    eng = init_inference(make_model(bcfg, "bloom-1b7"),
                         config={"kv_cache_bits": 0}, dtype=bf,
                         params=bparams, mesh=tp2)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    logits = eng.forward(ids)
    torch.cuda.synchronize()
    rec["b"] = {"launches": _build.launch_counts(),
                "finite": bool(torch.isfinite(logits).all()),
                "shape": list(logits.shape)}
    del eng
    _free()
    if rank == 0:
        one = init_inference(make_model(bcfg, "bloom-1b7"),
                             config={"kv_cache_bits": 0}, dtype=bf,
                             params=bparams)
        rec["b"]["rel_l2_vs_world1"] = rel_l2(logits, one.forward(ids))
        del one
    del logits, bparams
    _free()
    mark_part("(b) bloom-1b7 logits at tensor=2")
    # (c) the BigBird llama-1b-width model, 4 layers, tensor=2, phase 15
    # (a)'s load
    scfg = llama_config("1b", num_layers=FM_LAYERS, max_seq_len=8192,
                        sparse_attention=SPARSE_MODEL)
    rec["c"] = _fm_serve(rank, scfg, "llama-1b BigBird", sparse_prompts, 32,
                         SPARSE_SERVING, tp2, before=_clear_sparse_tables)
    rec["c"].pop("streams", None)
    mark_part("(c) BigBird llama-1b served at tensor=2")
    # (d) f32, 2 layers, against world 1
    ident = {}
    for name, plan_cfg, masked in (
            ("pythia-1.4b", TP2, False), ("bloom-1b7", TP2, False),
            ("bert-large", TP2, True),
            ("bert-large", {"zero_optimization": {"stage": 3}}, True)):
        c = _family_cfg(name, ID_LAYERS, dtype=f32, max_seq_len=FM_ID_S)
        what = name + (" ZeRO-3" if "zero_optimization" in plan_cfg
                       else " tensor=2")
        ident[what] = _f32_identity(
            rank, c, dict(MP_F32_CONFIG, **plan_cfg),
            _fm_batches(c, FM_ID_B, FM_ID_S, MP_F32_STEPS, 3, masked), name,
            params=_family_params(c, 4, f32))
    rng = np.random.default_rng(23)
    for name in ("pythia-1.4b", "bloom-1b7"):
        c = _family_cfg(name, ID_LAYERS, dtype=f32)
        ps = [rng.integers(0, c.vocab_size, n).astype(np.int32)
              for n in (100, 300)]
        ident[f"{name} streams"] = _fm_streams(rank, c, name, ps, tp2)
    rec["d"] = ident
    mark_part("(d) f32 identities")
    out = [None] * world
    dist.all_gather_object(out, rec)
    return out if rank == 0 else None


def families_mesh_phase(smi: str):
    """Phase 23: the families and the block-sparse model on a mesh."""
    from deepspeed_tpu_torch.parallel.launch import run_group
    t_phase = time.perf_counter()
    _free()
    bf = torch.bfloat16
    pyth = ("pythia-1.4b tensor=2 rank", 8, 8, 128)
    flash = [flash_case(f"{pyth[0]} S=1024", 1, 1024, *pyth[1:], bf),
             flash_case(f"{pyth[0]} training B={FM_B} S={FM_S}", FM_B, FM_S,
                        *pyth[1:], bf)]
    bwd = [bwd_case(f"{pyth[0]} training B={FM_B} S={FM_S}", FM_B, FM_S,
                    *pyth[1:], bf)]
    decode = [decode_case(f"{pyth[0]} 8/8 D=128 8 slots", 8, 8, 8, 128, 64,
                          17, [0, 63, 64, 200, 513, 900, 1024, 1056], bf)]
    sparse = [sparse_case(*FM_SPARSE_CASE[:8], **FM_SPARSE_CASE[8])]
    _free()
    rng = np.random.default_rng(230)
    lengths = (64, 192, 320, 448, 576, 704, 832, 1024)
    prompts = [rng.integers(0, 50304, n).astype(np.int32) for n in lengths]
    srng = np.random.default_rng(SPARSE_PROMPT_SEED)
    sparse_prompts = [srng.integers(0, VOCAB, size=int(n)).astype(np.int32)
                      for n in sparse_prompt_lengths(srng)]
    bloom_ids = rng.integers(0, 250880, (1, 512)).astype(np.int64)
    ranks = run_group(_fm_rank, 2, prompts, sparse_prompts, bloom_ids,
                      timeout_s=900)
    checks, L = {}, FM_LAYERS
    cfg = _family_cfg("pythia-1.4b", FM_LAYERS)
    tcfg = dataclasses.replace(cfg, max_seq_len=FM_S)
    st_a, st_c = ranks[0]["a_serving"], ranks[0]["c"]
    serve_law = _leaf_bytes(cfg, _fm_halved, 2)
    train_law = {"params": _leaf_bytes(tcfg, _fm_halved, 2),
                 "opt": _leaf_bytes(tcfg, _fm_halved, 12),
                 "grads": _leaf_bytes(tcfg, _fm_halved, 4)}
    for i, r in enumerate(ranks):
        la = r["a_serving"]["launches"]
        checks[f"(a) rank {i} B1 == prefills x {L}"] = \
            la["flash_fwd"] == st_a["prefills"] * L and \
            st_a["prefills"] == len(prompts)
        checks[f"(a) rank {i} B4 == decode steps x {L}"] = \
            la["paged_decode"] == st_a["decode_steps"] * L > 0
        checks[f"(a) rank {i} served param bytes == the law"] = \
            r["a_serving"]["param_bytes"] == serve_law
        tr = r["a_training"]
        checks[f"(a) rank {i} training finite"] = \
            bool(np.all(np.isfinite(tr["losses"])))
        checks[f"(a) rank {i} B1 == 2 x {L}, B2 == B3 == {L} a step"] = \
            tr["launches"]["flash_fwd"] == 2 * FM_STEPS * L and \
            tr["launches"]["flash_bwd_dq"] == \
            tr["launches"]["flash_bwd_dkv"] == FM_STEPS * L
        checks[f"(a) rank {i} bytes of params, opt, grads == the law"] = \
            tr["bytes"] == train_law
        checks[f"(b) rank {i} B1 == B4 == 0, finite logits"] = \
            r["b"]["launches"]["flash_fwd"] == 0 and \
            r["b"]["launches"]["paged_decode"] == 0 and r["b"]["finite"]
        lc = r["c"]["launches"]
        checks[f"(c) rank {i} B5 == prefills x {L}, B4 == decode steps x "
               f"{L}, B1 == 0"] = \
            lc["sparse_fwd"] == st_c["prefills"] * L and \
            st_c["prefills"] == len(sparse_prompts) and \
            lc["paged_decode"] == st_c["decode_steps"] * L and \
            lc["flash_fwd"] == 0
    checks["(a) decode route: the paged kernel"] = \
        st_a["decode_backend"] == "pallas"
    checks["(a, c) pools empty after"] = \
        st_a["held_blocks_after"] == 0 == st_c["held_blocks_after"]
    checks["(b) bf16 logits within 2e-2 of world 1"] = \
        ranks[0]["b"]["rel_l2_vs_world1"] <= 2e-2
    ident = ranks[0]["d"]
    for what, got in ident.items():
        if what.endswith("streams"):
            checks[f"(d) f32 {what} token-identical to world 1"] = got
        else:
            checks[f"(d) f32 {what} == world 1: losses 1e-5, params 1e-5"] \
                = got["loss_rel_err"] <= 1e-5 and \
                got["params_rel_l2"] <= 1e-5
    launches = {
        "families_mesh": {k: sum(
            r[part]["launches"].get(k, 0) for r in ranks
            for part in ("a_serving", "a_training", "c"))
            for k in FLASH_KERNELS + ("paged_decode", "sparse_fwd")}}
    rec = {"card": smi, "timing": ZERO_SHARED, "flash_cases": flash,
           "bwd_cases": bwd, "decode_cases": decode, "sparse_cases": sparse,
           "launches": launches, "phase_s": time.perf_counter() - t_phase}
    log(f"phase 23 (a) pythia-1.4b tensor=2 [{smi}; {ZERO_SHARED}] "
        + json.dumps({
            "serving": {k: st_a.get(k) for k in (
                "p50_ttft_ms", "p50_itl_ms", "tok_per_sec", "prefills",
                "decode_steps", "wall_s", "decode_backend")},
            "serving_launches": [r["a_serving"]["launches"] for r in ranks],
            "param_bytes": [r["a_serving"]["param_bytes"] for r in ranks],
            "param_bytes_law": serve_law,
            "training": {k: [r["a_training"][k] for r in ranks] for k in (
                "losses", "step_ms_wall", "peak_mem_gib", "bytes",
                "launches", "plan")},
            "training_bytes_law": train_law}))
    log(f"phase 23 (b) bloom-1b7 tensor=2 [{smi}] " + json.dumps(
        [r["b"] for r in ranks]))
    log(f"phase 23 (c) BigBird llama-1b tensor=2 [{smi}] " + json.dumps(
        {"ranks": [{k: r["c"][k] for k in ("launches", "param_bytes")}
                   for r in ranks]}
        | {k: st_c.get(k) for k in ("p50_ttft_ms", "p50_itl_ms",
                                    "tok_per_sec", "prefills",
                                    "decode_steps", "wall_s")}))
    log(f"phase 23 (d) f32 {ID_LAYERS} layers [{smi}] " + json.dumps(ident))
    log(f"phase 23: {rec['phase_s']:.1f}s, launches {json.dumps(launches)}, "
        f"checks {json.dumps(checks)}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise RuntimeError(f"phase 23: failed {failed}")
    return rec


def kernel_line(name, replaces, launches, cases, main, variant=None):
    rec = {k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")}
    return {"name": f"{name} ({variant})" if variant else name,
            "route": "cuda",
            "source": f"deepspeed_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            **rec, "shape": main["shape"], "cases": cases}


def _watch_recoveries():
    """Every serving round recovery in this process, by reason (a list
    the caller reads): a kernel failure the engine recovered from must
    not pass unseen."""
    from deepspeed_tpu_torch.inference.serving import ServingEngine
    seen, recover = [], ServingEngine._recover

    def counted(self, reason):
        seen.append(reason)
        return recover(self, reason)
    ServingEngine._recover = counted
    return seen


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
    card = smi.stdout.strip()
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability (9, 0), got {cap}")
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recovered = _watch_recoveries()
    t_start = time.perf_counter()

    warmers = start_flex_warmup()
    build_s, build_info = timed("build", build_phase)
    timed("flex_warmup_wait", wait_flex_warmup, warmers)

    flash, decode, bwd = timed("kernels", kernel_phase)
    flash16, decode16, bwd16 = timed("kernels_f16", kernel_phase_f16)
    sparse = timed("sparse_kernels", sparse_kernel_phase)
    srv, st, launches, served = timed("serving", serving_phase)
    times = timed("serving_step_times", step_times, srv)
    _, drift = timed("cross_check", cross_check, srv)
    bf16_drift = max(drift["bf16_kernels_vs_f32_plain"].values())
    breadth = timed("11_serving_breadth", serving_breadth_phase, srv, card,
                    bf16_drift)
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    quant = timed("12_quantized_spec", quantized_spec_phase, card,
                  bf16_drift, served)
    lora = timed("13_lora_handoff", lora_handoff_phase, card, served,
                 times["decode_step_16x1000_ms"])
    _free()
    sharded = timed("14_sharded_serving", sharded_serving_phase, card,
                    served, times["decode_step_16x1000_ms"])
    train = timed("training", training_phase,
                  next(c for c in flash
                       if c["case"].startswith("llama-1b training")),
                  bwd[0])
    timed("training_cross_check", training_cross_check)
    resume = timed("10_resume", resume_phase, card)
    sparse_train = timed("sparse_training", sparse_training_phase,
                         sparse[0])
    timed("sparse_cross_check", training_cross_check, S=2048,
          sparse=SPARSE_MODEL)
    p15 = timed("15_breadth", phase15, card, served, train)
    p16 = timed("16_zero_training", zero_training_phase, card)
    # serving engines recover a failed round by default: no phase before
    # the fleet's fault soak injects a fault, so none may have recovered
    if recovered:
        raise RuntimeError(f"a serving round was recovered before phase "
                           f"17: {recovered}")
    p17 = timed("17_fleet", fleet_phase, card, served, bf16_drift)
    p18 = timed("18_capacity", capacity_phase, card)
    p19 = timed("19_model_parallel", model_parallel_phase, card)
    p20 = timed("20_pipeline_ring", pipeline_ring_phase, card)
    p21 = timed("21_model_families", model_families_phase, card)
    p22 = timed("22_training_extras", training_extras_phase, card)
    p23 = timed("23_families_mesh", families_mesh_phase, card)
    # B1-B3 held at a ZeRO rank's shapes too, at the MoE cell's and a
    # tensor=2 rank's (D=128), and at GPT-2 1.3b's and BERT-large's; B4 at
    # GPT-2 1.3b's decode
    flash.append(p16["flash_case"])
    bwd.append(p16["bwd_case"])
    flash += p19["flash_cases"] + p21["flash_cases"] + p22["flash_cases"] \
        + p23["flash_cases"]
    bwd += p19["bwd_cases"] + p21["bwd_cases"] + p22["bwd_cases"] \
        + p23["bwd_cases"]
    decode += p21["decode_cases"] + p23["decode_cases"]
    sparse += p23["sparse_cases"]

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
    for entry in line["kernels"][:4]:
        name = entry["name"]
        if name == "paged_decode":
            continue
        entry["launches_by_path"] = {
            "training": tl[name],
            "resume": (resume["launches_uninterrupted"][name]
                       + resume["launches_resumed"][name])}
    line["kernels"][0]["launches_by_path"]["serving"] = launches["flash_fwd"]
    # phase 11's runs: generate's prefill (a) and the warm load (b)
    for entry in line["kernels"][:2]:
        name = entry["name"]
        n = breadth["generate"]["launches"][name] + breadth["launches"][name]
        entry["launches"] += n
        entry.setdefault("launches_by_path", {})["serving_breadth"] = n
    line["kernels"][1]["launches_by_path"]["serving"] = \
        launches["paged_decode"]
    # phase 12's loads: speculation on and off, the int8 pool, int8 weights
    for entry in line["kernels"][:2]:
        n = quant["launches"][entry["name"]]
        entry["launches"] += n
        entry["launches_by_path"]["quantized_spec"] = n
    # phase 13's loads: the multi-LoRA load and the handoff's decode engine
    for entry in line["kernels"][:2]:
        n = lora["launches"][entry["name"]]
        entry["launches"] += n
        entry["launches_by_path"]["lora_handoff"] = n
    # phase 14's loads: the MoE engine on one card, and every rank of the
    # tp=2 and ep=2 engines
    for entry in line["kernels"][:2]:
        n = sharded["launches"][entry["name"]]
        entry["launches"] += n
        entry["launches_by_path"]["sharded"] = n
    # phase 15: B5 on the sparse model's serving prefills; B1-B4's f16
    # instantiations on the fp16 training and f16 serving paths
    sparse_entry = line["kernels"][4]
    sparse_entry["launches"] += p15["sparse_serving"]
    sparse_entry["launches_by_path"] = {"training": sl["sparse_fwd"],
                                        "sparse_serving": p15["sparse_serving"]}
    # B4 in the sparse model's decode; B1 and B4 in (a)'s dense twin and
    # in (c)'s bf16 twin of the f16 load
    for entry in line["kernels"][:2]:
        for path, counts in p15["bf16_by_path"].items():
            n = counts.get(entry["name"], 0)
            if n:
                entry["launches"] += n
                entry["launches_by_path"][path] = n
    # phase 16: every rank of the ZeRO stages' llama-1b runs
    for entry in line["kernels"]:
        n = p16["launches"].get(entry["name"], 0)
        if n:
            entry["launches"] += n
            entry["launches_by_path"]["zero_training"] = n
    # phase 17: the bf16 fleet (a, b: per replica and role in the phase's
    # lines) and the f32 fleet (c-e)
    for entry in line["kernels"][:2]:
        for path, counts in p17["launches"].items():
            entry["launches"] += counts[entry["name"]]
            entry["launches_by_path"][path] = counts[entry["name"]]
    # phase 18: the llama-1b cell on the on-device run and routes (i)-(iv)
    for entry in line["kernels"]:
        n = p18["launches"].get(entry["name"], 0)
        if n:
            entry["launches"] += n
            entry["launches_by_path"]["capacity"] = n
    # phase 19: the MoE cell, and every rank of expert=2 and tensor=2
    # phase 20: every rank of pipe=2 (pipeline), of seq=2 (ring) and of
    # the data=2 generate
    # phase 21: GPT-2 1.3b served and trained, BERT-large's forward and
    # training, Pythia / GPT-Neo / BLOOM served
    for p in (p19, p20, p21):
        for entry in line["kernels"][:4]:
            for path, counts in p["launches"].items():
                n = counts.get(entry["name"], 0)
                if n:
                    entry["launches"] += n
                    entry["launches_by_path"][path] = n
    # phase 22: the six training-extras runs (a)-(f) at llama-1b width
    for entry in line["kernels"][:4]:
        n = sum(c.get(entry["name"], 0) for c in p22["launches"].values())
        if n:
            entry["launches"] += n
            entry["launches_by_path"]["training_extras"] = n
    # phase 23: every rank of Pythia served and trained at tensor=2 and of
    # the BigBird model served at tensor=2
    for entry in line["kernels"][:5]:
        n = p23["launches"]["families_mesh"].get(entry["name"], 0)
        if n:
            entry["launches"] += n
            entry["launches_by_path"]["families_mesh"] = n
    for name, site, cases, main_case in (
            ("flash_fwd", "deepspeed_tpu/ops/flash_attention.py:220",
             flash16, flash16[1]),
            ("paged_decode", "deepspeed_tpu/ops/decode_attention.py:172",
             decode16, decode16[0]),
            ("flash_bwd_dq", "deepspeed_tpu/ops/flash_attention.py:426",
             [c["dq"] for c in bwd16], bwd16[0]["dq"]),
            ("flash_bwd_dkv", "deepspeed_tpu/ops/flash_attention.py:452",
             [c["dkv"] for c in bwd16], bwd16[0]["dkv"])):
        entry = kernel_line(name, site, p15["f16"][name], cases, main_case,
                            variant="f16")
        entry["launches_by_path"] = {
            "fp16_training": p15["f16_by_path"]["training"][name],
            "f16_serving": p15["f16_by_path"]["serving"][name]}
        line["kernels"].append(entry)
    log("phase_s " + json.dumps({"phase": "total",
                                 "s": time.perf_counter() - t_start}))
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind("cuda:0"),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--flex-warmup"]:
        sys.exit(flex_warmup(int(sys.argv[2])))
    sys.exit(main())
