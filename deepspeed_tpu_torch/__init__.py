"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

The JAX package ``deepspeed_tpu`` stays beside it as the reference; this
package imports nothing from it and never imports jax. It serves
llama-family models and the other transformer families (GPT-2, OPT,
BLOOM, GPT-Neo, GPT-J, GPT-NeoX, BERT-style encoders; HF checkpoints from
local files through ``models.hf_import``): continuous batching over a paged KV pool, with the
flash-forward (prefill) and paged-decode kernels written by hand in CUDA
(``csrc/``), chunked prefill, a copy-on-write prefix cache, deadlines and
admission watermarks, one-shot ``generate`` on a contiguous cache,
greedy speculative decoding, an int8 KV cache (JAX's default from a
1024-token context), int8 weights, multi-LoRA and the KV handoff, and
it serves MoE models (``mixtral_config``) and shards serving over the
ranks of a ``torch.distributed`` group (tensor and expert parallel,
``parallel.MeshPlan``); a fleet of serving engines runs behind
``inference.ServingRouter`` (failover, prefill / decode roles with the
KV handoff, ``inference.FleetController``, round recovery, fault
injection, request tracing). It trains dense models on one card
through ``initialize`` ->
``Engine.train_batch``, with the flash backward (dQ and dK/dV kernels)
in CUDA as well, and trains a block-sparse model (``sparse_attention``
layouts) through three more CUDA kernels (forward, dQ, dK/dV). Entry
points run on the card; ``device="cpu"`` runs the plain PyTorch versions
of the kernels instead.
"""

from deepspeed_tpu_torch.inference import (InferenceConfig, ServingConfig,
                                           init_inference, init_serving)
from deepspeed_tpu_torch.models import (TransformerConfig, gpt2_config,
                                        llama_config, make_model)
from deepspeed_tpu_torch.runtime import initialize

__all__ = ["InferenceConfig", "ServingConfig", "TransformerConfig",
           "gpt2_config", "init_inference", "init_serving", "initialize",
           "llama_config", "make_model"]
