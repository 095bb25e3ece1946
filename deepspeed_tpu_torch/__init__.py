"""deepspeed_tpu_torch — the PyTorch/CUDA port of deepspeed_tpu for NVIDIA
Hopper (H100).

The JAX package ``deepspeed_tpu`` stays beside it as the reference; this
package imports nothing from it and never imports jax. This slice serves
llama-family models: continuous batching over a paged KV pool, with the
flash-forward (prefill) and paged-decode kernels written by hand in CUDA
(``csrc/``). It trains them on one card through ``initialize`` ->
``Engine.train_batch``, with the flash backward (dQ and dK/dV kernels)
in CUDA as well, and trains a block-sparse model (``sparse_attention``
layouts) through three more CUDA kernels (forward, dQ, dK/dV). Entry
points run on the card; ``device="cpu"`` runs the plain PyTorch versions
of the kernels instead.
"""

from deepspeed_tpu_torch.inference import (InferenceConfig, ServingConfig,
                                           init_inference, init_serving)
from deepspeed_tpu_torch.models import (TransformerConfig, llama_config,
                                        make_model)
from deepspeed_tpu_torch.runtime import initialize

__all__ = ["InferenceConfig", "ServingConfig", "TransformerConfig",
           "init_inference", "init_serving", "initialize", "llama_config",
           "make_model"]
