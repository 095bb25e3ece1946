"""Optimizer registry, a port of ``deepspeed_tpu/ops/registry.py``: the
config's optimizer name -> its builder, JAX's table. The names the JAX
package knows are all accepted by the config. The host-offloaded names
build the device optimizer they stand for, as in JAX (``cpuadam`` ->
AdamW, ``cpuadagrad`` -> Adagrad); the host update itself is the
``offload_optimizer.use_cpu_adam`` route (``runtime/swap_tensor.py``).
The 1-bit
family (``ops/onebit.py``) composes with ``compression_training`` and
MoQ in JAX; on its compressed path (pure data parallel at stage 0) the
port's engine raises for either, naming ROADMAP A11 (training extras
under 1-bit and offload)."""

SUPPORTED_OPTIMIZERS = {
    "adam", "adamw", "fusedadam", "sgd", "lamb", "fusedlamb", "adagrad",
    "onebitadam", "onebitlamb", "zerooneadam", "lion", "cpuadam", "cpuadagrad",
}

def get_optimizer_builder(name: str):
    from deepspeed_tpu_torch.ops.adam import adam, adamw
    from deepspeed_tpu_torch.ops.lamb import lamb
    from deepspeed_tpu_torch.ops.onebit import (onebit_adam, onebit_lamb,
                                                zero_one_adam)
    from deepspeed_tpu_torch.ops.optimizers import adagrad, lion, sgd
    name = name.lower()
    table = {"adam": adam, "fusedadam": adam, "adamw": adamw, "sgd": sgd,
             "lamb": lamb, "fusedlamb": lamb, "adagrad": adagrad,
             "lion": lion, "onebitadam": onebit_adam,
             "onebitlamb": onebit_lamb, "zerooneadam": zero_one_adam,
             "cpuadam": adamw, "cpuadagrad": adagrad}
    if name in table:
        return table[name]
    raise ValueError(f"unknown optimizer '{name}'")
