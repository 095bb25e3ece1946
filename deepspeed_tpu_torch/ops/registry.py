"""Optimizer registry, a port of ``deepspeed_tpu/ops/registry.py``: the
config's optimizer name -> its builder. The names the JAX package knows
are all accepted by the config; the ones this slice has not ported raise
when built, naming ROADMAP A3."""

SUPPORTED_OPTIMIZERS = {
    "adam", "adamw", "fusedadam", "sgd", "lamb", "fusedlamb", "adagrad",
    "onebitadam", "onebitlamb", "zerooneadam", "lion", "cpuadam", "cpuadagrad",
}


def get_optimizer_builder(name: str):
    from deepspeed_tpu_torch.ops.adam import adam, adamw
    name = name.lower()
    table = {"adam": adam, "fusedadam": adam, "adamw": adamw}
    if name in table:
        return table[name]
    if name in SUPPORTED_OPTIMIZERS:
        raise NotImplementedError(
            f"optimizer '{name}' is not ported yet: ROADMAP A3 (LAMB, Lion, "
            "SGD, Adagrad, the 1-bit family and the host-offloaded variants)")
    raise ValueError(f"unknown optimizer '{name}'")
