"""Optimizer registry, a port of ``deepspeed_tpu/ops/registry.py``: the
config's optimizer name -> its builder, JAX's table for the single-rank
optimizers. The names the JAX package knows are all accepted by the
config; the ones the port has not ported raise when built, naming their
ROADMAP item: the 1-bit family (A4: its phases exist to compress a
data-parallel all-reduce) and the host-offloaded variants (A8)."""

SUPPORTED_OPTIMIZERS = {
    "adam", "adamw", "fusedadam", "sgd", "lamb", "fusedlamb", "adagrad",
    "onebitadam", "onebitlamb", "zerooneadam", "lion", "cpuadam", "cpuadagrad",
}

_DEFERRED = {
    "onebitadam": "A4 (the 1-bit family compresses a data-parallel "
                  "gradient all-reduce)",
    "onebitlamb": "A4 (the 1-bit family compresses a data-parallel "
                  "gradient all-reduce)",
    "zerooneadam": "A4 (the 1-bit family compresses a data-parallel "
                   "gradient all-reduce)",
    "cpuadam": "A8 (host-offloaded optimizers)",
    "cpuadagrad": "A8 (host-offloaded optimizers)",
}


def get_optimizer_builder(name: str):
    from deepspeed_tpu_torch.ops.adam import adam, adamw
    from deepspeed_tpu_torch.ops.lamb import lamb
    from deepspeed_tpu_torch.ops.optimizers import adagrad, lion, sgd
    name = name.lower()
    table = {"adam": adam, "fusedadam": adam, "adamw": adamw, "sgd": sgd,
             "lamb": lamb, "fusedlamb": lamb, "adagrad": adagrad,
             "lion": lion}
    if name in table:
        return table[name]
    if name in _DEFERRED:
        raise NotImplementedError(f"optimizer '{name}' is not ported yet: "
                                  f"ROADMAP {_DEFERRED[name]}")
    raise ValueError(f"unknown optimizer '{name}'")
