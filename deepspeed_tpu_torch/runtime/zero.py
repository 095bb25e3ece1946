"""ZeRO stages on one device, a port of the single-device case of
``deepspeed_tpu/runtime/zero.py``.

In the JAX package a stage is a set of sharding rules over the data axis:
stage 1 shards the optimizer state, stage 2 also the gradient buffers,
stage 3 also the params. With one device every rule shards over an axis
of size 1, so the four stages run the same program (ZeRO-3 on one chip
still trains, as it does in the JAX package). Sharding over more than one
rank belongs to ROADMAP A4.
"""

import torch


def check_single_device(stage: int) -> None:
    """Raise when the default ``torch.distributed`` group has more than
    one rank: this slice runs every stage unsharded on one device."""
    ranks = 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        ranks = torch.distributed.get_world_size()
    if ranks > 1:
        raise NotImplementedError(
            f"ZeRO stage {stage} over {ranks} ranks is not ported yet: "
            "ROADMAP A4 (multi-device ZeRO over torch.distributed)")
