"""Offline checkpoint -> consolidated fp32 state dict (no engine needed), a
port of ``deepspeed_tpu/utils/zero_to_fp32.py``.

The port's checkpoints hold one ``.npy`` per leaf (``runtime/
checkpointing.py``), so this reads them with numpy alone: the fp32 MASTER
weights from the optimizer state (``opt/master/...``) where present, else
the params widened to f32 (bf16 from its uint16 bits, exactly). The keys
are JAX's flattened names without the ``params/`` prefix, as the JAX tool
emits them. ZeRO-Infinity layer-chunk and NVMe-swap checkpoints belong to
ROADMAP A8 and raise.

CLI:  python -m deepspeed_tpu_torch.utils.zero_to_fp32 <ckpt_dir> <out.npz>
      [--tag T]
"""

import argparse
import os
from typing import Dict, Optional

import numpy as np

from deepspeed_tpu_torch.runtime.checkpointing import LATEST_FILE, read_payload

__all__ = ["convert_zero_checkpoint_to_fp32_state_dict",
           "get_fp32_state_dict_from_zero_checkpoint"]


def _resolve_tag(ckpt_dir: str, tag: Optional[str]) -> str:
    if tag is not None:
        return str(tag)
    latest = os.path.join(ckpt_dir, LATEST_FILE)
    if not os.path.exists(latest):
        raise FileNotFoundError(f"no '{LATEST_FILE}' file under {ckpt_dir} "
                                "and no --tag given")
    with open(latest) as f:
        return f.read().strip()


def _widen(arr: np.ndarray, dtype: str) -> np.ndarray:
    """A stored leaf as a new f32 array; bf16 bits shifted into the high
    half (exact)."""
    if dtype == "bfloat16":
        return (arr.astype(np.uint32) << 16).view(np.float32)
    return np.array(arr, np.float32)


def get_fp32_state_dict_from_zero_checkpoint(ckpt_dir: str,
                                             tag: Optional[str] = None
                                             ) -> Dict[str, np.ndarray]:
    """Flat {name: fp32 array} dict from a checkpoint directory."""
    path = os.path.join(ckpt_dir, _resolve_tag(ckpt_dir, tag))
    for name, what in (("infinity_shapes.json", "ZeRO-Infinity layer chunks"),
                       ("optswap.npz", "NVMe-swapped optimizer state")):
        if os.path.exists(os.path.join(path, name)):
            raise NotImplementedError(
                f"{what} ({name}) are not ported yet: ROADMAP A8 "
                "(ZeRO-Offload / Infinity)")
    # memory-mapped: only the masters (or params) are read
    arrays, dtypes = read_payload(os.path.join(path, "state"), mmap=True)
    source = ("opt/master/" if any(k.startswith("opt/master/")
                                   for k in arrays) else "params/")
    return {k[len(source):]: _widen(v, dtypes[k])
            for k, v in arrays.items() if k.startswith(source)}


def convert_zero_checkpoint_to_fp32_state_dict(ckpt_dir: str,
                                               output_file: str,
                                               tag: Optional[str] = None
                                               ) -> str:
    """Write the fp32 dict as one ``.npz`` ("/" in names becomes "__")."""
    sd = get_fp32_state_dict_from_zero_checkpoint(ckpt_dir, tag)
    if not output_file.endswith(".npz"):
        output_file += ".npz"
    np.savez(output_file, **{k.replace("/", "__"): v for k, v in sd.items()})
    total = sum(v.size for v in sd.values())
    print(f"wrote {len(sd)} fp32 tensors ({total/1e6:.1f}M params) to "
          f"{output_file}")
    return output_file


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Extract a consolidated fp32 state dict from a "
                    "deepspeed_tpu_torch checkpoint directory (no engine "
                    "needed)")
    p.add_argument("checkpoint_dir")
    p.add_argument("output_file")
    p.add_argument("--tag", default=None)
    a = p.parse_args(argv)
    convert_zero_checkpoint_to_fp32_state_dict(a.checkpoint_dir,
                                               a.output_file, tag=a.tag)


if __name__ == "__main__":
    main()
