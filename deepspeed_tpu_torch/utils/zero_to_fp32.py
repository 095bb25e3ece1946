"""Offline checkpoint -> consolidated fp32 state dict (no engine needed), a
port of ``deepspeed_tpu/utils/zero_to_fp32.py``.

The port's checkpoints hold one ``.npy`` per leaf (``runtime/
checkpointing.py``), so this reads them with numpy alone: the fp32 MASTER
weights from the optimizer state (``opt/master/...``) where present, from
a swapped optimizer state (``optswap.npz``: the swapper's (3, C) chunks,
master = plane 0, or the host tier's flat ``master``, over the params in
leaf order), else the params widened to f32 (bf16 from its uint16 bits,
exactly). A ZeRO-Infinity tag (``infinity_shapes.json``) is rebuilt from
its layer chunks (``opt_i.bin`` plane 0, or the bf16 ``param_i.bin`` of a
layer never stepped) and the embedding / head masters of
``infinity_small.npz``; JAX's tags of both kinds read the same. The keys
are JAX's flattened names without the ``params/`` prefix, as the JAX tool
emits them.

CLI:  python -m deepspeed_tpu_torch.utils.zero_to_fp32 <ckpt_dir> <out.npz>
      [--tag T]
"""

import argparse
import json
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


def _split_flat(flat: np.ndarray, shapes: Dict[str, tuple]
                ) -> Dict[str, np.ndarray]:
    """A flat f32 vector over the leaves in sorted-name order (the trees'
    leaf order) -> {name: leaf}."""
    out, off = {}, 0
    for name in sorted(shapes):
        size = int(np.prod(shapes[name]))
        out[name] = np.array(flat[off:off + size], np.float32).reshape(
            shapes[name])
        off += size
    return out


def _swap_masters(swap_file: str, shapes: Dict[str, tuple]
                  ) -> Dict[str, np.ndarray]:
    with np.load(swap_file) as z:
        if "master" in z.files:
            flat = z["master"]
        else:
            flat = np.concatenate([z[f"chunk_{i}"][0]
                                   for i in range(len(z.files))])
    return _split_flat(flat, shapes)


def _infinity_fp32(path: str) -> Dict[str, np.ndarray]:
    """A layer-chunk tag: each layer's master from its optimizer chunk
    (plane 0), or its bf16 params where it was never stepped; the
    embedding / head masters from ``infinity_small.npz``."""
    with open(os.path.join(path, "infinity_shapes.json")) as f:
        man = json.load(f)
    chunk, L = int(man["chunk"]), int(man["num_layers"])
    names, shapes = man["leaf_names"], man["leaf_shapes"]
    cdir = os.path.join(path, "infinity_chunks")
    layers = {n: [] for n in names}
    for i in range(L):
        p = os.path.join(cdir, f"opt_{i}.bin")
        if os.path.exists(p):
            flat = np.fromfile(p, np.float32).reshape(3, chunk)[0]
        else:
            flat = _widen(np.fromfile(os.path.join(cdir, f"param_{i}.bin"),
                                      np.uint16), "bfloat16")
        off = 0
        for n, shape in zip(names, shapes):
            size = int(np.prod(shape))
            layers[n].append(flat[off:off + size].reshape(shape))
            off += size
    out = {f"layers/{n}": np.stack(v) for n, v in layers.items()}
    with open(os.path.join(path, "infinity_meta.json")) as f:
        dtypes = json.load(f)["dtypes"]
    with np.load(os.path.join(path, "infinity_small.npz")) as z:
        for k in z.files:
            key = k.replace("__", "/")
            if key.startswith("nl_opt/") and key.endswith("/master"):
                out[key[len("nl_opt/"):-len("/master")]] = _widen(
                    z[k], "bfloat16" if "bfloat16" in dtypes.get(key, "")
                    else "float32")
    return out


def get_fp32_state_dict_from_zero_checkpoint(ckpt_dir: str,
                                             tag: Optional[str] = None
                                             ) -> Dict[str, np.ndarray]:
    """Flat {name: fp32 array} dict from a checkpoint directory."""
    path = os.path.join(ckpt_dir, _resolve_tag(ckpt_dir, tag))
    if os.path.exists(os.path.join(path, "infinity_shapes.json")):
        return _infinity_fp32(path)
    # memory-mapped: only the masters (or params) are read
    arrays, dtypes = read_payload(os.path.join(path, "state"), mmap=True)
    swap_file = os.path.join(path, "optswap.npz")
    if os.path.exists(swap_file):
        return _swap_masters(swap_file, {
            k[len("params/"):]: v.shape for k, v in arrays.items()
            if k.startswith("params/")})
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
