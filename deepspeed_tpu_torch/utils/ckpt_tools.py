"""Checkpoint inspect / mesh-validate CLI, a port of
``deepspeed_tpu/utils/ckpt_tools.py`` over the port's payload metadata
(the ``.npy`` headers and ``dtypes.json``; no tensor data is read).

  inspect  — tags, step counters, config, param / optimizer summary (a
             layer-streamed tag: its chunks; a swapped optimizer state:
             ``optswap.npz``)
  validate — would the state restore onto mesh axes A x B x ...? (every
             param needs a dim divisible by each mesh axis it could shard
             over: shape arithmetic, the JAX tool's rule unchanged)

CLI:  python -m deepspeed_tpu_torch.utils.ckpt_tools inspect <dir> [--tag T]
      [-v]
      python -m deepspeed_tpu_torch.utils.ckpt_tools validate <dir>
      --mesh fsdp=2,tensor=4 [--tag T]
"""

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

from deepspeed_tpu_torch.runtime.checkpointing import (LATEST_FILE,
                                                       payload_metadata)

# the JAX package's mesh axes (deepspeed_tpu/parallel/mesh.py AXIS_ORDER)
AXIS_ORDER = ("pipe", "data", "fsdp", "expert", "seq", "tensor")


def _tags(ckpt_dir: str):
    tags = []
    for name in sorted(os.listdir(ckpt_dir)):
        sub = os.path.join(ckpt_dir, name)
        if not os.path.isdir(sub):
            continue
        if os.path.isfile(os.path.join(sub, "meta.json")) or \
                any(n.startswith("state-v") for n in os.listdir(sub)):
            tags.append(name)
    return tags


def _resolve_tag(ckpt_dir: str, tag: Optional[str]) -> str:
    if tag is not None:
        return tag
    latest = os.path.join(ckpt_dir, LATEST_FILE)
    if os.path.exists(latest):
        with open(latest) as f:
            return f.read().strip()
    tags = _tags(ckpt_dir)
    if not tags:
        raise FileNotFoundError(f"no checkpoint tags under {ckpt_dir}")
    return tags[-1]


def _leaves(ckpt_dir: str, tag: str):
    """[(name, shape, dtype)] of the saved state."""
    md = payload_metadata(os.path.join(ckpt_dir, tag, "state"))
    return [(name, shape, dt) for name, (shape, dt) in sorted(md.items())]


def cmd_inspect(args) -> int:
    ckpt_dir = args.dir
    if not os.path.isdir(ckpt_dir):
        print(f"error: no such checkpoint dir: {ckpt_dir}")
        return 1
    tags = _tags(ckpt_dir)
    latest = None
    if os.path.exists(os.path.join(ckpt_dir, LATEST_FILE)):
        with open(os.path.join(ckpt_dir, LATEST_FILE)) as f:
            latest = f.read().strip()
    print(f"checkpoint dir: {ckpt_dir}")
    print(f"tags: {', '.join(tags) or '(none)'}"
          + (f"   latest -> {latest}" if latest else ""))
    try:
        tag = _resolve_tag(ckpt_dir, args.tag)
    except FileNotFoundError as e:
        print(f"error: {e}")
        return 1
    meta_path = os.path.join(ckpt_dir, tag, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        cs = meta.get("client_state", {})
        cfg = meta.get("config", {})
        print(f"tag {tag}: global_steps={cs.get('global_steps')} "
              f"world_size={meta.get('world_size')}")
        zero = (cfg.get("zero_optimization") or {}).get("stage")
        mesh = (cfg.get("mesh") or {}).get("axes")
        print(f"  zero stage: {zero}   mesh axes: {mesh}")
    tag_dir = os.path.join(ckpt_dir, tag)
    inf = os.path.join(tag_dir, "infinity_shapes.json")
    if os.path.exists(inf):
        with open(inf) as f:
            m = json.load(f)
        print(f"  infinity chunks: {m['num_layers']} layers x "
              f"chunk {m['chunk']} elems")
        return 0
    swap = os.path.join(tag_dir, "optswap.npz")
    if os.path.exists(swap):
        with np.load(swap) as z:
            n = sum(int(np.prod(z[k].shape)) for k in z.files)
        print(f"  swapped optimizer state: {len(z.files)} arrays, "
              f"{n / 1e6:.2f}M f32 values (optswap.npz)")
    try:
        leaves = _leaves(ckpt_dir, tag)
    except (OSError, ValueError) as e:
        print(f"  (state metadata unavailable: {e})")
        return 0
    n_param = sum(int(np.prod(s)) for p, s, _ in leaves
                  if p.startswith("params/"))
    n_total = sum(int(np.prod(s)) for _, s, _ in leaves)
    print(f"  state: {len(leaves)} arrays, params {n_param / 1e6:.2f}M, "
          f"total {n_total / 1e6:.2f}M elems")
    if args.verbose:
        for p, s, d in leaves:
            print(f"    {p}  {list(s)}  {d}")
    return 0


def _parse_mesh(spec: str):
    axes = {}
    for part in spec.split(","):
        k, v = part.split("=")
        axes[k.strip()] = int(v)
    return axes


def cmd_validate(args) -> int:
    """Would the saved params restore onto the target mesh: every param
    needs, for each axis it could shard over (tensor / fsdp / pipe), a dim
    divisible by that axis' size."""
    try:
        tag = _resolve_tag(args.dir, args.tag)
    except (FileNotFoundError, NotADirectoryError) as e:
        print(f"error: {e}")
        return 1
    axes = _parse_mesh(args.mesh)
    bad_axes = set(axes) - set(AXIS_ORDER)
    if bad_axes:
        print(f"unknown mesh axes: {sorted(bad_axes)} (valid: {AXIS_ORDER})")
        return 1
    try:
        leaves = _leaves(args.dir, tag)
    except (OSError, ValueError) as e:
        print(f"cannot read state metadata: {e}")
        return 1
    problems = []
    check_sizes = [n for ax, n in axes.items()
                   if ax in ("tensor", "fsdp", "pipe") and n > 1]
    for path, shape, _ in leaves:
        if not path.startswith("params/"):
            continue
        for n in check_sizes:
            if not any(d % n == 0 for d in shape if d > 1):
                problems.append((path, shape, n))
    if problems:
        print(f"NOT restorable onto mesh {axes}: "
              f"{len(problems)} arrays have no dim divisible by the axis "
              "size:")
        for path, shape, n in problems[:10]:
            print(f"  {path} {list(shape)} vs axis size {n}")
        return 1
    print(f"OK: tag {tag} restores onto mesh {axes} "
          f"({len(leaves)} arrays checked)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dstpu_torch_ckpt",
        description="Inspect / mesh-validate deepspeed_tpu_torch checkpoints")
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("inspect", help="show tags, config, state summary")
    pi.add_argument("dir")
    pi.add_argument("--tag", default=None)
    pi.add_argument("-v", "--verbose", action="store_true")
    pi.set_defaults(fn=cmd_inspect)
    pv = sub.add_parser("validate",
                        help="check restorability onto a target mesh")
    pv.add_argument("dir")
    pv.add_argument("--tag", default=None)
    pv.add_argument("--mesh", required=True, help="e.g. fsdp=2,tensor=4")
    pv.set_defaults(fn=cmd_validate)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
