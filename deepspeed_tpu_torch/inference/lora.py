"""Multi-tenant LoRA serving: the host-side adapter store and the device
slot-pool layout, the port's copy of ``deepspeed_tpu/inference/lora.py``.

A LoRA adapter is tiny (rank-r A/B factors per projection), so the engine
keeps every registered adapter's tables in host RAM (``AdapterStore``) and
pages the ones with in-flight requests into a fixed device slot pool —
the paged-KV idea applied to read-only weights. The host half of the slot
accounting lives in ``kv_cache.AdapterSlotPool`` (refcount + LRU, slot 0
= the null adapter); this module owns the TABLES: host numpy A/B stacks
per adapter, the device pool layout and its init, and the PEFT-shaped
random adapters the tests and chip_smoke use.

Pool layout: one entry per targeted projection, ``{proj: {"a": [L, NS,
In, r], "b": [L, NS, r, Out]}}`` with the LAYER axis leading, so each
layer slices its row, and the SLOT axis second, so the per-batch-row
gather (``models/transformer._lora_delta``) is one ``index_select`` over
slots after the layer slice. Slot 0 stays all-zero: a base-model request
indexes it and adds an exact zero delta — no masking, no program split
(the trash-block discipline, applied to weights). The pool is allocated
once and written in place by page-ins, so its addresses never change.

B tables are PRE-SCALED by alpha/rank at registration, so the delta needs
no per-adapter scalar — the scaling is data, not program.

Under tensor parallelism the pool shards as JAX's
``adapter_pool_logical_axes`` says: q / k / v's B columns with their
projection's columns, o's A rows with the attention heads; everything
else replicates. A rank's pool holds its slice, and a page-in writes the
slice of the host tables (``shard_tables``).
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.accelerator import resolve_device
from deepspeed_tpu_torch.parallel.partitioning import (local_shape,
                                                       shard_leaf, spec_tree)

# projection name -> (In, Out) dims as functions of the model config
_PROJS = ("q", "k", "v", "o")


def _proj_dims(cfg, proj: str) -> Tuple[int, int]:
    H = cfg.hidden_size
    nh, nkv, hd = cfg.num_heads, cfg.kv_heads, cfg.dim_per_head
    return {
        "q": (H, nh * hd),
        "k": (H, nkv * hd),
        "v": (H, nkv * hd),
        "o": (nh * hd, H),
    }[proj]


@dataclasses.dataclass
class Adapter:
    """One registered adapter: per-layer A/B stacks, host numpy.

    ``tables[proj] = (A [L, In, r], B [L, r, Out])`` — B already carries
    alpha/rank. float32 at rest; cast at page-in."""
    adapter_id: int
    rank: int
    tables: Dict[str, Tuple[np.ndarray, np.ndarray]]


class AdapterStore:
    """Host RAM registry of every adapter the engine can serve.

    All adapters in one store share ``rank`` and ``targets`` — the device
    pool has ONE shape, so the decode step is shaped by the pool, never by
    which adapters exist (a mismatched registration is a caller bug and
    raises). ``table_for_slot`` hands the engine the arrays its page-in
    writes into the pool slot."""

    def __init__(self, cfg, rank: int, targets=("q", "k", "v", "o")):
        if rank < 1:
            raise ValueError(f"lora rank must be >= 1, got {rank}")
        bad = [t for t in targets if t not in _PROJS]
        if bad:
            raise ValueError(f"unknown lora targets {bad}; "
                             f"supported: {_PROJS}")
        self.cfg = cfg
        self.rank = int(rank)
        self.targets = tuple(targets)
        self._adapters: Dict[int, Adapter] = {}

    def __contains__(self, adapter_id: int) -> bool:
        return adapter_id == 0 or adapter_id in self._adapters

    def __len__(self) -> int:
        return len(self._adapters)

    def get(self, adapter_id: int) -> Adapter:
        return self._adapters[adapter_id]

    def register(self, adapter_id: int,
                 tables: Dict[str, Tuple[np.ndarray, np.ndarray]],
                 alpha: Optional[float] = None) -> None:
        """Register host A/B stacks for ``adapter_id``.

        ``tables[proj] = (A [L, In, r], B [L, r, Out])`` float arrays.
        ``alpha``: PEFT scaling — B is stored pre-multiplied by
        alpha/rank (None = already scaled). adapter_id 0 is reserved for
        the null adapter and cannot be registered."""
        if adapter_id == 0:
            raise ValueError("adapter_id 0 is the reserved null adapter")
        L = self.cfg.num_layers
        scale = 1.0 if alpha is None else float(alpha) / self.rank
        out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        if set(tables) != set(self.targets):
            raise ValueError(f"adapter {adapter_id} targets "
                             f"{sorted(tables)} != store targets "
                             f"{sorted(self.targets)} (one pool shape)")
        for proj, (a, b) in tables.items():
            din, dout = _proj_dims(self.cfg, proj)
            a = np.asarray(a, np.float32)
            b = np.asarray(b, np.float32) * scale
            if a.shape != (L, din, self.rank):
                raise ValueError(
                    f"adapter {adapter_id} {proj}.A shape {a.shape} != "
                    f"{(L, din, self.rank)}")
            if b.shape != (L, self.rank, dout):
                raise ValueError(
                    f"adapter {adapter_id} {proj}.B shape {b.shape} != "
                    f"{(L, self.rank, dout)}")
            out[proj] = (a, b)
        self._adapters[adapter_id] = Adapter(adapter_id, self.rank, out)

    def table_for_slot(self, adapter_id: int) -> Dict[str, dict]:
        """The ``{proj: {"a": [L, In, r], "b": [L, r, Out]}}`` f32 host
        arrays to write into one pool slot (the page-in casts them to the
        pool's dtype)."""
        ad = self._adapters[adapter_id]
        return {p: {"a": a, "b": b} for p, (a, b) in ad.tables.items()}


def adapter_pool_logical_axes(targets=("q", "k", "v", "o")):
    """Logical axes of the slot pool, JAX's: A factors and the slot and
    rank dims replicate; the B OUT columns of q / k / v shard with their
    projection's columns ("qkv"), so the delta is computed shard-local;
    o is the row-parallel projection: its A IN rows shard with the
    attention heads ("heads") and its partial sums join ``wo``'s
    reduction."""
    axes = {}
    for proj in targets:
        if proj == "o":
            axes[proj] = {"a": ("layers", None, "heads", None),
                          "b": ("layers", None, None, None)}
        else:
            axes[proj] = {"a": ("layers", None, None, None),
                          "b": ("layers", None, None, "qkv")}
    return axes


def init_adapter_pool(cfg, num_slots: int, rank: int,
                      targets=("q", "k", "v", "o"), dtype=torch.float32,
                      device=None, mesh=None):
    """Zero-filled slot pool ``{proj: {"a": [L, NS, In, r], "b": [L, NS,
    r, Out]}}`` on ``device`` (None means the card, as every entry point
    of the port); under a tensor axis of ``mesh`` each leaf is this
    rank's slice. All-zero slots ARE the null adapter — a fresh pool
    serves base-model traffic with no page-ins."""
    device = resolve_device(device)
    L = cfg.num_layers
    specs = spec_tree(adapter_pool_logical_axes(targets))
    pool = {}
    for proj in targets:
        din, dout = _proj_dims(cfg, proj)
        full = {"a": (L, num_slots, din, rank), "b": (L, num_slots, rank,
                                                      dout)}
        pool[proj] = {
            name: torch.zeros(shape if mesh is None else local_shape(
                shape, specs[proj][name], mesh, f"{proj}.{name}"),
                dtype=dtype, device=device)
            for name, shape in full.items()}
    return pool


def adapter_pool_bytes(cfg, num_slots: int, rank: int, targets,
                       dtype) -> int:
    """Bytes of the whole (unsharded) slot pool."""
    L = cfg.num_layers
    return sum(L * num_slots * rank * (din + dout) * dtype.itemsize
               for din, dout in (_proj_dims(cfg, p) for p in targets))


def shard_tables(tables, targets, mesh):
    """One adapter's ``{proj: {"a": [L, In, r], "b": [L, r, Out]}}``
    tables cut to this rank's slice of the pool (the pool's spec without
    its slot dim)."""
    specs = spec_tree(adapter_pool_logical_axes(targets))

    def drop_slot(spec):
        return spec[:1] + spec[2:]
    return {proj: {name: shard_leaf(t, drop_slot(specs[proj][name]), mesh,
                                    f"{proj}.{name}")
                   for name, t in ab.items()}
            for proj, ab in tables.items()}


def make_random_adapter(cfg, rank: int, seed: int,
                        targets=("q", "k", "v", "o"), scale: float = 0.02):
    """PEFT-shaped random adapter tables for tests and chip_smoke: A ~
    N(0, scale), B ~ N(0, scale) — BOTH nonzero so every projection's
    delta is exercised (real PEFT inits B to zero, which would hide
    wiring bugs behind an all-zero delta). numpy-seeded: the same seed
    gives JAX's tables."""
    rng = np.random.default_rng(seed)
    L = cfg.num_layers
    tables = {}
    for proj in targets:
        din, dout = _proj_dims(cfg, proj)
        a = rng.normal(0.0, scale, (L, din, rank)).astype(np.float32)
        b = rng.normal(0.0, scale, (L, rank, dout)).astype(np.float32)
        tables[proj] = (a, b)
    return tables


def apply_lora_dense(params, cfg, tables):
    """Fold adapter tables INTO a dense numpy param tree (the JAX layout,
    unfused ``wq/wk/wv/wo``): ``w += A @ B`` per layer — the merge a
    single-tenant deployment would bake offline. The parity oracle:
    serving through the paged pool must match serving the merged weights.
    Returns a NEW tree; norms etc. shared."""
    key_of = {"q": "wq", "k": "wk", "v": "wv", "o": "wo"}
    out = dict(params)
    layers = dict(params["layers"])
    for proj, (a, b) in tables.items():
        k = key_of[proj]
        w = np.asarray(layers[k], np.float32)
        delta = np.einsum("lir,lro->lio", np.asarray(a, np.float32),
                          np.asarray(b, np.float32))
        layers[k] = (w + delta).astype(np.asarray(layers[k]).dtype)
    out["layers"] = layers
    return out
