"""Data efficiency: the seqlen curriculum, distributed sampling, random-LTD
token dropping, the indexed dataset and the offline analyzer, PyTorch port
of ``deepspeed_tpu/runtime/data_pipeline.py`` (its schedulers, sampler,
dataset and analyzer are pure Python and numpy, copied here).

Random-LTD takes its draws as an input: ``random_ltd_layer`` runs a layer
on the kept tokens ``select`` [B, keep] (sorted indices), which
``ltd_selection`` draws on the host from a generator keyed by (seed,
step, micro-batch, layer, global row). No draw needs the card, a rank of
a data-parallel world draws exactly the rows a one-rank run draws, and a
test can hand JAX's selection to the port. JAX draws ``argsort(uniform)
[:, :keep]`` from ``jax.random``, bits the port cannot reproduce; the two
agree in distribution.
"""

import math
import os
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


class CurriculumScheduler:
    """Difficulty schedule, JAX's: ``schedule_type`` fixed_linear (linear
    to the max over ``total_curriculum_step``), fixed_root ((step /
    total)^(1 / root_degree)), fixed_discrete (``difficulty`` [] up to
    each ``max_step`` []) or custom (a callable step -> difficulty); each
    value rounded up to a multiple of ``difficulty_step`` and clipped to
    [min, max]."""

    def __init__(self, cfg: Dict[str, Any],
                 custom_fn: Optional[Callable[[int], int]] = None):
        self.type = cfg.get("schedule_type", cfg.get("curriculum_type_schedule",
                                                     "fixed_linear"))
        self.min_difficulty = int(cfg.get("min_difficulty", 8))
        self.max_difficulty = int(cfg.get("max_difficulty", 1024))
        sc = cfg.get("schedule_config", {})
        self.total_step = int(sc.get("total_curriculum_step", 1000))
        self.difficulty_step = int(sc.get("difficulty_step", 8))
        self.root_degree = int(sc.get("root_degree", 2))
        self.discrete_difficulties = list(sc.get("difficulty", []))
        self.discrete_steps = list(sc.get("max_step", []))
        self.custom_fn = custom_fn
        if self.type == "custom" and custom_fn is None:
            raise ValueError("custom curriculum schedule needs a callable")
        self.current = self.min_difficulty

    def _raw(self, step: int) -> float:
        if self.type == "fixed_linear":
            frac = min(1.0, step / max(1, self.total_step))
        elif self.type == "fixed_root":
            frac = min(1.0, (step / max(1, self.total_step))
                       ** (1.0 / self.root_degree))
        elif self.type == "fixed_discrete":
            for d, s in zip(self.discrete_difficulties, self.discrete_steps):
                if step <= s:
                    return float(d)
            return float(self.discrete_difficulties[-1]
                         if self.discrete_difficulties else self.max_difficulty)
        elif self.type == "custom":
            return float(self.custom_fn(step))
        else:
            raise ValueError(f"unknown curriculum schedule {self.type!r}")
        return (self.min_difficulty
                + frac * (self.max_difficulty - self.min_difficulty))

    def update_difficulty(self, step: int) -> int:
        d = self._raw(step)
        q = self.difficulty_step
        d = int(min(self.max_difficulty,
                    max(self.min_difficulty, math.ceil(d / q) * q)))
        self.current = d
        return d

    def get_current_difficulty(self) -> int:
        return self.current


def apply_seqlen_curriculum(batch: Dict[str, Any], difficulty: int
                            ) -> Dict[str, Any]:
    """Every leaf of 2 or more dims cut to ``difficulty`` along dim 1 (the
    ids, labels and mask alike)."""
    return {k: (v[:, :difficulty] if getattr(v, "ndim", 0) >= 2
                and v.shape[1] > difficulty else v)
            for k, v in batch.items()}


class DistributedSampler:
    """Each rank's contiguous shard of the epoch's permutation (numpy,
    seeded by seed + epoch). ``num_replicas`` / ``rank`` default to the
    default process group's (1 / 0 without one)."""

    def __init__(self, dataset_len: int, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        if num_replicas is None or rank is None:
            dist = torch.distributed
            live = dist.is_available() and dist.is_initialized()
            num_replicas = num_replicas or (dist.get_world_size() if live
                                            else 1)
            rank = rank if rank is not None else (dist.get_rank() if live
                                                  else 0)
        if rank >= num_replicas:
            raise ValueError(f"rank {rank} >= num_replicas {num_replicas}")
        self.n = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        if drop_last:
            self.num_samples = self.n // num_replicas
        else:
            self.num_samples = math.ceil(self.n / num_replicas)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        order = np.arange(self.n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        if not self.drop_last and self.n % self.num_replicas:
            pad = self.num_replicas * self.num_samples - self.n
            order = np.concatenate([order, order[:pad]])
        shard = order[self.rank * self.num_samples:
                      (self.rank + 1) * self.num_samples]
        return iter(shard.tolist())


# ---------------------------------------------------------------------------
# Random-LTD (random layerwise token dropping)
# ---------------------------------------------------------------------------

class RandomLTDScheduler:
    """Kept-token schedule, JAX's: linear from ``min_value`` to
    ``max_value`` over ``total_layer_tokens_steps`` (or ``total_steps``),
    rounded up to a multiple of ``seq_step``, at most the sequence."""

    def __init__(self, cfg: Dict[str, Any]):
        rl = cfg.get("random_ltd", cfg)
        self.min_value = int(rl.get("random_ltd_schedule", {}).get(
            "min_value", rl.get("min_value", 128)))
        self.max_value = int(rl.get("random_ltd_schedule", {}).get(
            "max_value", rl.get("max_value", 2048)))
        sched = rl.get("random_ltd_schedule", rl)
        self.total_steps = int(sched.get("schedule_config", sched).get(
            "total_layer_tokens_steps", sched.get("total_steps", 1000)))
        self.step_size = int(sched.get("schedule_config", sched).get(
            "seq_step", 64))

    def kept_tokens(self, step: int, seq_len: int) -> int:
        frac = min(1.0, step / max(1, self.total_steps))
        k = self.min_value + frac * (self.max_value - self.min_value)
        k = int(min(seq_len, max(self.min_value,
                                 math.ceil(k / self.step_size) * self.step_size)))
        return min(k, seq_len)


def ltd_selection(key, rows: int, seq_len: int, keep: int,
                  row0: int = 0) -> np.ndarray:
    """The kept tokens of ``rows`` rows, [rows, keep] int64, each row's
    ``keep`` indices drawn without replacement and sorted: row r from a
    numpy generator keyed by (``key``..., ``row0`` + r), ``key`` being
    (seed, step, micro-batch, layer)."""
    out = np.empty((rows, keep), np.int64)
    for r in range(rows):
        rng = np.random.default_rng([*key, row0 + r])
        out[r] = np.sort(rng.permutation(seq_len)[:keep])
    return out


def random_ltd_layer(x, layer_fn, select, *args, **kwargs):
    """``layer_fn`` on the kept tokens ``select`` [B, keep] (sorted) of x
    [B, S, H]; the others pass through unchanged. The layer sees each kept
    token's true position (``positions`` [B, S] gathered, or the indices
    themselves) and the key mask gathered with the tokens; causality
    among sorted tokens is causality by index, so attention runs at S =
    keep unchanged. ``select`` None runs the layer on every token.

    Over ``seq`` (x this rank's piece of the sequence, ``select`` kept
    tokens of the whole sequence, JAX's selection from its global
    array): the hidden state, the positions and the mask are gathered
    over ``seq``, the rank runs the layer on its contiguous keep / n of
    the kept tokens (JAX's ring splits the kept [B, keep] over ``seq`` in
    order; a ``keep`` that n does not divide raises its ValueError), the
    outputs are gathered back over ``seq`` and each rank keeps its piece
    of the sequence."""
    from deepspeed_tpu_torch.comm.comm import all_gather
    from deepspeed_tpu_torch.parallel.context import (axis_index,
                                                      gather_along,
                                                      seq_parallel_degree)
    n = seq_parallel_degree()
    if select is None or select.shape[1] >= x.shape[1] * n:
        return layer_fn(x, *args, **kwargs)
    B, S, H = x.shape
    idx = select.to(device=x.device, dtype=torch.long)
    kwargs = dict(kwargs)
    pos, mask = kwargs.get("positions"), kwargs.get("mask")
    mine = idx
    if n > 1:
        keep = idx.shape[1]
        if keep % n:
            raise ValueError(f"random-LTD over seq: {keep} kept tokens do "
                             f"not split evenly over the {n} ranks of the "
                             "seq axis (JAX's ring shard_map refuses them)")
        x = gather_along(x, "seq", dim=1)
        if pos is not None:
            pos = all_gather(pos.contiguous(), "seq", dim=1)
        if mask is not None:
            mask = all_gather(mask.contiguous(), "seq", dim=1)
        mine = idx.narrow(1, axis_index("seq") * (keep // n), keep // n)
    sub = x.gather(1, mine[..., None].expand(B, -1, H))
    kwargs["positions"] = mine if pos is None else pos.gather(1, mine)
    if mask is not None:
        kwargs["mask"] = mask.gather(1, mine)
    out = layer_fn(sub, *args, **kwargs)
    y = out[0] if isinstance(out, tuple) else out
    if n > 1:
        y = gather_along(y, "seq", dim=1)
    full = x.scatter(1, idx[..., None].expand(B, -1, H), y.to(x.dtype))
    if n > 1:
        full = full.narrow(1, axis_index("seq") * S, S).contiguous()
    if isinstance(out, tuple):
        return (full,) + tuple(out[1:])
    return full


# --------------------------------------------------------------------------
# The indexed dataset (Megatron's mmap .bin / .idx pair) and the offline
# analyzer whose per-sample metrics the curriculum sampler reads
# --------------------------------------------------------------------------

class IndexedDataset:
    """A variable-length token dataset on an mmap: ``prefix.bin`` holds the
    int32 token streams back to back, ``prefix.idx`` the magic, the count
    and the offsets (int64). A sample is one slice of the map."""

    MAGIC = 0x44535450  # "DSTP"

    def __init__(self, prefix: str):
        idx = np.fromfile(f"{prefix}.idx", dtype=np.int64)
        if len(idx) < 3 or idx[0] != self.MAGIC:
            raise ValueError(f"{prefix}.idx is not an indexed dataset")
        n = int(idx[1])
        self._offsets = idx[2:2 + n + 1]
        self._data = np.memmap(f"{prefix}.bin", dtype=np.int32, mode="r")

    def __len__(self):
        return len(self._offsets) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return np.asarray(self._data[self._offsets[i]:self._offsets[i + 1]])

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self._offsets)


def write_indexed_dataset(samples, prefix: str) -> int:
    """Write 1-D int token arrays (streamed) as ``prefix.bin`` /
    ``prefix.idx``; returns the sample count."""
    offsets = [0]
    with open(f"{prefix}.bin", "wb") as f:
        for s in samples:
            arr = np.ascontiguousarray(np.asarray(s, np.int32).reshape(-1))
            arr.tofile(f)
            offsets.append(offsets[-1] + arr.size)
    n = len(offsets) - 1
    header = np.array([IndexedDataset.MAGIC, n], np.int64)
    np.concatenate([header, np.asarray(offsets, np.int64)]).tofile(
        f"{prefix}.idx")
    return n


class DataAnalyzer:
    """The offline per-sample metric pass: ``metrics`` {name: fn(tokens)
    -> float}; ``run`` writes ``<name>_values.npy`` (by sample id) and
    ``<name>_order.npy`` (ids easiest first, a stable sort) into
    ``out_dir``."""

    BUILTIN = {"seqlen": lambda toks: float(len(toks)),
               "vocab_rarity": lambda toks: float(
                   np.mean(np.asarray(toks, np.float64)))}

    def __init__(self, metrics: Optional[Dict[str, Any]] = None):
        self.metrics = metrics or {"seqlen": self.BUILTIN["seqlen"]}

    def run(self, dataset, out_dir: str) -> Dict[str, str]:
        os.makedirs(out_dir, exist_ok=True)
        values = {name: [] for name in self.metrics}
        for i in range(len(dataset)):
            sample = dataset[i]
            toks = sample["input_ids"] if isinstance(sample, dict) else sample
            for name, fn in self.metrics.items():
                values[name].append(fn(toks))
        paths = {}
        for name, vals in values.items():
            v = np.asarray(vals, np.float64)
            order = np.argsort(v, kind="stable").astype(np.int64)
            np.save(os.path.join(out_dir, f"{name}_values.npy"), v)
            np.save(os.path.join(out_dir, f"{name}_order.npy"), order)
            paths[name] = out_dir
        return paths


class CurriculumSampler:
    """Batches drawn uniformly from the samples whose metric is within the
    scheduler's current difficulty (at least a global batch of them).
    Every rank draws the same stream (seed only) and takes its strided
    rows of the global draw."""

    def __init__(self, metric_dir: str, metric: str,
                 scheduler: CurriculumScheduler, batch_size: int, *,
                 rank: int = 0, world_size: int = 1, seed: int = 0):
        self.values = np.load(os.path.join(metric_dir,
                                           f"{metric}_values.npy"))
        self.order = np.load(os.path.join(metric_dir, f"{metric}_order.npy"))
        self._sorted_vals = self.values[self.order]
        self.scheduler = scheduler
        self.batch_size = batch_size
        self.rank, self.world = rank, world_size
        self._rng = np.random.default_rng(seed)

    def eligible(self, step: int) -> np.ndarray:
        d = self.scheduler.update_difficulty(step)
        cutoff = int(np.searchsorted(self._sorted_vals, d, side="right"))
        cutoff = max(cutoff, self.batch_size * self.world)
        return self.order[:cutoff]

    def sample(self, step: int) -> np.ndarray:
        """Sample ids of this rank's micro-batch at ``step``."""
        pool = self.eligible(step)
        picks = self._rng.choice(pool, size=self.batch_size * self.world,
                                 replace=len(pool) < self.batch_size * self.world)
        return picks[self.rank::self.world]
