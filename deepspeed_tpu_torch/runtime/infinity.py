"""ZeRO-Infinity layer streaming, a port of ``deepspeed_tpu/runtime/
infinity.py``: the layers' params and optimizer state live off the card
(on NVMe, or in pinned host memory) and a step streams them through it
one layer at a time.

    forward:  embed (on the card) -> for each layer: fetch its params ->
              the layer's forward (no graph kept) -> keep its input x_i
    backward: CE head (on the card) -> for each layer, last first: fetch
              its params -> the layer's forward again and its VJP
              (``torch.autograd.grad``: the remat boundary is the layer,
              as in JAX) -> the layer's f32 grads staged to the host
    update:   the global grad norm and clip -> the embedding and head's
              AdamW on the card -> for each layer: its optimizer chunk in
              -> the fused flat AdamW (on the card, or with
              ``use_cpu_adam`` the host C++ in place) -> chunk and bf16
              params out

On the card a layer's forward launches the flash forward (B1), and its
backward launches it again in the recompute before the backward kernels
(B2, B3): per step B1 = 2 x layers x gas, B2 = B3 = layers x gas.

Storage per layer (``LayerStore``, JAX's file layout): the layer's leaves
in sorted order, flat and zero-padded to the chunk (the layer's size
rounded up to 128), kept as bf16 bits whatever the compute dtype (as in
JAX: the f32 master in the optimizer chunk carries the precision), and a
(3, C) f32 optimizer chunk (master, m, v), made lazily: a layer with no
chunk yet starts from master = its bf16 params, m = v = 0. Backends:
"nvme" (``param_i.bin`` / ``opt_i.bin`` through ``ops/aio.py``, a host
cache of the param chunks up to ``param_cache_bytes``), "pinned" (page-
locked host tensors: the cpu tier on the card) and "host" (CPU tensors).

The IO overlaps the compute: a prefetch pool reads two layers ahead of
the sweep, and the update sweep's chunks are read one ahead and written
behind on a writer thread (at most two in flight), drained at the step's
end. ``pipeline=False`` is the drained executor, the same numbers bit for
bit. fp16 keeps a host loss scaler (JAX's ``_on_overflow`` /
``_on_good_step``): an overflowed step writes nothing.

The layer's tree passes through the training extras JAX's executor
applies inside each streamed layer: the compression transform (on the
one-layer tree ``{"layers": tree}``, so its masks are per layer) and
MoQ's fake-quant of every leaf of 2 or more dims at the layer's bits of
the step. ``max_live_params`` (``stage3_max_live_parameters``, only when
the key is set) keeps up to that many params' worth of layers' bf16
chunks on the card: the forward and backward skip their copies, and the
update refreshes them (``param_reads`` counts the copies made).

Over ranks (``mesh``: ``data`` x ``fsdp`` x ``tensor``; ``pipe``, ``seq``
and ``expert`` raise, as in JAX): each layer's chunk is padded to
128 x F x TP and cut in F x TP shards over (fsdp, tensor); a rank's
store holds its shard of every chunk and of its optimizer state. On use
a chunk is gathered whole by one ``all_gather`` (the comm facade); a
``tensor`` rank cuts its column / row slices of the leaves by the
tensor-parallel rules (``parallel/partitioning``) and runs the layer on
its heads, its collectives through ``parallel/context``. The layer's
grads are reduce-scattered back to the shards (and summed over
``data``), the global norm is all-reduced, and each rank's update sweep
touches its own shards only. The batch splits over (data, fsdp); the
embedding and head stay whole on every rank, their grads all-reduced
over the batch axes. Checkpoints keep the whole-chunk layout: a save
gathers each chunk and rank 0 writes it; a load takes the rank's shard
of each saved chunk, cut or padded to this run's chunk, so a tag moves
between fsdp degrees.

A MoE model raises (its experts are not streamed, as in JAX), and so do
a model with per-layer windows and the leaves JAX's executor drops
(``executor_dropped``).
"""

import dataclasses
import json
import math
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.comm import comm
from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops.adam import fused_adam_update
from deepspeed_tpu_torch.ops.optimizers import _lr_at, sum_of_squares
from deepspeed_tpu_torch.parallel import context as par_ctx
from deepspeed_tpu_torch.parallel.partitioning import (make_rules, mesh_axes,
                                                       shard_slices,
                                                       spec_axes)
from deepspeed_tpu_torch.runtime.quantize import ste_quant_traced_bits
from deepspeed_tpu_torch.robustness import faults as rb_faults
from deepspeed_tpu_torch.robustness.retry import retry_io

_PLANES = 3
#: infinity_shapes.json's version key (JAX's manifest carries none; the
#: readers of either package read the keys they need)
SHAPES_SCHEMA = 1
_OUT_KEYS = ("wo", "w_out", "moe_w_out")
_SEQ = iter(range(1 << 62))


class LayerStore:
    """Per-layer chunks: bf16 params (C,) and f32 optimizer (3, C)."""

    def __init__(self, path: Optional[str], n_layers: int, chunk: int,
                 backend: str = "nvme", aio_config=None):
        if backend not in ("nvme", "pinned", "host"):
            raise ValueError(f"backend {backend!r}: nvme, pinned or host")
        self.n_layers, self.chunk, self.backend = n_layers, chunk, backend
        self._host: Dict[str, torch.Tensor] = {}
        self._dir = None
        self._aio_r = self._aio_w = None
        self._lock = threading.Lock()
        if backend == "nvme":
            if not path:
                raise ValueError("LayerStore(nvme) requires a path")
            from deepspeed_tpu_torch.ops.aio import AIOHandle
            self._dir = os.path.join(
                path, f"dstpu-infinity-{os.getpid()}-{next(_SEQ)}")
            os.makedirs(self._dir, exist_ok=True)
            self._aio_r = AIOHandle.from_config(aio_config, "read")
            self._aio_w = AIOHandle.from_config(aio_config, "write")
        # file operations by kind ("param_read", "opt_write", ...)
        self.io = {f"{k}_{op}": 0 for k in ("param", "opt")
                   for op in ("read", "write")}

    def _shape(self, kind: str):
        return ((self.chunk,), torch.bfloat16) if kind == "param" else \
            ((_PLANES, self.chunk), torch.float32)

    def _path(self, kind: str, i: int) -> str:
        return os.path.join(self._dir, f"{kind}_{i}.bin")

    def write(self, kind: str, i: int, t: torch.Tensor) -> None:
        """Keep ``t`` (a contiguous CPU tensor the store now owns) as
        layer i's ``kind`` chunk."""
        if self.backend != "nvme":
            self._host[f"{kind}_{i}"] = t
            return
        with self._lock:
            self.io[f"{kind}_write"] += 1
        self._aio_w.pwrite(self._path(kind, i), t)

    def read(self, kind: str, i: int, out: Optional[torch.Tensor] = None,
             pin: bool = False) -> Optional[torch.Tensor]:
        """Layer i's ``kind`` chunk (None if it was never written). The
        host backends return the kept tensor itself."""
        if self.backend != "nvme":
            return self._host.get(f"{kind}_{i}")
        p = self._path(kind, i)
        if not os.path.exists(p):
            return None
        with self._lock:
            self.io[f"{kind}_read"] += 1
        if out is None:
            shape, dtype = self._shape(kind)
            out = torch.empty(shape, dtype=dtype, pin_memory=pin)
        return self._aio_r.pread(p, out)

    def save_to(self, dst: str) -> None:
        """Every chunk into ``dst`` as ``<kind>_<i>.bin``."""
        os.makedirs(dst, exist_ok=True)
        if self.backend != "nvme":
            for k, v in self._host.items():
                p = os.path.join(dst, f"{k}.bin")

                def do(v=v, p=p):
                    rb_faults.io_seam("nvme_write", p)
                    _view_bytes(v).tofile(p)
                retry_io(do, what="layer-chunk checkpoint write", path=p)
            return
        for f in os.listdir(self._dir):
            src, out = os.path.join(self._dir, f), os.path.join(dst, f)
            retry_io(lambda src=src, out=out: shutil.copyfile(src, out),
                     what="layer-chunk checkpoint copy", path=out)

    def load_from(self, src: str, saved_chunk: Optional[int] = None,
                  pin: bool = False, whole: Optional[int] = None,
                  offset: int = 0) -> None:
        """Every chunk of ``src``: a saved chunk (of ``saved_chunk``
        values; the zero pad past the layer's values may differ) is cut or
        padded to the whole chunk of ``whole`` values (default: this
        store's), and this store keeps its ``chunk`` values from
        ``offset`` (a rank's shard)."""
        whole = whole or self.chunk
        saved = saved_chunk or whole
        for f in sorted(os.listdir(src)):
            if not f.endswith(".bin"):
                continue
            kind, i = f[:-4].rsplit("_", 1)
            p = os.path.join(src, f)
            dt = np.uint16 if kind == "param" else np.float32
            arr = retry_io(lambda p=p, dt=dt: np.fromfile(p, dt),
                           what="layer-chunk checkpoint read", path=p)
            arr = arr.reshape(-1 if kind == "param" else (_PLANES, saved))
            # this shard's values that the saved chunk holds
            n = max(0, min(saved, offset + self.chunk) - offset)
            shape, dtype = self._shape(kind)
            t = torch.zeros(shape, dtype=dtype, pin_memory=pin)
            src_t = torch.from_numpy(np.ascontiguousarray(arr))
            if kind == "param":
                t.view(torch.int16)[:n].copy_(
                    src_t.view(torch.int16)[offset:offset + n])
            else:
                t[:, :n].copy_(src_t[:, offset:offset + n])
            self.write(kind, int(i), t)

    def host_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self._host.values())

    def disk_bytes(self) -> int:
        if not self._dir or not os.path.isdir(self._dir):
            return 0
        return sum(os.path.getsize(os.path.join(self._dir, f))
                   for f in os.listdir(self._dir))

    def close(self) -> None:
        for h in (self._aio_r, self._aio_w):
            if h is not None:
                h.close()
        self._aio_r = self._aio_w = None
        self._host.clear()
        if self._dir:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None


def _view_bytes(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as numpy (bf16 as its uint16 bits)."""
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


class StagingRing:
    """Rotating host staging buffers with write-behind fences: the host
    sweep keeps read i+1, update i and write i-1 in flight over ``nbufs``
    buffers; ``acquire`` waits out the write still draining a buffer
    before handing it back (``slot``: the raw buffer, no wait)."""

    def __init__(self, nbufs: int, shape, dtype=torch.float32,
                 pin: bool = False):
        self.nbufs = nbufs
        self._bufs = [torch.empty(shape, dtype=dtype, pin_memory=pin)
                      for _ in range(nbufs)]
        self._busy: List = [None] * nbufs

    def slot(self, i: int) -> torch.Tensor:
        return self._bufs[i % self.nbufs]

    def acquire(self, i: int) -> torch.Tensor:
        k = i % self.nbufs
        if self._busy[k] is not None:
            self._busy[k].result()
            self._busy[k] = None
        return self._bufs[k]

    def mark_busy(self, i: int, fut) -> None:
        self._busy[i % self.nbufs] = fut

    def drain(self) -> None:
        for k, busy in enumerate(self._busy):
            if busy is not None:
                busy.result()
                self._busy[k] = None


def layer_template(cfg):
    """[(name, shape)] of one layer's leaves, in sorted order."""
    one = tt.init_params(dataclasses.replace(cfg, num_layers=1),
                         torch.Generator(), "meta")["layers"]
    return [(k, tuple(one[k].shape[1:])) for k in sorted(one)]


def executor_dropped(cfg) -> List[str]:
    """What JAX's executor leaves out of the model this config describes
    (ROADMAP C19): its embedding adds the token and learned-position rows
    and the embedding norm only (no token types), and its head reads
    ``final_norm_scale`` whatever ``final_norm`` says (a ``KeyError``
    without one) and adds no head bias."""
    out = []
    if cfg.type_vocab_size:
        out.append("tok_type_embed")
    if cfg.head_bias and not cfg.tie_embeddings:
        out.append("lm_head_bias")
    if not cfg.final_norm:
        out.append("final_norm=False")
    return out


class InfinityExecutor:
    """Layer-streamed train / eval of a dense transformer whose layers
    live in a ``LayerStore``. Owns the store, the embedding / head params
    (``nl_params``) and their optimizer state (``nl_opt``), and the IO
    threads; the engine hands it ``train_batch``, ``eval_batch`` and the
    checkpoints."""

    def __init__(self, model_cfg, *, device, seed: int = 0, params=None,
                 nvme_path: Optional[str] = None, lr=1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 bias_correction: bool = True, grad_clip: float = 0.0,
                 backend: str = "nvme", param_cache_bytes: int = 0,
                 gas: int = 1, fp16: Optional[Dict[str, Any]] = None,
                 use_cpu_adam: bool = False, pipeline: bool = True,
                 aio_config=None, mesh=None, compression=None,
                 moq: bool = False, max_live_params: int = 0):
        if model_cfg.num_experts > 1:
            raise ValueError("layer-streamed offload supports dense "
                             "transformers (MoE experts are not streamed)")
        if model_cfg.attn_windows:
            raise ValueError("layer-streamed offload does not thread "
                             "per-layer attn_windows")
        dropped = executor_dropped(model_cfg)
        if dropped:
            raise NotImplementedError(
                f"{', '.join(dropped)} under the layer-streamed offload "
                "executor: ROADMAP A11 (the leaves JAX's executor drops): "
                "JAX's executor embeds the token and position rows and the "
                "embedding norm only, reads final_norm_scale whatever "
                "final_norm says and adds no head bias (ROADMAP C19)")
        self.mesh = mesh if (mesh is not None
                             and mesh.plan.world_size > 1) else None
        F = TP = 1
        if self.mesh is not None:
            for ax in ("pipe", "seq", "expert"):
                if self.mesh.size(ax) > 1:
                    raise ValueError(f"layer-streamed offload shards over "
                                     f"data/fsdp/tensor; mesh axis '{ax}' "
                                     "> 1")
            F, TP = self.mesh.size("fsdp"), self.mesh.size("tensor")
        self._F = F
        self.dp = F * (self.mesh.size("data") if self.mesh else 1)
        # the shard axes of a chunk, in JAX's order (row-major shard index)
        self._chunk_axes = tuple(a for a, n in (("fsdp", F), ("tensor", TP))
                                 if n > 1)
        self.cfg = model_cfg
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.awm, self.bc = adam_w_mode, bias_correction
        self.lr, self.clip, self.gas = lr, grad_clip, gas
        self.compression = compression
        self.moq = bool(moq)
        self.applied_steps = 0
        self.skipped_steps = 0
        self.fp16 = dict(fp16) if fp16 else None
        if self.fp16:
            static = float(self.fp16.get("loss_scale", 0.0) or 0.0)
            self._dynamic_scale = static == 0.0
            self._scale = (static if not self._dynamic_scale else
                           float(2.0 ** self.fp16.get("initial_scale_power",
                                                      16)))
            self._scale_window = int(self.fp16.get("loss_scale_window", 1000))
            self._min_scale = float(self.fp16.get("min_loss_scale", 1.0))
            self._hysteresis = int(self.fp16.get("hysteresis", 2))
            self._good_steps = 0
            self._hyst_left = self._hysteresis
        L = model_cfg.num_layers
        self._template = layer_template(model_cfg)
        self._sizes = [math.prod(s) for _, s in self._template]
        numel = sum(self._sizes)
        align = 128 * F * TP
        self.whole_chunk = -(-numel // align) * align
        # what this rank's store keeps of each chunk: values
        # [shard_offset, shard_offset + chunk) of the whole chunk
        self.chunk = self.whole_chunk // (F * TP)
        self.shard_offset = 0
        if self.mesh is not None:
            self.shard_offset = self.chunk * (
                self.mesh.index("fsdp") * TP + self.mesh.index("tensor"))
        self.layer_params = numel
        self.num_params = L * numel
        self._tp_slices = self._tp_keep = None
        if TP > 1:
            self._tensor_cuts()
        self._pin = self.cuda
        self.store = LayerStore(nvme_path, L, self.chunk, backend=backend,
                                aio_config=aio_config)
        self.native = bool(use_cpu_adam)
        if self.native:
            from deepspeed_tpu_torch.ops import host_build
            host_build.CPU_ADAM.lib()      # a failed build raises here
        self.pipeline = bool(pipeline)
        self._rpool = ThreadPoolExecutor(2)
        self._wpool = ThreadPoolExecutor(2)
        self._pending_writes: List = []
        self._opt_stage = None
        self._cache_layers = 0
        if backend == "nvme":
            self._cache_layers = (param_cache_bytes // (2 * self.chunk)
                                  if param_cache_bytes else L)
        self._param_cache: Dict[int, torch.Tensor] = {}
        self._cache_lock = threading.Lock()
        # the live cache: layers' bf16 chunks kept on the card, up to
        # max_live_params params' worth (JAX's count: whole layers)
        self._live: Dict[int, torch.Tensor] = {}
        self.live_layers = (min(L, int(max_live_params) // max(1, numel))
                            if max_live_params else 0)
        # param chunk copies to the card (forward, backward, lazy init)
        self.param_reads = 0
        self._init_params(seed, params)

    def _tensor_cuts(self) -> None:
        """Each leaf's tensor-parallel slice (JAX's per-layer col / row
        rules: ``make_rules(0, tp=True)`` without the ``layers`` dim), and
        the mask over the whole chunk that keeps a replicated leaf's grad
        on tensor rank 0 only, so the sum over ``tensor`` counts it once
        (every tensor rank computes it whole)."""
        axes = tt.logical_axes(self.cfg)["layers"]
        rules = make_rules(0, tp=True)
        first = self.mesh.index("tensor") == 0
        self._tp_slices = {}
        keep = torch.ones(self.whole_chunk, dtype=torch.float32)
        off = 0
        for (name, shape), size in zip(self._template, self._sizes):
            spec = mesh_axes(axes[name][1:], rules)
            self._tp_slices[name] = shard_slices(shape, spec, self.mesh,
                                                 f"layers/{name}")
            if "tensor" not in spec_axes(spec) and not first:
                keep[off:off + size] = 0.0
            off += size
        self._tp_keep = keep.to(self.device)

    # --- init ------------------------------------------------------------
    def _flat_bits(self, leaves) -> torch.Tensor:
        """One layer's leaves -> this rank's (C,) bf16 chunk on the host
        (its shard of the whole chunk over fsdp x tensor)."""
        flat = torch.cat([t.reshape(-1).to(torch.bfloat16) for t in leaves])
        flat = torch.nn.functional.pad(flat,
                                       (0, self.whole_chunk - flat.numel()))
        out = torch.empty(self.chunk, dtype=torch.bfloat16,
                          pin_memory=self._pin)
        return out.copy_(flat[self.shard_offset:
                              self.shard_offset + self.chunk])

    @torch.no_grad()
    def _init_params(self, seed: int, params) -> None:
        """Layer by layer (the whole tree never exists on the card): from
        ``params`` (a JAX-layout tree of numpy arrays) or a seeded draw of
        a one-layer model per layer (its residual out-projections rescaled
        by 1 / sqrt(L), the whole model's init)."""
        cfg, L = self.cfg, self.cfg.num_layers
        names = [n for n, _ in self._template]
        if params is not None:
            for i in range(L):
                self.store.write("param", i, self._flat_bits(
                    [torch.from_numpy(np.array(params["layers"][n][i],
                                               np.float32))
                     for n in names]))
            nl = {k: torch.from_numpy(np.array(v, np.float32))
                  for k, v in params.items() if k != "layers"}
        else:
            cfg1 = dataclasses.replace(cfg, num_layers=1)
            gen = torch.Generator(device=self.device).manual_seed(seed)
            rescale = 1.0 / math.sqrt(L)
            for i in range(L + 1):
                drawn = tt.init_params(cfg1, gen, self.device,
                                       dtype=torch.float32)
                if i == L:
                    nl = {k: v for k, v in drawn.items() if k != "layers"}
                    break
                lay = drawn["layers"]
                self.store.write("param", i, self._flat_bits(
                    [lay[n][0] * (rescale if n in _OUT_KEYS else 1.0)
                     for n in names]))
        self.nl_params = {k: v.to(self.device, cfg.dtype).requires_grad_()
                          for k, v in nl.items()}
        self.nl_opt = {k: {"master": v.detach().float().clone(),
                           "m": torch.zeros_like(v, dtype=torch.float32),
                           "v": torch.zeros_like(v, dtype=torch.float32)}
                       for k, v in self.nl_params.items()}

    # --- param streaming --------------------------------------------------
    def _get_param(self, i: int) -> torch.Tensor:
        got = self._param_cache.get(i)
        if got is None:
            got = self.store.read("param", i, pin=self._pin)
            if got is None:
                raise RuntimeError(f"missing param chunk {i}")
            self._cache(i, got, new=True)
        return got

    def _cache(self, i: int, bits: torch.Tensor, new: bool) -> None:
        """Keep layer i's bits in the host cache: a ``new`` layer while
        there is room, an update of a layer it holds always (the read and
        write threads both come here)."""
        with self._cache_lock:
            if (not new and i in self._param_cache) or \
                    len(self._param_cache) < self._cache_layers:
                self._param_cache[i] = bits

    def _param_dev(self, i: int, host=None) -> torch.Tensor:
        """Layer i's chunk on the card: the live cache's, else a copy of
        the host chunk (kept live while the budget has room)."""
        got = self._live.get(i)
        if got is not None:
            return got
        host = host if host is not None else self._get_param(i)
        self.param_reads += 1
        dev = host.to(self.device, non_blocking=True)
        if len(self._live) < self.live_layers:
            self._live[i] = dev
        return dev

    def _refresh_live(self, i: int, bits: torch.Tensor) -> None:
        """After the update: layer i's new chunk on the card where the
        live cache holds it (or has room)."""
        if i in self._live or len(self._live) < self.live_layers:
            self._live[i] = bits.to(self.device, non_blocking=True)

    def _stream_params(self, order):
        """(i, layer i's bf16 chunk on the card) over ``order``, with two
        host reads in flight ahead of the consumer (none when drained;
        none for a layer the live cache holds)."""
        order = list(order)
        depth = 2 if self.pipeline else 0

        def submit(k):
            return (None if k in self._live
                    else self._rpool.submit(self._get_param, k))
        futs = {k: submit(k) for k in order[:depth]}
        for pos, i in enumerate(order):
            fut = futs.pop(i, None)
            if depth and pos + depth < len(order):
                nxt = order[pos + depth]
                futs[nxt] = submit(nxt)
            yield i, self._param_dev(
                i, fut.result() if fut is not None else None)

    def _whole(self, bits: torch.Tensor) -> torch.Tensor:
        """A layer's bf16 shard gathered whole over fsdp x tensor (one
        ``all_gather`` of the bits, as int32 pairs: gloo moves no 16-bit
        integers; the chunk itself at one rank)."""
        if not self._chunk_axes:
            return bits
        return comm.all_gather(bits.view(torch.int32), self._chunk_axes,
                               mesh=self.mesh).view(torch.bfloat16)

    def _to_shard(self, grad: torch.Tensor) -> torch.Tensor:
        """A layer's whole-chunk grad -> this rank's shard of its sum over
        the ranks: reduce-scattered over fsdp x tensor (a replicated
        leaf counted once over ``tensor``) and summed over ``data``."""
        if self.mesh is None:
            return grad
        if self._tp_keep is not None:
            grad = grad * self._tp_keep
        grad = comm.reduce_scatter(grad, self._chunk_axes, mesh=self.mesh)
        return comm.all_reduce(grad, "data", mesh=self.mesh)

    def _leaves(self, flat: torch.Tensor, step: int = 0,
                qbits=None) -> Dict[str, torch.Tensor]:
        """A layer's whole chunk (bf16 bits, or their f32 view in the
        backward) -> the param dict this rank's layer runs, in the compute
        dtype: the compression transform (per layer, JAX's
        ``{"layers": tree}``), MoQ's fake-quant of the leaves of 2 or more
        dims at ``qbits``, then a tensor rank's slices."""
        out, off = {}, 0
        for (name, shape), size in zip(self._template, self._sizes):
            out[name] = flat[off:off + size].view(shape).to(self.cfg.dtype)
            off += size
        if self.compression is not None:
            out = self.compression.apply({"layers": out}, step)["layers"]
        if self.moq and qbits is not None:
            out = {k: (ste_quant_traced_bits(v, qbits) if v.dim() >= 2
                       else v) for k, v in out.items()}
        if self._tp_slices is not None:
            out = {k: v[self._tp_slices[k]] for k, v in out.items()}
        return out

    def _layer(self, x, flat, positions, mask, step: int = 0, qbits=None):
        with par_ctx.parallel_context(self.mesh):
            return tt.transformer_layer(
                x, self._leaves(flat, step, qbits), self.cfg,
                positions=positions, mask=mask)[0]

    # --- the step ----------------------------------------------------------
    def _batch(self, batch):
        def dev(v):
            return (v if isinstance(v, torch.Tensor)
                    else torch.as_tensor(np.asarray(v))).to(self.device)
        ids = dev(batch["input_ids"])
        labels = tt.lm_labels({"input_ids": ids, **(
            {"labels": dev(batch["labels"])} if "labels" in batch else {})})
        mask = dev(batch["attention_mask"]) \
            if batch.get("attention_mask") is not None else None
        return ids, labels, mask

    def _rows(self, g: int, mb: int):
        """This rank's rows of micro-batch g (mb rows): its piece over
        the batch axes (data, fsdp), row-major as JAX's batch spec."""
        if self.mesh is None:
            return slice(g * mb, (g + 1) * mb)
        if mb % self.dp:
            raise ValueError(f"microbatch {mb} not divisible by "
                             f"data*fsdp={self.dp}")
        n = mb // self.dp
        r = self.mesh.index("data") * self._F + self.mesh.index("fsdp")
        return slice(g * mb + r * n, g * mb + (r + 1) * n)

    def _top_loss(self, nl, x, labels, count=None):
        """JAX's executor head: the final norm (``final_norm_scale`` and
        its bias where the model has one) and the chunked CE over the
        tied or untied head. ``count``: the micro-batch's label count
        over every rank (this rank's share of the mean)."""
        h = tt._norm(x, nl["final_norm_scale"], nl.get("final_norm_bias"),
                     self.cfg)
        tied = nl.get("lm_head") is None
        head = nl["tok_embed"] if tied else nl["lm_head"]
        c = self.cfg.loss_chunk if self.cfg.loss_chunk else min(1024,
                                                                x.shape[1])
        return tt.chunked_cross_entropy(h, head, labels, c, tied_embed=tied,
                                        count=count)

    def _embed(self, nl, ids):
        """JAX's executor embedding: the token rows, the learned position
        rows and the embedding norm (no token types)."""
        return tt._embed(nl, ids, self.cfg, token_types=False)

    def _positions(self, ids):
        B, S = ids.shape
        return torch.arange(S, device=ids.device)[None].expand(B, S)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _qbits(self, moq_bits, i: int):
        """Layer i's MoQ bit width: the engine's [L] bits of the step, or
        32 where none came (JAX's dummy, which MoQ still applies)."""
        if not self.moq:
            return None
        return float(moq_bits[i]) if moq_bits is not None else 32.0

    def train_batch(self, batch, moq_bits=None) -> Dict[str, Any]:
        """One optimizer step over ``gas`` micro-batches of ``batch`` (the
        global batch on every rank). ``moq_bits``: MoQ's [L] bit widths of
        this step."""
        cfg, L, gas = self.cfg, self.cfg.num_layers, self.gas
        ids_all, labels_all, mask_all = self._batch(batch)
        mb = ids_all.shape[0] // gas
        step = self.applied_steps
        stage: List[Optional[torch.Tensor]] = [None] * L
        sq_layer: List[Optional[torch.Tensor]] = [None] * L
        nl_grads = None
        losses = []
        scale = self._scale if self.fp16 else 1.0
        nl_names = sorted(self.nl_params)
        nl_leaves = [self.nl_params[k] for k in nl_names]
        for g in range(gas):
            sl = self._rows(g, mb)
            ids, labels = ids_all[sl], labels_all[sl]
            mask = mask_all[sl] if mask_all is not None else None
            count = None
            if self.mesh is not None:
                whole = labels_all[g * mb:(g + 1) * mb]
                count = (whole != -100).sum().clamp_min(1).float()
            pos = self._positions(ids)
            with torch.no_grad():
                x = self._embed(self.nl_params, ids)
                acts = [x]
                for i, bits in self._stream_params(range(L)):
                    x = self._layer(x, self._whole(bits), pos, mask, step,
                                    self._qbits(moq_bits, i))
                    acts.append(x)
                    if not self.pipeline:
                        self._sync()
            xl = acts[L].detach().requires_grad_()
            scaled = self._top_loss(self.nl_params, xl, labels, count) * scale
            *dnl, dx = torch.autograd.grad(scaled, nl_leaves + [xl],
                                           materialize_grads=True)
            losses.append(scaled.detach().reshape(1))
            last = g == gas - 1
            for i, bits in self._stream_params(range(L - 1, -1, -1)):
                flat32 = self._whole(bits).float().requires_grad_()
                xi = acts[i].detach().requires_grad_()
                y = self._layer(xi, flat32, pos, mask, step,
                                self._qbits(moq_bits, i))
                # the layer's collectives differentiate on the mesh
                with par_ctx.parallel_context(self.mesh):
                    dp, dx = torch.autograd.grad(y, (flat32, xi), dx)
                dp = self._to_shard(dp)
                acts[i + 1] = None
                if stage[i] is not None:
                    dp = dp + stage[i].to(self.device, non_blocking=True)
                if last:
                    sq_layer[i] = sum_of_squares(dp)
                stage[i] = self._to_host(dp)
            with torch.enable_grad():
                x0 = self._embed(self.nl_params, ids)
                demb = torch.autograd.grad(x0, nl_leaves, dx,
                                           allow_unused=True,
                                           materialize_grads=True)
            dnl = [a + b for a, b in zip(dnl, demb)]
            nl_grads = (dnl if nl_grads is None
                        else [a + b for a, b in zip(nl_grads, dnl)])
        inv = 1.0 / gas
        sq_l = torch.stack(sq_layer).sum().reshape(1)
        losses = torch.cat(losses)
        if self.mesh is not None:
            # the embedding / head grads and the loss: summed over the
            # batch axes (each rank holds its rows' share); the layer
            # shards' squares summed over the shard axes
            for gr in nl_grads:
                comm.all_reduce(gr, ("data", "fsdp"), mesh=self.mesh)
            comm.all_reduce(losses, ("data", "fsdp"), mesh=self.mesh)
            comm.all_reduce(sq_l, self._chunk_axes, mesh=self.mesh)
        self._sync()
        loss = sum(float(v) / scale for v in losses) / gas
        sq_total = float(sq_l[0]) * inv * inv
        nl_sq = float(torch.stack([sum_of_squares(gr * inv)
                                   for gr in nl_grads]).sum())
        if self.fp16 and not math.isfinite(sq_total + nl_sq):
            self._on_overflow()
            self.skipped_steps += 1
            return self._metrics(loss, float("nan"), True, scale)
        gnorm = math.sqrt(sq_total + nl_sq) / scale
        coef = inv / scale
        if self.clip and self.clip > 0 and gnorm > self.clip:
            coef *= self.clip / (gnorm + 1e-6)
        if self.fp16:
            self._on_good_step()
        self.applied_steps += 1
        lr_t = _lr_at(self.lr, self.applied_steps)
        self._nl_update(nl_names, nl_grads, lr_t, coef)
        del nl_grads
        if self.native:
            self._native_update_sweep(stage, lr_t, coef)
        else:
            self._device_update_sweep(stage, lr_t, coef)
        self._drain_write()
        return self._metrics(loss, gnorm, False, scale)

    def _metrics(self, loss, gnorm, overflow, scale):
        out = {"loss": torch.tensor(loss, dtype=torch.float32),
               "grad_norm": torch.tensor(gnorm, dtype=torch.float32),
               "overflow": torch.tensor(overflow)}
        if self.fp16:
            out["loss_scale"] = torch.tensor(scale, dtype=torch.float32)
        return out

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        if not self.cuda:
            return t.detach()
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    @torch.no_grad()
    def _nl_update(self, names, grads, lr_t, coef) -> None:
        """The embedding / head AdamW on the card, in place."""
        for name, g in zip(names, grads):
            o = self.nl_opt[name]
            fused_adam_update(o["master"], o["m"], o["v"], g.float() * coef,
                              lr_t, self.applied_steps, b1=self.b1,
                              b2=self.b2, eps=self.eps, wd=self.wd,
                              awm=self.awm, bc=self.bc)
            self.nl_params[name].copy_(o["master"])

    def _adam_chunk(self, opt, grad, bits, lr_t, coef) -> torch.Tensor:
        """The flat AdamW on one layer chunk on the card, in place on
        ``opt`` (None: the lazy init from ``bits``); returns (opt, the new
        bf16 bits)."""
        if opt is None:
            opt = torch.zeros((_PLANES, self.chunk), dtype=torch.float32,
                              device=self.device)
            opt[0].copy_(bits)
        fused_adam_update(opt[0], opt[1], opt[2], grad * coef, lr_t,
                          self.applied_steps, b1=self.b1, b2=self.b2,
                          eps=self.eps, wd=self.wd, awm=self.awm, bc=self.bc)
        return opt, opt[0].to(torch.bfloat16)

    @torch.no_grad()
    def _device_update_sweep(self, stage, lr_t, coef) -> None:
        """read(i+1) || AdamW(i) on the card || write(i-1)."""
        L = self.cfg.num_layers
        read = (lambda i: self.store.read("opt", i, pin=self._pin))
        fut = self._rpool.submit(read, 0) if self.pipeline else None
        for i in range(L):
            opt_host = fut.result() if self.pipeline else read(i)
            if self.pipeline:
                fut = self._rpool.submit(read, i + 1) if i + 1 < L else None
            opt = (None if opt_host is None
                   else opt_host.to(self.device, non_blocking=True))
            # the params only for a lazy init (master = the bf16 params)
            bits = self._param_dev(i) if opt is None else None
            opt, new_bits = self._adam_chunk(
                opt, stage[i].to(self.device, non_blocking=True), bits,
                lr_t, coef)
            stage[i] = None
            self._refresh_live(i, new_bits)
            opt_h, bits_h = self._to_host(opt), self._to_host(new_bits)
            done = None
            if self.cuda:
                done = torch.cuda.Event()
                done.record()
            self._write_layer(i, opt_h, bits_h, done)

    def _write_layer(self, i, opt_h, bits_h, done=None) -> None:
        def work():
            if done is not None:
                done.synchronize()
            self.store.write("opt", i, opt_h)
            self.store.write("param", i, bits_h)
            self._cache(i, bits_h, new=False)
        if not self.pipeline:
            work()
            return
        self._bound_writes()
        fut = self._wpool.submit(work)
        self._pending_writes.append(fut)
        return fut

    def _bound_writes(self, limit: int = 2) -> None:
        while len(self._pending_writes) >= limit:
            self._pending_writes.pop(0).result()

    def _drain_write(self) -> None:
        pend, self._pending_writes = self._pending_writes, []
        for f in pend:
            f.result()

    def _opt_read_staged(self, i: int) -> torch.Tensor:
        """Layer i's optimizer chunk in a staging buffer of the ring (lazy
        init from the bf16 params when there is none yet)."""
        buf = self._opt_stage.acquire(i)
        got = self.store.read("opt", i, out=buf)
        if got is None:
            buf[0].copy_(self._get_param(i))
            buf[1:].zero_()
            return buf
        return got

    def _native_update_sweep(self, stage, lr_t, coef) -> None:
        """The fused C++ AdamW (``ops/cpu_adam.py``) over the store's
        chunks, on the host: read i+1 fills one staging buffer while the
        host updates chunk i in a second and the writer drains i-1 from
        the third. The grads come from the host stage."""
        from deepspeed_tpu_torch.ops.cpu_adam import adam_step_flat
        L = self.cfg.num_layers
        self._sync()
        if self._opt_stage is None:
            self._opt_stage = StagingRing(3, (_PLANES, self.chunk),
                                          pin=self._pin)
        fut = (self._rpool.submit(self._opt_read_staged, 0)
               if self.pipeline else None)
        for i in range(L):
            opt = fut.result() if self.pipeline else self._opt_read_staged(i)
            if self.pipeline:
                fut = (self._rpool.submit(self._opt_read_staged, i + 1)
                       if i + 1 < L else None)
            adam_step_flat(opt[0], opt[1], opt[2], stage[i].reshape(-1),
                           step_num=self.applied_steps, lr=lr_t,
                           betas=(self.b1, self.b2), eps=self.eps,
                           weight_decay=self.wd, adamw_mode=self.awm,
                           bias_correction=self.bc, grad_scale=coef)
            stage[i] = None
            bits = torch.empty(self.chunk, dtype=torch.bfloat16,
                               pin_memory=self._pin).copy_(opt[0])
            self._refresh_live(i, bits)
            if self.store.backend != "nvme":
                opt = opt.clone()          # the store keeps its own chunk
            w = self._write_layer(i, opt, bits)
            if w is not None and opt is self._opt_stage.slot(i):
                self._opt_stage.mark_busy(i, w)

    def _on_overflow(self) -> None:
        if not self._dynamic_scale:
            return
        self._hyst_left -= 1
        if self._hyst_left <= 0:
            self._scale = max(self._min_scale, self._scale / 2.0)
            self._hyst_left = self._hysteresis
        self._good_steps = 0

    def _on_good_step(self) -> None:
        if not self._dynamic_scale:
            return
        self._good_steps += 1
        if self._good_steps >= self._scale_window:
            self._scale *= 2.0
            self._good_steps = 0
            self._hyst_left = self._hysteresis

    @torch.no_grad()
    def eval_batch(self, batch):
        """The loss of a batch (over ranks: each rank's rows, the mean
        over every rank's labels), at the step's compression and, with
        MoQ, JAX's 32-bit fake-quant."""
        ids, labels, mask = self._batch(batch)
        count = None
        if self.mesh is not None:
            count = (labels != -100).sum().clamp_min(1).float()
            sl = self._rows(0, ids.shape[0])
            ids, labels = ids[sl], labels[sl]
            mask = mask[sl] if mask is not None else None
        pos = self._positions(ids)
        x = self._embed(self.nl_params, ids)
        for i, bits in self._stream_params(range(self.cfg.num_layers)):
            x = self._layer(x, self._whole(bits), pos, mask,
                            self.applied_steps, self._qbits(None, i))
        loss = self._top_loss(self.nl_params, x, labels, count)
        if self.mesh is not None:
            loss = comm.all_reduce(loss.reshape(1).clone(), ("data", "fsdp"),
                                   mesh=self.mesh)[0]
        return loss

    def measure_decomposition(self, batch, reps: int = 2) -> Dict[str, float]:
        """What a step's parts cost, measured one at a time with a fence
        (JAX's ``measure_decomposition``): one layer chunk's copy to the
        card, one layer's forward + backward with its params already
        there, one chunk's AdamW and one optimizer chunk's read and write;
        scaled to the step (two param fetches, one forward + backward and
        one update and one chunk round trip a layer)."""
        L = self.cfg.num_layers
        ids, labels, mask = self._batch(batch)
        ids = ids[self._rows(0, ids.shape[0] // self.gas)]
        pos = self._positions(ids)

        def timed(fn):
            fn()
            self._sync()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            self._sync()
            return (time.perf_counter() - t0) / reps * 1e3

        host = self._get_param(0)
        bits = self._whole(host.to(self.device))
        with torch.no_grad():
            x = self._embed(self.nl_params, ids)

        def layer():
            with torch.no_grad():
                self._layer(x, bits, pos, mask)
            flat32 = bits.float().requires_grad_()
            xi = x.detach().requires_grad_()
            y = self._layer(xi, flat32, pos, mask)
            with par_ctx.parallel_context(self.mesh):
                torch.autograd.grad(y, (flat32, xi), torch.ones_like(y))

        grad = torch.zeros(self.chunk, device=self.device)
        dma = timed(lambda: host.to(self.device, non_blocking=True))
        layer_ms = timed(layer)
        if self.native:
            from deepspeed_tpu_torch.ops.cpu_adam import adam_step_flat
            scratch = torch.zeros((_PLANES, self.chunk))
            g = torch.zeros(self.chunk)
            update = timed(lambda: adam_step_flat(
                scratch[0], scratch[1], scratch[2], g, step_num=1,
                lr=1e-3, grad_scale=1.0))
        else:
            shard = host.to(self.device)
            update = timed(lambda: self._adam_chunk(None, grad, shard, 1e-3,
                                                    1.0))
        opt_io = 0.0
        if self.store.backend == "nvme" and \
                self.store.read("opt", 0) is not None:
            opt_io = timed(lambda: self.store.write(
                "opt", 0, self.store.read("opt", 0)))
        return {"offload_chunk_dma_ms": dma, "offload_layer_ms": layer_ms,
                "offload_dma_ms": dma * 2 * L,
                "offload_compute_ms": layer_ms * L,
                "offload_update_ms": update,
                "offload_update_sweep_ms": update * L,
                "offload_opt_io_ms": opt_io,
                "offload_io_ms": dma * 2 * L + opt_io * L,
                "offload_pipeline": self.pipeline}

    # --- checkpoints ---------------------------------------------------------
    def _rank0(self) -> bool:
        return self.mesh is None or comm.get_rank() == 0

    def save_checkpoint(self, path: str) -> Dict[str, Any]:
        """The chunks into ``path/infinity_chunks`` (whole chunks: over
        ranks each is gathered and rank 0 writes it; collective) and the
        shapes manifest ``infinity_shapes.json`` (``utils/zero_to_fp32``
        rebuilds the f32 tree from them with no engine); returns the small
        state the engine saves beside them."""
        self._drain_write()
        self._sync()
        dst = os.path.join(path, "infinity_chunks")
        if self.mesh is None:
            self.store.save_to(dst)
        else:
            self._save_gathered(dst)
        if self._rank0():
            with open(os.path.join(path, "infinity_shapes.json"), "w") as f:
                json.dump({"schema": SHAPES_SCHEMA, "chunk": self.whole_chunk,
                           "num_layers": self.cfg.num_layers,
                           "leaf_names": [n for n, _ in self._template],
                           "leaf_shapes": [list(s)
                                           for _, s in self._template]}, f)
        out = {"nl_params": {k: v.detach().cpu()
                             for k, v in self.nl_params.items()},
               "nl_opt": {k: {p: t.cpu() for p, t in o.items()}
                          for k, o in self.nl_opt.items()},
               "applied_steps": self.applied_steps}
        if self.fp16:
            out["loss_scale"] = [self._scale, self._good_steps,
                                 self._hyst_left]
        return out

    def _save_gathered(self, dst: str) -> None:
        """Each layer's param and optimizer chunks gathered whole over the
        shard axes; rank 0 writes them as a one-rank save does."""
        if self._rank0():
            os.makedirs(dst, exist_ok=True)
        for i in range(self.cfg.num_layers):
            for kind in ("param", "opt"):
                t = self.store.read(kind, i)
                if t is None:            # no update yet: on every rank
                    continue
                t = t.view(torch.int32) if kind == "param" else t
                whole = comm.all_gather(t.contiguous(), self._chunk_axes,
                                        dim=t.dim() - 1, mesh=self.mesh)
                if not self._rank0():
                    continue
                if kind == "param":
                    whole = whole.view(torch.bfloat16)
                p = os.path.join(dst, f"{kind}_{i}.bin")

                def do(whole=whole, p=p):
                    rb_faults.io_seam("nvme_write", p)
                    _view_bytes(whole).tofile(p)
                retry_io(do, what="layer-chunk checkpoint write", path=p)

    @torch.no_grad()
    def load_checkpoint(self, path: str, small: Dict[str, Any]) -> None:
        """A tag of any fsdp x tensor degree (whole chunks): each rank
        keeps its shard of every saved chunk, the zero pad cut or padded
        to this run's chunk."""
        saved_chunk = None
        manifest = os.path.join(path, "infinity_shapes.json")
        if os.path.exists(manifest):
            with open(manifest) as f:
                meta = json.load(f)
            saved_chunk = meta.get("chunk")
            if meta.get("num_layers") != self.cfg.num_layers:
                raise ValueError(f"checkpoint has {meta.get('num_layers')} "
                                 f"layers, model has {self.cfg.num_layers}")
        self._drain_write()
        self.store.load_from(os.path.join(path, "infinity_chunks"),
                             saved_chunk=saved_chunk, pin=self._pin,
                             whole=self.whole_chunk,
                             offset=self.shard_offset)
        self._param_cache.clear()
        self._live.clear()
        for k, v in small["nl_params"].items():
            self.nl_params[k].copy_(v)
        for k, o in small["nl_opt"].items():
            for p, t in o.items():
                self.nl_opt[k][p].copy_(t)
        self.applied_steps = int(small["applied_steps"])
        if self.fp16 and "loss_scale" in small:
            s, g, h = [float(x) for x in np.asarray(
                small["loss_scale"]).reshape(-1)]
            self._scale, self._good_steps, self._hyst_left = s, int(g), int(h)

    def device_bytes(self) -> int:
        """The card's share of the training state: the embedding / head
        params and their optimizer state, and the live cache's chunks."""
        return (sum(v.numel() * v.element_size()
                    for v in self.nl_params.values())
                + sum(t.numel() * 4 for o in self.nl_opt.values()
                      for t in o.values())
                + sum(t.numel() * t.element_size()
                      for t in self._live.values()))

    def close(self) -> None:
        self._drain_write()
        self._rpool.shutdown(wait=True)
        self._wpool.shutdown(wait=True)
        self.store.close()
        self._live.clear()
