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

One rank only: a mesh is ROADMAP A8d; a MoE model raises (its experts
are not streamed, as in JAX).
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

from deepspeed_tpu_torch.models import transformer as tt
from deepspeed_tpu_torch.ops.adam import fused_adam_update
from deepspeed_tpu_torch.ops.optimizers import _lr_at, sum_of_squares
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
                  pin: bool = False) -> None:
        """Every chunk of ``src``; a saved chunk of another length (the
        zero pad past the layer's values) is cut or padded to this one."""
        saved = saved_chunk or self.chunk
        for f in sorted(os.listdir(src)):
            if not f.endswith(".bin"):
                continue
            kind, i = f[:-4].rsplit("_", 1)
            p = os.path.join(src, f)
            dt = np.uint16 if kind == "param" else np.float32
            arr = retry_io(lambda p=p, dt=dt: np.fromfile(p, dt),
                           what="layer-chunk checkpoint read", path=p)
            arr = arr.reshape(-1 if kind == "param" else (_PLANES, saved))
            n = min(saved, self.chunk)
            shape, dtype = self._shape(kind)
            t = torch.zeros(shape, dtype=dtype, pin_memory=pin)
            src_t = torch.from_numpy(np.ascontiguousarray(arr))
            if kind == "param":
                t.view(torch.int16)[:n].copy_(src_t.view(torch.int16)[:n])
            else:
                t[:, :n].copy_(src_t[:, :n])
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
                 aio_config=None):
        if model_cfg.num_experts > 1:
            raise ValueError("layer-streamed offload supports dense "
                             "transformers (MoE experts are not streamed)")
        if model_cfg.attn_windows:
            raise ValueError("layer-streamed offload does not thread "
                             "per-layer attn_windows")
        family = tt.family_leaves(model_cfg)
        if family:
            raise NotImplementedError(
                f"{family} under ZeRO-Infinity layer streaming is not ported "
                "yet: ROADMAP A11 (the executor's embedding backward, final "
                "norm and head take a llama-shaped model's leaves)")
        self.cfg = model_cfg
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.awm, self.bc = adam_w_mode, bias_correction
        self.lr, self.clip, self.gas = lr, grad_clip, gas
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
        self.chunk = -(-numel // 128) * 128
        self.layer_params = numel
        self.num_params = L * numel
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
        self._init_params(seed, params)

    # --- init ------------------------------------------------------------
    def _flat_bits(self, leaves) -> torch.Tensor:
        """One layer's leaves -> its (C,) bf16 chunk on the host."""
        flat = torch.cat([t.reshape(-1).to(torch.bfloat16) for t in leaves])
        flat = torch.nn.functional.pad(flat, (0, self.chunk - flat.numel()))
        out = torch.empty(self.chunk, dtype=torch.bfloat16,
                          pin_memory=self._pin)
        return out.copy_(flat)

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

    def _stream_params(self, order):
        """(i, layer i's bf16 chunk on the card) over ``order``, with two
        host reads in flight ahead of the consumer (none when drained)."""
        order = list(order)
        depth = 2 if self.pipeline else 0
        futs = {k: self._rpool.submit(self._get_param, k)
                for k in order[:depth]}
        for pos, i in enumerate(order):
            fut = futs.pop(i, None)
            if depth and pos + depth < len(order):
                nxt = order[pos + depth]
                futs[nxt] = self._rpool.submit(self._get_param, nxt)
            host = fut.result() if fut is not None else self._get_param(i)
            yield i, host.to(self.device, non_blocking=True)

    def _leaves(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """A layer's chunk (bf16 bits, or their f32 view in the backward)
        -> its param dict in the compute dtype."""
        out, off = {}, 0
        for (name, shape), size in zip(self._template, self._sizes):
            out[name] = flat[off:off + size].view(shape).to(self.cfg.dtype)
            off += size
        return out

    def _layer(self, x, flat, positions, mask):
        return tt.transformer_layer(x, self._leaves(flat), self.cfg,
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

    def _top_loss(self, nl, x, labels):
        h = tt._norm(x, nl["final_norm_scale"], nl.get("final_norm_bias"),
                     self.cfg)
        tied = nl.get("lm_head") is None
        head = nl["tok_embed"] if tied else nl["lm_head"]
        c = self.cfg.loss_chunk if self.cfg.loss_chunk else min(1024,
                                                                x.shape[1])
        return tt.chunked_cross_entropy(h, head, labels, c, tied_embed=tied)

    def _positions(self, ids):
        B, S = ids.shape
        return torch.arange(S, device=ids.device)[None].expand(B, S)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def train_batch(self, batch) -> Dict[str, Any]:
        """One optimizer step over ``gas`` micro-batches of ``batch``."""
        cfg, L, gas = self.cfg, self.cfg.num_layers, self.gas
        ids_all, labels_all, mask_all = self._batch(batch)
        mb = ids_all.shape[0] // gas
        stage: List[Optional[torch.Tensor]] = [None] * L
        sq_layer: List[Optional[torch.Tensor]] = [None] * L
        nl_grads = None
        loss_sum = 0.0
        scale = self._scale if self.fp16 else 1.0
        nl_names = sorted(self.nl_params)
        nl_leaves = [self.nl_params[k] for k in nl_names]
        for g in range(gas):
            sl = slice(g * mb, (g + 1) * mb)
            ids, labels = ids_all[sl], labels_all[sl]
            mask = mask_all[sl] if mask_all is not None else None
            pos = self._positions(ids)
            with torch.no_grad():
                x = tt._embed(self.nl_params, ids, cfg)
                acts = [x]
                for i, bits in self._stream_params(range(L)):
                    x = self._layer(x, bits, pos, mask)
                    acts.append(x)
                    if not self.pipeline:
                        self._sync()
            xl = acts[L].detach().requires_grad_()
            scaled = self._top_loss(self.nl_params, xl, labels) * scale
            *dnl, dx = torch.autograd.grad(scaled, nl_leaves + [xl],
                                           materialize_grads=True)
            loss_sum += float(scaled.detach()) / scale
            last = g == gas - 1
            for i, bits in self._stream_params(range(L - 1, -1, -1)):
                flat32 = bits.float().requires_grad_()
                xi = acts[i].detach().requires_grad_()
                y = self._layer(xi, flat32, pos, mask)
                dp, dx = torch.autograd.grad(y, (flat32, xi), dx)
                acts[i + 1] = None
                if stage[i] is not None:
                    dp = dp + stage[i].to(self.device, non_blocking=True)
                if last:
                    sq_layer[i] = sum_of_squares(dp)
                stage[i] = self._to_host(dp)
            with torch.enable_grad():
                x0 = tt._embed(self.nl_params, ids, cfg)
                (demb,) = torch.autograd.grad(
                    x0, self.nl_params["tok_embed"], dx)
            dnl[nl_names.index("tok_embed")] = \
                dnl[nl_names.index("tok_embed")] + demb
            nl_grads = (dnl if nl_grads is None
                        else [a + b for a, b in zip(nl_grads, dnl)])
        inv = 1.0 / gas
        self._sync()
        sq_total = float(torch.stack(sq_layer).sum()) * inv * inv
        nl_sq = float(torch.stack([sum_of_squares(gr * inv)
                                   for gr in nl_grads]).sum())
        if self.fp16 and not math.isfinite(sq_total + nl_sq):
            self._on_overflow()
            self.skipped_steps += 1
            return self._metrics(loss_sum / gas, float("nan"), True, scale)
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
        return self._metrics(loss_sum / gas, gnorm, False, scale)

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
            bits = self._get_param(i).to(self.device, non_blocking=True)
            opt, new_bits = self._adam_chunk(
                opt, stage[i].to(self.device, non_blocking=True), bits,
                lr_t, coef)
            stage[i] = None
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
        ids, labels, mask = self._batch(batch)
        pos = self._positions(ids)
        x = tt._embed(self.nl_params, ids, self.cfg)
        for _, bits in self._stream_params(range(self.cfg.num_layers)):
            x = self._layer(x, bits, pos, mask)
        return self._top_loss(self.nl_params, x, labels)

    def measure_decomposition(self, batch, reps: int = 2) -> Dict[str, float]:
        """What a step's parts cost, measured one at a time with a fence
        (JAX's ``measure_decomposition``): one layer chunk's copy to the
        card, one layer's forward + backward with its params already
        there, one chunk's AdamW and one optimizer chunk's read and write;
        scaled to the step (two param fetches, one forward + backward and
        one update and one chunk round trip a layer)."""
        L = self.cfg.num_layers
        ids, labels, mask = self._batch(batch)
        ids = ids[:ids.shape[0] // self.gas]
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
        bits = host.to(self.device)
        with torch.no_grad():
            x = tt._embed(self.nl_params, ids, self.cfg)

        def layer():
            with torch.no_grad():
                self._layer(x, bits, pos, mask)
            flat32 = bits.float().requires_grad_()
            xi = x.detach().requires_grad_()
            y = self._layer(xi, flat32, pos, mask)
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
            update = timed(lambda: self._adam_chunk(None, grad, bits, 1e-3,
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
    def save_checkpoint(self, path: str) -> Dict[str, Any]:
        """The chunks into ``path/infinity_chunks`` and the shapes manifest
        ``infinity_shapes.json`` (``utils/zero_to_fp32`` rebuilds the f32
        tree from them with no engine); returns the small state the
        engine saves beside them."""
        self._drain_write()
        self._sync()
        self.store.save_to(os.path.join(path, "infinity_chunks"))
        with open(os.path.join(path, "infinity_shapes.json"), "w") as f:
            json.dump({"schema": SHAPES_SCHEMA, "chunk": self.chunk,
                       "num_layers": self.cfg.num_layers,
                       "leaf_names": [n for n, _ in self._template],
                       "leaf_shapes": [list(s) for _, s in self._template]},
                      f)
        out = {"nl_params": {k: v.detach().cpu()
                             for k, v in self.nl_params.items()},
               "nl_opt": {k: {p: t.cpu() for p, t in o.items()}
                          for k, o in self.nl_opt.items()},
               "applied_steps": self.applied_steps}
        if self.fp16:
            out["loss_scale"] = [self._scale, self._good_steps,
                                 self._hyst_left]
        return out

    @torch.no_grad()
    def load_checkpoint(self, path: str, small: Dict[str, Any]) -> None:
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
                             saved_chunk=saved_chunk, pin=self._pin)
        self._param_cache.clear()
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
        params and their optimizer state."""
        return (sum(v.numel() * v.element_size()
                    for v in self.nl_params.values())
                + sum(t.numel() * 4 for o in self.nl_opt.values()
                      for t in o.values()))

    def close(self) -> None:
        self._drain_write()
        self._rpool.shutdown(wait=True)
        self._wpool.shutdown(wait=True)
        self.store.close()
