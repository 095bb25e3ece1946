"""The optimizer-state tiers of ZeRO-Offload, a port of
``deepspeed_tpu/runtime/swap_tensor.py``: the f32 Adam state (master, m,
v) leaves the card and a step streams it back, or the update runs on the
host.

``NVMeOptimizerSwapper`` (JAX's class of that name): the whole state is
laid out as fixed-size flat chunks, a (3, C) f32 buffer each (planes
master, m, v), over the param leaves in the tree's order. AdamW is
elementwise, so a chunk boundary needs no leaf boundary. ``storage``:
"nvme" (chunk files through ``ops/aio.py``), "pinned" (page-locked host
buffers: the ``offload_optimizer.device=cpu`` tier on the card) or
"host" (plain CPU tensors: the same tier on the CPU). A step is

    read chunk i+1  ||  update chunk i on the card  ||  write chunk i-1

with the file reads and writes on two threads (each with its own IO
handle) and the copies to and from the card on two side streams of
their own, ordered by events: the copy of chunk i+1 and the copy back of
chunk i-1 run while the card updates chunk i. Two device buffers take
turns, allocated for the step only (the card holds no optimizer state
between steps). The update is ``ops/adam.fused_adam_update`` on the chunk's
planes; the updated masters are cast into the params in place.
``pipeline=False`` is the drained swapper (every read and write done
before the next chunk), the same numbers bit for bit.

``HostAdamSwapper`` (JAX's ``HostAdamSwapper``, and its
``XlaHostAdamSwapper`` route, which places the update on a TPU host
inside the XLA program: on the card there is one host flavour, and JAX
states that both export the same ``{master, m, v}`` layout): master, m
and v in pinned host memory, the grads copied down in the wire dtype
(bf16 bits for bf16, f16 widened on the host, f32), the fused C++ update
in place (``ops/cpu_adam.py``, or ``ops/cpu_adagrad.py`` with
``optim="adagrad"``) writing the new params, which are copied up.

Both compute the global grad norm over what they hold (the NVMe swapper
on the card, the host one in the C++ over the wire grads; over ranks the
caller hands in the squares' sum over every rank, ``sq_total``), clip,
and report an fp16 overflow (a non-finite norm) before touching any
state: the caller skips the step. ``export_state`` / ``import_state`` use
JAX's layout (``chunk_i`` (3, C) planes; or ``master``, ``m``, ``v`` /
``accum`` flat), which a checkpoint keeps as ``optswap.npz``;
``planes`` / ``state_from_planes`` turn it into (P, n) planes over the
leaves in order and back.

Over ranks (ZeRO stage 1-3 on ``data`` / ``fsdp``, JAX's ``_flat_spec``
sharding of the flat state over the mesh) a rank's swapper holds its
ZeRO partition only: the engine builds it on each leaf's optimizer slice,
and a checkpoint gathers the planes whole into the one-rank layout.
"""

import itertools
import math
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops.adam import fused_adam_update
from deepspeed_tpu_torch.ops.optimizers import _lr_at, sum_of_squares

# master / exp_avg / exp_avg_sq planes in each chunk buffer
_PLANES = 3
_SEQ = itertools.count()


def _host_empty(shape, dtype, pin: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=pin)


def grad_norm_coef(sq_total: float, *, grad_scale: float, clip: float):
    """(global norm, update coefficient) of grads whose squares sum to
    ``sq_total`` and that carry a ``grad_scale`` (the fp16 loss scale), as
    JAX's swappers: the norm of the unscaled grads, and 1 / scale times
    clip / (norm + 1e-6) where the norm passes ``clip``."""
    gnorm = math.sqrt(sq_total) / grad_scale
    coef = 1.0 / grad_scale
    if clip and clip > 0 and gnorm > clip:
        coef *= clip / (gnorm + 1e-6)
    return gnorm, coef


def chunk_planes(planes: np.ndarray, chunk: int) -> Dict[str, np.ndarray]:
    """(P, n) planes cut into zero-padded (P, chunk) chunks ``chunk_i``
    (the NVMe swapper's layout at ``chunk`` values a chunk)."""
    P, n = planes.shape
    out = {}
    for i in range(max(1, math.ceil(n / chunk))):
        c = np.zeros((P, chunk), np.float32)
        part = planes[:, i * chunk:(i + 1) * chunk]
        c[:, :part.shape[1]] = part
        out[f"chunk_{i}"] = c
    return out


class NVMeOptimizerSwapper:
    """The f32 Adam / AdamW state in flat chunks off the card, streamed
    through it each step. The swapper owns the chunks, the IO threads and
    handles; the engine owns the params, grads, loss scale and step
    count."""

    def __init__(self, params: List[torch.Tensor], *, device,
                 nvme_path: Optional[str] = None, storage: str = "nvme",
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 bias_correction: bool = True, chunk_elems: int = 1 << 24,
                 pipeline: bool = True, aio_config=None):
        if storage not in ("nvme", "pinned", "host"):
            raise ValueError(f"storage {storage!r}: nvme, pinned or host")
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.storage = storage
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.awm, self.bc = adam_w_mode, bias_correction
        self.pipeline = pipeline
        self._sizes = [p.numel() for p in params]
        self.num_params = sum(self._sizes)
        c = max(1, int(chunk_elems))
        self.chunk = c
        self.n_chunks = max(1, math.ceil(self.num_params / c))
        # chunk ci <- [(leaf li, offset in the leaf, length)] in leaf order
        self._chunk_segs: List[List] = [[] for _ in range(self.n_chunks)]
        off = 0
        for li, size in enumerate(self._sizes):
            lo = 0
            while lo < size:
                ci = off // c
                take = min(size - lo, (ci + 1) * c - off)
                self._chunk_segs[ci].append((li, lo, take))
                off, lo = off + take, lo + take
        pin = self.cuda
        self._dir = None
        self._store: Dict[int, torch.Tensor] = {}
        self._aio_r = self._aio_w = None
        if storage == "nvme":
            if not nvme_path:
                raise ValueError("storage='nvme' requires nvme_path")
            from deepspeed_tpu_torch.ops.aio import AIOHandle
            self._dir = os.path.join(
                nvme_path, f"dstpu-optswap-{os.getpid()}-{next(_SEQ)}")
            os.makedirs(self._dir, exist_ok=True)
            # one handle (ring) per direction: a queued write never delays
            # the next read
            self._aio_r = AIOHandle.from_config(aio_config, "read")
            self._aio_w = AIOHandle.from_config(aio_config, "write")
            self._rbufs = [_host_empty((_PLANES, c), torch.float32, pin)
                           for _ in range(2)]
            self._wbufs = ([_host_empty((_PLANES, c), torch.float32, True)
                            for _ in range(2)] if self.cuda else self._rbufs)
        self._rpool = ThreadPoolExecutor(1) if pipeline else None
        self._wpool = ThreadPoolExecutor(1) if pipeline else None
        self._wfut: List = [None, None]
        if self.cuda:
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
            self._ev = {k: [torch.cuda.Event() for _ in range(2)]
                        for k in ("h2d", "upd", "d2h")}
            for e in self._ev["d2h"]:
                e.record()

    # --- storage ---------------------------------------------------------
    def _path(self, i: int) -> str:
        return os.path.join(self._dir, f"opt_chunk_{i}.bin")

    def _read_file(self, i: int, out: torch.Tensor) -> torch.Tensor:
        return self._aio_r.pread(self._path(i), out)

    def _write_file(self, i: int, buf: torch.Tensor, after=None) -> None:
        if after is not None:
            after.synchronize()
        self._aio_w.pwrite(self._path(i), buf)

    # --- the state's life --------------------------------------------------
    def _flat_chunk(self, ci: int, leaves, dtype=torch.float32):
        """Chunk ci of the leaves, flat and zero-padded to C."""
        parts = [leaves[li].detach().reshape(-1)[lo:lo + ln].to(dtype)
                 for li, lo, ln in self._chunk_segs[ci]]
        flat = torch.cat(parts) if len(parts) != 1 else parts[0]
        if flat.numel() < self.chunk:
            flat = torch.nn.functional.pad(flat,
                                           (0, self.chunk - flat.numel()))
        return flat

    @torch.no_grad()
    def initialize(self, params: List[torch.Tensor]) -> None:
        """master = the params (f32), m = v = 0, chunk by chunk."""
        for i in range(self.n_chunks):
            buf = torch.zeros((_PLANES, self.chunk), dtype=torch.float32,
                              pin_memory=self.cuda)
            buf[0].copy_(self._flat_chunk(i, params))
            self._put(i, buf)

    def _put(self, i: int, buf: torch.Tensor) -> None:
        if self.storage == "nvme":
            self._write_file(i, buf)
        else:
            self._store[i] = buf

    def _get(self, i: int) -> torch.Tensor:
        """Chunk i as a host tensor (a copy for the nvme tier)."""
        if self.storage == "nvme":
            return self._read_file(i, torch.empty((_PLANES, self.chunk),
                                                  dtype=torch.float32))
        return self._store[i]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], params: List[torch.Tensor], *,
             lr: float, step_num: int, clip: Optional[float] = None,
             grad_scale: float = 1.0, sq_total: Optional[float] = None):
        """One AdamW step: ``grads`` (f32, already averaged; under fp16
        still scaled by ``grad_scale``) update the state and, in place,
        ``params``. ``sq_total``: the grads' sum of squares over every
        rank (default: over ``grads``). Returns (grad norm, overflow); on
        an overflow nothing is read or written."""
        total = (float(torch.stack([sum_of_squares(g) for g in grads]).sum())
                 if sq_total is None else sq_total)
        if not math.isfinite(total):
            return float("nan"), True
        gnorm, coef = grad_norm_coef(total, grad_scale=grad_scale, clip=clip)
        lr_t = _lr_at(lr, step_num)
        nvme = self.storage == "nvme"
        main = torch.cuda.current_stream(self.device) if self.cuda else None
        if self.cuda:
            # this step's copies follow the last step's copies back and the
            # grads' making; the two device buffers live for the step only
            # (the allocator reuses them once both side streams are done)
            self._h2d.wait_stream(self._d2h)
            self._h2d.wait_stream(main)
            self._dbufs = [torch.empty((_PLANES, self.chunk),
                                       dtype=torch.float32,
                                       device=self.device) for _ in range(2)]
            for buf in self._dbufs:
                buf.record_stream(self._h2d)
                buf.record_stream(self._d2h)
        rfut = None
        if nvme and self.pipeline:
            self._free_read_slot(0)
            rfut = self._rpool.submit(self._read_file, 0, self._rbufs[0])
        for i in range(self.n_chunks):
            k = i % 2
            if nvme:
                host = (rfut.result() if self.pipeline
                        else self._read_file(i, self._rbufs[k]))
                if self.pipeline and i + 1 < self.n_chunks:
                    self._free_read_slot(1 - k)
                    rfut = self._rpool.submit(self._read_file, i + 1,
                                              self._rbufs[1 - k])
            else:
                host = self._store[i]
            if self.cuda:
                dev = self._dbufs[k]
                with torch.cuda.stream(self._h2d):
                    self._h2d.wait_event(self._ev["d2h"][k])
                    dev.copy_(host, non_blocking=True)
                    self._ev["h2d"][k].record(self._h2d)
                main.wait_event(self._ev["h2d"][k])
            else:
                dev = host
            self._update_chunk(i, dev, grads, params, lr_t, step_num, coef)
            self._write_back(i, k, dev, main)
        for k in range(2):
            self._wait_write(k)
        self._dbufs = None
        return gnorm, False

    def _free_read_slot(self, k: int) -> None:
        """Read staging buffer k may be refilled: its copy to the card is
        done (and on the CPU, where it is also the write buffer, its
        write)."""
        if self.cuda:
            self._ev["h2d"][k].synchronize()
        else:
            self._wait_write(k)

    def _wait_write(self, k: int) -> None:
        if self._wfut[k] is not None:
            self._wfut[k].result()
            self._wfut[k] = None

    def _update_chunk(self, i, dev, grads, params, lr_t, step_num, coef):
        g = self._flat_chunk(i, grads)
        master, m, v = dev[0], dev[1], dev[2]
        fused_adam_update(master, m, v, g * coef if coef != 1.0 else g, lr_t,
                          step_num, b1=self.b1, b2=self.b2, eps=self.eps,
                          wd=self.wd, awm=self.awm, bc=self.bc)
        off = 0
        for li, lo, ln in self._chunk_segs[i]:
            params[li].detach().view(-1)[lo:lo + ln].copy_(
                master[off:off + ln])
            off += ln

    def _write_back(self, i, k, dev, main) -> None:
        nvme = self.storage == "nvme"
        if self.cuda:
            self._ev["upd"][k].record(main)
            if nvme:
                self._wait_write(k)        # write staging buffer k is free
            target = self._wbufs[k] if nvme else self._store[i]
            with torch.cuda.stream(self._d2h):
                self._d2h.wait_event(self._ev["upd"][k])
                target.copy_(dev, non_blocking=True)
                self._ev["d2h"][k].record(self._d2h)
            done = self._ev["d2h"][k]
        else:
            target, done = dev, None       # updated in place
        if not nvme:
            return
        if self.pipeline:
            self._wfut[k] = self._wpool.submit(self._write_file, i, target,
                                               done)
        else:
            self._write_file(i, target, done)

    # --- checkpoints: the swapped state is part of the training state ----
    def export_state(self) -> Dict[str, np.ndarray]:
        """Every chunk, read back to host memory (JAX's ``chunk_i``)."""
        if self.cuda:
            torch.cuda.synchronize(self.device)
        return {f"chunk_{i}": self._get(i).numpy().copy()
                for i in range(self.n_chunks)}

    def planes(self, state: Dict[str, np.ndarray],
               n: Optional[int] = None) -> np.ndarray:
        """An exported state (of ``n`` values a plane; default this
        swapper's) as (3, n) planes over the leaves in order."""
        flat = np.concatenate([state[f"chunk_{i}"]
                               for i in range(len(state))], axis=1)
        return flat[:, :n or self.num_params]

    def state_from_planes(self, planes: np.ndarray) -> Dict[str, np.ndarray]:
        """(3, n) planes in this swapper's chunk layout (``chunk_i``)."""
        return chunk_planes(planes, self.chunk)

    def import_state(self, chunks: Dict[str, np.ndarray]) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)
        for i in range(self.n_chunks):
            arr = np.ascontiguousarray(chunks[f"chunk_{i}"], np.float32)
            if arr.shape != (_PLANES, self.chunk):
                raise ValueError(f"optswap chunk_{i}: shape {arr.shape}, "
                                 f"this swapper's {(_PLANES, self.chunk)}")
            buf = torch.empty((_PLANES, self.chunk), dtype=torch.float32,
                              pin_memory=self.cuda)
            buf.copy_(torch.from_numpy(arr))
            self._put(i, buf)

    def host_bytes(self) -> int:
        return sum(t.numel() * 4 for t in self._store.values())

    def disk_bytes(self) -> int:
        if not self._dir or not os.path.isdir(self._dir):
            return 0
        return sum(os.path.getsize(os.path.join(self._dir, f))
                   for f in os.listdir(self._dir))

    def close(self) -> None:
        for k in range(2):
            self._wait_write(k)
        for pool in (self._rpool, self._wpool):
            if pool is not None:
                pool.shutdown(wait=True)
        self._rpool = self._wpool = None
        for h in (self._aio_r, self._aio_w):
            if h is not None:
                h.close()
        self._aio_r = self._aio_w = None
        self._store.clear()
        if self._dir:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class HostAdamSwapper:
    """ZeRO-Offload with the optimizer on the host: f32 state in host
    memory (pinned on the card's machine), updated in place by the fused
    C++ (``optim`` "adam" or "adagrad"). A step moves the grads down and
    the params up in the compute dtype: 4 bytes a param under bf16,
    against the 24 the chunk-streamed tier moves."""

    def __init__(self, params: List[torch.Tensor], *, device, lr=1e-3,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adam_w_mode: bool = True,
                 bias_correction: bool = True,
                 compute_dtype=torch.bfloat16, optim: str = "adam"):
        self.device = torch.device(device)
        pin = self.device.type == "cuda"
        self.optim = optim
        self._sizes = [p.numel() for p in params]
        self._offsets = np.cumsum([0] + self._sizes).tolist()
        self.n = n = sum(self._sizes)
        if optim == "adagrad":
            from deepspeed_tpu_torch.ops.cpu_adagrad import CPUAdagrad
            self.cpu = CPUAdagrad(n, lr=lr, eps=eps,
                                  weight_decay=weight_decay, pin=pin)
        else:
            from deepspeed_tpu_torch.ops.cpu_adam import CPUAdam
            self.cpu = CPUAdam(n, lr=lr, betas=betas, eps=eps,
                               weight_decay=weight_decay,
                               adamw_mode=adam_w_mode,
                               bias_correction=bias_correction, pin=pin)
        self._bf16 = compute_dtype == torch.bfloat16
        self._f16 = compute_dtype == torch.float16
        # the wire: the compute dtype (f16 widened to f32 on the host for
        # the C++, the updated params narrowed back)
        self._wire = compute_dtype if (self._bf16 or self._f16) \
            else torch.float32
        self._gbuf = _host_empty(n, self._wire, pin)
        self._pbuf = _host_empty(n, torch.bfloat16 if self._bf16
                                 else torch.float32, pin)
        if self._f16:
            self._g32 = torch.empty(n, dtype=torch.float32)
            self._p16 = _host_empty(n, torch.float16, pin)

    @torch.no_grad()
    def initialize(self, params: List[torch.Tensor]) -> None:
        for p, off, size in zip(params, self._offsets, self._sizes):
            self.cpu.master[off:off + size].copy_(p.detach().reshape(-1))

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], params: List[torch.Tensor], *,
             lr: float, step_num: int, clip: Optional[float] = None,
             grad_scale: float = 1.0, sq_total: Optional[float] = None):
        for g, off, size in zip(grads, self._offsets, self._sizes):
            self._gbuf[off:off + size].copy_(g.reshape(-1),
                                             non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        gflat = self._gbuf
        if self._f16:
            self._g32.copy_(self._gbuf)
            gflat = self._g32
        sq = self.cpu.sq_norm(gflat) if sq_total is None else sq_total
        if not math.isfinite(sq):
            return float("nan"), True
        gnorm = math.sqrt(sq) / grad_scale
        coef = (1.0 / grad_scale) * self.cpu.clip_coef(sq, clip,
                                                       1.0 / grad_scale)
        self.cpu.step(gflat, step_num, lr=_lr_at(lr, step_num),
                      grad_scale=coef, out=self._pbuf)
        out = self._pbuf
        if self._f16:
            self._p16.copy_(self._pbuf)
            out = self._p16
        for p, off, size in zip(params, self._offsets, self._sizes):
            p.detach().view(-1).copy_(out[off:off + size], non_blocking=True)
        return gnorm, False

    def export_state(self) -> Dict[str, np.ndarray]:
        return {k: v.numpy().copy() for k, v in self.cpu.state().items()}

    def planes(self, state: Dict[str, np.ndarray],
               n: Optional[int] = None) -> np.ndarray:
        """An exported state (of ``n`` values a plane) as (P, n) planes,
        in ``cpu.state()``'s key order."""
        return np.stack([state[k] for k in self.cpu.state()])[:, :n]

    def state_from_planes(self, planes: np.ndarray) -> Dict[str, np.ndarray]:
        return {k: planes[j] for j, k in enumerate(self.cpu.state())}

    def import_state(self, state: Dict[str, np.ndarray]) -> None:
        for k, v in self.cpu.state().items():
            v.copy_(torch.from_numpy(np.ascontiguousarray(state[k],
                                                          np.float32)))

    def host_bytes(self) -> int:
        return sum(v.numel() * 4 for v in self.cpu.state().values())

    def disk_bytes(self) -> int:
        return 0

    def close(self) -> None:
        pass
