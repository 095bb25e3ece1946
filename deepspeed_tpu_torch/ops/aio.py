"""Native async file IO for the offload tiers, a port of
``deepspeed_tpu/ops/aio.py`` over ``csrc/host/dstpu_aio.cpp`` (io_uring by
raw syscalls, or a thread pool of pread / pwrite where the kernel refuses
``io_uring_setup``: ``uses_io_uring`` says which path a handle took).

``AIOHandle.pwrite`` / ``pread`` move a whole contiguous host buffer (a
numpy array or a CPU tensor, pinned or not) at a file offset, each
through a fault seam (``aio_write`` / ``aio_read``, ``robustness/
faults.io_seam``) and ``retry_io``. ``direct=True`` opens the file with
``O_DIRECT``, which needs the buffer's address, its size and the offset
to be multiples of 4096: such a buffer comes from ``aligned_buffer``
(``dstpu_aio_alloc``, registered with the card's driver so copies to and
from the card are pinned), or is a pinned tensor whose own storage
starts on a page; anything else raises before it reaches the C++.
"""

import ctypes
import errno
from typing import Optional

import numpy as np
import torch

from deepspeed_tpu_torch.ops import host_build
from deepspeed_tpu_torch.robustness import faults as rb_faults
from deepspeed_tpu_torch.robustness.retry import retry_io

ALIGN = 4096
# the handle's own defaults (deeper and wider than the config section's
# 8 / 1; a field the user did not set keeps these, as in JAX)
_DEFAULT_QUEUE_DEPTH = 32
_DEFAULT_THREAD_COUNT = 4


def _buffer(buf):
    """(address, bytes, page-aligned view?) of a contiguous host buffer."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("aio: need a contiguous CPU tensor, got "
                             f"{buf.device} contiguous={buf.is_contiguous()}")
        return (buf.data_ptr(), buf.numel() * buf.element_size(),
                buf.storage_offset() == 0)
    if not isinstance(buf, np.ndarray) or not buf.flags.c_contiguous:
        raise ValueError("aio: need a contiguous numpy array or tensor")
    return buf.ctypes.data, buf.nbytes, True


def _check_direct(addr: int, nbytes: int, offset: int, whole: bool) -> None:
    if not whole or addr % ALIGN or nbytes % ALIGN or offset % ALIGN:
        raise ValueError(
            f"aio O_DIRECT needs a buffer starting its own storage on a "
            f"{ALIGN}-byte page, a size and an offset in whole pages: got "
            f"address % {ALIGN} = {addr % ALIGN}, {nbytes} bytes, offset "
            f"{offset}, own storage={whole}")


class AlignedBuffer:
    """``nbytes`` (rounded up to whole pages) from ``dstpu_aio_alloc``, as
    a uint8 CPU tensor (``tensor``), registered with the card's driver
    when CUDA is there (``pinned``). ``free()`` (or the collector)
    returns it."""

    def __init__(self, nbytes: int, pin: bool = True):
        self.nbytes = -(-int(nbytes) // ALIGN) * ALIGN
        self.addr = host_build.AIO.call("dstpu_aio_alloc", self.nbytes)
        if not self.addr:
            raise MemoryError(f"dstpu_aio_alloc({self.nbytes}) failed")
        raw = (ctypes.c_uint8 * self.nbytes).from_address(self.addr)
        self.tensor = torch.frombuffer(raw, dtype=torch.uint8)
        self.pinned = False
        if pin and torch.cuda.is_available():
            rc = torch.cuda.cudart().cudaHostRegister(self.addr, self.nbytes,
                                                      0)
            if int(rc) != 0:
                raise RuntimeError(f"cudaHostRegister failed: {rc}")
            self.pinned = True

    def view(self, dtype: torch.dtype, shape) -> torch.Tensor:
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        return self.tensor[:n].view(dtype).view(tuple(shape))

    def free(self) -> None:
        if self.addr:
            if self.pinned:
                torch.cuda.cudart().cudaHostUnregister(self.addr)
            self.tensor = None
            host_build.AIO.call("dstpu_aio_free", self.addr)
            self.addr = 0

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


def aligned_buffer(nbytes: int, pin: bool = True) -> AlignedBuffer:
    return AlignedBuffer(nbytes, pin)


class AIOHandle:
    """One ring (or thread pool): ``block_size`` bytes a request, up to
    ``queue_depth`` in flight. A handle serializes its own operations;
    the offload tiers open one for reads and one for writes."""

    @classmethod
    def from_config(cls, aio_cfg=None, role: str = "read") -> "AIOHandle":
        """A handle from the config ``aio`` section: ``role`` picks the
        read or the write queue depth (each defaults to ``queue_depth``);
        the fields the user did not set keep the handle's defaults."""
        if aio_cfg is None:
            return cls()
        was_set = getattr(aio_cfg, "was_set", lambda _k: True)
        depth = (aio_cfg.read_queue_depth if role == "read"
                 else aio_cfg.write_queue_depth)
        if depth is None:
            depth = (aio_cfg.queue_depth if was_set("queue_depth")
                     else _DEFAULT_QUEUE_DEPTH)
        threads = (aio_cfg.thread_count if was_set("thread_count")
                   else _DEFAULT_THREAD_COUNT)
        return cls(block_size=aio_cfg.block_size, queue_depth=depth,
                   thread_count=threads)

    def __init__(self, block_size: int = 1 << 20,
                 queue_depth: int = _DEFAULT_QUEUE_DEPTH,
                 thread_count: int = _DEFAULT_THREAD_COUNT):
        self._h = host_build.AIO.call("dstpu_aio_open", block_size,
                                      queue_depth, thread_count)
        self.block_size = block_size
        self.queue_depth = queue_depth
        self.thread_count = thread_count

    @property
    def uses_io_uring(self) -> bool:
        return bool(host_build.AIO.call("dstpu_aio_uses_uring", self._h))

    def pwrite(self, path: str, buf, file_offset: int = 0,
               direct: bool = False) -> None:
        addr, nbytes, whole = _buffer(buf)
        if direct:
            _check_direct(addr, nbytes, file_offset, whole)

        def do():
            rb_faults.io_seam("aio_write", path, file_offset)
            rc = host_build.AIO.call("dstpu_aio_pwrite", self._h,
                                     path.encode(), addr, nbytes,
                                     file_offset, int(direct))
            if rc != 0:
                raise OSError(errno.EIO, f"aio pwrite rc={rc}")
        retry_io(do, what="aio pwrite", path=path)

    def pread(self, path: str, out, file_offset: int = 0,
              direct: bool = False):
        """Fill ``out`` (an array or tensor) from the file; returns it."""
        addr, nbytes, whole = _buffer(out)
        if direct:
            _check_direct(addr, nbytes, file_offset, whole)

        def do():
            rb_faults.io_seam("aio_read", path, file_offset)
            rc = host_build.AIO.call("dstpu_aio_pread", self._h,
                                     path.encode(), addr, nbytes,
                                     file_offset, int(direct))
            if rc != 0:
                raise OSError(errno.EIO, f"aio pread rc={rc}")
            return out
        return retry_io(do, what="aio pread", path=path)

    def close(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            host_build.AIO.call("dstpu_aio_close", h)
        self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def uses_io_uring(aio_cfg=None) -> Optional[bool]:
    """Whether a handle opened here takes the io_uring path."""
    h = AIOHandle.from_config(aio_cfg)
    try:
        return h.uses_io_uring
    finally:
        h.close()
