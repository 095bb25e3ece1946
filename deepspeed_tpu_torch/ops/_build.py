"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into a shared
library, loaded with ``ctypes`` (no PyTorch headers: a build takes seconds,
not minutes). Libraries are named by a hash of their source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header
rebuilds and an unchanged one is reused. All missing
libraries build at once, one ``nvcc`` process per source.

Every kernel has a ``Kernel`` handle with a ``launches`` counter: a
wrapper adds one to it where it launches the kernel and nowhere else, so a
run can show that its main path went through the kernel.

Nothing here runs at import time: the CPU tests import every module on
machines that have no ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

from deepspeed_tpu_torch.robustness import events

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# inside the checkout, listed in .gitignore; overridable for read-only installs
BUILD_DIR = Path(os.environ.get("DSTPU_TORCH_BUILD_DIR", CSRC / "_build"))
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-lineinfo", "-shared",
                           "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class Kernel:
    """One CUDA source: its C entry point's signature, its loaded library
    and its launch count."""

    def __init__(self, name: str, argtypes: List):
        self.name = name
        self.argtypes = argtypes
        self.source = CSRC / f"{name}.cu"
        self.launches = 0
        self._fn = None

    def library_path(self) -> Path:
        headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
        h = hashlib.sha1(self.source.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{h}.so"

    def fn(self):
        """The C entry point, building the library on first use."""
        if self._fn is None:
            path = self.library_path()
            if not path.exists():
                build([self])
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point; a launch the card refused raises here."""
        rc = self.fn()(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {rc}")
        self.launches += 1


FLASH_FWD = Kernel("flash_fwd", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _F, _P])
# q, k_pool, v_pool, tables, lens, k_row, v_row, workspace, out; S, Nq,
# Nkv, D, bs, MB, piece rows, dtype, sm_scale, stream
PAGED_DECODE = Kernel("paged_decode", [_P] * 9 + [_I] * 8 + [_F, _P])
# q, k, v, o, dO, lse, delta, kv_mask, then the outputs; B, S, N, Nkv, D,
# dtype, causal, sm_scale, stream
FLASH_BWD_DQ = Kernel("flash_bwd_dq", [_P] * 9 + [_I] * 7 + [_F, _P])
FLASH_BWD_DKV = Kernel("flash_bwd_dkv", [_P] * 10 + [_I] * 7 + [_F, _P])
# block-sparse: q, k, v (dO, lse, delta), the adjacency tables, the work
# list's items and sums, its workspaces, then the outputs; B, S, N, D,
# block, table row stride, the item and sum counts, dtype, causal,
# sm_scale, stream
SPARSE_FWD = Kernel("sparse_fwd", [_P] * 11 + [_I] * 10 + [_F, _P])
SPARSE_BWD_DQ = Kernel("sparse_bwd_dq", [_P] * 12 + [_I] * 10 + [_F, _P])
SPARSE_BWD_DKV = Kernel("sparse_bwd_dkv", [_P] * 14 + [_I] * 10 + [_F, _P])
KERNELS: Dict[str, Kernel] = {k.name: k for k in (
    FLASH_FWD, PAGED_DECODE, FLASH_BWD_DQ, FLASH_BWD_DKV, SPARSE_FWD,
    SPARSE_BWD_DQ, SPARSE_BWD_DKV)}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/*.cu with the CUDA toolkit")


def nvcc_command(kernel: Kernel, out: Path, verbose: bool = False) -> List[str]:
    extra = ["-Xptxas", "-v"] if verbose else []
    return ([nvcc_path()] + NVCC_FLAGS + extra
            + ["-o", str(out), str(kernel.source)])


def build(kernels: Optional[List[Kernel]] = None, verbose: bool = False,
          force: bool = False) -> Dict[str, str]:
    """Compile the given kernels (default: all) whose library is missing,
    one nvcc process per source, all started together. Returns each
    kernel's compiler output (``verbose`` adds ptxas's register and
    shared-memory report). Raises with the compiler's output on failure."""
    kernels = list(KERNELS.values()) if kernels is None else kernels
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [k for k in kernels if force or not k.library_path().exists()]
    t0 = time.perf_counter()
    procs = []
    for k in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs.append((k, Path(tmp), subprocess.Popen(
            nvcc_command(k, Path(tmp), verbose), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    logs, failed = {}, []
    for k, tmp, p in procs:
        out, _ = p.communicate()
        logs[k.name] = out
        if p.returncode != 0:
            failed.append(f"{k.name}:\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            # atomic: a concurrent loader sees the whole library or none
            os.replace(tmp, k.library_path())
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    if todo:
        events.emit("kernels_built", kernels=[k.name for k in todo],
                    seconds=round(time.perf_counter() - t0, 3))
    return logs


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_handle(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as a pointer int."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
