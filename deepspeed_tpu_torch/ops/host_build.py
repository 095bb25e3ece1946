"""Build and load the port's host C++: the fused CPU-Adam and CPU-Adagrad
steps and the async file IO of the offload tiers
(``csrc/host/dstpu_cpu_adam.cpp``, ``dstpu_cpu_adagrad.cpp``,
``dstpu_aio.cpp``; the port's own copies of the JAX package's host
sources, built with the same flags).

Each library is built at first use with ``g++`` into the port's build
directory (``ops/_build.BUILD_DIR``, gitignored), named by a hash of its
source, its flags and the host's CPU (``-march=native`` builds for the
CPU it runs on), so an edited source or another CPU rebuilds and an
unchanged one is reused. The compiler writes to a name of its own
process and the result is moved into place with ``os.replace``: test
workers that build at once never see half a library. A build that fails raises; there is no
fallback to plain Python.

Every C entry point is called through ``HostLibrary.call``, which adds
one to that entry point's count (``calls``), as ``_build.Kernel.launches``
counts a kernel's launches: a run can show that its host code ran.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

from deepspeed_tpu_torch.ops import _build

HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
CXX = "g++"
OPT_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]
AIO_FLAGS = ["-O2", "-shared", "-fPIC", "-pthread"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_F = ctypes.c_float
_INT = ctypes.c_int


def _cpu_key() -> bytes:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for), from /proc/cpuinfo where there is one."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        return b""


class HostLibrary:
    """One host source: its flags, its entry points' signatures
    ({name: (argtypes, restype)}), the loaded library and a call count
    per entry point."""

    def __init__(self, name: str, flags: List[str],
                 signatures: Dict[str, tuple]):
        self.name = name
        self.source = HOST_SRC / f"{name}.cpp"
        self.flags = list(flags)
        self.signatures = signatures
        self.calls = {fn: 0 for fn in signatures}
        self._lib = None
        self._count_lock = threading.Lock()     # IO threads call at once

    def library_path(self) -> Path:
        h = hashlib.sha1(self.source.read_bytes()
                         + " ".join([CXX] + self.flags).encode()
                         + _cpu_key()).hexdigest()
        return Path(_build.BUILD_DIR) / f"lib{self.name}-{h[:12]}.so"

    def build(self, force: bool = False) -> Path:
        """Compile into the build directory (unless already there);
        returns the library's path. Raises if the compiler fails."""
        out = self.library_path()
        if out.exists() and not force:
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
        cmd = [CXX] + self.flags + ["-o", str(tmp), str(self.source)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"host library {self.name}: {' '.join(cmd)} "
                               f"failed to run: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"host library {self.name}: {' '.join(cmd)} "
                               f"exited {proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, out)
        return out

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for fn, (argtypes, restype) in self.signatures.items():
                f = getattr(lib, fn)
                f.argtypes, f.restype = argtypes, restype
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args):
        """Call entry point ``fn`` and count it."""
        out = getattr(self.lib(), fn)(*args)
        with self._count_lock:
            self.calls[fn] += 1
        return out


_ADAM_ARGS = [_P, _P, _P, _P, _P, _I64, _F, _F, _F, _F, _F, _INT, _F, _F, _F]
CPU_ADAM = HostLibrary("dstpu_cpu_adam", OPT_FLAGS, {
    "dstpu_adam_step_bf16": (_ADAM_ARGS, None),
    "dstpu_adam_step_f32": (_ADAM_ARGS, None),
    "dstpu_sq_norm_bf16": ([_P, _I64], ctypes.c_double),
    "dstpu_sq_norm_f32": ([_P, _I64], ctypes.c_double)})
_ADAGRAD_ARGS = [_P, _P, _P, _P, _I64, _F, _F, _F, _F]
CPU_ADAGRAD = HostLibrary("dstpu_cpu_adagrad", OPT_FLAGS, {
    "dstpu_adagrad_step_bf16": (_ADAGRAD_ARGS, None),
    "dstpu_adagrad_step_f32": (_ADAGRAD_ARGS, None)})
_IO_ARGS = [_P, ctypes.c_char_p, _P, _I64, _I64, _INT]
AIO = HostLibrary("dstpu_aio", AIO_FLAGS, {
    "dstpu_aio_open": ([ctypes.c_uint, ctypes.c_uint, _INT], _P),
    "dstpu_aio_close": ([_P], None),
    "dstpu_aio_uses_uring": ([_P], _INT),
    "dstpu_aio_pread": (_IO_ARGS, _INT),
    "dstpu_aio_pwrite": (_IO_ARGS, _INT),
    "dstpu_aio_alloc": ([_I64], _P),
    "dstpu_aio_free": ([_P], None)})
LIBRARIES: Dict[str, HostLibrary] = {
    lib.name: lib for lib in (CPU_ADAM, CPU_ADAGRAD, AIO)}


def build_all(force: bool = False) -> Dict[str, Path]:
    """Every host library, built (or found) now."""
    return {name: lib.build(force) for name, lib in LIBRARIES.items()}


def reset_call_counts() -> None:
    for lib in LIBRARIES.values():
        lib.calls = {fn: 0 for fn in lib.signatures}


def call_counts(name: Optional[str] = None) -> Dict[str, int]:
    """{entry point: calls} of one library, or of all of them."""
    libs = [LIBRARIES[name]] if name else LIBRARIES.values()
    return {fn: n for lib in libs for fn, n in lib.calls.items()}
