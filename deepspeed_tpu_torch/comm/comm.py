"""Communication facade, a port of ``deepspeed_tpu/comm/comm.py``:
``init_distributed``, the world queries, ``barrier``, and the collectives
``all_reduce`` / ``all_gather`` / ``reduce_scatter`` / ``broadcast`` /
``ppermute`` by mesh **axis name**, and the ``CommsLogger``.

JAX's collectives take an axis name and lower to XLA collectives over
that axis of the mesh. Here the name picks the ``torch.distributed``
subgroup of that axis from the ambient mesh (``parallel/context``, which
the engines publish around their steps; ``mesh=`` overrides it): an axis
of size 1 is no call at all, and a tuple of axes runs one call per axis
(major axis first for a scatter, minor first for a gather, so the pieces
land in JAX's row-major order over the tuple). Every collective of the
port goes through here: the model's tensor- and expert-axis reductions
(``parallel/context.all_reduce`` when serving; its autograd collectives,
``copy_to_tensor`` and the rest, in training), ZeRO's gradient
reductions and parameter gathers, the 1-bit optimizers' wire, and the
point-to-point exchanges of the pipeline (activations down the ``pipe``
axis, their grads back up) and of ring attention (K/V shards around the
``seq`` axis).

Each call adds to a plain count of calls and bytes (the input's bytes;
for ``ppermute`` the bytes this rank sends) for its (op, axis), so a
test can check the schedule (``counts`` / ``reset_counts``), and records
the same into ``comms_logger`` when it is enabled (the ``comms_logger``
config section, JAX's ``CommsLogger``: per ``op[axis]`` calls and bytes,
``summary`` and ``log_summary``). JAX records at trace time, once a
compiled site; the eager port records every call.

gloo takes CUDA tensors for every collective used here (torch 2.11 on an
H100 and the CPU build alike): two ranks can share one card over gloo,
where NCCL refuses two ranks on one device. It refuses ``send`` /
``recv`` of a CUDA tensor, so ``ppermute`` over gloo on a CUDA machine
broadcasts over a two-rank group per pair instead (the mesh's ``p2p``
transport, chosen when it is built: ``parallel/mesh.py``).
``all_gather`` and ``reduce_scatter`` use ``all_gather_into_tensor`` /
``reduce_scatter_tensor``, the names both versions have. A collective
that fails raises; nothing is staged or retried quietly.
"""

import collections
import datetime
import logging
import os
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from deepspeed_tpu_torch.parallel import context as _ctx

Axis = Union[str, Sequence[str]]

# torch's CPU builds from 2.12 warn that the two names are deprecated for
# ``*_single`` ones, which the card's torch 2.11 lacks
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r".*(all_gather_into_tensor|reduce_scatter_tensor)` is "
            r"deprecated")

logger = logging.getLogger("deepspeed_tpu_torch")

_LOCK = threading.Lock()
_COUNTS: Dict[tuple, list] = collections.defaultdict(lambda: [0, 0])


# --------------------------------------------------------------------------
# comms logger (JAX's ``CommsLogger``, ``deepspeed_tpu/comm/comm.py:44``)
# --------------------------------------------------------------------------

class CommsLogger:
    """Records collective calls: op name, axis, bytes, per ``op[axis]``
    key, as JAX's. ``record_host`` adds wall-clock for host-blocking
    comm (``barrier``). Off until ``configure(enabled=True)``."""

    def __init__(self):
        self.enabled = False
        self.verbose = False
        self.prof_ops = set()
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.counts = collections.defaultdict(int)
            self.bytes = collections.defaultdict(int)
            self.host_ms = collections.defaultdict(float)

    def configure(self, enabled=True, verbose=False, prof_ops=()):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_ops = set(prof_ops or ())

    def record(self, op: str, axis, nbytes: int):
        if not self.enabled:
            return
        if self.prof_ops and op not in self.prof_ops:
            return
        key = f"{op}[{axis}]"
        with self._lock:
            self.counts[key] += 1
            self.bytes[key] += nbytes
        if self.verbose:
            logger.info(f"comm: {key} msg_size={nbytes}")

    def record_host(self, op: str, ms: float):
        if self.enabled:
            with self._lock:
                self.host_ms[op] += ms

    def summary(self) -> str:
        with self._lock:
            counts = dict(self.counts)
            nbytes = dict(self.bytes)
            host = dict(self.host_ms)
        lines = ["comm op                          count      total MB"]
        for key in sorted(counts):
            lines.append(f"{key:<32} {counts[key]:>6} "
                         f"{nbytes[key] / 1e6:>12.2f}")
        for key in sorted(host):
            lines.append(f"{key:<32} host_ms={host[key]:.1f}")
        return "\n".join(lines)

    def events(self, step: int) -> List[Tuple[str, float, int]]:
        """Monitor-ready ``(name, value, step)`` triples of the running
        totals: ``comm/<op>[axis]/{count,bytes}`` and
        ``comm/host_ms/<op>``."""
        with self._lock:
            counts = dict(self.counts)
            nbytes = dict(self.bytes)
            host = dict(self.host_ms)
        out = []
        for key in sorted(counts):
            out.append((f"comm/{key}/count", float(counts[key]), step))
            out.append((f"comm/{key}/bytes", float(nbytes[key]), step))
        for op in sorted(host):
            out.append((f"comm/host_ms/{op}", float(host[op]), step))
        return out


comms_logger = CommsLogger()


def configure(enabled: bool = True, verbose: bool = False,
              prof_ops=()) -> None:
    """Switch ``comms_logger`` on (or off), as the engine does from the
    ``comms_logger`` config section."""
    comms_logger.configure(enabled=enabled, verbose=verbose,
                           prof_ops=prof_ops)


def log_summary(monitor=None, step: Optional[int] = None,
                engine=None) -> str:
    """JAX's ``log_summary``: the logger's summary, logged and returned;
    with an enabled ``monitor`` its totals also go out as events
    (``monitor.write_events``) at ``step`` (``engine.global_steps`` when
    an ``engine`` is given; 0 with a warning otherwise). JAX's ``engine=``
    also reports the collective census XLA's partitioner inserted into
    the compiled step, read from its HLO; an eager step has no compiled
    program to read, and every collective of the port goes through this
    facade and is in the summary already, so no census is reported."""
    msg = comms_logger.summary()
    if engine is not None and step is None:
        step = getattr(engine, "global_steps", None)
    logger.info("\n" + msg)
    if monitor is not None and getattr(monitor, "enabled", False):
        if step is None:
            logger.warning("comm.log_summary(monitor=...) without step= — "
                           "events land on step 0")
            step = 0
        monitor.write_events(comms_logger.events(step))
    return msg


def _record(op: str, axis: str, x: Optional[torch.Tensor],
            nbytes: Optional[int] = None) -> None:
    if nbytes is None:
        nbytes = x.numel() * x.element_size()
    with _LOCK:
        c = _COUNTS[(op, axis)]
        c[0] += 1
        c[1] += nbytes
    comms_logger.record(op, axis, nbytes)


def reset_counts() -> None:
    with _LOCK:
        _COUNTS.clear()


def counts() -> Dict[str, Dict[str, Dict[str, int]]]:
    """{op: {axis: {"calls": n, "bytes": b}}} since the last reset."""
    out: Dict[str, Dict[str, Dict[str, int]]] = {}
    with _LOCK:
        for (op, axis), (n, b) in sorted(_COUNTS.items()):
            out.setdefault(op, {})[axis] = {"calls": n, "bytes": b}
    return out


# --------------------------------------------------------------------------
# init and world queries
# --------------------------------------------------------------------------

def init_distributed(dist_backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: int = 300) -> None:
    """Join the default process group, once. Explicit arguments first,
    then the reference's env (``RANK`` / ``WORLD_SIZE`` with
    ``MASTER_ADDR`` / ``MASTER_PORT``: ``env://``). A single process
    (no world size, or 1) needs nothing. The backend defaults to nccl
    with CUDA (one rank a card) and gloo without; pass "gloo" to share
    one card between ranks."""
    if dist.is_initialized():
        return
    env = os.environ
    if world_size is None and env.get("WORLD_SIZE"):
        world_size = int(env["WORLD_SIZE"])
    if rank is None and env.get("RANK"):
        rank = int(env["RANK"])
    if not world_size or world_size <= 1:
        return
    if init_method is None:
        if not env.get("MASTER_ADDR"):
            raise ValueError(
                f"init_distributed: world size {world_size} needs an "
                "init_method (tcp://host:port or file://path) or "
                "MASTER_ADDR / MASTER_PORT")
        init_method = "env://"
    backend = dist_backend or ("nccl" if torch.cuda.is_available()
                               else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def barrier() -> None:
    if is_initialized() and dist.get_world_size() > 1:
        t0 = time.perf_counter()
        _record("barrier", "world", torch.zeros(()))
        dist.barrier()
        comms_logger.record_host("barrier",
                                 (time.perf_counter() - t0) * 1e3)


# --------------------------------------------------------------------------
# collectives by axis name
# --------------------------------------------------------------------------

def _axes(axis: Axis):
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _group(a: str, mesh):
    """(group, size) of this rank's ``a`` axis; (None, 1) without one."""
    mesh = mesh if mesh is not None else _ctx.current_mesh()
    if mesh is None or mesh.size(a) == 1:
        return None, 1
    return mesh.axis_group(a), mesh.size(a)


def all_reduce(x: torch.Tensor, axis: Axis, op: str = "sum",
               mesh=None) -> torch.Tensor:
    """Reduce ``x`` in place over ``axis`` ("sum", "max" or "mean": the
    sum times 1 / size) and return it."""
    reduce_op = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
                 "max": dist.ReduceOp.MAX}[op]
    n = 1
    for a in _axes(axis):
        group, size = _group(a, mesh)
        if group is None:
            continue
        _record("all_reduce" if op != "max" else "all_reduce_max", a, x)
        dist.all_reduce(x, op=reduce_op, group=group)
        n *= size
    if op == "mean" and n > 1:
        x.mul_(1.0 / n)
    return x


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0,
               mesh=None) -> torch.Tensor:
    """The pieces of ``x`` of every rank along ``axis`` concatenated along
    ``dim`` in coordinate order (JAX's tiled ``all_gather``); ``x``
    itself when the axis has size 1."""
    for a in reversed(_axes(axis)):
        group, size = _group(a, mesh)
        if group is None:
            continue
        _record("all_gather", a, x)
        y = x.movedim(dim, 0).contiguous()
        out = y.new_empty((size * y.shape[0],) + y.shape[1:])
        dist.all_gather_into_tensor(out, y, group=group)
        x = out.movedim(0, dim)
    return x.contiguous()


def reduce_scatter(x: torch.Tensor, axis: Axis, dim: int = 0,
                   mesh=None) -> torch.Tensor:
    """The sum of ``x`` over ``axis``, cut along ``dim`` in size pieces:
    this rank's piece (JAX's tiled ``psum_scatter``). ``dim`` must split
    evenly."""
    for a in _axes(axis):
        group, size = _group(a, mesh)
        if group is None:
            continue
        if x.shape[dim] % size:
            raise ValueError(f"reduce_scatter over {a} (size {size}): dim "
                             f"{dim} of shape {tuple(x.shape)} does not "
                             "split evenly")
        _record("reduce_scatter", a, x)
        y = x.movedim(dim, 0).contiguous()
        out = y.new_empty((y.shape[0] // size,) + y.shape[1:])
        dist.reduce_scatter_tensor(out, y, group=group)
        x = out.movedim(0, dim)
    return x.contiguous()


def broadcast(x: torch.Tensor, axis: Axis, src_index: int = 0,
              mesh=None) -> torch.Tensor:
    """``x`` of the rank at coordinate ``src_index`` along ``axis``, in
    place on every rank of it."""
    for a in _axes(axis):
        group, _ = _group(a, mesh)
        if group is None:
            continue
        _record("broadcast", a, x)
        src = dist.get_global_rank(group, src_index) \
            if group is not dist.group.WORLD else src_index
        dist.broadcast(x, src, group=group)
    return x


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[Tuple[int, int]],
             mesh=None) -> torch.Tensor:
    """JAX's ``ppermute``: for each (src, dst) pair of ``perm``
    (coordinates along ``axis``), the rank at ``src`` sends its ``x`` to
    the rank at ``dst``. Returns what this rank received: a new tensor of
    ``x``'s shape and dtype, zeros where no pair sends to it (``x``
    itself is never modified). Every rank of the axis group calls it with
    the same ``perm``; a rank that only receives passes any tensor of the
    right shape and dtype. The pairs run in ``perm``'s order over the
    mesh's transport (``parallel/mesh.py``: one ``batch_isend_irecv``,
    or a broadcast over each pair's two-rank group)."""
    mesh = mesh if mesh is not None else _ctx.current_mesh()
    out = torch.zeros_like(x)
    if mesh is None or mesh.size(axis) == 1:
        if (0, 0) in perm:
            out.copy_(x)
        return out
    me = mesh.index(axis)
    sends = [d for s, d in perm if s == me]
    _record("ppermute", axis, x, len(sends) * x.numel() * x.element_size())
    members = mesh.axis_ranks(axis)
    if mesh.p2p == "pairs":
        for s, d in perm:
            if me not in (s, d):
                continue
            if s == d:
                out.copy_(x)
                continue
            buf = x.contiguous().clone() if me == s else out
            dist.broadcast(buf, members[s], group=mesh.pair_group(axis, s, d))
        return out
    ops = []
    src = x.contiguous()
    for s, d in perm:
        if s == d == me:
            out.copy_(x)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, src, members[d]))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, members[s]))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out
