"""Communication facade, a port of ``deepspeed_tpu/comm/comm.py``:
``init_distributed``, the world queries, ``barrier``, and the collectives
``all_reduce`` / ``all_gather`` / ``reduce_scatter`` / ``broadcast`` by
mesh **axis name**.

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
reductions and parameter gathers, and the 1-bit optimizers' wire.

Each call adds to a plain count of calls and bytes (the input's bytes)
for its (op, axis), so a test can check the schedule
(``counts`` / ``reset_counts``). JAX's ``CommsLogger`` (timing, summaries,
the ``comms_logger`` config) is ROADMAP A9.

gloo takes CUDA tensors for every collective used here (torch 2.11 on an
H100 and the CPU build alike): two ranks can share one card over gloo,
where NCCL refuses two ranks on one device. ``all_gather`` and
``reduce_scatter`` use ``all_gather_into_tensor`` /
``reduce_scatter_tensor``, the names both versions have. A collective
that fails raises; nothing is staged or retried quietly.
"""

import collections
import datetime
import os
import threading
import warnings
from typing import Dict, Optional, Sequence, Union

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

_LOCK = threading.Lock()
_COUNTS: Dict[tuple, list] = collections.defaultdict(lambda: [0, 0])


def _record(op: str, axis: str, x: torch.Tensor) -> None:
    with _LOCK:
        c = _COUNTS[(op, axis)]
        c[0] += 1
        c[1] += x.numel() * x.element_size()


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
        _record("barrier", "world", torch.zeros(()))
        dist.barrier()


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
