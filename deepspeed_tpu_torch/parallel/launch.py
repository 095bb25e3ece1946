"""Run one function on every rank of a fresh process group.

    result = run_group(fn, 2, *args)   # fn(rank, world, *args) on 2 ranks

Spawns ``world`` processes (the ``spawn`` start method, which CUDA
needs), joins each to a ``torch.distributed`` group initialized from a
``file://`` store in a fresh temporary directory (no TCP port to race
for), calls ``fn(rank, world, *args)`` in each, and returns rank 0's
result. ``fn`` must be importable by name in a child (a module-level
function of a module whose top level imports nothing heavy: a spawned
child re-imports it). A rank that fails fails the call; the others are
stopped. The backend is gloo: it reduces CPU tensors and CUDA tensors
alike (staging the latter through the host), so two processes can share
one card, where NCCL refuses two ranks on one device.
"""

import datetime
import os
import pickle
import shutil
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _entry(rank, fn, world, init_file, out_file, timeout_s, threads, args):
    if threads:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(rank, world, *args)
        if rank == 0:
            with open(out_file, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_group(fn, world: int, *args, timeout_s: float = 600.0,
              threads: int = 0):
    """``fn(rank, world, *args)`` on ``world`` spawned ranks; returns rank
    0's return value. ``threads`` > 0 caps each rank's torch CPU
    threads (ranks sharing a host's cores)."""
    tmp = tempfile.mkdtemp(prefix="dstpu_group_")
    try:
        init_file = os.path.join(tmp, "init")
        out_file = os.path.join(tmp, "rank0.pkl")
        mp.spawn(_entry, args=(fn, world, init_file, out_file, timeout_s,
                               threads, args),
                 nprocs=world, join=True)
        with open(out_file, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
