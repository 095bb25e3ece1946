"""The single-controller seam of sharded serving.

Rank 0 of a serving mesh owns all host state (scheduler, allocator,
prefix cache, deadlines, watchdog, drains, adapters), as JAX keeps one
host state over its mesh: ranks that decided for themselves would read
different wall clocks and part ways in the next collective. Every device
call therefore goes through one seam: rank 0 ``send``s an op code, a few
host ints and the call's tensors (two ``broadcast``s: a fixed-size int64
header, then the tensors' bytes in one buffer), and the other ranks
``recv`` it and make the same call on their shards. Tokens rank 0 sampled
travel in the next call's tensors. All buffers live on the engine's
device, so the seam runs on gloo (which stages through the host itself)
and on NCCL alike; it never moves a tensor to the host to make a
collective work.
"""

from typing import List, Sequence, Tuple

import torch
import torch.distributed as dist

HEADER = 256                         # int64 entries
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int64,
           torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool)


class DeviceSeam:
    """Broadcasts device calls from a mesh's rank 0 (``mesh.src``) to the
    whole mesh group."""

    def __init__(self, mesh, device: torch.device):
        self.group = (mesh.group if mesh.group is not None
                      else dist.group.WORLD)
        self.src = mesh.src
        self.device = device

    def send(self, op: int, ints: Sequence[int] = (),
             tensors: Sequence[torch.Tensor] = ()) -> None:
        hdr = [int(op), len(ints), *[int(i) for i in ints], len(tensors)]
        for t in tensors:
            hdr += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
        if len(hdr) > HEADER:
            raise ValueError(f"seam op {op}: header of {len(hdr)} entries "
                             f"exceeds {HEADER}")
        head = torch.tensor(hdr + [0] * (HEADER - len(hdr)),
                            dtype=torch.int64, device=self.device)
        dist.broadcast(head, self.src, group=self.group)
        if tensors:
            buf = torch.cat([t.to(self.device).contiguous().reshape(-1)
                             .view(torch.uint8) for t in tensors])
            dist.broadcast(buf, self.src, group=self.group)

    def recv(self) -> Tuple[int, List[int], List[torch.Tensor]]:
        head = torch.empty((HEADER,), dtype=torch.int64, device=self.device)
        dist.broadcast(head, self.src, group=self.group)
        h = head.tolist()
        op, n = h[0], h[1]
        ints, at = h[2:2 + n], 2 + n
        specs = []
        for _ in range(h[at]):
            dtype, ndim = _DTYPES[h[at + 1]], h[at + 2]
            specs.append((dtype, tuple(h[at + 3:at + 3 + ndim])))
            at += 2 + ndim
        tensors: List[torch.Tensor] = []
        if specs:
            sizes = [torch.Size(s).numel() * d.itemsize for d, s in specs]
            buf = torch.empty((sum(sizes),), dtype=torch.uint8,
                              device=self.device)
            dist.broadcast(buf, self.src, group=self.group)
            off = 0
            for (dtype, shape), size in zip(specs, sizes):
                # a clone starts its own (aligned) storage for the view
                tensors.append(buf[off:off + size].clone().view(dtype)
                               .reshape(shape))
                off += size
        return op, ints, tensors
