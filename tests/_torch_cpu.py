"""CPU threads of the port's tests.

Under pytest-xdist each worker process runs torch's CPU kernels with as
many intra-op threads as the machine has cores, so ``-n 6`` on 8 cores
runs 48 spinning threads on 8 cores, and the small ops of a hidden-64
model wait on each other (a forward of the tiny MoE took 0.19 s at 8
threads under that load, 0.007 s at 1). Each port test module imports
this one: inside an xdist worker it gives torch ``cores // workers``
threads (at least 1); a run without xdist keeps torch's default.
"""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
if _WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
