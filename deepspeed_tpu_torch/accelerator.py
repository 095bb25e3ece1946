"""Device selection, PyTorch port of ``deepspeed_tpu/accelerator.py``.

The port runs on an NVIDIA GPU. ``device=None`` means ``"cuda"``; when CUDA
is missing that raises instead of carrying on on the CPU. The CPU is used
only when a caller asks for it by name (the tests do), and then every
kernel wrapper takes its plain PyTorch version.
"""

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: deepspeed_tpu_torch runs on an "
                "NVIDIA GPU. Pass device='cpu' to run the plain PyTorch "
                "versions of its kernels on the CPU.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: cuda or cpu")
    return dev


def device_kind(device: DeviceLike = None) -> str:
    """The card's name (``torch.cuda.get_device_name``), or "cpu"."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"
