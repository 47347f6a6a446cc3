"""Default-device resolution for the port's entry points.

Entry points (``core.compile``'s ``torch_device=``, ``serve.Deployment``'s
``devices=``) run on the card unless the caller names the CPU. Without a
card and without an explicit device they raise: the port never drops to
the CPU on its own, so a number measured by a run always names the
device it came from.
"""
from __future__ import annotations

import torch

_NO_CUDA = ("no CUDA device is available; pass a CPU device explicitly "
            "(compile(..., torch_device='cpu'), Deployment(acc, "
            "devices=['cpu'])) to run the port's plain PyTorch versions")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda:0``, which
    raises ``RuntimeError`` when CUDA is absent."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(_NO_CUDA)
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    return dev


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises ``RuntimeError`` when none is."""
    if not torch.cuda.is_available():
        raise RuntimeError(_NO_CUDA)
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
