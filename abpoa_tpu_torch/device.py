"""Device resolution: the port's entry points run on the card unless
the caller asks for the CPU, and never fall back to the CPU when a GPU
was asked for."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``"cpu"``, ``"cuda"``, ``"cuda:N"`` or a ``torch.device`` -> a
    ``torch.device``. Asking for CUDA on a host without a usable GPU
    raises ``RuntimeError``."""
    if device is None:
        raise ValueError("a device is required (\"cpu\" or \"cuda\")")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device!r} requested but only "
                               f"{torch.cuda.device_count()} GPU(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev
