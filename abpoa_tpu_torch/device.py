"""Device resolution and the DP planes' memory budget: the port's entry
points run on the card unless the caller asks for the CPU, and never
fall back to the CPU when a GPU was asked for."""
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


# share of the device's free memory that one launch's DP planes may take;
# the plain versions on the CPU get a fixed allowance instead
PLANE_BUDGET_SHARE = 0.5
CPU_PLANE_BUDGET = 4 << 30


def plane_budget(dev, in_flight: int = 1) -> int:
    """Bytes one DP launch's planes may take on `dev` when `in_flight`
    launches share the card (shards of one batch on one card each take
    their part of the share). The CPU runs one launch at a time. The
    serial engine and ``BatchPOA`` both hold their launches to it."""
    if dev.type == "cuda":
        free, _total = torch.cuda.mem_get_info(dev)
        return int(free * PLANE_BUDGET_SHARE / in_flight)
    return CPU_PLANE_BUDGET
