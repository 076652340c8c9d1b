"""Device resolution for the port's entry points: CUDA unless asked otherwise,
never a silent fallback to the CPU."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the GPU: under a process group this rank's card,
    ``cuda:{WUT_LOCAL_RANK % device_count}``, or the CPU where the launcher
    put the ranks there (``WUT_DEVICE=cpu``, its ``--cpu``).  ``"cpu"`` (or
    any explicit device) is taken as given.  Raises when CUDA is requested
    but no GPU is present."""
    if device is not None:
        dev = torch.device(device)
    elif not (torch.distributed.is_available()
              and torch.distributed.is_initialized()):
        dev = torch.device("cuda")
    elif os.environ.get("WUT_DEVICE") == "cpu":
        dev = torch.device("cpu")
    elif not torch.cuda.is_available():
        dev = torch.device("cuda")
    else:
        local = int(os.environ.get("WUT_LOCAL_RANK", os.environ.get(
            "WUT_PROCESS_ID", torch.distributed.get_rank())))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev


def refused_allocations(device: DeviceLike = None) -> int:
    """Allocations the caching allocator has refused on a CUDA ``device`` so
    far (its ``num_ooms``); 0 on the CPU.  PyTorch's cuDNN convolutions
    catch a refused workspace and run the heuristics' next engine, which
    sums in another order: a float32 step during which this count moved is
    not the computation that a card with room for the workspaces makes
    (``PERF.md`` §6, fault F1), so a comparison that needs the same bits
    checks it before and after."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(dev).get("num_ooms", 0))
