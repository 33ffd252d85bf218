"""The one place the port chooses its device."""

from __future__ import annotations

import torch

from .parallel import dist


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` or ``"cpu"`` as a :class:`torch.device`.  Asking for
    ``cuda`` where no CUDA device is available raises; there is no
    automatic choice.  In a multi-process run (``parallel/dist.py``,
    once joined) rank r takes ``cuda:{r % device count}``, so ranks
    share a card where there are fewer cards than ranks."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda was asked for, but torch sees no CUDA device")
        if not dist.is_initialized():
            return torch.device("cuda")
        dev = torch.device("cuda", dist.rank_world()[0] % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        return dev
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r} (expected 'cuda' or 'cpu')")

