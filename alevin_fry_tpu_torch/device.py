"""The one place the port chooses its device."""

from __future__ import annotations

import os

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


def refuse_device_mesh(mesh_var: str) -> None:
    """Raise NotImplementedError where ``mesh_var`` (``AFT_GPL_MESH``,
    ``AFT_EM_MESH``) asks, the reference's way, for an in-process device
    mesh, which is not ported."""
    if os.environ.get(mesh_var, "").strip().lower() not in ("", "0", "none", "off"):
        raise NotImplementedError(f"{mesh_var} asks for a device mesh, which is not ported yet")
