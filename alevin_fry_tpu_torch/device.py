"""The one place the port chooses its device."""

from __future__ import annotations

import os

import torch

# the reference's multi-host coordinator variables (parallel/dist.py)
_COORDINATOR_VARS = ("AFT_COORDINATOR", "JAX_COORDINATOR_ADDRESS")


def resolve_device(name: str) -> torch.device:
    """``"cuda"`` or ``"cpu"`` as a :class:`torch.device`.  Asking for
    ``cuda`` where no CUDA device is available raises; there is no
    automatic choice."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda was asked for, but torch sees no CUDA device")
        return torch.device("cuda")
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r} (expected 'cuda' or 'cpu')")


def refuse_multi_process(mesh_var: str | None = None) -> None:
    """The port runs one process on one device.  Raise
    NotImplementedError where the environment asks the reference's way
    for a multi-host run, or, through ``mesh_var``, for a device mesh."""
    for var in _COORDINATOR_VARS:
        if os.environ.get(var):
            raise NotImplementedError(f"{var} asks for a multi-host run, which is not ported yet")
    if mesh_var and os.environ.get(mesh_var, "").strip().lower() not in ("", "0", "none", "off"):
        raise NotImplementedError(f"{mesh_var} asks for a device mesh, which is not ported yet")
