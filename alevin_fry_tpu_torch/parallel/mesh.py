"""Device meshes of one process (port of ``alevin_fry_tpu/parallel/mesh.py``).

The reference's mesh is the devices of one JAX process (``make_mesh``
over ``jax.devices()``); its programs are ``shard_map`` bodies whose
collectives run between the chips.  Here a :class:`Mesh` is a tuple of
``torch.device`` shards that one process drives from one host thread,
one shard after the other: launches are asynchronous, so the shards'
work overlaps on their cards all the same.  Shard ``s`` lies on
``cuda:{s % device count}``, so several shards may share a card (as the
reference's tests put 8 virtual devices on one CPU); on the CPU every
shard is the CPU.

The stages call three programs on a mesh: gpl's barcode histogram
(:func:`sharded_histogram`), ATAC gpl's genomic-bin histogram
(:func:`sharded_bin_histogram`), both under ``AFT_GPL_MESH``, and the
EM (``ops/em.py::em_cells(mesh=...)``, under ``AFT_EM_MESH``).  The one
collective, a psum, sums the shards' integer partials on shard 0 in
shard order, so the sum is exact in any order; each partial is a copy
between the shards' cards: ``Tensor.to`` is a peer copy over NVLink
where two shards' cards differ and a copy on the card where they are
the same.

``MOVED_BYTES`` counts the bytes the collectives move from one shard to
another: what NVLink carries where each shard has a card of its own
(between two shards of one card the same copy stays on the card).

The kernels' entry points launch on the current card, and the wrappers
(``ops/``) enter their tensors' card, so a shard's kernels run on its
card whichever card is current.  NCCL is not used: it takes one process
per card and refuses two ranks on one card, so it could not lay two
shards on one card.  A multi-process run (``parallel/dist.py``) never
takes a mesh (:func:`mesh_from_env`), as the reference's gpl refuses one
there.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dist

# bytes the collectives moved from one shard to another since the
# process started
MOVED_BYTES = 0

_SIGN = np.uint64(1 << 63)
# the EM's shard count is a power of two of at most this (the
# reference's batch ladder shards evenly; the port keeps its reading)
EM_MAX_SHARDS = 64


@dataclass(frozen=True)
class Mesh:
    """The shards of a one-process mesh, each a ``torch.device``."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def _cards(device: torch.device) -> int:
    """Cards of ``device``'s kind this process sees (the CPU is one)."""
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on cuda was asked for, but torch sees no CUDA device")
        return torch.cuda.device_count()
    if device.type == "cpu":
        return 1
    raise ValueError(f"no mesh on {device}")


def make_mesh(n: Optional[int] = None, device="cuda") -> Mesh:
    """``n`` shards (one per card when None), shard ``s`` on
    ``cuda:{s % device count}``, or all on the CPU for ``device`` cpu."""
    device = torch.device(device)
    cards = _cards(device)
    n = cards if n is None else int(n)
    if n < 1:
        raise ValueError("a mesh has at least one shard")
    if device.type == "cpu":
        return Mesh((device,) * n)
    return Mesh(tuple(torch.device("cuda", s % cards) for s in range(n)))


def mesh_from_env(var: str, device) -> Optional[Mesh]:
    """The mesh ``var`` (``AFT_GPL_MESH`` or ``AFT_EM_MESH``) asks for on
    ``device``, the reference's reading: unset is ``auto`` on a card and
    no mesh on the CPU; ``0``, ``none`` or ``off`` no mesh; ``auto`` one
    shard per card; an integer that many shards, which is not clamped to
    the card count (shards share cards).  The EM's count is the largest
    power of two within ``min(request, 64)``.  Fewer than 2 shards, or a
    multi-process run, is no mesh."""
    device = torch.device(device)
    spec = os.environ.get(var, "").strip().lower()
    if spec == "":
        spec = "auto" if device.type == "cuda" else "0"
    if spec in ("0", "none", "off"):
        return None
    if dist.is_initialized() and dist.rank_world()[1] > 1:
        return None
    want = _cards(device) if spec == "auto" else max(1, int(spec))
    n = want
    if var == "AFT_EM_MESH":
        n = 1
        while n * 2 <= min(want, EM_MAX_SHARDS):
            n *= 2
    return make_mesh(n, device) if n >= 2 else None


def _even(n: int, n_shards: int) -> List[int]:
    """Cut points of ``n`` rows split evenly over the shards."""
    return [n * s // n_shards for s in range(n_shards + 1)]


def _moved(t: torch.Tensor, src: torch.device, dst: torch.device) -> torch.Tensor:
    """``t`` (on shard ``src``) copied to shard ``dst``, counted."""
    global MOVED_BYTES
    MOVED_BYTES += t.numel() * t.element_size()
    return t.to(dst, non_blocking=True)


def _psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' integer partials (one a shard, on its device) summed
    on shard 0 in shard order."""
    root = mesh.devices[0]
    total = parts[0].to(root)
    for dev, p in zip(mesh.devices[1:], parts[1:]):
        total = total + _moved(p, dev, root)
    return total


def _replicated(mesh: Mesh, a: np.ndarray) -> dict:
    """``a`` on every card of the mesh, one copy a card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return {dev: t.to(dev) for dev in dict.fromkeys(mesh.devices)}


def _signed_order(codes: np.ndarray) -> np.ndarray:
    """uint64 codes as int64 words whose signed order is the codes'
    unsigned order (bit 63 flipped): barcodes of 32 bases use it."""
    return (np.ascontiguousarray(codes, np.uint64) ^ _SIGN).view(np.int64)


def sharded_histogram(mesh: Mesh, bcs: np.ndarray, wl_sorted: np.ndarray):
    """The barcode histogram against the sorted unique whitelist
    ``wl_sorted`` (uint64, replicated on every card): each shard
    searches its range of ``bcs`` and counts its hits, and the partial
    counts and unmatched counts go through a psum.  Returns (counts per
    whitelist entry, int64; the number of unmatched barcodes; the hit
    mask, bool)."""
    wl = _signed_order(wl_sorted)
    q = _signed_order(bcs)
    nw = len(wl)
    wl_on = _replicated(mesh, wl)
    cuts = _even(len(q), mesh.size)
    parts, hits = [], []
    for s, dev in enumerate(mesh.devices):
        b = torch.from_numpy(q[cuts[s]:cuts[s + 1]]).to(dev)
        w = wl_on[dev]
        if nw:
            idx = torch.searchsorted(w, b).clamp_(max=nw - 1)
            hit = w[idx] == b
            cnt = torch.bincount(idx[hit], minlength=nw)
        else:
            hit = torch.zeros(len(b), dtype=torch.bool, device=dev)
            cnt = torch.zeros(0, dtype=torch.int64, device=dev)
        parts.append(torch.cat([cnt, (~hit).sum().view(1)]))
        hits.append(hit)
    tot = _psum(mesh, parts).cpu().numpy()
    hit = np.concatenate([h.cpu().numpy() for h in hits]) if hits else np.zeros(0, bool)
    return tot[:nw], int(tot[nw]), hit


def sharded_bin_histogram(mesh: Mesh, idx: np.ndarray, n_bins: int) -> np.ndarray:
    """The genomic-bin histogram of the ATAC gpl (atac/cellfilter.rs:67-102):
    each shard counts its range of the bin indices (each in [0,
    ``n_bins``)), and a psum merges the partials.  Returns int64
    counts[n_bins]."""
    ix = np.ascontiguousarray(idx, np.int64)
    cuts = _even(len(ix), mesh.size)
    parts = []
    for s, dev in enumerate(mesh.devices):
        cnt = torch.bincount(torch.from_numpy(ix[cuts[s]:cuts[s + 1]]).to(dev),
                             minlength=n_bins)
        if len(cnt) != n_bins:
            raise ValueError(f"a bin index lies past the {n_bins} bins")
        parts.append(cnt)
    return _psum(mesh, parts).cpu().numpy()
