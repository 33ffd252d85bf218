"""Connected components of the per-cell UMI graphs (PUGs) on kernel K7
(port of ``alevin_fry_tpu/ops/pug_device.py``).

The parsimony resolution joins a cell's (equivalence class, UMI) nodes
into weakly connected components before its greedy cover
(pugutils.rs:278-301).  The JAX package ran that step on the accelerator
as min-label propagation with pointer jumping over a padded (B, N, D)
neighbour tensor (``connected_components_batched`` :122) or as boolean
matrix squaring (``_dense_cc_run`` :72), with cells past its padding
ladder and any device failure sent to a host loop.  Here every cell runs
on the card in K7 (``csrc/pug_cc.cu``): one block per cell propagates
labels over the cell's CSR adjacency as ``csrc/radc.cpp``'s
``radc_pug_graph_export`` writes it, with no padding and no host route.

:func:`connected_components` takes (nodes per cell, a host array; degree
per node and cell-local neighbours, tensors) and returns, per node, the
smallest cell-local node index of its component (int32), with the rounds
each cell took.  It launches K7 for tensors on a CUDA device and takes the
plain PyTorch twin :func:`connected_components_twin` (the JAX package's
``_host_cc_labels`` loop, batched) for tensors on the CPU.  ``LAUNCHES``
counts K7's launches; ``STATS`` the cells it ran on the global-memory
route.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import _kernels

LAUNCHES = {"K7": 0}
STATS = {"global_cells": 0}


def upload_csr(n_nodes: np.ndarray, deg: np.ndarray, nbrs: np.ndarray,
               device: torch.device) -> Tuple[np.ndarray, torch.Tensor, torch.Tensor]:
    """The exported graphs as K7 takes them: the node counts as a host
    int64 array, the degrees (int64) and neighbours (int32) as tensors on
    ``device``."""
    return (np.ascontiguousarray(n_nodes, np.int64),
            *(torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
              for a, dt in ((deg, np.int64), (nbrs, np.int32))))


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    off = torch.zeros(len(counts) + 1, dtype=torch.int64, device=counts.device)
    torch.cumsum(counts, 0, out=off[1:])
    return off


def connected_components_twin(n_nodes: np.ndarray, deg: torch.Tensor,
                              nbrs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7's plain PyTorch version: every cell's min-label propagation at
    once (``_host_cc_labels``, pug.py:495-509): each node takes the
    smallest label over its neighbours, then its label's label, until no
    label moves.  Returns (label per node, int32 cell-local; rounds per
    cell, int32: the last round that moved one of its labels, plus the
    round that found none)."""
    dev = nbrs.device
    n = len(deg)
    n_nodes = torch.from_numpy(np.asarray(n_nodes, np.int64)).to(dev)
    node_off = _offsets(n_nodes)
    cell = torch.repeat_interleave(torch.arange(len(n_nodes), device=dev), n_nodes)
    base = node_off[:-1][cell]
    u = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    v = nbrs.long() + base[u]
    lab = torch.arange(n, device=dev)
    rounds = torch.where(n_nodes > 0, 1, 0).to(torch.int32)
    it = 0
    while True:
        it += 1
        new = lab.clone().scatter_reduce_(0, u, lab[v], reduce="amin")
        new = torch.minimum(new, new[new])
        moved = new != lab
        if not bool(moved.any()):
            return (lab - base).to(torch.int32), rounds
        rounds[cell[moved]] = it + 1
        lab = new


def connected_components(n_nodes: np.ndarray, deg: torch.Tensor,
                         nbrs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 on the tensors' CUDA device, or its twin for tensors on the CPU
    (module docstring)."""
    if nbrs.device.type == "cpu":
        return connected_components_twin(n_nodes, deg, nbrs)
    dev = nbrs.device
    counts = np.asarray(n_nodes)
    if counts.dtype != np.int64 or counts.ndim != 1 or int(counts.sum()) != len(deg):
        raise ValueError("K7 takes a 1-D int64 host array of node counts that sum to the "
                         "number of degrees")
    for t, dt in ((deg, torch.int64), (nbrs, torch.int32)):
        if t.device != dev or t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("K7 takes contiguous 1-D int64 degrees and int32 neighbours on "
                             "one CUDA device")
    lib = _kernels.load()
    node_off = _offsets(torch.from_numpy(counts).to(dev))
    adj_off = _offsets(deg)
    labels = torch.empty(len(deg), dtype=torch.int32, device=dev)
    rounds = torch.zeros(len(counts), dtype=torch.int32, device=dev)
    live = np.flatnonzero(counts > 0)
    need = 4 * counts[live]
    scratch_off = np.full(len(counts), -1, np.int64)
    groups = _kernels.launch_groups(need, int(lib.aft_smem_limit()))
    n_scratch = 0
    for cells, smem in groups:
        if smem < 0:
            scratch_off[live[cells]] = np.cumsum(counts[live[cells]]) - counts[live[cells]]
            n_scratch = int(counts[live[cells]].sum())
            STATS["global_cells"] += len(cells)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    soff = torch.from_numpy(scratch_off).to(dev)
    stream = _kernels.stream_of(labels)
    for cells, smem in groups:
        cl = torch.from_numpy(live[cells].astype(np.int32)).to(dev)
        _kernels.check(lib.aft_pug_cc(
            node_off.data_ptr(), adj_off.data_ptr(), nbrs.data_ptr(), cl.data_ptr(), len(cells),
            soff.data_ptr(), scratch.data_ptr(), max(smem, 0), labels.data_ptr(),
            rounds.data_ptr(), stream,
        ), "K7 aft_pug_cc")
        LAUNCHES["K7"] += 1
    return labels, rounds


def cc_labels(n_nodes: np.ndarray, deg: np.ndarray, nbrs: np.ndarray,
              device: torch.device) -> np.ndarray:
    """Component labels (cell-local smallest node index, int32) of every
    exported graph, computed on ``device``."""
    labels, _rounds = connected_components(*upload_csr(n_nodes, deg, nbrs, device))
    return labels.cpu().numpy()
