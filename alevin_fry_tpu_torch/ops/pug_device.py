"""Connected components of the per-cell UMI graphs (PUGs) on kernel K7
(port of ``alevin_fry_tpu/ops/pug_device.py``).

The parsimony resolution joins a cell's (equivalence class, UMI) nodes
into weakly connected components before its greedy cover
(pugutils.rs:278-301).  The JAX package ran that step on the accelerator
as min-label propagation with pointer jumping over a padded (B, N, D)
neighbour tensor (``connected_components_batched`` :122) or as boolean
matrix squaring (``_dense_cc_run`` :72), with cells past its padding
ladder and any device failure sent to a host loop.  Here every cell runs
on the card in K7 (``csrc/pug_cc.cu``) over the cell's CSR adjacency as
``csrc/radc.cpp``'s ``radc_pug_graph_export`` writes it, with no padding
and no host route: one pass over the degrees labels the nodes without an
edge and lists the others, and a union-find over that list labels the
rest.  :func:`launch_plan` chooses each cell's route on the host from its
node and entry counts: (w) one warp, (a) its layout staged in shared
memory, (b) its parents alone there, (c) global scratch.

:func:`connected_components` takes (nodes per cell and adjacency entries
per cell, host arrays; degree per node and cell-local neighbours,
tensors) and returns, per node, the smallest cell-local node index of
its component (int32), with the rounds each cell took (K7 runs one
pass: 1 for every live cell).  It launches K7
for tensors on a CUDA device and takes the plain PyTorch twin
:func:`connected_components_twin` (the JAX package's ``_host_cc_labels``
loop, batched) for tensors on the CPU.  ``LAUNCHES`` counts K7's
launches; ``STATS`` the cells it ran on each route.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from .. import _kernels

LAUNCHES = {"K7": 0}
ROUTES = ("warp", "staged", "shared", "global")  # (w), (a), (b), (c)
STATS = {f"{r}_cells": 0 for r in ROUTES}

# K7's layout (csrc/pug_cc.cu): a block route's header (the mbarrier, two
# running counts, a pass step's scan totals and prefixes), then the
# cell's int32 arrays for at most min(n, m) edged nodes
HEADER = 1040
WARPS = 8  # route (w): cells (one a warp) a block
WARP_ENTRIES = 256  # route (w): most adjacency entries of a cell
WARP_NODES = 2048  # route (w): most nodes of a cell
NODES_PER_THREAD = 16  # block routes: a thread per this many nodes of the largest cell
MIN_THREADS, MAX_THREADS = 64, 512
MAX_STREAMS = 8  # side streams the launches of one call spread over


def _r16(b):
    return (b + 15) & ~15


def upload_csr(n_nodes: np.ndarray, deg: np.ndarray, nbrs: np.ndarray, device: torch.device
               ) -> Tuple[np.ndarray, np.ndarray, torch.Tensor, torch.Tensor]:
    """The exported graphs as K7 takes them: the node counts and each
    cell's adjacency entries (the sum of its degrees) as host int64
    arrays, the degrees (int64) and neighbours (int32) as tensors on
    ``device``, uploaded from pinned memory without blocking the host."""
    n_nodes = np.ascontiguousarray(n_nodes, np.int64)
    deg = np.ascontiguousarray(deg, np.int64)
    if int(n_nodes.sum()) != len(deg):
        raise ValueError("the node counts do not sum to the number of degrees")
    n_entries = np.zeros(len(n_nodes), np.int64)
    live = n_nodes > 0
    if live.any():
        n_entries[live] = np.add.reduceat(deg, (np.cumsum(n_nodes) - n_nodes)[live])
    tensors = []
    for a, dt in ((deg, np.int64), (nbrs, np.int32)):
        t = torch.from_numpy(np.ascontiguousarray(a, dt))
        if torch.device(device).type == "cuda":
            t = t.pin_memory()
        tensors.append(t.to(device, non_blocking=True))
    return (n_nodes, n_entries, *tensors)


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


# --- the launch plan ---------------------------------------------------------------

def cell_bytes(n, m) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shared bytes of cells of ``n`` nodes and ``m`` adjacency entries
    (int64), laid out for min(n, m) edged nodes: (route (w)'s slot of one
    warp, route (a)'s block, route (b)'s block).  Each holds the edged
    nodes, their parents and their offsets; (w) and (a) the neighbours too
    ((a) as a bulk-copied slice, 16 bytes longer), (b) the parents alone;
    (a) and (b) after the header."""
    n, m = (np.asarray(x, np.int64) for x in (n, m))
    k = np.minimum(n, m)
    nodes = 2 * _r16(4 * k) + _r16(4 * (k + 1))
    return nodes + _r16(4 * m), HEADER + nodes + _r16(4 * m) + 16, HEADER + _r16(4 * k)


# route (w)'s slot: every cell it takes fits the slot of its largest
WARP_SLOT = int(cell_bytes(WARP_ENTRIES, WARP_ENTRIES)[0])


def scratch_words(n, m, route) -> np.ndarray:
    """Global scratch words of route (b) cells (edged nodes, offsets,
    neighbours, the node-to-rank map) and (c) cells (their parents too);
    0 on the others."""
    n, m, route = (np.asarray(x, np.int64) for x in (n, m, route))
    k = np.minimum(n, m)
    return np.where(route >= 2, 2 * k + 1 + m + n + np.where(route == 3, k, 0), 0)


def block_threads(n) -> np.ndarray:
    """Threads of a block route's block for cells of ``n`` nodes: a power
    of two from 64 to 512, at least one per NODES_PER_THREAD nodes."""
    return MIN_THREADS << np.searchsorted(_THREAD_NODES, n)


_THREAD_NODES = NODES_PER_THREAD * MIN_THREADS << np.arange(3)  # 64-256 threads' most nodes
# a block route's buckets of shared bytes a block: the kernel's registers
# hold an SM to 2 blocks of 512 threads or 4 of 256, so blocks of up to
# 32 KB need no launch of their own
_BLOCK_BUCKETS = 1 << np.arange(15, 19)


@dataclass
class Launch:
    """One K7 launch: ``cells`` (indices into the batch; on a block route
    the most nodes first) on ``route`` (0-3: (w), (a), (b), (c)) with
    ``threads`` threads and ``smem`` dynamic shared bytes a block (route
    (w): WARPS cells a block, a WARP_SLOT each)."""

    cells: np.ndarray
    route: int
    threads: int
    smem: int


def launch_plan(n_nodes, n_entries, limit: int
                ) -> Tuple[List[Launch], np.ndarray, np.ndarray, np.ndarray, int]:
    """K7's launches for cells of ``n_nodes`` nodes and ``n_entries``
    adjacency entries under ``limit`` shared bytes a block.  A live cell
    (n > 0) takes route (w) when it has at most WARP_ENTRIES entries and
    WARP_NODES nodes (one launch, while WARPS slots fit the limit), else
    (a) when its staged layout fits, else (b) when its parents fit (with
    its node-to-rank map where that fits too), else (c).  A block route's
    launch holds the cells of one route and one bucket of shared bytes a
    block (so that a few large cells do not limit how many blocks of
    small ones an SM holds), the most nodes first, with the bytes and the
    block size of its largest; the launches of the largest layouts come
    first.  Returns (the launches, each cell's first node and first entry
    (C+1 each: host cumsums), each cell's first word in the global scratch
    or -1, the scratch words)."""
    n, m = (np.asarray(x, np.int64) for x in (n_nodes, n_entries))
    node_off = np.concatenate(([0], np.cumsum(n)))
    entry_off = np.concatenate(([0], np.cumsum(m)))
    scratch_off = np.full(len(n), -1, np.int64)
    warp = (m <= WARP_ENTRIES) & (n <= WARP_NODES) & (n > 0) & (WARPS * WARP_SLOT <= limit)
    cells = np.flatnonzero(warp)
    launches = []
    if len(cells):
        launches.append(Launch(cells, 0, 32 * WARPS, WARPS * WARP_SLOT))
    # the block routes' cells: the few large ones
    cells = np.flatnonzero(~warp & (n > 0))
    if not len(cells):
        return launches, node_off, entry_off, scratch_off, 0
    nb, mb = n[cells], m[cells]
    _slot, staged, shared = cell_bytes(nb, mb)
    route = np.where(staged <= limit, 1, np.where(shared <= limit, 2, 3))
    words = scratch_words(nb, mb, route)
    scratch_off[cells] = np.where(route >= 2, np.cumsum(words) - words, -1)
    # route (b) holds its node-to-rank map (4 bytes a node) in shared
    # memory where it fits: its cells have the most neighbours to map
    mapped = shared + _r16(4 * nb)
    block = np.where(route == 1, staged, np.where(
        route == 3, HEADER, np.where(mapped <= limit, mapped, shared)))
    group = route << 8 | np.searchsorted(_BLOCK_BUCKETS, block)
    order = np.argsort(group << 40 | (1 << 40) - 1 - nb)  # by group, the most nodes first
    group = group[order]
    starts = np.flatnonzero(np.concatenate(([True], group[1:] != group[:-1])))
    smem = np.maximum.reduceat(block[order], starts)
    threads = block_threads(np.maximum.reduceat(nb[order], starts))
    ends = np.append(starts[1:], len(order))
    launches += [Launch(cells[order[a:b]], g >> 8, t, s) for a, b, g, t, s in zip(
        starts.tolist(), ends.tolist(), group[starts].tolist(), threads.tolist(), smem.tolist())]
    launches.sort(key=lambda ln: (-ln.route, -ln.smem))
    return launches, node_off, entry_off, scratch_off, int(words.sum())


# --- the kernel ------------------------------------------------------------------

class _Staging:
    """A pinned host buffer that the plan is packed into, and the event
    recorded after the copy that last read it."""

    def __init__(self, words: int):
        self.buf = torch.empty(words, dtype=torch.int64, pin_memory=True)
        self.view = self.buf.numpy()
        self.read = None


_STAGING = {}  # device -> ring of STAGING_SLOTS buffers, and the next one's index
STAGING_SLOTS = 2


def _upload_plan(dev, launches, node_off, entry_off, scratch_off) -> torch.Tensor:
    """The plan on ``dev`` in one copy from pinned memory that does not
    block the host: the cells' first nodes, first entries and scratch
    offsets (int64), then every launch's cells (int32).  The host packs
    it into the next of a ring of pinned buffers, once the copy that last
    read that buffer has run."""
    C = len(node_off) - 1
    n_cells = sum(len(ln.cells) for ln in launches)
    words = 3 * C + 2 + (n_cells + 1) // 2
    ring = _STAGING.setdefault(dev, [[None] * STAGING_SLOTS, 0])
    slots, i = ring
    ring[1] = (i + 1) % STAGING_SLOTS
    st = slots[i]
    if st is None or len(st.view) < words:
        st = slots[i] = _Staging(1 << max(words - 1, 1).bit_length())
    elif st.read is not None:
        st.read.synchronize()
    v = st.view
    v[:C + 1] = node_off
    v[C + 1:2 * C + 2] = entry_off
    v[2 * C + 2:3 * C + 2] = scratch_off
    cells = v[3 * C + 2:words].view(np.int32)
    at = 0
    for ln in launches:
        cells[at:at + len(ln.cells)] = ln.cells
        at += len(ln.cells)
    plan = torch.empty(words, dtype=torch.int64, device=dev)
    plan.copy_(st.buf[:words], non_blocking=True)
    st.read = st.read or torch.cuda.Event()
    st.read.record(torch.cuda.current_stream(dev))
    return plan


def connected_components(n_nodes: np.ndarray, n_entries: np.ndarray, deg: torch.Tensor,
                         nbrs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 on the tensors' CUDA device, or its twin for tensors on the CPU
    (module docstring); ``n_entries`` is each cell's sum of degrees.  The
    host plans the launches from the two host arrays and uploads the plan
    without blocking; nothing is read back."""
    if nbrs.device.type == "cpu":
        return connected_components_twin(n_nodes, deg, nbrs)
    # the shared-memory limit is read, and K7 launched, on the tensors' card
    with _kernels.on(nbrs.device):
        return _connected_components_cuda(n_nodes, n_entries, deg, nbrs)


def _connected_components_cuda(n_nodes, n_entries, deg, nbrs):
    dev = nbrs.device
    counts, entries = np.asarray(n_nodes), np.asarray(n_entries)
    for a, total in ((counts, len(deg)), (entries, len(nbrs))):
        if a.dtype != np.int64 or a.ndim != 1 or len(a) != len(counts) or int(a.sum()) != total \
                or (len(a) and (a.min() < 0 or a.max() >= 1 << 31)):
            raise ValueError("K7 takes 1-D int64 host arrays of node counts and adjacency "
                             "entries per cell (each below 2**31) that sum to the numbers of "
                             "degrees and neighbours")
    for t, dt in ((deg, torch.int64), (nbrs, torch.int32)):
        if t.device != dev or t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError("K7 takes contiguous 1-D int64 degrees and int32 neighbours on "
                             "one CUDA device")
    lib = _kernels.load()
    labels = torch.empty(len(deg), dtype=torch.int32, device=dev)
    rounds = torch.zeros(len(counts), dtype=torch.int32, device=dev)
    launches, node_off, entry_off, scratch_off, n_scratch = launch_plan(
        counts, entries, int(lib.aft_smem_limit()))
    if not launches:
        return labels, rounds
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    plan = _upload_plan(dev, launches, node_off, entry_off, scratch_off)
    p, C = plan.data_ptr(), len(counts)
    ptrs = (p, p + 8 * (C + 1), p + 16 * (C + 1))
    at = p + 8 * (3 * C + 2)
    # the groups run side by side, so one group's slowest cells do not
    # hold the next group back
    streams = _kernels.fork(dev, min(len(launches), MAX_STREAMS))
    try:
        for i, ln in enumerate(launches):
            _kernels.check(lib.aft_pug_cc(
                deg.data_ptr(), nbrs.data_ptr(), *ptrs, at, len(ln.cells), ln.route,
                ln.threads, ln.smem, scratch.data_ptr(), labels.data_ptr(), rounds.data_ptr(),
                streams[i % len(streams)].cuda_stream,
            ), "K7 aft_pug_cc")
            at += 4 * len(ln.cells)
            _kernels.launched(LAUNCHES, "K7", dev)
            STATS[f"{ROUTES[ln.route]}_cells"] += len(ln.cells)
    finally:
        _kernels.join(dev, streams)
    return labels, rounds


def cc_labels(n_nodes: np.ndarray, deg: np.ndarray, nbrs: np.ndarray,
              device: torch.device) -> np.ndarray:
    """Component labels (cell-local smallest node index, int32) of every
    exported graph, computed on ``device`` and read back into pinned host
    memory."""
    return _read_back(connected_components(*upload_csr(n_nodes, deg, nbrs, device))[0])


def _read_back(labels: torch.Tensor) -> np.ndarray:
    """``labels`` on the host, through pinned memory from a card."""
    if labels.device.type == "cpu":
        return labels.numpy()
    host = torch.empty(labels.shape, dtype=labels.dtype, pin_memory=True)
    host.copy_(labels, non_blocking=True)
    torch.cuda.current_stream(labels.device).synchronize()
    return host.numpy()
