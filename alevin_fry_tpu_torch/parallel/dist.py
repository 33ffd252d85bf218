"""Multi-process runs over ``torch.distributed`` (port of
``alevin_fry_tpu/parallel/dist.py``).

Each process (a rank) of an N-process run owns a contiguous range of
the RAD file's chunks (:func:`host_chunk_plan`), does its stage's work on
them, and the partial results merge over collectives in rank order;
rank 0 writes every artifact, so the artifacts equal a one-process
run's byte for byte.  What every rank needs (histograms, counters) is
all-gathered; what only rank 0 writes is sent to it alone, point to
point (:func:`gather_to_root`, :func:`stream_concat_files`).

The run is set up from the reference's variables: the coordinator
``AFT_COORDINATOR`` (else ``JAX_COORDINATOR_ADDRESS``) as ``host:port``,
``AFT_NUM_PROCESSES`` and ``AFT_PROCESS_ID``.  Rank 0 hosts the TCP
store at the coordinator's address.  Without a coordinator every
function here is the one-process case and ``torch.distributed`` is
never initialized.

Every collective moves host data: histograms, spill-bucket bytes, COO
triplets and counters, as CPU tensors over the ``gloo`` backend.  NCCL
is not used: it would need device tensors and one GPU per rank, where
here two ranks may share one card.  The cards of one process form the
device mesh of ``parallel/mesh.py``, which a multi-process run does not
take.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Tuple

import numpy as np

# seconds a collective (and the rendezvous) may wait for its peers
# before it raises; a rank that finishes its share early waits here
TIMEOUT_S = 1800
# seconds the barrier of a failing stage waits for its peers
ERROR_BARRIER_S = 30

_COORDINATOR_VARS = ("AFT_COORDINATOR", "JAX_COORDINATOR_ADDRESS")
_INITIALIZED = False
_RANK, _WORLD = 0, 1

# bytes this rank handed to collectives since the process started (its
# padded share of every all-gather, its parts sent to rank 0)
SENT_BYTES = 0

# dtypes gloo gathers as they are; every other dtype travels as a view
# of the same bytes (gloo refuses unsigned 32- and 64-bit tensors)
_WIRE = {1: np.uint8, 4: np.int32, 8: np.int64}
_NATIVE = {np.dtype(t) for t in (np.uint8, np.int32, np.int64, np.float32, np.float64)}


def _coordinator() -> str | None:
    """The coordinator's ``host:port`` from the environment, or None."""
    for var in _COORDINATOR_VARS:
        if os.environ.get(var):
            return os.environ[var]
    return None


def initialize() -> None:
    """Join the run the environment describes (idempotent).  Without a
    coordinator this is a no-op; with one, ``AFT_NUM_PROCESSES`` and
    ``AFT_PROCESS_ID`` must be set (a ValueError names the one missing
    before any connection is made) and the rendezvous raises after
    :data:`TIMEOUT_S` if the peers do not come."""
    global _INITIALIZED, _RANK, _WORLD
    if _INITIALIZED:
        return
    coord = _coordinator()
    if coord is None:
        return
    for var in ("AFT_NUM_PROCESSES", "AFT_PROCESS_ID"):
        if not os.environ.get(var, "").strip():
            raise ValueError(
                f"a coordinator is set ({coord}) but {var} is not: a multi-process run needs "
                "AFT_NUM_PROCESSES and AFT_PROCESS_ID"
            )
    world = int(os.environ["AFT_NUM_PROCESSES"])
    rank = int(os.environ["AFT_PROCESS_ID"])
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"AFT_PROCESS_ID {rank} is not a rank of AFT_NUM_PROCESSES {world}")
    import torch.distributed as td

    td.init_process_group(
        "gloo", init_method=f"tcp://{coord}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S),
    )
    _RANK, _WORLD, _INITIALIZED = rank, world, True


def is_initialized() -> bool:
    return _INITIALIZED


def rank_world() -> Tuple[int, int]:
    """(rank, world size): (0, 1) without a coordinator; with one, the
    run is joined first, so a stage never runs as world 1 under it."""
    if not _INITIALIZED and _coordinator() is not None:
        initialize()
    return _RANK, _WORLD


def host_chunk_plan(num_chunks: int, world: int, rank: int) -> Tuple[int, int]:
    """The contiguous chunk range [start, end) of ``rank``: the first
    ``num_chunks % world`` ranks take one chunk more."""
    per, extra = divmod(num_chunks, world)
    start = rank * per + min(rank, extra)
    return start, start + per + (1 if rank < extra else 0)


def record_chunk_plan(chunk_records, world: int, rank: int) -> Tuple[int, int]:
    """The contiguous chunk range [start, end) of ``rank`` that holds
    about a ``world``-th of the records (``chunk_records``: each chunk's).
    A collated file holds one chunk a cell, largest first, so equal
    chunk counts (:func:`host_chunk_plan`) would leave the last ranks
    only the smallest cells."""
    cum = np.concatenate([[0], np.cumsum(np.asarray(chunk_records, np.int64))])
    cut = [int(np.searchsorted(cum, cum[-1] * r / world)) for r in (rank, rank + 1)]
    start, end = (0 if rank == 0 else cut[0]), (len(cum) - 1 if rank == world - 1 else cut[1])
    return min(start, end), end


def barrier() -> None:
    """Wait until every rank reaches this point (no-op in one process)."""
    if rank_world()[1] > 1:
        import torch.distributed as td

        td.barrier()


def finalize(ok: bool = True) -> None:
    """End the run: a barrier, so that rank 0, which hosts the TCP store,
    leaves only after every peer has, then the process group goes.  On
    a failing stage's way out (``ok`` false) the barrier waits at most
    :data:`ERROR_BARRIER_S` seconds, since a peer may be held in
    another collective."""
    global _INITIALIZED, _RANK, _WORLD
    if not _INITIALIZED:
        return
    import torch.distributed as td

    try:
        if ok:
            td.barrier()
        else:
            try:
                td.monitored_barrier(timeout=datetime.timedelta(seconds=ERROR_BARRIER_S))
            except RuntimeError:
                pass
    finally:
        td.destroy_process_group()
        _RANK, _WORLD, _INITIALIZED = 0, 1, False


def _to_wire(arr: np.ndarray) -> np.ndarray:
    """``arr`` as an array gloo gathers, of the same bytes."""
    if arr.dtype in _NATIVE:
        return arr
    if arr.dtype.itemsize in _WIRE:
        return arr.view(_WIRE[arr.dtype.itemsize])
    return arr.view(np.uint8)


def allgather_ragged(arr) -> List[np.ndarray]:
    """Every rank's 1-D array, in rank order, on every rank; the lengths
    may differ.  The lengths are gathered first, each array padded to
    the longest, and any dtype gloo refuses travels as a view of its
    bytes, so unsigned 64-bit keys come back bit for bit."""
    global SENT_BYTES
    arr = np.ascontiguousarray(arr).reshape(-1)
    _rank, world = rank_world()
    if world == 1:
        return [arr]
    import torch
    import torch.distributed as td

    wire = _to_wire(arr)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    td.all_gather(lens, torch.tensor([len(wire)], dtype=torch.int64))
    lens = [int(n) for n in lens]
    most = max(lens)
    SENT_BYTES += 8 + most * wire.itemsize
    if most == 0:
        return [np.zeros(0, arr.dtype) for _ in range(world)]
    pad = np.zeros(most, wire.dtype)
    pad[: len(wire)] = wire
    parts = [torch.empty(most, dtype=torch.from_numpy(pad).dtype) for _ in range(world)]
    td.all_gather(parts, torch.from_numpy(pad))
    return [p.numpy()[:n].view(arr.dtype) for p, n in zip(parts, lens)]


def send_to_root(arr) -> None:
    """Send the 1-D array ``arr`` to rank 0, its length first, then (if
    any) its bytes, in the dtype views of :func:`allgather_ragged`;
    rank 0 takes it with :func:`recv_from`."""
    global SENT_BYTES
    import torch
    import torch.distributed as td

    wire = _to_wire(np.ascontiguousarray(arr).reshape(-1))
    td.send(torch.tensor([len(wire)], dtype=torch.int64), dst=0)
    SENT_BYTES += 8
    if len(wire):
        td.send(torch.from_numpy(wire), dst=0)
        SENT_BYTES += wire.nbytes


def recv_from(src: int, dtype) -> np.ndarray:
    """At rank 0, the array of ``dtype`` that rank ``src`` sent by
    :func:`send_to_root`."""
    import torch
    import torch.distributed as td

    n = torch.zeros(1, dtype=torch.int64)
    td.recv(n, src=src)
    if int(n) == 0:
        return np.zeros(0, dtype)
    buf = torch.empty(int(n), dtype=torch.from_numpy(_to_wire(np.zeros(0, dtype))).dtype)
    td.recv(buf, src=src)
    return buf.numpy().view(dtype)


def gather_to_root(arr) -> List[np.ndarray]:
    """Every rank's 1-D array, in rank order, at rank 0 alone; each other
    rank sends its array once, point to point, and gets back ``world``
    empty arrays.  What only rank 0 writes (spill buckets, per-cell
    results) goes this way, so it crosses once whatever the number of
    ranks."""
    arr = np.ascontiguousarray(arr).reshape(-1)
    rank, world = rank_world()
    if world == 1:
        return [arr]
    if rank != 0:
        send_to_root(arr)
        return [np.zeros(0, arr.dtype) for _ in range(world)]
    return [arr] + [recv_from(src, arr.dtype) for src in range(1, world)]


def stream_concat_files(local_path, out_fh, chunk_bytes: int = 8 << 20) -> int:
    """Write every rank's file ``local_path`` into ``out_fh`` at rank 0,
    in rank order, in rounds of at most ``chunk_bytes`` bytes, so memory
    stays flat whatever the files' sizes; each other rank sends its file
    to rank 0 alone.  Every rank calls it (other ranks may pass
    ``out_fh=None``).  Returns the bytes written."""
    rank, world = rank_world()
    sizes = [int(p[0]) for p in allgather_ragged(
        np.asarray([os.path.getsize(local_path)], np.int64))]
    with open(local_path, "rb") as fh:
        if rank == 0:
            for block in iter(lambda: fh.read(chunk_bytes), b""):
                out_fh.write(block)
        else:
            for block in iter(lambda: fh.read(chunk_bytes), b""):
                send_to_root(np.frombuffer(bytearray(block), np.uint8))
    if rank == 0:
        for src in range(1, world):
            for off in range(0, sizes[src], chunk_bytes):
                out_fh.write(recv_from(src, np.uint8).tobytes())
    return sum(sizes)


def merge_partial_coo(rows, cols, vals, row_offset: int):
    """Every rank's COO triplets at rank 0, in rank order, its rows
    shifted by ``row_offset`` (the rows of the ranks before it): ranks
    own disjoint, contiguous cell ranges, so no reduction is needed.
    Other ranks get empty arrays."""
    if rank_world()[1] == 1:
        return np.asarray(rows), np.asarray(cols), np.asarray(vals)
    r = gather_to_root(np.asarray(rows, np.int64) + np.int64(row_offset))
    c = gather_to_root(np.asarray(cols, np.int64))
    v = gather_to_root(np.asarray(vals, np.float32))
    return np.concatenate(r), np.concatenate(c), np.concatenate(v)


def merge_counts(summed, maxed=()) -> list:
    """Counters of every rank: those of ``summed`` summed, then those of
    ``maxed`` their maximum over the ranks."""
    parts = np.stack(allgather_ragged(np.asarray([*summed, *maxed], np.int64)))
    n = len(summed)
    return [int(v) for v in parts[:, :n].sum(axis=0)] + [int(v) for v in parts[:, n:].max(axis=0)]
