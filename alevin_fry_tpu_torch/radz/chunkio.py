"""Chunked record decode/encode to and from columnar arrays.

A RAD chunk is ``nbytes:u32 | nrec:u32 | records...`` where ``nbytes``
includes the 8-byte chunk header (reference: chunk framing read back at
src/collate.rs:749-753; written at src/convert.rs:473-492).

Decoding yields a :class:`ReadBatch`: one NumPy array per record field
plus a CSR offset array for the ragged alignment lists.  This is the
boundary between the host-side byte format and the device array programs —
everything downstream operates on these columns.

The per-record offset walk (the only sequential part) runs in native C++
(csrc/radc.cpp) when available; field extraction is vectorized NumPy
byte-gathering either way.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List

import numpy as np

from .. import spans
from .constants import ORI_BIT_U32, REF_ID_MASK_U32
from .prefetch import prefetched, read_spans
from .records import RecordSchema
from . import _native


@dataclass
class ReadBatch:
    """Columnar batch of mapped-read records.

    Attributes:
        read_cols: read-level fields (barcodes, umi), each shape (n,)
            as uint64.
        aln_offsets: (n+1,) int64 CSR offsets into the alignment columns.
        refs: (total_aln,) uint32 reference ids (orientation bit removed
            when the schema has a ref field).
        dirs: (total_aln,) bool, True = forward.
        aln_cols: other alignment-level fields (pos, as, start, end,
            type, start_pos, frag_len, ...), each shape (total_aln,).
        chunk_id: (n,) int64 index of the source chunk for each read.
        chunk_offsets: (n_chunks+1,) int64 read-index boundary per chunk.
    """

    schema: RecordSchema
    read_cols: Dict[str, np.ndarray] = field(default_factory=dict)
    aln_offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    refs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint32))
    dirs: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    aln_cols: Dict[str, np.ndarray] = field(default_factory=dict)
    chunk_id: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    chunk_offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    # raw bytes + record starts, kept when some read columns were
    # skipped at decode time so they can be gathered lazily on demand
    raw_buf: np.ndarray | None = None
    rec_starts: np.ndarray | None = None
    # global index of this batch's first chunk when the batch is one
    # block of a streamed decode (iter_decoded_blocks)
    first_chunk: int = 0

    @property
    def n_reads(self) -> int:
        return len(self.aln_offsets) - 1

    @property
    def n_aln(self) -> int:
        return int(self.aln_offsets[-1])

    @property
    def num_aln_per_read(self) -> np.ndarray:
        return np.diff(self.aln_offsets)

    def barcode(self, level: int = -1) -> np.ndarray:
        """The collation barcode.  For multi-barcode data level 0 is the
        sample BC and the last level is the cell BC (the collate key,
        cf. CollatableMappedRecord::collate_key)."""
        names = self.schema.barcode_fields
        col = self.read_cols.get(names[level])
        if col is None:
            return self.barcode_at(slice(None), level)
        return col

    def barcode_at(self, idx, level: int = -1) -> np.ndarray:
        """Barcode values at read indices ``idx``; gathers lazily from
        the raw bytes when the column was skipped at decode time."""
        name = self.schema.barcode_fields[level]
        col = self.read_cols.get(name)
        if col is not None:
            return col[idx]
        if self.raw_buf is None or self.rec_starts is None:
            raise KeyError(f"column {name} was skipped and no raw bytes kept")
        off = 4
        width = None
        for n, w in self.schema.read_fields:
            if n == name:
                width = w
                break
            off += w
        assert width is not None, name
        return _gather_uint(self.raw_buf, self.rec_starts[idx] + off, width)

    @property
    def umi(self) -> np.ndarray:
        return self.read_cols[self.schema.umi_field]


def _gather_uint(buf: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """Gather little-endian unsigned ints of ``width`` bytes starting at
    ``starts`` from a uint8 buffer (native single pass when available)."""
    if _native.available() and len(starts) > 16384:
        return _native.gather_uint(buf, starts, width)
    out = np.zeros(len(starts), dtype=np.uint64)
    for k in range(width):
        out |= buf[starts + k].astype(np.uint64) << np.uint64(8 * k)
    return out


def _scatter_uint(
    buf: np.ndarray, starts: np.ndarray, width: int, values: np.ndarray
) -> None:
    v = values.astype(np.uint64)
    for k in range(width):
        buf[starts + k] = ((v >> np.uint64(8 * k)) & np.uint64(0xFF)).astype(np.uint8)


def _walk_records_py(
    buf: np.ndarray, rec_region_starts: List[int], rec_region_counts: List[int],
    read_bytes: int, aln_bytes: int
):
    """Pure-Python fallback for the sequential record-offset walk.

    Returns (rec_starts[int64], num_aln[int64]) over all chunks."""
    total = int(sum(rec_region_counts))
    rec_starts = np.empty(total, np.int64)
    num_aln = np.empty(total, np.int64)
    mv = buf  # uint8 ndarray
    i = 0
    u32 = np.uint32
    del u32
    for start, count in zip(rec_region_starts, rec_region_counts):
        off = start
        for _ in range(count):
            na = int(
                mv[off]
                | (int(mv[off + 1]) << 8)
                | (int(mv[off + 2]) << 16)
                | (int(mv[off + 3]) << 24)
            )
            rec_starts[i] = off
            num_aln[i] = na
            off += 4 + read_bytes + na * aln_bytes
            i += 1
    return rec_starts, num_aln


def _read_chunks(fh: BinaryIO, num_chunks: int | None) -> tuple[List[bytes], List[int]]:
    """The next ``num_chunks`` chunks' bodies (headers stripped) and
    record counts, or to EOF if None; counts the bytes as
    ``bytes_read``."""
    chunk_bufs: List[bytes] = []
    chunk_recs: List[int] = []
    n = nread = 0
    while num_chunks is None or n < num_chunks:
        hdr = fh.read(8)
        if len(hdr) < 8:
            if num_chunks is not None:
                raise EOFError(f"expected {num_chunks} chunks but hit EOF after {n}")
            break
        nbytes, nrec = struct.unpack("<II", hdr)
        body = fh.read(nbytes - 8)
        if len(body) != nbytes - 8:
            raise EOFError("truncated chunk body")
        chunk_bufs.append(body)
        chunk_recs.append(nrec)
        nread += nbytes
        n += 1
    spans.add("bytes_read", nread)
    return chunk_bufs, chunk_recs


def _join_regions(chunk_bufs: List[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """The chunk bodies as one byte array, and where each starts."""
    buf = (np.frombuffer(b"".join(chunk_bufs), dtype=np.uint8) if chunk_bufs
           else np.zeros(0, np.uint8))
    sizes = np.asarray([len(b) for b in chunk_bufs], np.int64)
    region_starts = np.zeros(len(chunk_bufs), np.int64)
    if len(sizes) > 1:
        np.cumsum(sizes[:-1], out=region_starts[1:])
    return buf, region_starts


def read_chunk_bodies(
    fh: BinaryIO, num_chunks: int | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read raw chunk bodies (chunk headers stripped) without decoding
    fields, inside a ``read`` span.  Returns (buf[uint8],
    region_starts[int64], chunk_recs[int64]) — the inputs to the native
    byte-level record walk."""
    with spans.span("read", "codec"):
        chunk_bufs, chunk_recs = _read_chunks(fh, num_chunks)
        buf, region_starts = _join_regions(chunk_bufs)
    return buf, region_starts, np.asarray(chunk_recs, np.int64)


def chunk_record_counts(fh: BinaryIO, num_chunks: int) -> np.ndarray:
    """The record count of each of the next ``num_chunks`` chunks of
    ``fh``, from their headers alone: the bodies are skipped."""
    counts = np.zeros(num_chunks, np.int64)
    for i in range(num_chunks):
        hdr = fh.read(8)
        if len(hdr) < 8:
            raise EOFError(f"expected {num_chunks} chunks but hit EOF after {i}")
        nbytes, counts[i] = struct.unpack("<II", hdr)
        fh.seek(nbytes - 8, 1)
    return counts


def decode_all_chunks(
    fh: BinaryIO,
    schema: RecordSchema,
    num_chunks: int | None = None,
    skip_read_fields=None,
    want_dirs: bool = True,
) -> ReadBatch:
    """Decode ``num_chunks`` chunks (or until EOF if None) from ``fh``
    into a columnar :class:`ReadBatch`.

    ``skip_read_fields`` names read-level columns to leave undecoded
    (gathered lazily via ReadBatch.barcode_at); ``want_dirs=False``
    skips materializing the per-alignment orientation booleans."""
    with spans.span("read", "codec"):
        chunk_bufs, chunk_recs = _read_chunks(fh, num_chunks)
    return decode_chunk_bodies(
        chunk_bufs, chunk_recs, schema,
        skip_read_fields=skip_read_fields, want_dirs=want_dirs,
    )


def _iter_raw_chunk_groups(
    fh: BinaryIO,
    num_chunks: int | None,
    max_records: int,
    chunk_range: tuple | None = None,
):
    """Stream chunks into groups of roughly ``max_records`` reads,
    yielding (first_chunk, chunk_bufs, chunk_recs) WITHOUT any decode.
    This is pure file IO (``fh.read`` releases the GIL), so it is the
    layer a prefetch thread runs — the reference's reader thread reads
    raw chunk bytes exactly the same way (collate.rs:748-763); decode
    and compute stay on the consumer thread.

    ``chunk_range=(start, end)`` restricts to that global chunk
    interval (the multi-host ingest plan: each host owns a contiguous
    range; chunks before ``start`` are header-skipped without decode)."""
    chunk_bufs: List[bytes] = []
    chunk_recs: List[int] = []
    start, end = chunk_range if chunk_range is not None else (0, None)

    for _ in range(start):
        hdr = fh.read(8)
        if len(hdr) < 8:
            raise EOFError("hit EOF while skipping to the host chunk range")
        nbytes, _nrec = struct.unpack("<II", hdr)
        fh.seek(nbytes - 8, 1)

    first_chunk = start
    n = start
    pending = nread = 0
    while (num_chunks is None or n < num_chunks) and (end is None or n < end):
        hdr = fh.read(8)
        if len(hdr) < 8:
            if num_chunks is not None:
                raise EOFError(f"expected {num_chunks} chunks but hit EOF after {n}")
            break
        nbytes, nrec = struct.unpack("<II", hdr)
        body = fh.read(nbytes - 8)
        if len(body) != nbytes - 8:
            raise EOFError("truncated chunk body")
        chunk_bufs.append(body)
        chunk_recs.append(nrec)
        pending += nrec
        nread += nbytes
        n += 1
        if pending >= max_records:
            spans.add("bytes_read", nread)
            yield first_chunk, chunk_bufs, chunk_recs
            first_chunk = n
            chunk_bufs, chunk_recs, pending, nread = [], [], 0, 0
    if chunk_bufs:
        spans.add("bytes_read", nread)
        yield first_chunk, chunk_bufs, chunk_recs


def _maybe_prefetched(groups, prefetch: bool):
    """``groups`` read on a producer thread, or on this one; each
    group's read is a ``read`` span either way."""
    return prefetched(groups) if prefetch else read_spans(groups)


def iter_decoded_blocks(
    fh: BinaryIO,
    schema: RecordSchema,
    num_chunks: int | None,
    max_records: int,
    skip_read_fields=None,
    want_dirs: bool = True,
    chunk_range: tuple | None = None,
    prefetch: bool = False,
):
    """Stream-decode chunks into ReadBatch blocks of roughly
    ``max_records`` reads each (bounded-memory ingestion; the analog of
    the reference's --max-records scatter bound).  Each block's
    ``first_chunk`` records the global index of its first chunk and
    ``chunk_id`` is globally offset.

    ``prefetch=True`` reads the next group's raw bytes on a producer
    thread while this thread decodes/processes the current one (IO-only
    overlap: decoding on the producer would convoy on the GIL)."""
    for first, chunk_bufs, chunk_recs in _maybe_prefetched(
        _iter_raw_chunk_groups(fh, num_chunks, max_records, chunk_range),
        prefetch,
    ):
        yield decode_chunk_bodies(
            chunk_bufs, chunk_recs, schema,
            skip_read_fields=skip_read_fields, want_dirs=want_dirs, first_chunk=first,
        )


def iter_raw_blocks(
    fh: BinaryIO,
    num_chunks: int | None,
    max_records: int,
    prefetch: bool = False,
    chunk_range: tuple | None = None,
):
    """Stream chunks into raw byte blocks of roughly ``max_records``
    reads each WITHOUT field decode.  Yields (buf[uint8],
    region_starts[int64], chunk_recs[int64]) — the native walk inputs."""
    for _first, chunk_bufs, chunk_recs in _maybe_prefetched(
        _iter_raw_chunk_groups(fh, num_chunks, max_records, chunk_range),
        prefetch,
    ):
        with spans.span("decode", "codec"):
            buf, region_starts = _join_regions(chunk_bufs)
        yield buf, region_starts, np.asarray(chunk_recs, np.int64)


def decode_chunk_bodies(
    chunk_bufs: List[bytes],
    chunk_recs: List[int],
    schema: RecordSchema,
    skip_read_fields=None,
    want_dirs: bool = True,
    first_chunk: int = 0,
) -> ReadBatch:
    """Decode pre-read chunk bodies (without the 8-byte chunk headers),
    inside a ``decode`` span that counts the ``records``;
    ``first_chunk`` is the global index of the first chunk."""
    with spans.span("decode", "codec"):
        batch = _decode_bodies(chunk_bufs, chunk_recs, schema, skip_read_fields or set(),
                               want_dirs, first_chunk)
        spans.add("records", batch.n_reads)
    return batch


def _decode_bodies(chunk_bufs, chunk_recs, schema, skip_read_fields, want_dirs,
                   first_chunk) -> ReadBatch:
    buf, region_starts = _join_regions(chunk_bufs)

    rb, ab = schema.read_bytes, schema.aln_bytes
    if _native.available():
        rec_starts, num_aln = _native.walk_records(
            buf, region_starts, np.asarray(chunk_recs, np.int64), rb, ab,
        )
    else:
        rec_starts, num_aln = _walk_records_py(buf, region_starts, chunk_recs, rb, ab)

    batch = ReadBatch(schema=schema)
    aln_offsets = np.zeros(len(rec_starts) + 1, np.int64)
    np.cumsum(num_aln, out=aln_offsets[1:])
    total_aln = int(aln_offsets[-1])

    if _native.available():
        read_cols, aln_cols = _native.extract_fields2(
            buf, rec_starts, num_aln,
            [w for _, w in schema.read_fields],
            [w for _, w in schema.aln_fields],
            read_keep=[n not in skip_read_fields for n, _ in schema.read_fields],
        )
        for (name, _w), col in zip(schema.read_fields, read_cols):
            if col is not None:
                batch.read_cols[name] = col
        for (name, _w), col in zip(schema.aln_fields, aln_cols):
            if name == schema.ref_field:
                if want_dirs:
                    batch.dirs = (col & np.uint64(ORI_BIT_U32)) != 0
                batch.refs = (col & np.uint64(REF_ID_MASK_U32)).astype(np.uint32)
            else:
                batch.aln_cols[name] = col
    else:
        # read-level fields
        off = 4
        for name, w in schema.read_fields:
            if name not in skip_read_fields:
                batch.read_cols[name] = _gather_uint(buf, rec_starts + off, w)
            off += w
        # flat start offset of each alignment entry
        aln_base = np.repeat(rec_starts + 4 + rb, num_aln) + (
            np.arange(total_aln, dtype=np.int64)
            - np.repeat(aln_offsets[:-1], num_aln)
        ) * ab
        foff = 0
        for name, w in schema.aln_fields:
            col = _gather_uint(buf, aln_base + foff, w)
            foff += w
            if name == schema.ref_field:
                if want_dirs:
                    batch.dirs = (col & np.uint64(ORI_BIT_U32)) != 0
                batch.refs = (col & np.uint64(REF_ID_MASK_U32)).astype(np.uint32)
            else:
                batch.aln_cols[name] = col
    batch.aln_offsets = aln_offsets
    if skip_read_fields:
        batch.raw_buf = buf
        batch.rec_starts = rec_starts

    chunk_offsets = np.zeros(len(chunk_recs) + 1, np.int64)
    np.cumsum(np.asarray(chunk_recs, np.int64), out=chunk_offsets[1:])
    batch.chunk_offsets = chunk_offsets
    batch.chunk_id = np.repeat(
        np.arange(first_chunk, first_chunk + len(chunk_recs), dtype=np.int64),
        np.asarray(chunk_recs, np.int64),
    )
    batch.first_chunk = first_chunk
    return batch


def encode_records(
    schema: RecordSchema,
    read_cols: Dict[str, np.ndarray],
    aln_offsets: np.ndarray,
    refs: np.ndarray | None,
    dirs: np.ndarray | None,
    aln_cols: Dict[str, np.ndarray],
) -> np.ndarray:
    """Vectorized encode of records (no chunk header) to a byte buffer."""
    n = len(aln_offsets) - 1
    num_aln = np.diff(aln_offsets)
    rb, ab = schema.read_bytes, schema.aln_bytes
    rec_sizes = 4 + rb + num_aln * ab
    rec_starts = np.zeros(n + 1, np.int64)
    np.cumsum(rec_sizes, out=rec_starts[1:])
    total = int(rec_starts[-1])
    buf = np.zeros(total, np.uint8)
    rec_starts = rec_starts[:-1]

    if _native.available():
        rcols = [read_cols[name] for name, _ in schema.read_fields]
        acols = []
        for name, _w in schema.aln_fields:
            if name == schema.ref_field:
                acols.append(
                    refs.astype(np.uint64)
                    | (dirs.astype(np.uint64) << np.uint64(31))
                )
            else:
                acols.append(aln_cols[name])
        _native.encode_records_native(
            buf, rec_starts, num_aln,
            [w for _, w in schema.read_fields],
            [w for _, w in schema.aln_fields],
            rcols, acols,
        )
        return buf

    _scatter_uint(buf, rec_starts, 4, num_aln.astype(np.uint64))
    off = 4
    for name, w in schema.read_fields:
        _scatter_uint(buf, rec_starts + off, w, read_cols[name])
        off += w

    total_aln = int(aln_offsets[-1])
    aln_base = np.repeat(rec_starts + 4 + rb, num_aln) + (
        np.arange(total_aln, dtype=np.int64) - np.repeat(aln_offsets[:-1], num_aln)
    ) * ab
    foff = 0
    for name, w in schema.aln_fields:
        if name == schema.ref_field:
            col = refs.astype(np.uint64) | (
                dirs.astype(np.uint64) << np.uint64(31)
            )
        else:
            col = aln_cols[name].astype(np.uint64)
        _scatter_uint(buf, aln_base + foff, w, col)
        foff += w
    return buf


def write_cell_chunks(
    sink,
    schema: RecordSchema,
    read_cols: Dict[str, np.ndarray],
    aln_offsets: np.ndarray,
    refs: np.ndarray,
    dirs: np.ndarray,
    aln_cols: Dict[str, np.ndarray],
    cell_sizes: np.ndarray,
) -> int:
    """Encode all records once and emit one chunk per cell (records must
    already be grouped by cell in order).  Returns the number of
    non-empty chunks written."""
    body = encode_records(schema, read_cols, aln_offsets, refs, dirs, aln_cols)
    num_aln = np.diff(aln_offsets)
    rec_sizes = 4 + schema.read_bytes + num_aln * schema.aln_bytes
    rec_byte_off = np.zeros(len(rec_sizes) + 1, np.int64)
    np.cumsum(rec_sizes, out=rec_byte_off[1:])
    cell_starts = np.zeros(len(cell_sizes) + 1, np.int64)
    np.cumsum(cell_sizes, out=cell_starts[1:])
    mv = memoryview(body.data)
    parts = []
    n_written = 0
    for ci in range(len(cell_sizes)):
        s, e = int(cell_starts[ci]), int(cell_starts[ci + 1])
        if s == e:
            continue
        bs, be = int(rec_byte_off[s]), int(rec_byte_off[e])
        parts.append(struct.pack("<II", be - bs + 8, e - s))
        parts.append(mv[bs:be])
        n_written += 1
    sink.write(b"".join(parts))
    return n_written


class ChunkWriter:
    """Writes chunks (with their nbytes/nrec headers) to a binary stream
    and counts them."""

    def __init__(self, fh: BinaryIO):
        self.fh = fh
        self.num_chunks = 0

    def write_chunk_bytes(self, body: np.ndarray, nrec: int) -> None:
        self.fh.write(struct.pack("<II", int(body.nbytes) + 8, nrec))
        self.fh.write(body.tobytes())
        self.num_chunks += 1
