"""A NumPy writer of RAD files, the benchmark's own.

The layout is the RAD format's (as alevin-fry and libradicl write it):

* the header: ``is_paired:u8``, ``ref_count:u64``, each reference name
  as ``len:u16`` and its UTF-8 bytes, ``num_chunks:u64``;
* three tag sections (file, read, alignment), each ``count:u16`` and
  then per tag ``len:u16``, the name, ``type:u8`` (an array tag adds
  the type of its length and of its elements);
* the file tags' values, in declaration order;
* the chunks: ``nbytes:u32`` (the 8 header bytes included), ``nrec:u32``,
  then the records, each ``num_aln:u32``, the read tags' values, and
  per alignment the alignment tags' values, all little-endian.

Everything is vectorised: a record's fields are scattered into one byte
buffer a field at a time.  :func:`encode_records` is also the
reference's encoder of a collated file's expected bytes.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Sequence, Tuple

import numpy as np

# RAD type ids
U8, U16, U32, U64, ARRAY, STRING = 1, 2, 3, 4, 7, 8
WIDTH = {U8: 1, U16: 2, U32: 4, U64: 8}
# the orientation flag of ``compressed_ori_refid``: set means forward
ORI_BIT = np.uint32(1 << 31)


def int_type_for_seq_len(length: int) -> int:
    """The smallest unsigned type that holds ``length`` 2-bit bases."""
    for limit, t in ((4, U8), (8, U16), (16, U32), (32, U64)):
        if length <= limit:
            return t
    raise ValueError(f"no integer type holds {length} bases")


def _tags(tags: Sequence[Tuple[str, tuple]]) -> bytes:
    out = [struct.pack("<H", len(tags))]
    for name, typ in tags:
        nb = name.encode()
        out.append(struct.pack("<H", len(nb)) + nb + bytes(typ))
    return b"".join(out)


def _tag_value(typ: tuple, value) -> bytes:
    if typ[0] in WIDTH:
        return int(value).to_bytes(WIDTH[typ[0]], "little")
    if typ[0] == STRING:
        vb = str(value).encode()
        return struct.pack("<H", len(vb)) + vb
    if typ[0] == ARRAY:
        arr = np.asarray(value, {U8: "<u1", U16: "<u2", U32: "<u4", U64: "<u8"}[typ[2]])
        return int(arr.size).to_bytes(WIDTH[typ[1]], "little") + arr.tobytes()
    raise ValueError(f"unsupported tag type {typ}")


class Schema:
    """A record layout: the tag sections and the file tags' values.
    Each tag is ``(name, type)`` with ``type`` a tuple of type ids."""

    def __init__(self, ref_names: List[str], is_paired: int, file_tags, file_values: dict,
                 read_tags, aln_tags):
        self.ref_names = list(ref_names)
        self.is_paired = is_paired
        self.file_tags, self.file_values = list(file_tags), dict(file_values)
        self.read_tags, self.aln_tags = list(read_tags), list(aln_tags)
        self.read_widths = [WIDTH[t[0]] for _, t in self.read_tags]
        self.aln_widths = [WIDTH[t[0]] for _, t in self.aln_tags]

    def prelude(self, num_chunks: int) -> bytes:
        """The header, tag sections and file tag values."""
        names = b"".join(struct.pack("<H", len(n.encode())) + n.encode()
                         for n in self.ref_names)
        return b"".join([
            struct.pack("<BQ", self.is_paired, len(self.ref_names)), names,
            struct.pack("<Q", num_chunks),
            _tags(self.file_tags), _tags(self.read_tags), _tags(self.aln_tags),
            b"".join(_tag_value(t, self.file_values[n]) for n, t in self.file_tags),
        ])


def rna_schema(ref_names: List[str], bc_len: int, umi_len: int) -> Schema:
    """Short-read scRNA records: read tags ``b`` and ``u``, alignment tag
    ``compressed_ori_refid``."""
    return Schema(ref_names, 0, [("cblen", (U16,)), ("ulen", (U16,))],
                  {"cblen": bc_len, "ulen": umi_len},
                  [("b", (int_type_for_seq_len(bc_len),)), ("u", (int_type_for_seq_len(umi_len),))],
                  [("compressed_ori_refid", (U32,))])


def atac_schema(ref_names: List[str], ref_lens: Sequence[int], bc_len: int) -> Schema:
    """scATAC records: read tag ``barcode``, alignment tags ``ref``,
    ``type``, ``start_pos``, ``frag_len``."""
    return Schema(ref_names, 1, [("cblen", (U16,)), ("ref_lengths", (ARRAY, U64, U64))],
                  {"cblen": bc_len, "ref_lengths": np.asarray(ref_lens, np.uint64)},
                  [("barcode", (int_type_for_seq_len(bc_len),))],
                  [("ref", (U32,)), ("type", (U8,)), ("start_pos", (U32,)), ("frag_len", (U16,))])


def _scatter(buf: np.ndarray, pos: np.ndarray, width: int, values: np.ndarray) -> None:
    """Write ``values`` little-endian, ``width`` bytes each, at ``pos``."""
    if len(pos) == 0:
        return
    if width > 1 and not (pos % width).any():
        # aligned: one store a value through a view of the buffer
        view = buf[:len(buf) - len(buf) % width].view(f"<u{width}")
        view[pos // width] = np.asarray(values).astype(f"<u{width}")
        return
    raw = np.ascontiguousarray(values, "<u8").view(np.uint8).reshape(-1, 8)[:, :width]
    buf[pos[:, None] + np.arange(width)] = raw


def encode_records(schema: Schema, read_cols: Sequence[np.ndarray], aln_offsets: np.ndarray,
                   aln_cols: Sequence[np.ndarray]) -> np.ndarray:
    """The bytes of records (no chunk header): ``read_cols`` one array per
    read tag, ``aln_cols`` one per alignment tag (the orientation already
    folded into ``compressed_ori_refid``), CSR ``aln_offsets``."""
    nal = np.diff(aln_offsets).astype(np.int64)
    rb, ab = sum(schema.read_widths), sum(schema.aln_widths)
    size = 4 + rb + nal * ab
    starts = np.zeros(len(nal) + 1, np.int64)
    np.cumsum(size, out=starts[1:])
    buf = np.zeros(int(starts[-1]), np.uint8)
    starts = starts[:-1]
    _scatter(buf, starts, 4, nal)
    off = 4
    for col, w in zip(read_cols, schema.read_widths):
        _scatter(buf, starts + off, w, col)
        off += w
    first = np.repeat(starts + 4 + rb, nal) + (
        np.arange(int(nal.sum()), dtype=np.int64) - np.repeat(aln_offsets[:-1], nal)) * ab
    off = 0
    for col, w in zip(aln_cols, schema.aln_widths):
        _scatter(buf, first + off, w, col)
        off += w
    return buf


def encode_chunks(schema: Schema, read_cols, aln_offsets, aln_cols,
                  chunk_offsets: np.ndarray) -> np.ndarray:
    """Records grouped into chunks (``chunk_offsets`` over the reads),
    each behind its ``nbytes:u32 nrec:u32`` header."""
    body = encode_records(schema, read_cols, aln_offsets, aln_cols)
    nal = np.diff(aln_offsets).astype(np.int64)
    size = 4 + sum(schema.read_widths) + nal * sum(schema.aln_widths)
    rec_end = np.zeros(len(nal) + 1, np.int64)
    np.cumsum(size, out=rec_end[1:])
    nrec = np.diff(chunk_offsets).astype(np.int64)
    nbytes = rec_end[chunk_offsets[1:]] - rec_end[chunk_offsets[:-1]] + 8
    out = np.empty(len(body) + 8 * len(nrec), np.uint8)
    hdr_pos = rec_end[chunk_offsets[:-1]] + 8 * np.arange(len(nrec))
    keep = np.ones(len(out), bool)
    keep[hdr_pos[:, None] + np.arange(8)] = False
    out[keep] = body
    _scatter(out, hdr_pos, 4, nbytes)
    _scatter(out, hdr_pos + 4, 4, nrec)
    return out


def write_rad(path, schema: Schema, read_cols, aln_offsets, aln_cols,
              chunk_offsets: np.ndarray) -> None:
    """Write a whole RAD file."""
    with open(path, "wb") as fh:
        fh.write(schema.prelude(len(chunk_offsets) - 1))
        encode_chunks(schema, read_cols, aln_offsets, aln_cols, chunk_offsets).tofile(fh)


def fixed_chunks(n: int, per_chunk: int) -> np.ndarray:
    """Chunk offsets for ``n`` records, ``per_chunk`` a chunk."""
    return np.append(np.arange(0, n, per_chunk, dtype=np.int64), n)


def write_raw_unmapped(path, bcs: np.ndarray, counts: np.ndarray) -> None:
    """The mapper's ``unmapped_bc_count.bin``: raw ``(bc:u64, count:u32)``
    pairs."""
    rec = np.empty(len(bcs), np.dtype([("bc", "<u8"), ("ct", "<u4")]))
    rec["bc"], rec["ct"] = bcs, counts
    rec.tofile(path)


# --- barcodes as text ---------------------------------------------------------

BASES = np.frombuffer(b"ACGT", np.uint8)


def unpack_ascii(codes: np.ndarray, length: int) -> np.ndarray:
    """2-bit packed codes (first base in the highest bits) -> (n,
    length) ASCII bytes."""
    shifts = np.uint64(2) * np.arange(length - 1, -1, -1, dtype=np.uint64)
    return BASES[((np.asarray(codes, np.uint64)[:, None] >> shifts) & np.uint64(3))
                 .astype(np.uint8)]


def revcomp(codes: np.ndarray, length: int) -> np.ndarray:
    """Reverse complement of 2-bit packed codes."""
    codes = np.asarray(codes, np.uint64)
    out = np.zeros_like(codes)
    for i in range(length):
        comp = ((codes >> np.uint64(2 * i)) & np.uint64(3)) ^ np.uint64(3)
        out |= comp << np.uint64(2 * (length - 1 - i))
    return out


def write_barcode_list(path, codes: np.ndarray, length: int) -> None:
    """One barcode a line."""
    mat = np.empty((len(codes), length + 1), np.uint8)
    mat[:, :length] = unpack_ascii(codes, length)
    mat[:, length] = ord("\n")
    mat.tofile(path)
