"""ctypes bindings for the native RAD codec (``csrc/libradc.so``, built
from ``csrc/radc.cpp`` with ``make -C csrc``).

The only inherently sequential part of RAD decoding is walking the
variable-length record boundaries (each record's size depends on its
``num_aln`` field).  That walk, field extraction, the collated emit and
the text formatting of the outputs run here in C++; the callers keep a
pure-NumPy path for when the library does not load.  Only the entry
points the port calls are bound.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False


def _find_lib():
    here = Path(__file__).resolve().parent.parent.parent
    for cand in (here / "csrc" / "libradc.so", here / "libradc.so"):
        if cand.exists():
            return str(cand)
    env = os.environ.get("AFT_RADC_LIB")
    if env and os.path.exists(env):
        return env
    return None


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.radc_walk_records.restype = ctypes.c_int64
        lib.radc_walk_records.argtypes = [
            ctypes.c_void_p,  # buf
            ctypes.c_int64,  # buf_len
            ctypes.c_void_p,  # region_starts (int64*)
            ctypes.c_void_p,  # region_counts (int64*)
            ctypes.c_int64,  # n_regions
            ctypes.c_int64,  # read_bytes
            ctypes.c_int64,  # aln_bytes
            ctypes.c_void_p,  # out rec_starts (int64*)
            ctypes.c_void_p,  # out num_aln   (int64*)
        ]
        lib.radc_walk_records_mt.restype = ctypes.c_int64
        lib.radc_walk_records_mt.argtypes = (
            lib.radc_walk_records.argtypes + [ctypes.c_int32]
        )
        lib.radc_format_triplets.restype = ctypes.c_int64
        lib.radc_format_triplets.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.radc_ori_counts.restype = ctypes.c_int64
        lib.radc_ori_counts.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_void_p, ctypes.c_int64,   # rec_starts, n_recs
            ctypes.c_void_p,                   # num_aln
            ctypes.c_int64, ctypes.c_int64,    # read_bytes, aln_bytes
            ctypes.c_int64, ctypes.c_int32,    # ref_off, ori_mode
            ctypes.c_void_p,                   # kept_out
        ]
        lib.radc_format_f32.restype = ctypes.c_int64
        lib.radc_format_f32.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.radc_scan_names.restype = ctypes.c_int64
        lib.radc_scan_names.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_int64, ctypes.c_void_p,   # count, starts_out
        ]
        lib.radc_gather_uint.restype = ctypes.c_int64
        lib.radc_gather_uint.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_void_p, ctypes.c_int64,   # starts, n
            ctypes.c_int64, ctypes.c_void_p,   # width, out
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_sort_rle_u64_segments.restype = None
        lib.radc_sort_rle_u64_segments.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # keys, seg_offsets
            ctypes.c_int64,                    # n_segs
            ctypes.c_void_p, ctypes.c_void_p,  # uniq_out, cnt_out
            ctypes.c_void_p, ctypes.c_void_p,  # range_starts, range_counts
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_count_u64.restype = ctypes.c_int64
        lib.radc_count_u64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,  # keys, n, cap
            ctypes.c_void_p, ctypes.c_void_p,  # uniq_out, cnt_out
        ]
        lib.radc_collate_emit2.restype = ctypes.c_int64
        lib.radc_collate_emit2.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_void_p, ctypes.c_void_p,  # rec_starts, num_aln
            ctypes.c_void_p,                   # corrected_bc
            ctypes.c_void_p, ctypes.c_void_p,  # order, order_offsets
            ctypes.c_void_p, ctypes.c_int64,   # out_offsets, n_chunks
            ctypes.c_int64, ctypes.c_int64,    # read_bytes, aln_bytes
            ctypes.c_int64, ctypes.c_int64,    # bc_off, bc_width
            ctypes.c_int64, ctypes.c_int32,    # ref_off, ori_mode
            ctypes.c_void_p, ctypes.c_int64,   # out, out_cap
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_extract_fields2.restype = ctypes.c_int64
        lib.radc_extract_fields2.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_void_p, ctypes.c_int64,   # rec_starts, n_recs
            ctypes.c_void_p, ctypes.c_void_p,  # num_aln, aln_offs
            ctypes.c_void_p, ctypes.c_int64,   # read_widths, n
            ctypes.c_void_p, ctypes.c_int64,   # aln_widths, n
            ctypes.c_void_p, ctypes.c_void_p,  # read_cols**, aln_cols**
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_lookup_u64.restype = ctypes.c_int64
        lib.radc_lookup_u64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # keys, vals, n
            ctypes.c_void_p, ctypes.c_int64,   # queries, n_q
            ctypes.c_void_p, ctypes.c_void_p,  # hit_out, val_out
        ]
        lib.radc_encode_records.restype = ctypes.c_int64
        lib.radc_encode_records.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # buf, len
            ctypes.c_void_p, ctypes.c_int64,   # rec_starts, n_recs
            ctypes.c_void_p,                   # num_aln
            ctypes.c_void_p, ctypes.c_int64,   # read_widths, n
            ctypes.c_void_p, ctypes.c_int64,   # aln_widths, n
            ctypes.c_void_p, ctypes.c_void_p,  # read_cols**, aln_cols**
        ]
        lib.radc_format_bed.restype = ctypes.c_int64
        lib.radc_format_bed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # name_bytes, name_offs
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # chrs, starts, ends
            ctypes.c_void_p, ctypes.c_int64,   # bcs, bc_len
            ctypes.c_void_p, ctypes.c_int64,   # counts, n
            ctypes.c_void_p, ctypes.c_int32,   # out, n_threads
        ]
        lib.radc_gather_records.restype = None
        lib.radc_gather_records.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # buf, rec_starts
            ctypes.c_void_p, ctypes.c_void_p,  # sizes, order
            ctypes.c_int64, ctypes.c_void_p,   # n, dst_off
            ctypes.c_void_p, ctypes.c_int32,   # out, n_threads
        ]
        lib.radc_crc32c.restype = ctypes.c_uint32
        lib.radc_crc32c.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32,  # buf, len, init
        ]
        lib.radc_snappy_max_compressed.restype = ctypes.c_int64
        lib.radc_snappy_max_compressed.argtypes = [ctypes.c_int64]
        lib.radc_snappy_compress.restype = ctypes.c_int64
        lib.radc_snappy_compress.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # in, len, out
        ]
        lib.radc_snappy_uncompress.restype = ctypes.c_int64
        lib.radc_snappy_uncompress.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # in, len
            ctypes.c_void_p, ctypes.c_int64,   # out, out_cap
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def walk_records(
    buf: np.ndarray,
    region_starts: np.ndarray,
    region_counts: np.ndarray,
    read_bytes: int,
    aln_bytes: int,
):
    lib = _load()
    total = int(region_counts.sum())
    rec_starts = np.empty(total, np.int64)
    num_aln = np.empty(total, np.int64)
    buf = np.ascontiguousarray(buf)
    region_starts = np.ascontiguousarray(region_starts, np.int64)
    region_counts = np.ascontiguousarray(region_counts, np.int64)
    rc = lib.radc_walk_records_mt(
        buf.ctypes.data, buf.nbytes,
        region_starts.ctypes.data, region_counts.ctypes.data,
        len(region_starts), read_bytes, aln_bytes,
        rec_starts.ctypes.data, num_aln.ctypes.data, _NTHREADS,
    )
    if rc < 0:
        raise ValueError("record walk overran the buffer (corrupt RAD chunk?)")
    return rec_starts, num_aln


def _col_ptrs(cols):
    arr = (ctypes.c_void_p * len(cols))()
    for i, c in enumerate(cols):
        arr[i] = c.ctypes.data if c is not None else None
    return arr


def ori_counts(
    buf: np.ndarray,
    rec_starts: np.ndarray,
    num_aln: np.ndarray,
    read_bytes: int,
    aln_bytes: int,
    ref_off: int,
    ori_mode: int,
) -> np.ndarray:
    """Per-record surviving-alignment counts under the orientation
    filter (ori_mode 1=fw, 2=rc)."""
    lib = _load()
    n = len(rec_starts)
    kept = np.empty(n, np.int64)
    buf = np.ascontiguousarray(buf)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    num_aln = np.ascontiguousarray(num_aln, np.int64)
    rc = lib.radc_ori_counts(
        buf.ctypes.data, buf.nbytes,
        rec_starts.ctypes.data, n, num_aln.ctypes.data,
        read_bytes, aln_bytes, ref_off, ori_mode,
        kept.ctypes.data,
    )
    if rc < 0:
        raise ValueError("orientation scan overran the buffer")
    return kept


_NTHREADS = max(1, min(8, os.cpu_count() or 1))


def set_threads(n: int) -> None:
    """Set the native kernel thread count (the CLI's -t/--threads; the
    reference caps collate/sort at 16 and gpl at 8, main.rs:49-52 —
    callers pass their already-capped value)."""
    global _NTHREADS
    _NTHREADS = max(1, min(int(n), 64))


def gather_uint(buf: np.ndarray, starts: np.ndarray, width: int) -> np.ndarray:
    """Gather little-endian uints of ``width`` bytes at ``starts``."""
    lib = _load()
    buf = np.ascontiguousarray(buf)
    starts = np.ascontiguousarray(starts, np.int64)
    out = np.empty(len(starts), np.uint64)
    rc = lib.radc_gather_uint(
        buf.ctypes.data, buf.nbytes, starts.ctypes.data, len(starts),
        width, out.ctypes.data, _NTHREADS,
    )
    if rc < 0:
        raise ValueError("gather_uint out of bounds")
    return out


def sort_rle_u64_segments(keys: np.ndarray, seg_offsets: np.ndarray):
    """Fused per-segment sort + run-length encode (threaded).
    Returns (uniq[u64], counts[int64]) over all segments in order.
    ``keys`` is sorted in place as a side effect."""
    lib = _load()
    keys = np.ascontiguousarray(keys, np.uint64)
    seg_offsets = np.ascontiguousarray(seg_offsets, np.int64)
    n = len(keys)
    uniq = np.empty(n, np.uint64)
    cnt = np.empty(n, np.int64)
    rstarts = np.zeros(_NTHREADS, np.int64)
    rcounts = np.zeros(_NTHREADS, np.int64)
    lib.radc_sort_rle_u64_segments(
        keys.ctypes.data, seg_offsets.ctypes.data, len(seg_offsets) - 1,
        uniq.ctypes.data, cnt.ctypes.data,
        rstarts.ctypes.data, rcounts.ctypes.data, _NTHREADS,
    )
    if _NTHREADS == 1 or rcounts[1:].sum() == 0:
        k = int(rcounts[0])
        return uniq[:k], cnt[:k]
    pieces_u = []
    pieces_c = []
    for t in range(_NTHREADS):
        s, c = int(rstarts[t]), int(rcounts[t])
        if c:
            pieces_u.append(uniq[s : s + c])
            pieces_c.append(cnt[s : s + c])
    return np.concatenate(pieces_u), np.concatenate(pieces_c)


def count_u64(keys: np.ndarray, cap_hint: int = 0):
    """Hash-based distinct counting.  Returns (uniq sorted, counts)."""
    lib = _load()
    keys = np.ascontiguousarray(keys, np.uint64)
    n = len(keys)
    cap = int(cap_hint) if cap_hint else n
    cap = max(cap, 1)
    uniq = np.empty(cap, np.uint64)
    cnt = np.empty(cap, np.uint64)
    k = lib.radc_count_u64(keys.ctypes.data, n, cap, uniq.ctypes.data,
                           cnt.ctypes.data)
    uniq, cnt = uniq[:k], cnt[:k]
    order = np.argsort(uniq)
    return uniq[order], cnt[order]


def collate_emit2(
    buf: np.ndarray,
    rec_starts: np.ndarray,
    num_aln: np.ndarray,
    corrected_bc: np.ndarray,
    order: np.ndarray,
    order_offsets: np.ndarray,
    out_offsets: np.ndarray,
    read_bytes: int,
    aln_bytes: int,
    bc_off: int,
    bc_width: int,
    ref_off: int,
    ori_mode: int,
) -> np.ndarray:
    """Threaded byte-level collated emit over precomputed per-chunk
    record ranges and output offsets.  Returns the output byte buffer."""
    lib = _load()
    out_cap = int(out_offsets[-1])
    out = np.empty(out_cap, np.uint8)
    buf = np.ascontiguousarray(buf)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    num_aln = np.ascontiguousarray(num_aln, np.int64)
    corrected_bc = np.ascontiguousarray(corrected_bc, np.uint64)
    order = np.ascontiguousarray(order, np.int64)
    order_offsets = np.ascontiguousarray(order_offsets, np.int64)
    out_offsets = np.ascontiguousarray(out_offsets, np.int64)
    rc = lib.radc_collate_emit2(
        buf.ctypes.data, buf.nbytes,
        rec_starts.ctypes.data, num_aln.ctypes.data,
        corrected_bc.ctypes.data,
        order.ctypes.data, order_offsets.ctypes.data,
        out_offsets.ctypes.data, len(order_offsets) - 1,
        read_bytes, aln_bytes, bc_off, bc_width, ref_off, ori_mode,
        out.ctypes.data, out_cap, _NTHREADS,
    )
    if rc < 0:
        raise ValueError("collate emit overran a buffer or sizes mismatched")
    return out


def extract_fields2(
    buf: np.ndarray,
    rec_starts: np.ndarray,
    num_aln: np.ndarray,
    read_widths,
    aln_widths,
    read_keep=None,
    aln_keep=None,
):
    """Threaded one-pass extraction of record fields into u64 columns.
    ``read_keep``/``aln_keep`` are optional per-field booleans; skipped
    fields come back as None (no memory traffic spent on them).
    Returns (read_cols list, aln_cols list)."""
    lib = _load()
    n = len(rec_starts)
    num_aln = np.ascontiguousarray(num_aln, np.int64)
    aln_offs = np.zeros(n + 1, np.int64)
    np.cumsum(num_aln, out=aln_offs[1:])
    total_aln = int(aln_offs[-1])
    if read_keep is None:
        read_keep = [True] * len(read_widths)
    if aln_keep is None:
        aln_keep = [True] * len(aln_widths)
    read_cols = [np.empty(n, np.uint64) if k else None for k in read_keep]
    aln_cols = [np.empty(total_aln, np.uint64) if k else None for k in aln_keep]
    rw = np.asarray(read_widths, np.int64)
    aw = np.asarray(aln_widths, np.int64)
    buf = np.ascontiguousarray(buf)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    rc = lib.radc_extract_fields2(
        buf.ctypes.data, buf.nbytes,
        rec_starts.ctypes.data, n, num_aln.ctypes.data, aln_offs.ctypes.data,
        rw.ctypes.data, len(rw), aw.ctypes.data, len(aw),
        _col_ptrs(read_cols), _col_ptrs(aln_cols), _NTHREADS,
    )
    if rc < 0:
        raise ValueError("field extraction overran the buffer")
    return read_cols, aln_cols


def lookup_u64(keys: np.ndarray, vals: np.ndarray, queries: np.ndarray):
    """Batched u64 hash-map lookup.  Returns (hit[bool], mapped[u64])."""
    lib = _load()
    keys = np.ascontiguousarray(keys, np.uint64)
    vals = np.ascontiguousarray(vals, np.uint64)
    queries = np.ascontiguousarray(queries, np.uint64)
    hit = np.empty(len(queries), np.uint8)
    out = np.empty(len(queries), np.uint64)
    lib.radc_lookup_u64(
        keys.ctypes.data, vals.ctypes.data, len(keys),
        queries.ctypes.data, len(queries),
        hit.ctypes.data, out.ctypes.data,
    )
    return hit.view(bool), out


def format_f32(vals: np.ndarray) -> list:
    """Format f32 values Rust-Display-style (shortest round-trip,
    positional). Returns a list of str, one per value."""
    lib = _load()
    vals = np.ascontiguousarray(vals, np.float32)
    n = len(vals)
    if n == 0:
        return []
    out = np.empty(n * 64, np.uint8)
    ln = lib.radc_format_f32(vals.ctypes.data, n, out.ctypes.data)
    return out[: ln - 1].tobytes().decode().split("\n")


def scan_names(buf: np.ndarray, count: int):
    """Scan a [len:u16|utf8]*count name region.  Returns
    (region_nbytes, starts[int64 count+1]) or (-1, starts) when the
    buffer ends mid-region (read more and retry)."""
    lib = _load()
    starts = np.empty(count + 1, np.int64)
    n = lib.radc_scan_names(
        buf.ctypes.data, len(buf), count, starts.ctypes.data
    )
    return int(n), starts


def format_triplets(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> bytes:
    """Format integer COO triplets as 'r c v\\n' lines natively."""
    lib = _load()
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.int64)
    n = len(rows)
    out = np.empty(max(n, 1) * 62, np.uint8)
    ln = lib.radc_format_triplets(
        rows.ctypes.data, cols.ctypes.data, vals.ctypes.data, n,
        out.ctypes.data,
    )
    return out[:ln].tobytes()


def encode_records_native(
    out_buf: np.ndarray,
    rec_starts: np.ndarray,
    num_aln: np.ndarray,
    read_widths,
    aln_widths,
    read_cols,
    aln_cols,
) -> None:
    """Encode columnar records into ``out_buf`` at ``rec_starts``."""
    lib = _load()
    rw = np.asarray(read_widths, np.int64)
    aw = np.asarray(aln_widths, np.int64)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    num_aln = np.ascontiguousarray(num_aln, np.int64)
    read_cols = [np.ascontiguousarray(c, np.uint64) for c in read_cols]
    aln_cols = [np.ascontiguousarray(c, np.uint64) for c in aln_cols]
    rc = lib.radc_encode_records(
        out_buf.ctypes.data, out_buf.nbytes,
        rec_starts.ctypes.data, len(rec_starts), num_aln.ctypes.data,
        rw.ctypes.data, len(rw), aw.ctypes.data, len(aw),
        _col_ptrs(read_cols), _col_ptrs(aln_cols),
    )
    if rc < 0:
        raise ValueError("record encoding overran the buffer")


def format_bed(
    ref_names, chrs, starts, ends, bcs, bc_len: int, counts, n_threads: int = 1
) -> bytes:
    """Render ``chr\tstart\tend\tbarcode\tcount`` BED rows natively;
    ``ref_names`` is a sequence of str."""
    lib = _load()
    encoded = [s.encode() for s in ref_names]
    name_offs = np.zeros(len(encoded) + 1, np.int64)
    np.cumsum([len(s) for s in encoded], out=name_offs[1:])
    name_bytes = b"".join(encoded)
    nb = np.frombuffer(name_bytes, np.uint8) if name_bytes else np.zeros(1, np.uint8)
    chrs = np.ascontiguousarray(chrs, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    ends = np.ascontiguousarray(ends, np.int64)
    bcs = np.ascontiguousarray(bcs, np.uint64)
    counts = np.ascontiguousarray(counts, np.int64)
    n = len(chrs)
    max_name = int(np.diff(name_offs).max()) if len(encoded) else 0
    out = np.empty(n * (max_name + bc_len + 65), np.uint8)
    w = lib.radc_format_bed(
        nb.ctypes.data, name_offs.ctypes.data,
        chrs.ctypes.data, starts.ctypes.data, ends.ctypes.data,
        bcs.ctypes.data, bc_len, counts.ctypes.data, n,
        out.ctypes.data, n_threads,
    )
    return out[:w].tobytes()


def gather_records(
    buf: np.ndarray, rec_starts: np.ndarray, sizes: np.ndarray,
    order: np.ndarray, dst_off: np.ndarray, out: np.ndarray,
) -> None:
    """``out[dst_off[i]:][:sizes[order[i]]]`` = the bytes of record
    ``order[i]`` (threaded memcpy gather)."""
    lib = _load()
    # locals keep every converted buffer alive through the call
    buf = np.ascontiguousarray(buf, np.uint8)
    rec_starts = np.ascontiguousarray(rec_starts, np.int64)
    sizes = np.ascontiguousarray(sizes, np.int64)
    order = np.ascontiguousarray(order, np.int64)
    dst_off = np.ascontiguousarray(dst_off, np.int64)
    lib.radc_gather_records(
        buf.ctypes.data, rec_starts.ctypes.data, sizes.ctypes.data,
        order.ctypes.data, len(order), dst_off.ctypes.data, out.ctypes.data,
        _NTHREADS,
    )


def _bytes_view(data) -> np.ndarray:
    arr = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    return np.ascontiguousarray(arr, np.uint8)


def crc32c(data, init: int = 0) -> int:
    """CRC-32C (Castagnoli) of a byte buffer."""
    lib = _load()
    arr = _bytes_view(data)
    return int(lib.radc_crc32c(arr.ctypes.data, arr.nbytes, init))


def snappy_compress(data) -> bytes:
    """One snappy block of ``data`` (the framing splits the stream into
    chunks of at most 64 KiB)."""
    lib = _load()
    arr = _bytes_view(data)
    out = np.empty(int(lib.radc_snappy_max_compressed(arr.nbytes)), np.uint8)
    n = lib.radc_snappy_compress(arr.ctypes.data, arr.nbytes, out.ctypes.data)
    return out[:n].tobytes()


def snappy_uncompress(data, max_out: int) -> bytes:
    """Decode one snappy block of at most ``max_out`` bytes."""
    lib = _load()
    arr = _bytes_view(data)
    out = np.empty(max_out, np.uint8)
    n = lib.radc_snappy_uncompress(arr.ctypes.data, arr.nbytes, out.ctypes.data, max_out)
    if n < 0:
        raise ValueError("malformed snappy block")
    return out[:n].tobytes()
