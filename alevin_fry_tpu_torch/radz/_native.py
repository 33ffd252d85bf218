"""ctypes bindings for the native RAD codec (``csrc/libradc.so``, built
from ``csrc/radc.cpp`` with ``make -C csrc``).

The only inherently sequential part of RAD decoding is walking the
variable-length record boundaries (each record's size depends on its
``num_aln`` field).  That walk, field extraction, the collated emit and
the text formatting of the outputs run here in C++.  The library is
required: the port has no other path for these operations, and
:func:`load` raises ``RuntimeError`` when it does not open.  Only the
entry points the port calls are bound.
"""

from __future__ import annotations

import ctypes
import os
import time
from pathlib import Path

import numpy as np

_LIB = None


def _find_lib():
    here = Path(__file__).resolve().parent.parent.parent
    for cand in (here / "csrc" / "libradc.so", here / "libradc.so"):
        if cand.exists():
            return str(cand)
    env = os.environ.get("AFT_RADC_LIB")
    if env and os.path.exists(env):
        return env
    return None


# The reference package's loader (alevin_fry_tpu/radz/_native.py)
# rebuilds csrc/libradc.so in place whenever radc.cpp is newer, and
# several processes may do so at once.  The linker unlinks the file and
# writes a new one, so a process that opens the library meanwhile finds
# a short file.  A failed open is retried for up to ten seconds.
_OPEN_ATTEMPTS, _OPEN_WAIT_S = 40, 0.25


def _open(path: str) -> ctypes.CDLL:
    """dlopen ``path``, waiting out a rewrite of the file in progress;
    raises OSError if it still does not load."""
    for _ in range(_OPEN_ATTEMPTS - 1):
        try:
            return ctypes.CDLL(path)
        except OSError:
            time.sleep(_OPEN_WAIT_S)
    return ctypes.CDLL(path)


def load() -> ctypes.CDLL:
    """The bound library, opened on the first call; raises
    ``RuntimeError`` naming the file when it does not load."""
    global _LIB
    if _LIB is not None:
        return _LIB
    path = _find_lib()
    if path is None:
        raise RuntimeError("the native RAD codec csrc/libradc.so was not found "
                           "(nor AFT_RADC_LIB); the port cannot run without it")
    try:
        lib = _open(path)
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
        lib.radc_format_triplets_f32.restype = ctypes.c_int64
        lib.radc_format_triplets_f32.argtypes = [
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
        lib.radc_sort_u64_segments.restype = None
        lib.radc_sort_u64_segments.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # keys, seg_offsets
            ctypes.c_int64, ctypes.c_int32,    # n_segs, n_threads
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
        lib.radc_pug_graph_build.restype = ctypes.c_void_p
        lib.radc_pug_graph_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64,   # cell_read_offsets, n_cells
            ctypes.c_void_p, ctypes.c_void_p,  # umi, refs
            ctypes.c_void_p, ctypes.c_void_p,  # aln_offsets, tid_to_gid
            ctypes.c_int32, ctypes.c_int32,    # gene_level, exact
            ctypes.c_void_p, ctypes.c_void_p,  # n_nodes, sym_entries
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_pug_graph_export.restype = None
        lib.radc_pug_graph_export.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.radc_pug_cover.restype = ctypes.c_int64
        lib.radc_pug_cover.argtypes = [
            ctypes.c_void_p,                   # handle
            ctypes.c_void_p, ctypes.c_int64,   # cell_read_offsets, n_cells
            ctypes.c_void_p, ctypes.c_void_p,  # aln_offsets, tid_to_gid
            ctypes.c_int32, ctypes.c_int64,    # gene_level, large_thresh
            ctypes.c_void_p,                   # comp_labels
            ctypes.c_void_p, ctypes.c_void_p,  # n_eqc, used_alt
            ctypes.c_void_p, ctypes.c_void_p,  # counts_out, lens_out
            ctypes.c_void_p,                   # labels_out
            ctypes.c_void_p, ctypes.c_void_p,  # range_info, label_counts
            ctypes.c_int32,                    # n_threads
        ]
        lib.radc_pug_free.restype = None
        lib.radc_pug_free.argtypes = [ctypes.c_void_p]
        lib.radc_gather_records.restype = None
        lib.radc_gather_records.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,  # buf, rec_starts
            ctypes.c_void_p, ctypes.c_void_p,  # sizes, order
            ctypes.c_int64, ctypes.c_void_p,   # n, dst_off
            ctypes.c_void_p, ctypes.c_int32,   # out, n_threads
        ]
        lib.radc_intern_label_sets.restype = ctypes.c_int64
        lib.radc_intern_label_sets.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # labels, offsets, n_sets
            ctypes.c_void_p, ctypes.c_void_p,  # ids_out, rep_out
        ]
        lib.radc_format_eqc_rows.restype = ctypes.c_int64
        lib.radc_format_eqc_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.radc_bam_scan.restype = ctypes.c_int64
        lib.radc_bam_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # buf, len, qname_state
            ctypes.c_void_p, ctypes.c_void_p,  # flags, tid
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bc, bclen, bc_valid
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # umi, umilen, umi_valid
            ctypes.c_void_p, ctypes.c_void_p,  # as, same_qname
            ctypes.c_void_p, ctypes.c_int64,   # bytes_consumed, max_recs
        ]
        lib.radc_bgzf_inflate.restype = ctypes.c_int64
        lib.radc_bgzf_inflate.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # buf, offs, lens
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out_offs, isizes, crcs
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,    # n_blocks, out, n_threads
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
    except OSError as err:
        raise RuntimeError(f"the native RAD codec csrc/libradc.so did not load "
                           f"from {path}: {err}") from err
    _LIB = lib
    return lib


def walk_records(
    buf: np.ndarray,
    region_starts: np.ndarray,
    region_counts: np.ndarray,
    read_bytes: int,
    aln_bytes: int,
):
    lib = load()
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
    lib = load()
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
    lib = load()
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


def sort_u64_segments(keys: np.ndarray, seg_offsets: np.ndarray) -> np.ndarray:
    """Sort u64 ``keys`` in place within each ``[seg_offsets[i],
    seg_offsets[i+1])`` segment (threaded).  Returns ``keys``."""
    lib = load()
    keys = np.ascontiguousarray(keys, np.uint64)
    seg_offsets = np.ascontiguousarray(seg_offsets, np.int64)
    lib.radc_sort_u64_segments(
        keys.ctypes.data, seg_offsets.ctypes.data, len(seg_offsets) - 1, _NTHREADS,
    )
    return keys


def sort_rle_u64_segments(keys: np.ndarray, seg_offsets: np.ndarray):
    """Fused per-segment sort + run-length encode (threaded).
    Returns (uniq[u64], counts[int64]) over all segments in order.
    ``keys`` is sorted in place as a side effect."""
    lib = load()
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
    lib = load()
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
    lib = load()
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
    lib = load()
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
    lib = load()
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
    lib = load()
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
    lib = load()
    starts = np.empty(count + 1, np.int64)
    n = lib.radc_scan_names(
        buf.ctypes.data, len(buf), count, starts.ctypes.data
    )
    return int(n), starts


def format_triplets(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> bytes:
    """Format integer COO triplets as 'r c v\\n' lines natively."""
    lib = load()
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


def format_triplets_f32(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> bytes:
    """Format f32 COO triplets as 'r c v\\n' lines natively: values that
    are exact integers print as integers, the rest as Rust's Display
    prints an f32."""
    lib = load()
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float32)
    n = len(rows)
    out = np.empty(max(n, 1) * 105, np.uint8)
    ln = lib.radc_format_triplets_f32(
        rows.ctypes.data, cols.ctypes.data, vals.ctypes.data, n, out.ctypes.data,
    )
    return out[:ln].tobytes()


def intern_label_sets(labels: np.ndarray, offsets: np.ndarray):
    """Number variable-length u64 label sets in order of first
    appearance.  Returns (id per set, index of each id's first set)."""
    lib = load()
    labels = np.ascontiguousarray(labels, np.uint64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n_sets = len(offsets) - 1
    ids = np.empty(n_sets, np.int64)
    rep = np.empty(max(n_sets, 1), np.int64)
    n_uniq = lib.radc_intern_label_sets(
        labels.ctypes.data, offsets.ctypes.data, n_sets, ids.ctypes.data, rep.ctypes.data,
    )
    return ids, rep[:n_uniq]


def format_eqc_rows(vals: np.ndarray, offsets: np.ndarray) -> bytes:
    """Render one '<v0>\\t<v1>...\\t<row>\\n' line per offsets segment."""
    lib = load()
    vals = np.ascontiguousarray(vals, np.uint64)
    offsets = np.ascontiguousarray(offsets, np.int64)
    n_rows = len(offsets) - 1
    out = np.empty(21 * len(vals) + 22 * max(n_rows, 1), np.uint8)
    w = lib.radc_format_eqc_rows(vals.ctypes.data, offsets.ctypes.data, n_rows, out.ctypes.data)
    return out[:w].tobytes()


def pug_graph_build(
    cell_read_offsets: np.ndarray,
    umi: np.ndarray,
    refs: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    gene_level: bool,
    exact: bool,
):
    """Build every cell's PUG natively and export the symmetrized
    adjacency.  Returns (handle, nodes per cell [int64], degree per node
    [int64], neighbours [int32, cell-local ids]); the handle goes to
    :func:`pug_cover`, then to :func:`pug_free`."""
    lib = load()
    cell_read_offsets = np.ascontiguousarray(cell_read_offsets, np.int64)
    umi = np.ascontiguousarray(umi, np.uint64)
    refs = np.ascontiguousarray(refs, np.uint32)
    aln_offsets = np.ascontiguousarray(aln_offsets, np.int64)
    tid_to_gid = np.ascontiguousarray(tid_to_gid, np.uint32)
    n_cells = len(cell_read_offsets) - 1
    n_nodes = np.zeros(max(n_cells, 1), np.int64)
    sym_entries = np.zeros(max(n_cells, 1), np.int64)
    handle = lib.radc_pug_graph_build(
        cell_read_offsets.ctypes.data, n_cells,
        umi.ctypes.data, refs.ctypes.data,
        aln_offsets.ctypes.data, tid_to_gid.ctypes.data,
        1 if gene_level else 0, 1 if exact else 0,
        n_nodes.ctypes.data, sym_entries.ctypes.data, _NTHREADS,
    )
    total_nodes = int(n_nodes[:n_cells].sum())
    total_entries = int(sym_entries[:n_cells].sum())
    deg = np.zeros(max(total_nodes, 1), np.int64)
    nbrs = np.zeros(max(total_entries, 1), np.int32)
    lib.radc_pug_graph_export(handle, deg.ctypes.data, nbrs.ctypes.data)
    return handle, n_nodes[:n_cells], deg[:total_nodes], nbrs[:total_entries]


def pug_cover(
    handle,
    cell_read_offsets: np.ndarray,
    aln_offsets: np.ndarray,
    tid_to_gid: np.ndarray,
    gene_level: bool,
    large_thresh: int,
    comp_labels: np.ndarray,
):
    """Finish the PUG resolution from per-node component labels: the
    greedy cover, or the cr-like fallback for a component larger than
    ``large_thresh``.  Returns (classes per cell, whether each cell took
    the fallback, class counts, class label lengths, flat labels)."""
    lib = load()
    cell_read_offsets = np.ascontiguousarray(cell_read_offsets, np.int64)
    aln_offsets = np.ascontiguousarray(aln_offsets, np.int64)
    tid_to_gid = np.ascontiguousarray(tid_to_gid, np.uint32)
    comp_labels = np.ascontiguousarray(comp_labels, np.int32)
    n_cells = len(cell_read_offsets) - 1
    n_reads = int(cell_read_offsets[-1]) if n_cells >= 0 else 0
    n_aln = int(aln_offsets[-1]) if len(aln_offsets) else 0
    n_eqc = np.zeros(max(n_cells, 1), np.int64)
    used_alt = np.zeros(max(n_cells, 1), np.uint8)
    counts = np.empty(max(n_reads, 1), np.int64)
    lens = np.empty(max(n_reads, 1), np.int64)
    labels = np.empty(max(n_aln, 1), np.uint32)
    range_info = np.zeros((_NTHREADS, 4), np.int64)
    label_counts = np.zeros(_NTHREADS, np.int64)
    lib.radc_pug_cover(
        handle, cell_read_offsets.ctypes.data, n_cells,
        aln_offsets.ctypes.data, tid_to_gid.ctypes.data,
        1 if gene_level else 0, large_thresh, comp_labels.ctypes.data,
        n_eqc.ctypes.data, used_alt.ctypes.data,
        counts.ctypes.data, lens.ctypes.data, labels.ctypes.data,
        range_info.ctypes.data, label_counts.ctypes.data, _NTHREADS,
    )
    # each thread wrote its cells' classes at its own offsets
    pieces_c, pieces_l, pieces_lab = [], [], []
    for t in range(_NTHREADS):
        _c0, rb, lb, ne = (int(x) for x in range_info[t])
        lc = int(label_counts[t])
        if ne:
            pieces_c.append(counts[rb : rb + ne])
            pieces_l.append(lens[rb : rb + ne])
        if lc:
            pieces_lab.append(labels[lb : lb + lc])
    cat = lambda ps, dt: np.concatenate(ps) if ps else np.zeros(0, dt)  # noqa: E731
    return (
        n_eqc[:n_cells],
        used_alt[:n_cells].view(bool),
        cat(pieces_c, np.int64),
        cat(pieces_l, np.int64),
        cat(pieces_lab, np.uint32),
    )


def pug_free(handle) -> None:
    load().radc_pug_free(handle)


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
    lib = load()
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
    lib = load()
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
    lib = load()
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
    lib = load()
    arr = _bytes_view(data)
    return int(lib.radc_crc32c(arr.ctypes.data, arr.nbytes, init))


def snappy_compress(data) -> bytes:
    """One snappy block of ``data`` (the framing splits the stream into
    chunks of at most 64 KiB)."""
    lib = load()
    arr = _bytes_view(data)
    out = np.empty(int(lib.radc_snappy_max_compressed(arr.nbytes)), np.uint8)
    n = lib.radc_snappy_compress(arr.ctypes.data, arr.nbytes, out.ctypes.data)
    return out[:n].tobytes()


def snappy_uncompress(data, max_out: int) -> bytes:
    """Decode one snappy block of at most ``max_out`` bytes."""
    lib = load()
    arr = _bytes_view(data)
    out = np.empty(max_out, np.uint8)
    n = lib.radc_snappy_uncompress(arr.ctypes.data, arr.nbytes, out.ctypes.data, max_out)
    if n < 0:
        raise ValueError("malformed snappy block")
    return out[:n].tobytes()


def bgzf_inflate(buf: np.ndarray, offs: np.ndarray, lens: np.ndarray, out_offs: np.ndarray,
                 isizes: np.ndarray, out: np.ndarray, crcs: np.ndarray) -> None:
    """Inflate BGZF member payloads (raw deflate, ``buf[offs[i]:][:lens[i]]``
    into ``out[out_offs[i]:][:isizes[i]]``) on the thread pool, checking
    each member's size and CRC32 trailer; raises ValueError on a corrupt
    member."""
    lib = load()
    crcs = np.ascontiguousarray(crcs, np.uint32)
    rc = lib.radc_bgzf_inflate(
        np.ascontiguousarray(buf, np.uint8).ctypes.data,
        np.ascontiguousarray(offs, np.int64).ctypes.data,
        np.ascontiguousarray(lens, np.int64).ctypes.data,
        np.ascontiguousarray(out_offs, np.int64).ctypes.data,
        np.ascontiguousarray(isizes, np.int64).ctypes.data,
        crcs.ctypes.data, len(offs), out.ctypes.data, _NTHREADS,
    )
    if rc != 0:
        raise ValueError(f"corrupt BGZF block at index {-rc - 1}")


def bam_scan(buf, qname_state: np.ndarray):
    """Scan the complete BAM records in ``buf``; returns (columns,
    bytes consumed).  ``qname_state`` (258 bytes, zero before the first
    call) carries the last kept record's qname from call to call.
    Raises ValueError on a structurally invalid record."""
    lib = load()
    arr = np.ascontiguousarray(np.frombuffer(buf, np.uint8))
    n_max = arr.nbytes // 36 + 1  # a record takes at least 36 bytes
    cols = {
        "flags": np.empty(n_max, np.uint16), "tid": np.empty(n_max, np.int32),
        "bc": np.empty(n_max, np.uint64), "bclen": np.empty(n_max, np.int32),
        "bc_valid": np.empty(n_max, np.uint8), "umi": np.empty(n_max, np.uint64),
        "umilen": np.empty(n_max, np.int32), "umi_valid": np.empty(n_max, np.uint8),
        "as": np.empty(n_max, np.int32), "same_qname": np.empty(n_max, np.uint8),
    }
    consumed = np.zeros(1, np.int64)
    n = lib.radc_bam_scan(
        arr.ctypes.data, arr.nbytes, qname_state.ctypes.data,
        *(cols[k].ctypes.data for k in ("flags", "tid", "bc", "bclen", "bc_valid", "umi",
                                         "umilen", "umi_valid", "as", "same_qname")),
        consumed.ctypes.data, n_max,
    )
    if n < 0:
        raise ValueError("structurally invalid BAM record")
    cols = {k: v[:n] for k, v in cols.items()}
    for k in ("bc_valid", "umi_valid", "same_qname"):
        cols[k] = cols[k] != 0
    return cols, int(consumed[0])
