"""collate: group reads by corrected cell barcode (port of
``alevin_fry_tpu/pipeline/collate.py``, single host).

Barcodes correct through the permit map; alignments off the expected
orientation drop, and reads left without alignments drop.  The
surviving reads are ordered by cell rank (cells by descending read
count, src/collate.rs:180-182) with a stable ``torch.sort`` on the
chosen device.  The byte-level path then gathers whole records with
the native codec; on a schema it refuses (no ref field, or a strand
filter on a ref field other than 4 bytes wide), a columnar path
decodes, reorders and re-encodes the records instead.

When the records exceed ``--max-records`` the collation goes out of
core (src/collate.rs:584-905): corrected records spill to buckets of
consecutive cell ranks, each at most ``max_records`` records, and each
bucket is then ordered on the device and gathered byte-wise.  The ATAC
collation (``atac/collate.py``) shares the byte-level and out-of-core
paths, keyed by barcode alone.

Writes the reference's artifacts: ``map.collated.rad`` (one chunk per
cell), ``unmapped_bc_count_collated.bin`` and ``collate.json``.  With
``-c`` the collated file is ``map.collated.rad.sz`` instead, the same
bytes as one snappy framing stream (``radz/snappyz.py``).  A
velocity-mode directory (``velo_mode`` in its gpl JSON) names the
collated file ``velo.map.collated.rad``, with ``-c`` too (then it holds
the snappy stream), as the reference does; quant refuses such a
directory.  A compressed stream cannot be seeked back into, so every
path knows its chunk count before it writes the header: the cells that
kept a read.  A multi-barcode (Flex) input goes through
``pipeline/collate_multi.py``, which shares the ordering, the spill
buckets and their gather; it and ATAC keep ``map.collated.rad``.

A multi-process run (``parallel/dist.py``) always takes the out-of-core
path: each rank scatters its contiguous range of the RAD chunks into
spill buckets of its own (``_collate_tmp_r<rank>``), and each bucket's
records and ranks are gathered over collectives in rank order, which is
the file's chunk order, so rank 0's stable ordering of the bucket writes
the one-process bytes.  Rank 0 writes every artifact.
"""

from __future__ import annotations

import contextlib
import io
import json
from pathlib import Path
from typing import Tuple

import numpy as np
import torch

from ..radz import (
    KnownRecordType, bincodeio, read_prelude, record_type_from_prelude,
)
from ..radz import _native
from ..radz import unmapped as unmappedio
from ..radz.chunkio import (
    ReadBatch, decode_all_chunks, encode_records, iter_decoded_blocks, read_chunk_bodies,
    write_cell_chunks,
)
from ..radz.records import RecordSchema
from ..radz.snappyz import SnappyFrameReader, SnappyFrameWriter

from .. import __version__, spans
from ..parallel import dist
from ..utils import aln_strand_mask, check_version_compat, record_layout, write_json
from .logging_ import get_logger
from .progress import Progress

log = get_logger("collate")

# reads per streamed block of the out-of-core scatter; smaller than a
# spill bucket, so decoding stays light while buckets stay large
COLLATE_BLOCK_RECORDS = 4_000_000


def correct_and_filter(
    batch: ReadBatch, map_keys: np.ndarray, map_vals: np.ndarray, expected_ori: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Correct barcodes and filter alignments by orientation ->
    (corrected barcode per read, kept-read mask, kept-alignment mask,
    alignment offsets of the kept reads)."""
    hit, corrected = _native.lookup_u64(map_keys, map_vals, batch.barcode())
    keep_aln = aln_strand_mask(batch.dirs, expected_ori)
    n = batch.n_reads
    kept_per_read = (
        np.add.reduceat(keep_aln.astype(np.int64), batch.aln_offsets[:-1])
        if n else np.zeros(0, np.int64)
    )
    kept_per_read[np.diff(batch.aln_offsets) == 0] = 0
    keep_read = hit & (kept_per_read > 0)
    read_of_aln = np.repeat(np.arange(n), batch.num_aln_per_read)
    keep_aln_final = keep_aln & keep_read[read_of_aln]
    new_offsets = np.zeros(int(keep_read.sum()) + 1, np.int64)
    np.cumsum(kept_per_read[keep_read], out=new_offsets[1:])
    return corrected, keep_read, keep_aln_final, new_offsets


def collation_order(ranks: np.ndarray, n_cells: int, device: torch.device):
    """Stable order of reads by cell rank, and reads per cell: a stable
    sort on ``device``."""
    r = torch.from_numpy(np.ascontiguousarray(ranks, np.int64)).to(device)
    order = torch.sort(r, stable=True).indices
    per_cell = torch.bincount(r, minlength=n_cells)
    both = torch.cat([order, per_cell]).cpu().numpy()
    return both[: len(ranks)], both[len(ranks):]


@contextlib.contextmanager
def _collated_writer(input_dir: Path, compress_out: bool, velo_mode: bool = False):
    """A sink for the collated file's bytes: ``map.collated.rad``, or
    with ``compress_out`` a snappy framing stream into
    ``map.collated.rad.sz``; in ``velo_mode`` either goes to
    ``velo.map.collated.rad``.  Open inside a ``write`` span, which
    counts the file's bytes."""
    path = input_dir / ("velo.map.collated.rad" if velo_mode
                        else "map.collated.rad.sz" if compress_out else "map.collated.rad")
    with spans.span("write", "codec"):
        with open(path, "wb") as fh:
            if compress_out:
                frames = SnappyFrameWriter(fh)
                yield frames
                frames.flush()
            else:
                yield fh
        spans.wrote(path)


@contextlib.contextmanager
def open_collated(input_dir: Path):
    """Open the collated RAD file of ``input_dir`` past its prelude:
    yields (file, prelude, file tag values).  ``collate.json`` says
    whether it is ``map.collated.rad`` or the snappy stream
    ``map.collated.rad.sz``, which decompresses as it is read."""
    with open(input_dir / "collate.json") as fh:
        compressed = bool(json.load(fh)["compressed_output"])
    if compressed:
        br = SnappyFrameReader(open(input_dir / "map.collated.rad.sz", "rb"))
    else:
        br = open(input_dir / "map.collated.rad", "rb")
    with br:
        prelude, ftm, _ = read_prelude(br)
        if compressed:
            # the prelude parser reads ahead and seeks back; past it the
            # stage reads forward only, so the decoded bytes can go
            br.drop_history()
        yield br, prelude, ftm


def _prelude_bytes(prelude, ftm, num_chunks: int) -> bytes:
    """The collated file's header and file tag values, holding its
    chunk count."""
    prelude.hdr.num_chunks = num_chunks
    head = io.BytesIO()
    prelude.write(head)
    prelude.write_file_tag_values(head, ftm)
    return head.getvalue()


def _check_record_type(prelude, ftm, expect_atac: bool = False) -> None:
    rec_type, _info = record_type_from_prelude(prelude, ftm)
    if (rec_type == KnownRecordType.ATAC) != expect_atac:
        raise ValueError(
            'To process atac-seq data, you should use the "atac" sub-command'
            if rec_type == KnownRecordType.ATAC
            else "the atac collate sub-command requires an ATAC RAD file"
        )


def _collate_in_memory_native(
    input_dir, rad_dir, cell_bcs, cell_cts, map_keys, map_vals, expected_ori,
    device, compress_out: bool, expect_atac: bool = False, velo_mode: bool = False,
) -> bool:
    """Byte-level collation: walk record boundaries, correct barcodes,
    then gather whole records in cell-rank order with the barcode
    patched in place and alignments orientation-filtered, in one native
    pass.  Returns False when the schema is not eligible.  The ATAC
    collation (``expect_atac``, ``expected_ori='.'``) is the same
    gather keyed by barcode alone (atac/collate.rs:586-595)."""
    with open(rad_dir / "map.rad", "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        _check_record_type(prelude, ftm, expect_atac)
        schema = RecordSchema.from_prelude(prelude)
        ori_mode = {"both": 0, ".": 0, "fw": 1, "+": 1, "rc": 2, "-": 2}.get(expected_ori)
        if ori_mode is None or schema.ref_field is None:
            return False
        if ori_mode != 0 and dict(schema.aln_fields)[schema.ref_field] != 4:
            return False
        bc_off, bc_width, ref_off = record_layout(schema)
        # ATAC headers may hold num_chunks = 0 (atac/collate.rs:212):
        # None streams to EOF
        buf, region_starts, chunk_recs = read_chunk_bodies(fh, prelude.hdr.num_chunks or None)
    with spans.span("decode", "codec"):
        rec_starts, num_aln = _native.walk_records(
            buf, region_starts, chunk_recs, schema.read_bytes, schema.aln_bytes
        )
        n = len(rec_starts)
        spans.add("records", n)
        bcs = _native.gather_uint(buf, rec_starts + 4 + bc_off, bc_width)
        if ori_mode == 0:
            kept_per_read = num_aln
        else:
            kept_per_read = _native.ori_counts(
                buf, rec_starts, num_aln, schema.read_bytes, schema.aln_bytes,
                ref_off, ori_mode,
            )
    log.info(
        "collating %d reads across %d chunks into %d cells",
        n, len(chunk_recs), len(cell_bcs),
    )
    with spans.span("map_lookup", "resolution"):
        # one lookup per read: remap the correction map's values to cell
        # ranks up front, so the map yields the rank directly
        sort_perm = np.argsort(cell_bcs, kind="stable")
        cell_sorted = cell_bcs[sort_perm]
        mpos = np.minimum(np.searchsorted(cell_sorted, map_vals), len(cell_sorted) - 1)
        # an explicit permit list (-b) may name barcodes that no read with
        # an alignment of the expected orientation carries; they are not
        # cells, and the reads their map entries correct are dropped
        # below, so the entries leave the lookup (the columnar path never
        # looks them up)
        is_cell = cell_sorted[mpos] == map_vals
        hit, rank = _native.lookup_u64(map_keys[is_cell],
                                       sort_perm[mpos[is_cell]].astype(np.uint64), bcs)
        kept_idx = np.flatnonzero(hit & (kept_per_read > 0))
        corrected = (
            cell_bcs[np.where(hit, rank, 0).astype(np.int64)]
            if len(cell_bcs) else np.zeros(n, np.uint64)
        )
    with spans.span("order", "resolution"):
        order_rel, per_cell = collation_order(
            rank[kept_idx].astype(np.int64), len(cell_bcs), device
        )
        order = kept_idx[order_rel]
        # record sizes are known from the kept-alignment counts, so every
        # chunk's output offset is exact and the native gather runs threaded
        order_offsets = np.zeros(len(per_cell) + 1, np.int64)
        np.cumsum(per_cell, out=order_offsets[1:])
        sizes = 4 + schema.read_bytes + kept_per_read[order] * schema.aln_bytes
        szsum = np.zeros(len(order) + 1, np.int64)
        np.cumsum(sizes, out=szsum[1:])
        chunk_bytes = (
            szsum[order_offsets[1:]] - szsum[order_offsets[:-1]] + 8 * (per_cell > 0)
        )
        out_offsets = np.zeros(len(per_cell) + 1, np.int64)
        np.cumsum(chunk_bytes, out=out_offsets[1:])
    if not np.array_equal(per_cell, cell_cts.astype(np.int64)):
        log.warning(
            "per-cell collated record counts differ from permit_freq counts "
            "(total %d vs %d)", int(per_cell.sum()), int(cell_cts.sum()),
        )
    with spans.span("emit", "codec"):
        body = _native.collate_emit2(
            buf, rec_starts, num_aln, corrected, order, order_offsets, out_offsets,
            schema.read_bytes, schema.aln_bytes, bc_off, bc_width, ref_off, ori_mode,
        )
    n_written = int((per_cell > 0).sum())
    with _collated_writer(input_dir, compress_out, velo_mode) as out:
        out.write(_prelude_bytes(prelude, ftm, n_written))
        out.write(memoryview(body.data))
    log.info("finished collating input rad file; wrote %d cell chunks", n_written)
    return True


def _collate_columnar(
    input_dir, rad_dir, cell_bcs, cell_cts, map_keys, map_vals, expected_ori,
    device, compress_out: bool, expect_atac: bool = False, velo_mode: bool = False,
) -> None:
    """Columnar collation: decode every record, reorder the columns by
    cell rank, re-encode one chunk per cell.  Reads left without
    alignments drop, as in the byte-level path."""
    with open(rad_dir / "map.rad", "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        _check_record_type(prelude, ftm, expect_atac)
        schema = RecordSchema.from_prelude(prelude)
        batch = decode_all_chunks(fh, schema, prelude.hdr.num_chunks or None)
    log.info(
        "collating %d reads across %d chunks into %d cells",
        batch.n_reads, prelude.hdr.num_chunks, len(cell_bcs),
    )
    with spans.span("map_lookup", "resolution"):
        corrected, keep_read, keep_aln, new_offsets = correct_and_filter(
            batch, map_keys, map_vals, expected_ori
        )
        sort_perm = np.argsort(cell_bcs, kind="stable")
        cell_sorted = cell_bcs[sort_perm]
        kept_bcs = corrected[keep_read]
        pos = np.searchsorted(cell_sorted, kept_bcs)
        if not (cell_sorted[np.minimum(pos, len(cell_sorted) - 1)] == kept_bcs).all():
            raise ValueError("corrected barcode missing from permit list")
        rank = sort_perm[pos]
    with spans.span("order", "resolution"):
        sort_idx, per_cell = collation_order(rank, len(cell_bcs), device)
    if not np.array_equal(per_cell, cell_cts.astype(np.int64)):
        log.warning(
            "per-cell collated record counts differ from permit_freq counts "
            "(total %d vs %d)", int(per_cell.sum()), int(cell_cts.sum()),
        )
    n_written = write_collated(
        input_dir, compress_out, prelude, ftm, batch, np.flatnonzero(keep_read),
        {schema.barcode_fields[-1]: corrected[keep_read]}, np.diff(new_offsets), keep_aln,
        sort_idx, per_cell, velo_mode,
    )
    log.info("finished collating input rad file; wrote %d cell chunks", n_written)


def write_collated(input_dir, compress_out: bool, prelude, ftm, batch: ReadBatch, kept,
                   rewrite: dict, nal, keep_aln, order, per_cell,
                   velo_mode: bool = False) -> int:
    """Write the collated file: ``batch``'s kept reads (indices
    ``kept``, with the read fields of ``rewrite`` replaced, ``nal``
    alignments each: the alignments under ``keep_aln``) in the order
    ``order`` of them, one chunk per cell of ``per_cell`` records; a
    cell with none writes no chunk.  Returns the chunks written."""
    with spans.span("emit", "codec"):
        final_reads = kept[order]
        read_cols = {k: v[final_reads] for k, v in batch.read_cols.items()}
        read_cols.update({k: v[order] for k, v in rewrite.items()})
        offsets = np.zeros(len(kept) + 1, np.int64)
        np.cumsum(nal, out=offsets[1:])
        out_nal = nal[order]
        out_offsets = np.zeros(len(kept) + 1, np.int64)
        np.cumsum(out_nal, out=out_offsets[1:])
        # positions of the kept alignments in the original flat arrays
        aln_gather = np.flatnonzero(keep_aln)[
            np.repeat(offsets[:-1][order], out_nal)
            + np.arange(int(out_offsets[-1])) - np.repeat(out_offsets[:-1], out_nal)
        ]
    n_written = int((per_cell > 0).sum())
    with _collated_writer(input_dir, compress_out, velo_mode) as sink:
        sink.write(_prelude_bytes(prelude, ftm, n_written))
        write_cell_chunks(
            sink, batch.schema, read_cols, out_offsets, batch.refs[aln_gather],
            batch.dirs[aln_gather], {k: v[aln_gather] for k, v in batch.aln_cols.items()},
            per_cell,
        )
    return n_written


def _gather_bucket_payload(rec_bytes, ranks, schema, n_cells, device):
    """One spill bucket's final bytes: its re-encoded records in stable
    cell-rank order (ordered on ``device``), an 8-byte chunk header in
    front of each cell.  Returns (bytes, number of chunks)."""
    rec_starts, num_aln = _native.walk_records(
        rec_bytes, np.asarray([0], np.int64), np.asarray([len(ranks)], np.int64),
        schema.read_bytes, schema.aln_bytes,
    )
    sizes = 4 + schema.read_bytes + num_aln * schema.aln_bytes
    order, _per_cell = collation_order(ranks.astype(np.int64), n_cells, device)
    out_sizes = sizes[order]
    rs = ranks[order]
    newc = np.ones(len(rs), bool)
    newc[1:] = rs[1:] != rs[:-1]
    starts = np.flatnonzero(newc)
    ends = np.append(starts[1:], len(rs))
    dst = np.zeros(len(order) + 1, np.int64)
    np.cumsum(out_sizes, out=dst[1:])
    rec_dst = dst[:-1] + 8 * np.cumsum(newc)
    out_buf = np.empty(int(dst[-1]) + 8 * len(starts), np.uint8)
    _native.gather_records(rec_bytes, rec_starts, sizes, order, rec_dst, out_buf)
    # chunk headers: [nbytes:u32][nrec:u32] in front of each cell
    hdr_pos = rec_dst[starts] - 8
    for field, off in (((dst[ends] - dst[starts] + 8), 0), ((ends - starts), 4)):
        le = field.astype("<u4").view(np.uint8).reshape(-1, 4)
        for k in range(4):
            out_buf[hdr_pos + off + k] = le[:, k]
    return out_buf, len(starts)


def _gather_rank_buckets(input_dir, spill_dir, n_buckets, schema, prelude, ftm,
                         n_cells, device, compress_out: bool,
                         velo_mode: bool = False) -> int:
    """Gather phase of the spill-bucket collation: order each bucket by
    cell rank and append one chunk per cell to the collated file.  The
    header's chunk count, the cells with a record, comes first from the
    buckets' rank files.  In a multi-process run each rank holds the
    buckets of its chunk range: each rank's records per cell, then every
    bucket's ranks and records go to rank 0 in rank order, the file's
    chunk order, so rank 0's stable ordering writes the one-process
    bytes, and rank 0 alone writes.  Returns the number of chunks
    written and the records per cell rank (at rank 0)."""
    rank, world = dist.rank_world()

    def gathered(b: int, kind: str, dtype) -> np.ndarray:
        return np.concatenate(dist.gather_to_root(
            np.fromfile(spill_dir / f"bucket_{b}.{kind}", dtype)))

    per_cell = np.zeros(n_cells, np.int64)
    for b in range(n_buckets):
        per_cell += np.bincount(np.fromfile(spill_dir / f"bucket_{b}.rank", np.uint32),
                                minlength=n_cells)
    if world > 1:
        cells = np.flatnonzero(per_cell)
        held = zip(dist.gather_to_root(cells), dist.gather_to_root(per_cell[cells]))
        per_cell = np.zeros(n_cells, np.int64)
        for c, n in held:
            per_cell[c] += n
    n_expected = int((per_cell > 0).sum())
    n_written = 0
    with (_collated_writer(input_dir, compress_out, velo_mode) if rank == 0
          else contextlib.nullcontext()) as sink:
        if sink is not None:
            sink.write(_prelude_bytes(prelude, ftm, n_expected))
        for b in range(n_buckets):
            with spans.span("spill_read", "codec"):
                ranks = gathered(b, "rank", np.uint32)
                rec_bytes = gathered(b, "rec", np.uint8)
                (spill_dir / f"bucket_{b}.rec").unlink()
                (spill_dir / f"bucket_{b}.rank").unlink()
            if sink is not None and len(ranks):
                with spans.span("order", "resolution"):
                    out_buf, n_chunks = _gather_bucket_payload(
                        rec_bytes, ranks, schema, n_cells, device
                    )
                sink.write(memoryview(out_buf.data))
                n_written += n_chunks
    if rank == 0 and n_written != n_expected:
        raise RuntimeError(f"wrote {n_written} cell chunks, the header says {n_expected}")
    return n_written, per_cell


def _collate_out_of_core(
    input_dir, rad_dir, cell_bcs, cell_cts, map_keys, map_vals, expected_ori,
    max_records, device, compress_out: bool, expect_atac: bool = False,
    num_chunks: int = 0, velo_mode: bool = False,
) -> None:
    """Bounded-memory collation (src/collate.rs:584-905): scatter the
    corrected records, re-encoded once, into spill buckets of
    consecutive cell ranks holding at most ``max_records`` records
    each, then gather every bucket with one in-memory ordering.  Shared
    with the ATAC collation (``expect_atac``, ``expected_ori='.'``).  In
    a multi-process run each rank scatters its chunk range, planned
    from the header's chunk count or else ``num_chunks`` (an ATAC
    header may hold 0), and the gather runs over collectives."""
    rank, world = dist.rank_world()
    with open(rad_dir / "map.rad", "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        _check_record_type(prelude, ftm, expect_atac)
        schema = RecordSchema.from_prelude(prelude)
        chunk_range = None
        if world > 1:
            n = prelude.hdr.num_chunks or num_chunks
            if n <= 0:
                raise ValueError("a multi-process collate needs the chunk count: the RAD "
                                 "header holds none")
            chunk_range = dist.host_chunk_plan(n, world, rank)
            log.info("multi-host collate: host %d/%d scatters chunks [%d, %d)",
                     rank, world, *chunk_range)
        # bucket b holds the ranks whose cumulative count starts in
        # [b * max_records, (b + 1) * max_records)
        csum = np.zeros(len(cell_cts) + 1, np.int64)
        np.cumsum(cell_cts.astype(np.int64), out=csum[1:])
        bucket_of_rank = csum[:-1] // max_records
        n_buckets = int(bucket_of_rank[-1]) + 1 if len(cell_cts) else 1
        log.info(
            "out-of-core collation: %d records into %d spill buckets",
            int(csum[-1]), n_buckets,
        )
        sort_perm = np.argsort(cell_bcs, kind="stable")
        cell_sorted = cell_bcs[sort_perm]
        spill_dir = input_dir / ("_collate_tmp" if world == 1 else f"_collate_tmp_r{rank}")
        spill_dir.mkdir(exist_ok=True)
        files = [
            (open(spill_dir / f"bucket_{b}.rec", "wb"),
             open(spill_dir / f"bucket_{b}.rank", "wb"))
            for b in range(n_buckets)
        ]
        try:
            with spans.span("scatter", "resolution"), \
                    Progress("collate scatter", "reads") as pb:
                # ATAC headers may hold num_chunks = 0: None streams to EOF
                for batch in iter_decoded_blocks(
                    fh, schema, prelude.hdr.num_chunks or None,
                    min(max_records, COLLATE_BLOCK_RECORDS), prefetch=True,
                    chunk_range=chunk_range,
                ):
                    pb.update(batch.n_reads)
                    _scatter_block(batch, schema, map_keys, map_vals, expected_ori,
                                   sort_perm, cell_sorted, bucket_of_rank, files)
            for rf, kf in files:
                rf.close()
                kf.close()
            n_written, _per_cell = _gather_rank_buckets(
                input_dir, spill_dir, n_buckets, schema, prelude, ftm, len(cell_bcs),
                device, compress_out, velo_mode,
            )
        finally:
            for rf, kf in files:
                rf.close()
                kf.close()
            for p in spill_dir.glob("bucket_*"):
                p.unlink(missing_ok=True)
            spill_dir.rmdir()
    log.info("finished out-of-core collation; wrote %d cell chunks", n_written)


def _scatter_block(batch, schema, map_keys, map_vals, expected_ori, sort_perm,
                   cell_sorted, bucket_of_rank, files) -> None:
    """Correct and filter one decoded block and append its records,
    re-encoded, and their cell ranks to the spill buckets."""
    corrected, keep_read, keep_aln, new_offsets = correct_and_filter(
        batch, map_keys, map_vals, expected_ori
    )
    if keep_read.any():
        spill_records(files, bucket_of_rank, sort_perm[np.searchsorted(cell_sorted,
                                                                       corrected[keep_read])],
                      batch, np.flatnonzero(keep_read),
                      {schema.barcode_fields[-1]: corrected[keep_read]}, np.diff(new_offsets),
                      keep_aln)


def spill_records(files, bucket_of_rank, rank, batch: ReadBatch, kept, rewrite: dict, nal,
                  keep_aln) -> None:
    """Append ``batch``'s kept reads (as :func:`write_collated` takes
    them) re-encoded, and their cell ranks ``rank``, to the spill
    buckets of those ranks."""
    schema = batch.schema
    read_cols = {k: v[kept] for k, v in batch.read_cols.items()}
    read_cols.update(rewrite)
    refs, dirs = batch.refs[keep_aln], batch.dirs[keep_aln]
    aln_cols = {k: v[keep_aln] for k, v in batch.aln_cols.items()}
    new_offsets = np.zeros(len(nal) + 1, np.int64)
    np.cumsum(nal, out=new_offsets[1:])
    bmask = bucket_of_rank[rank]
    for b in np.unique(bmask):
        sel = np.flatnonzero(bmask == b)
        offs = np.zeros(len(sel) + 1, np.int64)
        np.cumsum(nal[sel], out=offs[1:])
        gather = np.repeat(new_offsets[:-1][sel], nal[sel]) + (
            np.arange(int(offs[-1])) - np.repeat(offs[:-1], nal[sel])
        )
        body = encode_records(
            schema, {k: v[sel] for k, v in read_cols.items()}, offs,
            refs[gather], dirs[gather], {k: v[gather] for k, v in aln_cols.items()},
        )
        with spans.span("write", "codec"):
            files[int(b)][0].write(memoryview(body.data))
            files[int(b)][1].write(rank[sel].astype(np.uint32).tobytes())


def _read_cells_and_map(input_dir: Path):
    """The permit list's cells by descending read count (ties by
    barcode) with their counts, and the correction map's keys and
    values."""
    with spans.span("map_read", "codec"):
        _bclen, freq_bc, freq_ct = bincodeio.read_permit_freq(input_dir / "permit_freq.bin")
        map_keys, map_vals = bincodeio.read_u64_map_file(input_dir / "permit_map.bin")
    log.info("deserialized correction map of length: %d", len(map_keys))
    with spans.span("order", "resolution"):
        order = np.lexsort((freq_bc, -freq_ct.astype(np.int64)))
        return freq_bc[order], freq_ct[order], map_keys, map_vals


def _write_collate_sidecars(input_dir, rad_dir, map_keys, map_vals, compress_out,
                            cmdline, version):
    """``unmapped_bc_count_collated.bin`` (the unmapped-read counts per
    corrected barcode) and ``collate.json``."""
    with spans.span("map_read", "codec"):
        bcs_u, cts_u = unmappedio.read_raw_unmapped(rad_dir / "unmapped_bc_count.bin")
    with spans.span("map_lookup", "resolution"):
        cb = np.zeros(0, np.uint64)
        agg = np.zeros(0, np.uint64)
        if len(bcs_u):
            hit, corr = _native.lookup_u64(map_keys, map_vals, bcs_u)
            cb, inv = np.unique(corr[hit], return_inverse=True)
            agg = np.zeros(len(cb), np.uint64)
            np.add.at(agg, inv, cts_u[hit].astype(np.uint64))
    with spans.span("write", "codec"):
        path = input_dir / "unmapped_bc_count_collated.bin"
        unmappedio.write_collated_single(path, cb, agg.astype(np.uint32))
        spans.wrote(path)
    write_json(input_dir / "collate.json", {
        "cmd": cmdline,
        "version_str": version,
        "compressed_output": compress_out,
    })


def collate(
    input_dir: Path,
    rad_dir: Path,
    device: torch.device,
    max_records: int = 30_000_000,
    compress_out: bool = False,
    cmdline: str = "",
    version: str = __version__,
    collation_mode: str = "fast",
) -> None:
    """Collate ``rad_dir/map.rad`` into ``input_dir``; a multi-barcode
    (Flex) input goes through ``pipeline/collate_multi.py``, in
    ``collation_mode`` (``fast`` or ``two-round``), which only it reads."""
    input_dir = Path(input_dir)
    rad_dir = Path(rad_dir)
    mdata = check_version_compat(version, input_dir / "generate_permit_list.json")
    if mdata.get("multi_barcode"):
        from .collate_multi import collate_multi_bc

        collate_multi_bc(input_dir, rad_dir, device, max_records, compress_out, cmdline,
                         version, collation_mode)
        return
    collate_cells(input_dir, rad_dir, mdata["expected_ori"], device, max_records,
                  compress_out, cmdline, version,
                  velo_mode=bool(mdata.get("velo_mode", False)))


def collate_cells(input_dir, rad_dir, expected_ori, device, max_records, compress_out,
                  cmdline, version, expect_atac: bool = False, num_chunks: int = 0,
                  velo_mode: bool = False) -> None:
    """The collation proper, shared with ``atac collate``: the sidecars
    (rank 0's), then the out-of-core path beyond ``max_records`` records
    or in a multi-process run (``num_chunks``: the chunk count where the
    header holds none), else the byte-level path, else the columnar
    one; ``velo_mode`` names the collated file for velocity mode."""
    rank, world = dist.rank_world()
    cell_bcs, cell_cts, map_keys, map_vals = _read_cells_and_map(input_dir)
    if rank == 0:
        _write_collate_sidecars(input_dir, rad_dir, map_keys, map_vals, compress_out,
                                cmdline, version)
    args = (input_dir, rad_dir, cell_bcs, cell_cts, map_keys, map_vals, expected_ori)
    if world > 1 or int(cell_cts.sum()) > max_records:
        _collate_out_of_core(*args, max_records, device, compress_out, expect_atac,
                             num_chunks, velo_mode)
    elif not _collate_in_memory_native(*args, device, compress_out, expect_atac, velo_mode):
        _collate_columnar(*args, device, compress_out, expect_atac, velo_mode)
    dist.barrier()
