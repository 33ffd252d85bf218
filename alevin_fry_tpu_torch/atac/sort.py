"""atac sort: coordinate-sorted, deduplicated BED (port of
``alevin_fry_tpu/atac/sort.py``, reference src/atac/sort.rs).

Rows are the uniquely mapped reads with a correctable barcode
(atac/sort.rs:119-121): (chr, start, frag_len, corrected barcode).
They are sorted on the device and the runs of equal rows counted
(``ops/atac_device.sort_rle``), and each unique fragment shorter than
MAX_ATAC_FRAG_LEN becomes a BED row ``chr\\tstart\\tend\\tbarcode\\tcount``
(write_bed_string, atac/sort.rs:64-86), its barcode reverse-complemented
in rc mode.

Bins of 100 kb are prefixes of the (chr, start) order, so a sort over
consecutive-bin buckets, concatenated in bin order, equals one global
sort.  Up to ``max_records`` rows sort in memory; beyond that the rows
spill to buckets of consecutive bins, planned from the gpl stage's
``bin_recs.bin`` (atac/sort.rs:484-512), each then sorted on its own,
with the same output bytes.  With ``-c`` the BED goes through gzip into
``map.bed.gz``.

A multi-process run (``parallel/dist.py``) always spills: each rank
scatters its contiguous range of the chunks (counted by the header, else
by the gpl stage) into buckets of its own (``_sort_tmp_r<rank>``); each
bucket's rows are gathered in rank order and rank 0 sorts and writes it
(a bucket's sort does not depend on the order of its rows).
"""

from __future__ import annotations

import contextlib
import functools
import gzip
from pathlib import Path

import numpy as np
import torch

from .. import __version__, spans
from ..ops.atac_device import sort_rle
from ..ops.barcodes import revcomp_packed
from ..parallel import dist
from ..pipeline.logging_ import get_logger
from ..pipeline.progress import Progress
from ..radz import _native, bincodeio, read_prelude
from ..radz.chunkio import iter_decoded_blocks
from ..radz.constants import ATAC_BIN_SIZE, MAX_ATAC_FRAG_LEN
from ..radz.records import RecordSchema
from ..utils import check_version_compat, write_json

log = get_logger("atac.sort")

# one spilled row: (chr, start, frag_len, corrected barcode)
SPILL_DTYPE = np.dtype({
    "names": ["chr", "start", "flen", "bc"],
    "formats": ["<i4", "<i8", "<i4", "<u8"],
    "offsets": [0, 4, 12, 16],
    "itemsize": 24,
})


def format_bed_rows(ref_names, chrs, starts, frag_lens, bcs, counts, bc_len: int,
                    rc: bool, n_threads: int = 1) -> bytes:
    """Deduplicated fragments shorter than MAX_ATAC_FRAG_LEN as BED
    bytes, by the native formatter."""
    keep = frag_lens < MAX_ATAC_FRAG_LEN
    chrs, starts, frag_lens = chrs[keep], starts[keep], frag_lens[keep]
    bcs, counts = bcs[keep], counts[keep]
    if len(chrs) == 0:
        return b""
    if rc:
        bcs = revcomp_packed(bcs, bc_len)
    return _native.format_bed(
        list(ref_names), chrs, starts, starts + frag_lens, bcs, bc_len, counts, n_threads
    )


@contextlib.contextmanager
def _bed_writer(bed: Path, compress_out: bool):
    """The BED file (through gzip with ``compress_out``), opened and
    closed inside ``write`` spans; its bytes are counted."""
    with spans.span("write", "codec"):
        out = gzip.open(bed, "wb") if compress_out else open(bed, "wb")
    try:
        yield out
    finally:
        with spans.span("write", "codec"):
            out.close()
    spans.wrote(bed)


def _plan_buckets(bins: np.ndarray, max_records: int) -> np.ndarray:
    """Bucket of each genomic bin: consecutive bins grouped greedily
    into buckets of at most ``max_records`` records; a bin is never
    split, so an oversized bin gets a bucket of its own."""
    bucket_of_bin = np.zeros(len(bins), np.int64)
    b = acc = 0
    for i, c in enumerate(bins.astype(np.int64)):
        if acc > 0 and acc + c > max_records:
            b += 1
            acc = 0
        bucket_of_bin[i] = b
        acc += c
    return bucket_of_bin


def _extract_cols(batch, map_keys, map_vals) -> np.ndarray:
    """The (chr, start, frag_len, corrected barcode) rows of one decoded
    block's uniquely mapped reads with a correctable barcode."""
    hit, corrected = _native.lookup_u64(map_keys, map_vals, batch.barcode())
    keep = hit & (batch.num_aln_per_read == 1)
    first_aln = batch.aln_offsets[:-1][keep]
    rows = np.empty(int(keep.sum()), SPILL_DTYPE)
    rows["chr"] = batch.refs[first_aln]
    rows["start"] = batch.aln_cols["start_pos"][first_aln]
    rows["flen"] = batch.aln_cols["frag_len"][first_aln]
    rows["bc"] = corrected[keep]
    return rows


def _sort_dedup_emit(rows, ref_names, bc_len, rc, out, n_threads, device) -> int:
    """Sort one bucket's rows on ``device``, count their duplicates and
    write the BED rows (a ``sort``, a ``format`` and a ``write`` span);
    returns the number of unique fragments."""
    if len(rows) == 0:
        return 0
    with spans.span("sort", "resolution"):
        (chrs, starts, flens, bcs), counts = sort_rle(
            [rows["chr"].astype(np.int64), rows["start"], rows["flen"].astype(np.int64),
             rows["bc"]],
            device,
        )
    with spans.span("format", "codec"):
        bed = format_bed_rows(ref_names, chrs, starts, flens, bcs, counts, bc_len, rc,
                              n_threads)
    with spans.span("write", "codec"):
        out.write(bed)
    return len(chrs)


def sort(
    input_dir: Path,
    rad_dir: Path,
    device: torch.device,
    num_threads: int = 8,
    max_records: int = 30_000_000,
    compress_out: bool = False,
    cmdline: str = "",
    version: str = __version__,
) -> None:
    input_dir = Path(input_dir)
    rad_dir = Path(rad_dir)
    mdata = check_version_compat(version, input_dir / "generate_permit_list.json")
    rank, world = dist.rank_world()
    rc = bool(mdata["gpl_options"]["rc"])
    for f in ("bin_recs.bin", "bin_lens.bin"):
        if not (input_dir / f).exists():
            raise FileNotFoundError(f"bin file {f} does not exist; re-run atac gpl")
    with spans.span("map_read", "codec"):
        map_keys, map_vals = bincodeio.read_u64_map_file(input_dir / "permit_map.bin")
        bins = bincodeio.read_u64_vec_file(input_dir / "bin_recs.bin")
        blens = bincodeio.read_u64_vec_file(input_dir / "bin_lens.bin").astype(np.int64)
    total_unique = int(bins.sum())
    if rank == 0:
        write_json(input_dir / "sort.json", {
            "cmd": cmdline, "version_str": version, "compressed_output": compress_out,
        })

    bed = input_dir / ("map.bed.gz" if compress_out else "map.bed")
    with open(rad_dir / "map.rad", "rb") as fh, \
            (contextlib.nullcontext() if rank != 0 else _bed_writer(bed, compress_out)) as out:
        prelude, ftm, _ = read_prelude(fh)
        schema = RecordSchema.from_prelude(prelude)
        # ATAC headers may hold num_chunks = 0: None streams to EOF
        nc = prelude.hdr.num_chunks or None
        chunk_range = None
        if world > 1:
            n = nc or int(mdata.get("num-chunks") or 0)
            if n <= 0:
                raise ValueError("a multi-process atac sort needs a chunk count (the header's "
                                 "or the gpl stage's)")
            chunk_range = dist.host_chunk_plan(n, world, rank)
            log.info("multi-host atac sort: host %d/%d scatters chunks [%d, %d)",
                     rank, world, *chunk_range)
        bc_len = int(ftm["cblen"])
        ref_names = prelude.hdr.ref_names
        emit = functools.partial(
            _sort_dedup_emit, ref_names=ref_names, bc_len=bc_len, rc=rc, out=out,
            n_threads=num_threads, device=device,
        )
        if world == 1 and total_unique <= max_records:
            parts = []
            for batch in iter_decoded_blocks(fh, schema, nc, max_records):
                with spans.span("map_lookup", "resolution"):
                    parts.append(_extract_cols(batch, map_keys, map_vals))
            n_frag = emit(np.concatenate(parts) if parts else np.empty(0, SPILL_DTYPE))
        else:
            n_frag = _sort_out_of_core(fh, schema, nc, bins, blens, max_records,
                                       map_keys, map_vals, input_dir, emit, chunk_range)
    dist.barrier()
    log.info("wrote %d deduplicated fragments to %s", n_frag, bed)


def _sort_out_of_core(fh, schema, nc, bins, blens, max_records, map_keys, map_vals,
                      input_dir, emit, chunk_range=None) -> int:
    """Scatter the rows (of the chunks ``chunk_range``, all when None)
    to buckets of consecutive genomic bins, then sort and emit each
    bucket in bin order; in a multi-process run rank 0 emits each bucket
    gathered from every rank."""
    rank, world = dist.rank_world()
    with spans.span("plan", "resolution"):
        bucket_of_bin = _plan_buckets(bins, max_records)
        n_buckets = int(bucket_of_bin[-1]) + 1 if len(bins) else 1
        spill_dir = input_dir / ("_sort_tmp" if world == 1 else f"_sort_tmp_r{rank}")
        spill_dir.mkdir(exist_ok=True)
        paths = [spill_dir / f"bin_{b}.rows" for b in range(n_buckets)]
        files = [open(p, "wb") for p in paths]
    log.info("out-of-core sort: %d unique records into %d genomic-bin buckets",
             int(bins.sum()), n_buckets)
    try:
        with spans.span("scatter", "resolution"), \
                Progress("atac sort scatter", "reads") as pb:
            for batch in iter_decoded_blocks(fh, schema, nc, max_records, prefetch=True,
                                             chunk_range=chunk_range):
                pb.update(batch.n_reads)
                rows = _extract_cols(batch, map_keys, map_vals)
                if len(rows) == 0:
                    continue
                bmask = bucket_of_bin[blens[rows["chr"]] + rows["start"] // ATAC_BIN_SIZE]
                order = np.argsort(bmask, kind="stable")
                rows, bmask = rows[order], bmask[order]
                bnds = np.flatnonzero(np.diff(bmask)) + 1
                with spans.span("write", "codec"):
                    for seg, b in zip(np.split(rows, bnds), bmask[np.append(0, bnds)]):
                        files[int(b)].write(seg.tobytes())
        for f in files:
            f.close()
        n_frag = 0
        for p in paths:
            with spans.span("spill_read", "codec"):
                rows = np.fromfile(p, SPILL_DTYPE)
                p.unlink()
                if world > 1:
                    rows = np.concatenate(dist.gather_to_root(rows))
            n_frag += emit(rows)
    finally:
        for f in files:
            f.close()
        for p in paths:
            p.unlink(missing_ok=True)
        spill_dir.rmdir()
    return n_frag
