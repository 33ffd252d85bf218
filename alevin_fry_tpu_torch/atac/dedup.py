"""atac deduplicate (port of ``alevin_fry_tpu/atac/dedup.py``, reference
src/atac/deduplicate.rs).

Over the collated RAD file (one chunk per cell; ``map.collated.rad.sz``
when collate wrote it compressed): keep the uniquely
mapped proper pairs (one alignment of map type 4,
atac/deduplicate.rs:187), sort each cell's (chr, start, frag_len,
barcode) rows on the device with the cell as the outer key, count the
duplicates (``ops/atac_device.sort_rle``) and write BED rows.
Fragments of MAX_ATAC_FRAG_LEN and longer are counted but not written.
Returns the reference's four counters.  In a multi-process run
(``parallel/dist.py``) each rank deduplicates a contiguous range of the
cells holding about its share of the records into a BED of its own
(``.map.bed.r<rank>``); rank 0 writes ``map.bed`` from them in rank
order, and the counters are summed.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import numpy as np
import torch

from .. import __version__
from ..ops.atac_device import sort_rle
from ..parallel import dist
from ..pipeline.collate import open_collated
from ..pipeline.logging_ import get_logger
from ..radz.chunkio import chunk_record_counts, iter_decoded_blocks
from ..radz.constants import MAX_ATAC_FRAG_LEN
from ..radz.records import RecordSchema
from .sort import format_bed_rows

log = get_logger("atac.dedup")

# reads per streamed block; blocks hold whole cells (whole chunks), so
# deduplicating block by block is exact
DEDUP_BLOCK_RECORDS = 30_000_000


def deduplicate(input_dir: Path, device: torch.device, num_threads: int = 8,
                rev: bool = True, cmdline: str = "", version: str = __version__) -> dict:
    input_dir = Path(input_dir)
    rank, world = dist.rank_world()
    stats = {
        "num_multimapped": 0,
        "num_dedup": 0,
        "num_non_mapped_pair": 0,
        "num_frag_len_over_max": 0,
    }
    bed = input_dir / ("map.bed" if world == 1 else f".map.bed.r{rank}")
    with open_collated(input_dir) as (br, prelude, ftm), open(bed, "wb") as out:
        schema = RecordSchema.from_prelude(prelude)
        bc_len = int(ftm["cblen"])
        chunk_range = None
        if world > 1:
            # the cells are chunks, largest first: split by records
            with open_collated(input_dir) as (fh, _prelude, _ftm):
                chunk_range = dist.record_chunk_plan(
                    chunk_record_counts(fh, prelude.hdr.num_chunks), world, rank)
            log.info("multi-host atac dedup: host %d/%d owns cell chunks [%d, %d)",
                     rank, world, *chunk_range)
        for batch in iter_decoded_blocks(
            br, schema, prelude.hdr.num_chunks, DEDUP_BLOCK_RECORDS, prefetch=True,
            chunk_range=chunk_range,
        ):
            na = batch.num_aln_per_read
            first_aln = batch.aln_offsets[:-1]
            mtype = np.zeros(batch.n_reads, np.int64)
            mtype[na > 0] = batch.aln_cols["type"][first_aln[na > 0]].astype(np.int64)
            stats["num_multimapped"] += int((na > 1).sum())
            stats["num_non_mapped_pair"] += int(((na == 1) & (mtype != 4)).sum())
            keep = (na == 1) & (mtype == 4)
            fa = first_aln[keep]
            (_cell, chrs, starts, flens, bcs), counts = sort_rle(
                [batch.chunk_id[keep], batch.refs[fa].astype(np.int64),
                 batch.aln_cols["start_pos"][fa].astype(np.int64),
                 batch.aln_cols["frag_len"][fa].astype(np.int64), batch.barcode()[keep]],
                device,
            )
            stats["num_dedup"] += int((counts > 1).sum())
            stats["num_frag_len_over_max"] += int((flens >= MAX_ATAC_FRAG_LEN).sum())
            out.write(format_bed_rows(prelude.hdr.ref_names, chrs, starts, flens, bcs,
                                      counts, bc_len, rev, num_threads))
    if world > 1:
        # the ranks' BEDs in rank order are the one-process chunk order
        try:
            with (open(input_dir / "map.bed", "wb") if rank == 0
                  else contextlib.nullcontext()) as merged:
                dist.stream_concat_files(bed, merged)
        finally:
            bed.unlink()
        keys = sorted(stats)
        stats.update(zip(keys, dist.merge_counts([stats[k] for k in keys])))
        dist.barrier()
    log.info(
        "records >1 mapping: %d; deduplicated: %d; non-proper pairs: %d; "
        "frag length > %d: %d",
        stats["num_multimapped"], stats["num_dedup"], stats["num_non_mapped_pair"],
        MAX_ATAC_FRAG_LEN, stats["num_frag_len_over_max"],
    )
    return stats
