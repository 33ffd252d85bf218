"""atac deduplicate (port of ``alevin_fry_tpu/atac/dedup.py``, reference
src/atac/deduplicate.rs), single process.

Over the collated RAD file (one chunk per cell; ``map.collated.rad.sz``
when collate wrote it compressed): keep the uniquely
mapped proper pairs (one alignment of map type 4,
atac/deduplicate.rs:187), sort each cell's (chr, start, frag_len,
barcode) rows on the device with the cell as the outer key, count the
duplicates (``ops/atac_device.sort_rle``) and write BED rows.
Fragments of MAX_ATAC_FRAG_LEN and longer are counted but not written.
Returns the reference's four counters.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import __version__
from ..device import refuse_multi_process
from ..ops.atac_device import sort_rle
from ..pipeline.collate import open_collated
from ..pipeline.logging_ import get_logger
from ..radz.chunkio import iter_decoded_blocks
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
    refuse_multi_process()
    stats = {
        "num_multimapped": 0,
        "num_dedup": 0,
        "num_non_mapped_pair": 0,
        "num_frag_len_over_max": 0,
    }
    with open_collated(input_dir) as (br, prelude, ftm), \
            open(input_dir / "map.bed", "wb") as out:
        schema = RecordSchema.from_prelude(prelude)
        bc_len = int(ftm["cblen"])
        for batch in iter_decoded_blocks(
            br, schema, prelude.hdr.num_chunks, DEDUP_BLOCK_RECORDS, prefetch=True,
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
    log.info(
        "records >1 mapping: %d; deduplicated: %d; non-proper pairs: %d; "
        "frag length > %d: %d",
        stats["num_multimapped"], stats["num_dedup"], stats["num_non_mapped_pair"],
        MAX_ATAC_FRAG_LEN, stats["num_frag_len_over_max"],
    )
    return stats
