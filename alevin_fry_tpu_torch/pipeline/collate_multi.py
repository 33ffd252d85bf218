"""Multi-barcode (10x Flex) hierarchical collation, fast and two-round
modes (port of ``alevin_fry_tpu/pipeline/collate_multi.py``, reference
do_collate_multi_bc_fast, src/collate.rs:1160-1965).

* sample barcodes correct through ``sample_permit_map.bin``: one hash
  lookup a read, from the probe barcode to the dense sample;
* cell barcodes correct within their sample through one hash lookup a
  read of the composite key: in the fast mode into the composite cells
  (the identity tier against the sample's ``permit_freq.bin`` keys,
  which gives the cell's rank), then for the misses a 1-edit tier that
  keeps a unique Hamming-1 neighbour among the sample's cells
  (collate.rs:1486-1664), searched by kernel K4 on the chosen device
  once a sample; in the two-round mode into the samples' gpl-written
  ``permit_map.bin`` keys, merged (collate.rs:2277-2283);
* the composite key ``(sample << 2·cell_bc_len) | cell``
  (collate.rs:1194-1198), refused past 64 bits;
* output chunks grouped by present sample (ascending plate index), cells
  by descending read count within a sample, the reads of a cell in file
  order (a stable sort by cell rank on the device); the **manifest
  ordinal** (the dense index of the present samples) goes into
  barcodes[0] of every record, keeping that field's width
  (simpleaf#195, collate.rs:1312-1338, 1685-1702);
* above ``--max-records`` records the corrected records spill to buckets
  of consecutive cell ranks (the reference's TempBucket plan,
  collate.rs:1413-1480) and each bucket is gathered as the single-barcode
  out-of-core collate gathers it.

Each block's correction is a ``map_lookup`` span holding the ``tier``
span (the per-sample cell correction and its counts); the composite
order is an ``order`` span, the manifest a ``manifest`` span inside a
``write``.

Writes ``map.collated.rad`` (``.sz`` with ``-c``), ``collation_manifest.bin``,
an empty multi-key ``unmapped_bc_count_collated.bin`` and ``collate.json``
with ``multi_barcode`` and ``num_samples`` (and ``collation_mode`` in the
two-round mode, docs/parity.md divergence 8).

A multi-process run (``parallel/dist.py``) always takes the out-of-core
path: each rank scatters its chunk range, the buckets are gathered over
collectives in rank order (``collate.py``'s gather), and rank 0 writes
every artifact.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from .. import spans
from ..ops import barcodes as bcops
from ..parallel import dist
from ..radz import _native, bincodeio, read_prelude
from ..radz import unmapped as unmappedio
from ..radz.chunkio import decode_all_chunks, iter_decoded_blocks
from ..radz.collation import CollationManifest, SampleGroup
from ..radz.records import RecordSchema
from ..utils import aln_strand_mask, write_json
from .collate import (
    COLLATE_BLOCK_RECORDS, _gather_rank_buckets, collation_order, spill_records, write_collated,
)
from .logging_ import get_logger
from .progress import Progress

log = get_logger("collate.multi")


def _correct_block(batch, ctx):
    """Sample and cell correction of one decoded block -> (kept read
    indices, their cell ranks, their rewritten barcodes: barcodes[0] the
    manifest ordinal and barcodes[-1] the corrected cell, the
    kept-alignment mask, alignments per kept read).  Only the reads that
    keep a sample and an alignment in the expected orientation go
    through the cell tiers (a ``tier`` span); no other read is kept."""
    with spans.span("map_lookup", "resolution"):
        # sample correction: each probe barcode straight to its dense sample
        hit_s, sample_of = _native.lookup_u64(ctx["sample_keys"], ctx["sample_of_key"],
                                              batch.barcode(0))
        # orientation filter of the alignments
        keep_aln0 = aln_strand_mask(batch.dirs, ctx["expected_ori"])
        kept_per_read = (
            np.add.reduceat(keep_aln0.astype(np.int64), batch.aln_offsets[:-1])
            if batch.n_reads else np.zeros(0, np.int64)
        )
        kept_per_read[np.diff(batch.aln_offsets) == 0] = 0
        reads = np.flatnonzero(hit_s & (kept_per_read > 0))
        with spans.span("tier", "resolution"):
            kept_reads, rank = _tiers(batch.barcode(-1), reads, sample_of[reads], ctx)
        keep_read = np.zeros(batch.n_reads, bool)
        keep_read[kept_reads] = True
        keep_aln = keep_aln0 & np.repeat(keep_read, batch.num_aln_per_read)
        fields = batch.schema.barcode_fields
        rewrite = {fields[0]: ctx["ord_lut"][ctx["comp_sample"][rank]].astype(np.uint64),
                   fields[-1]: ctx["comp_cell"][rank]}
    return kept_reads, rank, rewrite, keep_aln, kept_per_read[kept_reads]


def _tiers(cbc, reads, sample, ctx):
    """The cell correction of ``reads`` (ascending), each within its
    ``sample`` (dense indices, u64) -> (the reads kept, ascending; their
    cell ranks).  Each read's composite key ``(sample, cell barcode)``
    goes through one hash lookup into the stage's table: in the fast
    mode the composite cells,
    so a hit is the identity tier and gives the rank; in the two-round
    mode every sample's ``permit_map.bin`` keys, each to the rank of its
    corrected cell.  The fast mode then keeps a unique Hamming-1
    neighbour among the sample's cells for each miss (K4, one search a
    sample) and counts its reads: ``tier_exact`` (a kept cell of the
    sample), ``tier_queries`` (sent to K4), ``tier_rescued`` (exactly one
    kept cell one substitution away) and ``tier_dropped`` (the other
    queries)."""
    bits = np.uint64(ctx["cell_bc_bits"])
    hit, rank = _native.lookup_u64(ctx["tier_keys"], ctx["tier_ranks"],
                                   (sample << bits) | cbc[reads])
    if ctx["mode"] == "two-round" or len(reads) == 0:
        return reads[hit], rank[hit].astype(np.int64)
    spans.add("tier_exact", int(hit.sum()))
    miss = np.flatnonzero(~hit)
    if len(miss):
        # the misses grouped by sample, in read order within each: none
        # of them is a kept cell of its sample, so a count of 1 is a
        # unique Hamming-1 neighbour
        miss_sample = sample[miss].astype(np.int64)
        by_sample = miss[np.argsort(miss_sample, kind="stable")]
        bounds = np.zeros(ctx["num_samples"] + 1, np.int64)
        np.cumsum(np.bincount(miss_sample, minlength=ctx["num_samples"]), out=bounds[1:])
        rescued, rescued_keys = [np.zeros(0, np.int64)], [np.zeros(0, np.uint64)]
        for sidx in np.flatnonzero(np.diff(bounds)).tolist():
            m = by_sample[bounds[sidx]:bounds[sidx + 1]]
            cnts, reps = bcops.find_neighbors(cbc[reads[m]], ctx["per_sample_valid"][sidx],
                                              ctx["cell_bc_len"], ctx["device"])
            good = cnts == 1
            rescued.append(m[good])
            rescued_keys.append((np.uint64(sidx) << bits) | reps[good])
        rescued = np.concatenate(rescued)
        # each representative's composite cell gives the rank
        found, r = _native.lookup_u64(ctx["tier_keys"], ctx["tier_ranks"],
                                      np.concatenate(rescued_keys))
        hit[rescued[found]] = True
        rank[rescued[found]] = r[found]
        spans.add("tier_queries", len(miss))
        spans.add("tier_rescued", len(rescued))
        spans.add("tier_dropped", len(miss) - len(rescued))
    return reads[hit], rank[hit].astype(np.int64)


def _two_round_table(input_dir: Path, sample_names, cell_bc_bits: int, comp_sorted,
                     comp_rank):
    """Every sample's ``permit_map.bin`` as one table: the composite key
    of a raw cell barcode -> the rank of its corrected composite cell
    (sorted keys; where a map repeats a key, its first entry; an entry
    whose corrected cell is no composite cell is left out, so its reads
    drop)."""
    bits = np.uint64(cell_bc_bits)
    keys, vals = [np.zeros(0, np.uint64)], [np.zeros(0, np.uint64)]
    for sidx, name in enumerate(sample_names):
        mp = input_dir / f"sample_{name}" / "permit_map.bin"
        if not mp.exists():
            log.info("Round 2: skipping sample '%s' (no permit maps)", name)
            continue
        mk, mv = bincodeio.read_u64_map_file(mp)
        keys.append((np.uint64(sidx) << bits) | mk)
        vals.append((np.uint64(sidx) << bits) | mv)
    keys, vals = np.concatenate(keys), np.concatenate(vals)
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    keys, vals = keys[first], vals[first]
    found, rank = _native.lookup_u64(comp_sorted, comp_rank, vals)
    return keys[found], rank[found]


def collate_multi_bc(input_dir: Path, rad_dir: Path, device: torch.device, max_records: int,
                     compress_out: bool, cmdline: str, version: str,
                     mode: str) -> None:
    if mode not in ("fast", "two-round"):
        raise ValueError(f"unknown collation mode {mode!r}")
    with spans.span("map_read", "codec"):
        with open(input_dir / "generate_permit_list.json") as fh:
            expected_ori = json.load(fh)["expected_ori"]
        with open(input_dir / "sample_info.json") as fh:
            sample_info = json.load(fh)
        num_samples = int(sample_info["num_samples"])
        entries = sample_info["samples"]
        sample_names = [e.get("name") or format(int(e["barcode"], 16), "x") for e in entries]
        sample_bcs = np.asarray([int(e["barcode"], 16) for e in entries], np.uint64)
        smk, smv = bincodeio.read_u64_map_file(input_dir / "sample_permit_map.bin")

        # each sample's valid cell barcodes (sorted by the writer) and counts
        per_sample_valid, per_sample_freq = [], []
        cell_bc_len = None
        for name in sample_names:
            fp = input_dir / f"sample_{name}" / "permit_freq.bin"
            if fp.exists():
                cell_bc_len, k, v = bincodeio.read_permit_freq(fp)
            else:
                k, v = np.zeros(0, np.uint64), np.zeros(0, np.uint64)
            per_sample_valid.append(k)
            per_sample_freq.append(v)
    cell_bc_len = cell_bc_len or 16
    cell_bc_bits = 2 * cell_bc_len
    sample_id_bits = 0 if num_samples <= 1 else (num_samples - 1).bit_length()
    if sample_id_bits + cell_bc_bits > 64:
        raise ValueError(
            f"Cannot collate: {num_samples} samples requires {sample_id_bits} "
            f"bits plus {cell_bc_bits} bits for {cell_bc_len}bp cell barcodes "
            "> 64-bit composite key capacity."
        )

    with spans.span("order", "resolution"):
        # composite cells: samples ascending, then descending count, then barcode
        comp_cell, comp_sample, comp_counts = ([np.zeros(0, np.uint64)], [np.zeros(0, np.int64)],
                                               [np.zeros(0, np.int64)])
        for sidx, (v, f) in enumerate(zip(per_sample_valid, per_sample_freq)):
            order = np.lexsort((v, -f.astype(np.int64)))
            comp_cell.append(v[order])
            comp_sample.append(np.full(len(v), sidx, np.int64))
            comp_counts.append(f[order].astype(np.int64))
        comp_cell = np.concatenate(comp_cell)
        comp_sample = np.concatenate(comp_sample)
        comp_counts = np.concatenate(comp_counts)
        comp_cells = (comp_sample.astype(np.uint64) << np.uint64(cell_bc_bits)) | comp_cell
        comp_perm = np.argsort(comp_cells, kind="stable")
        comp_sorted, comp_rank = comp_cells[comp_perm], comp_perm.astype(np.uint64)
        # the manifest ordinal: every kept read's (sample, cell) is a
        # composite cell, so the present samples are those holding one
        present = np.unique(comp_sample)
        ord_lut = np.zeros(max(num_samples, 1), np.int64)
        ord_lut[present] = np.arange(len(present))
        # each sample-permit-map key to the dense index of its sample
        sb_sorted_idx = np.argsort(sample_bcs, kind="stable")
        known, sample_of_key = _native.lookup_u64(sample_bcs[sb_sorted_idx],
                                                  sb_sorted_idx.astype(np.uint64), smv)

    ctx = {
        "num_samples": num_samples, "cell_bc_len": cell_bc_len,
        "cell_bc_bits": cell_bc_bits, "sample_keys": smk[known],
        "sample_of_key": sample_of_key[known],
        "per_sample_valid": per_sample_valid, "mode": mode, "expected_ori": expected_ori,
        "tier_keys": comp_sorted, "tier_ranks": comp_rank, "comp_sample": comp_sample,
        "comp_cell": comp_cell, "ord_lut": ord_lut, "device": device,
    }
    if mode == "two-round":
        with spans.span("map_read", "codec"):
            ctx["tier_keys"], ctx["tier_ranks"] = _two_round_table(
                input_dir, sample_names, cell_bc_bits, comp_sorted, comp_rank)

    rank, world = dist.rank_world()
    with open(rad_dir / "map.rad", "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        schema = RecordSchema.from_prelude(prelude)
        if world > 1 or int(comp_counts.sum()) > max_records:
            n_written, per_cell = _collate_multi_out_of_core(
                fh, input_dir, schema, prelude, ftm, ctx, comp_counts, max_records,
                compress_out,
            )
        else:
            batch = decode_all_chunks(fh, schema, prelude.hdr.num_chunks)
            log.info("multi-barcode collation over %d reads", batch.n_reads)
            n_written, per_cell = _collate_multi_in_memory(
                batch, input_dir, prelude, ftm, ctx, len(comp_cells), compress_out,
            )
    if rank != 0:
        # rank 0 writes the sidecars and the manifest
        dist.barrier()
        return

    cmeta = {"cmd": cmdline, "version_str": version, "compressed_output": compress_out,
             "multi_barcode": True, "num_samples": num_samples}
    if mode == "two-round":
        cmeta["collation_mode"] = "two-round"
    write_json(input_dir / "collate.json", cmeta)
    with spans.span("write", "codec"):
        # the mapper's multi-key unmapped counts are not read: the sidecar is
        # an empty (sample, cell) map, as the reference writes it
        unmappedio.write_collated_multi(
            input_dir / "unmapped_bc_count_collated.bin",
            np.zeros(0, np.uint64), np.zeros(0, np.uint64), np.zeros(0, np.uint32),
        )
        spans.wrote(input_dir / "unmapped_bc_count_collated.bin")
        with spans.span("manifest", "codec"):
            # the present samples in ascending plate index; chunk ranges
            # count the cells that wrote a chunk
            manifest = CollationManifest(["sample", "cell"])
            chunk_offset = 0
            for sidx in present.tolist():
                sel = comp_sample == sidx
                nch = int((per_cell[sel] > 0).sum())
                manifest.add_sample_group(SampleGroup(
                    key=int(sample_bcs[sidx]), name=sample_names[sidx],
                    chunk_start=chunk_offset, num_chunks=nch,
                    num_records=int(per_cell[sel].sum()),
                ))
                chunk_offset += nch
            manifest.write_to_file(input_dir / "collation_manifest.bin")
            spans.wrote(input_dir / "collation_manifest.bin")
    dist.barrier()
    log.info(
        "Multi-barcode collation complete: %d output chunks across %d samples",
        n_written, len(present),
    )


def _collate_multi_in_memory(batch, input_dir, prelude, ftm, ctx, n_cells, compress_out: bool):
    kept, rank, rewrite, keep_aln, nal = _correct_block(batch, ctx)
    with spans.span("order", "resolution"):
        order, per_cell = collation_order(rank, n_cells, ctx["device"])
    return write_collated(input_dir, compress_out, prelude, ftm, batch, kept, rewrite, nal,
                          keep_aln, order, per_cell), per_cell


def _collate_multi_out_of_core(fh, input_dir, schema, prelude, ftm, ctx, comp_counts,
                               max_records: int, compress_out: bool):
    """Bounded-memory collation: correct block by block, spill the
    re-encoded records to buckets of consecutive cell ranks planned from
    the permit counts (each at most ``max_records``), then gather each
    bucket in rank order.  In a multi-process run each rank scatters its
    chunk range and the gather runs over collectives."""
    rank, world = dist.rank_world()
    chunk_range = None
    if world > 1:
        if prelude.hdr.num_chunks <= 0:
            raise ValueError("a multi-process multi-BC collate needs a chunk count in the "
                             "RAD header")
        chunk_range = dist.host_chunk_plan(prelude.hdr.num_chunks, world, rank)
        log.info("multi-host multi-BC collate: host %d/%d scatters chunks [%d, %d)",
                 rank, world, *chunk_range)
    n_cells = len(comp_counts)
    csum = np.zeros(n_cells + 1, np.int64)
    np.cumsum(comp_counts, out=csum[1:])
    bucket_of_rank = csum[:-1] // max_records
    n_buckets = int(bucket_of_rank[-1]) + 1 if n_cells else 1
    log.info("out-of-core multi-BC collation: ~%d records into %d spill buckets",
             int(csum[-1]), n_buckets)
    spill_dir = input_dir / ("_collate_tmp" if world == 1 else f"_collate_tmp_r{rank}")
    spill_dir.mkdir(exist_ok=True)
    files = [(open(spill_dir / f"bucket_{b}.rec", "wb"),
              open(spill_dir / f"bucket_{b}.rank", "wb")) for b in range(n_buckets)]
    try:
        with spans.span("scatter", "resolution"), \
                Progress("multi-BC collate scatter", "reads") as pb:
            for batch in iter_decoded_blocks(
                fh, schema, prelude.hdr.num_chunks or None,
                min(max_records, COLLATE_BLOCK_RECORDS), prefetch=True,
                chunk_range=chunk_range,
            ):
                pb.update(batch.n_reads)
                _scatter_block(batch, ctx, bucket_of_rank, files)
        for rf, kf in files:
            rf.close()
            kf.close()
        return _gather_rank_buckets(input_dir, spill_dir, n_buckets, schema, prelude, ftm,
                                    n_cells, ctx["device"], compress_out)
    finally:
        for rf, kf in files:
            rf.close()
            kf.close()
        for p in spill_dir.glob("bucket_*"):
            p.unlink(missing_ok=True)
        spill_dir.rmdir()


def _scatter_block(batch, ctx, bucket_of_rank, files) -> None:
    """Correct one block and append its records, re-encoded, and their
    cell ranks to the spill buckets."""
    kept, rank, rewrite, keep_aln, nal = _correct_block(batch, ctx)
    if len(kept):
        spill_records(files, bucket_of_rank, rank, batch, kept, rewrite, nal, keep_aln)
