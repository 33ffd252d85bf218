"""Multi-barcode (10x Flex) hierarchical collation, fast and two-round
modes (port of ``alevin_fry_tpu/pipeline/collate_multi.py``, reference
do_collate_multi_bc_fast, src/collate.rs:1160-1965).

* sample barcodes correct through ``sample_permit_map.bin``;
* cell barcodes correct per sample: in the fast mode an identity tier
  against the sample's ``permit_freq.bin`` keys, then a 1-edit tier that
  keeps a unique Hamming-1 neighbour among them (collate.rs:1486-1664),
  searched by kernel K4 on the chosen device; in the two-round mode
  through the sample's gpl-written ``permit_map.bin`` (collate.rs:
  2277-2283);
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
from ..radz import bincodeio, read_prelude
from ..radz import unmapped as unmappedio
from ..radz.chunkio import decode_all_chunks, iter_decoded_blocks
from ..radz.collation import CollationManifest, SampleGroup
from ..radz.records import RecordSchema
from ..utils import aln_strand_mask, write_json
from .collate import (
    COLLATE_BLOCK_RECORDS, _gather_rank_buckets, _lookup_map, collation_order, spill_records,
    write_collated,
)
from .logging_ import get_logger
from .progress import Progress

log = get_logger("collate.multi")


def _in_sorted(sorted_keys: np.ndarray, query: np.ndarray):
    """(position of each query in ``sorted_keys``, clipped; whether it is
    there)."""
    if len(sorted_keys) == 0:
        return np.zeros(len(query), np.int64), np.zeros(len(query), bool)
    pos = np.minimum(np.searchsorted(sorted_keys, query), len(sorted_keys) - 1)
    return pos, sorted_keys[pos] == query


def _correct_block(batch, ctx):
    """Sample and cell correction of one decoded block -> (kept read
    indices, their cell ranks, their rewritten barcodes: barcodes[0] the
    manifest ordinal and barcodes[-1] the corrected cell, the
    kept-alignment mask, alignments per kept read).  Only the reads that
    keep a sample and an alignment in the expected orientation go
    through the cell tiers (a ``tier`` span); no other read is kept."""
    with spans.span("map_lookup", "resolution"):
        # sample correction
        hit_s, corr_s = _lookup_map(ctx["smk"], ctx["smv"], batch.barcode(0))
        si, known = _in_sorted(ctx["sb_sorted"], corr_s)
        known &= hit_s
        sample_idx = np.full(batch.n_reads, -1, np.int64)
        sample_idx[known] = ctx["sb_sorted_idx"][si[known]]
        # orientation filter of the alignments
        keep_aln0 = aln_strand_mask(batch.dirs, ctx["expected_ori"])
        kept_per_read = (
            np.add.reduceat(keep_aln0.astype(np.int64), batch.aln_offsets[:-1])
            if batch.n_reads else np.zeros(0, np.int64)
        )
        kept_per_read[np.diff(batch.aln_offsets) == 0] = 0
        sample_idx[~(kept_per_read > 0)] = -1
        with spans.span("tier", "resolution"):
            corrected_cell, cell_ok = _tiers(batch.barcode(-1), sample_idx, ctx)
        keep_read = cell_ok

        rk = (sample_idx[keep_read].astype(np.uint64) << np.uint64(ctx["cell_bc_bits"])) \
            | corrected_cell[keep_read]
        pos, in_cells = _in_sorted(ctx["comp_sorted"], rk)
        # every corrected read should hit a known cell; any other drops
        kept_reads = np.flatnonzero(keep_read)[in_cells]
        rank = ctx["comp_perm"][pos[in_cells]]
        keep_read2 = np.zeros(batch.n_reads, bool)
        keep_read2[kept_reads] = True
        keep_aln = keep_aln0 & np.repeat(keep_read2, batch.num_aln_per_read)
        fields = batch.schema.barcode_fields
        rewrite = {fields[0]: ctx["ord_lut"][sample_idx[kept_reads]].astype(np.uint64),
                   fields[-1]: corrected_cell[kept_reads]}
    return kept_reads, rank, rewrite, keep_aln, kept_per_read[kept_reads]


def _tiers(cbc, sample_idx, ctx):
    """Each read's cell barcode corrected within its sample (``sample_idx``,
    -1 for a read that goes through no tier) -> (corrected cells, which
    reads were corrected).  The fast mode counts its reads:
    ``tier_exact`` (a kept cell of the sample), ``tier_queries`` (sent to
    K4), ``tier_rescued`` (exactly one kept cell one substitution away)
    and ``tier_dropped`` (the other queries)."""
    corrected_cell = np.zeros(len(cbc), np.uint64)
    cell_ok = np.zeros(len(cbc), bool)
    for sidx in range(ctx["num_samples"]):
        sel = np.flatnonzero(sample_idx == sidx)
        if len(sel) == 0:
            continue
        q = cbc[sel]
        if ctx["mode"] == "two-round":
            if ctx["round2_maps"][sidx] is None:
                continue
            hit, corr = _lookup_map(*ctx["round2_maps"][sidx], q)
            corrected_cell[sel[hit]] = corr[hit]
            cell_ok[sel[hit]] = True
            continue
        valid = ctx["per_sample_valid"][sidx]
        _, ident = _in_sorted(valid, q)
        corrected_cell[sel[ident]] = q[ident]
        cell_ok[sel[ident]] = True
        spans.add("tier_exact", int(ident.sum()))
        # the 1-edit tier: none of these queries is a valid code, so a
        # count of 1 is a unique Hamming-1 neighbour
        rest = sel[~ident]
        if len(rest):
            cnts, reps = bcops.find_neighbors(q[~ident], valid, ctx["cell_bc_len"],
                                              ctx["device"])
            good = cnts == 1
            corrected_cell[rest[good]] = reps[good]
            cell_ok[rest[good]] = True
            n_good = int(good.sum())
            spans.add("tier_queries", len(rest))
            spans.add("tier_rescued", n_good)
            spans.add("tier_dropped", len(rest) - n_good)
    return corrected_cell, cell_ok


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
        comp_cells, comp_counts = [np.zeros(0, np.uint64)], [np.zeros(0, np.int64)]
        for sidx, (v, f) in enumerate(zip(per_sample_valid, per_sample_freq)):
            order = np.lexsort((v, -f.astype(np.int64)))
            comp_cells.append((np.uint64(sidx) << np.uint64(cell_bc_bits)) | v[order])
            comp_counts.append(f[order].astype(np.int64))
        comp_cells = np.concatenate(comp_cells)
        comp_counts = np.concatenate(comp_counts)
        comp_perm = np.argsort(comp_cells, kind="stable")
        comp_sample = (comp_cells >> np.uint64(cell_bc_bits)).astype(np.int64)
        # the manifest ordinal: every kept read's (sample, cell) is a
        # composite cell, so the present samples are those holding one
        present = np.unique(comp_sample)
        ord_lut = np.zeros(max(num_samples, 1), np.int64)
        ord_lut[present] = np.arange(len(present))

    sb_sorted_idx = np.argsort(sample_bcs, kind="stable")
    ctx = {
        "num_samples": num_samples, "cell_bc_len": cell_bc_len,
        "cell_bc_bits": cell_bc_bits, "smk": smk, "smv": smv,
        "sb_sorted": sample_bcs[sb_sorted_idx], "sb_sorted_idx": sb_sorted_idx,
        "per_sample_valid": per_sample_valid, "mode": mode, "expected_ori": expected_ori,
        "comp_sorted": comp_cells[comp_perm], "comp_perm": comp_perm, "ord_lut": ord_lut,
        "round2_maps": None, "device": device,
    }
    if mode == "two-round":
        ctx["round2_maps"] = []
        with spans.span("map_read", "codec"):
            for name in sample_names:
                mp = input_dir / f"sample_{name}" / "permit_map.bin"
                if not mp.exists():
                    log.info("Round 2: skipping sample '%s' (no permit maps)", name)
                ctx["round2_maps"].append(bincodeio.read_u64_map_file(mp) if mp.exists()
                                          else None)

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
