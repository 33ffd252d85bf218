"""atac generate-permit-list (port of ``alevin_fry_tpu/atac/gpl.py``,
reference src/atac/cellfilter.rs).

Only the unfiltered external list is supported (the reference's only
ATAC cell filter, atac/cellfilter.rs:56-65).  One streamed pass over
the reads counts the barcodes and the 100 kb genomic bins of the
uniquely mapped reads' start positions (atac/cellfilter.rs:67-102);
the bin histogram plans the sort stage's buckets.  The whitelist is
reverse-complemented unless ``rc`` is off.  The keep / 1-edit rescue
step is the RNA gpl's (``pipeline/gpl.rescue_and_write``), with kernel K4
or K5 on the chosen device (``ops/barcodes.find_neighbors``).

Writes permit_freq.bin, permit_map.bin, bin_recs.bin, bin_lens.bin and
generate_permit_list.json, as the reference does.  In a multi-process
run (``parallel/dist.py``) each rank counts its contiguous range of the
chunks, which the header must count; the bins, the barcode histogram
and the counters merge over collectives, every rank runs the rescue on
the merged histogram and rank 0 writes.  In a one-process run
``AFT_GPL_MESH`` counts the bins and the whitelisted barcodes on a
device mesh (``parallel/mesh.py``, atac/cellfilter.rs:67-102): only the
unmatched barcodes are histogrammed on the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .. import __version__, spans
from ..ops import barcodes as bcops
from ..parallel import dist
from ..parallel.mesh import mesh_from_env, sharded_bin_histogram, sharded_histogram
from ..pipeline.gpl import (
    GPL_BLOCK_RECORDS, _histogram, _merge_histograms, merge_rank_histograms, rescue_and_write,
)
from ..pipeline.logging_ import get_logger
from ..pipeline.progress import Progress
from ..radz import KnownRecordType, bincodeio, read_prelude, record_type_from_prelude
from ..radz.chunkio import iter_decoded_blocks
from ..radz.constants import ATAC_BIN_SIZE
from ..radz.records import RecordSchema
from ..utils import read_barcode_file, write_json

log = get_logger("atac.gpl")


@dataclass
class AtacGplOpts:
    input_dir: Path
    output_dir: Path
    unfiltered_pl: Path
    device: torch.device  # where the rescue (K4 or K5) runs
    min_reads: int = 10
    rc: bool = True
    threads: int = 8
    cmdline: str = ""
    version: str = __version__


def initialize_rec_list(ref_lens: np.ndarray, size_range: int):
    """Cumulative bin offsets per reference (atac/cellfilter.rs:38-53):
    (offsets of length nrefs + 1, total bins)."""
    nrange = np.ceil(
        ref_lens.astype(np.float32) / np.float32(size_range)
    ).astype(np.int64)
    blens = np.zeros(len(ref_lens) + 1, np.uint64)
    np.cumsum(nrange, out=blens[1:])
    return blens, int(blens[-1])


def _whitelist(opts: AtacGplOpts) -> np.ndarray:
    """The whitelist, reverse-complemented in rc mode
    (atac/cellfilter.rs:104-139), sorted and unique: a ``list_parse``
    span."""
    with spans.span("list_parse", "codec"):
        wl, wl_len = read_barcode_file(opts.unfiltered_pl)
        if opts.rc:
            wl = bcops.revcomp_packed(wl, wl_len)
        return np.unique(wl)


def generate_permit_list(opts: AtacGplOpts) -> int:
    """Run the stage; returns the number of distinct corrected barcodes."""
    rank, world = dist.rank_world()
    with open(Path(opts.input_dir) / "map.rad", "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        rec_type, _info = record_type_from_prelude(prelude, ftm)
        if rec_type != KnownRecordType.ATAC:
            raise ValueError(
                f"atac generate-permit-list requires an ATAC RAD file, got {rec_type}"
            )
        schema = RecordSchema.from_prelude(prelude)
        chunk_range = None
        if world > 1:
            if prelude.hdr.num_chunks <= 0:
                raise ValueError("a multi-process atac gpl needs a chunk count in the RAD header")
            chunk_range = dist.host_chunk_plan(prelude.hdr.num_chunks, world, rank)
            log.info("multi-host atac gpl: process %d/%d owns chunks [%d, %d)",
                     rank, world, *chunk_range)
        bclen = int(ftm["cblen"])
        blens, tot_bins = initialize_rec_list(
            np.asarray(ftm["ref_lengths"], np.uint64), ATAC_BIN_SIZE
        )
        bins = np.zeros(tot_bins, np.uint64)
        h_bc = np.zeros(0, np.uint64)
        h_ct = np.zeros(0, np.uint64)
        num_reads = num_chunks = max_ambig = 0
        mesh = mesh_from_env("AFT_GPL_MESH", opts.device) if world == 1 else None
        wl = _whitelist(opts)
        if mesh is not None:
            wl_counts = np.zeros(len(wl), np.int64)
        with spans.span("histogram", "resolution"), \
                Progress("atac gpl histogram", "reads") as pb:
            # ATAC headers may hold num_chunks = 0: None streams to EOF
            for batch in iter_decoded_blocks(
                fh, schema, prelude.hdr.num_chunks or None, GPL_BLOCK_RECORDS,
                prefetch=True, chunk_range=chunk_range,
            ):
                pb.update(batch.n_reads)
                num_reads += batch.n_reads
                num_chunks += len(batch.chunk_offsets) - 1
                nal = batch.num_aln_per_read
                if batch.n_reads:
                    max_ambig = max(max_ambig, int(nal.max()))
                first_aln = batch.aln_offsets[:-1][nal == 1]
                bin_idx = (
                    blens[batch.refs[first_aln].astype(np.int64)].astype(np.int64)
                    + batch.aln_cols["start_pos"][first_aln].astype(np.int64)
                    // ATAC_BIN_SIZE
                )
                bcs = batch.barcode()
                if mesh is None:
                    np.add.at(bins, bin_idx, 1)
                else:
                    if len(bin_idx):
                        bins += sharded_bin_histogram(mesh, bin_idx, tot_bins).astype(np.uint64)
                    if len(bcs):
                        cnt, _unmatched, hit = sharded_histogram(mesh, bcs, wl)
                        wl_counts += cnt
                        bcs = bcs[~hit]
                b_bc, b_ct = _histogram(bcs)
                h_bc, h_ct = _merge_histograms(h_bc, h_ct, b_bc, b_ct)
        if mesh is not None:
            nz = wl_counts > 0
            h_bc, h_ct = _merge_histograms(h_bc, h_ct, wl[nz], wl_counts[nz].astype(np.uint64))
    if world > 1:
        bins = np.sum(np.stack(dist.allgather_ragged(bins)), axis=0, dtype=np.uint64)
        h_bc, h_ct = merge_rank_histograms(h_bc, h_ct)
        num_reads, num_chunks, max_ambig = dist.merge_counts([num_reads, num_chunks],
                                                             [max_ambig])
        log.info("multi-host atac gpl: merged %d per-host histograms", world)

    out_dir = Path(opts.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    write = rank == 0
    if write:
        with spans.span("write", "codec"):
            bincodeio.write_u64_vec_file(out_dir / "bin_recs.bin", bins)
            bincodeio.write_u64_vec_file(out_dir / "bin_lens.bin", blens)
            spans.wrote(out_dir / "bin_recs.bin", out_dir / "bin_lens.bin")

    num_corrected = rescue_and_write(
        wl, h_bc, h_ct, bclen, opts.min_reads, num_reads, opts.device, out_dir, write,
    )
    if write:
        write_json(out_dir / "generate_permit_list.json", {
            "version_str": opts.version,
            "max-ambig-record": max_ambig,
            "num-chunks": num_chunks,
            "cmd": opts.cmdline,
            "permit-list-type": "unfiltered",
            "gpl_options": {
                "input_dir": str(opts.input_dir),
                "output_dir": str(opts.output_dir),
                "fmeth": f"UnfilteredExternalList({opts.unfiltered_pl}, {opts.min_reads})",
                "threads": opts.threads,
                "rc": opts.rc,
                "cmdline": opts.cmdline,
                "version": opts.version,
            },
            "max-rec-in-bin": int(bins.max()) if tot_bins else 0,
        })
    dist.barrier()
    log.info("total number of distinct corrected barcodes: %d", num_corrected)
    return num_corrected
