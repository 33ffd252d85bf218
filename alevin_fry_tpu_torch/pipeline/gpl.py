"""generate-permit-list (RNA), unfiltered permit list with the 1-edit
rescue (port of ``alevin_fry_tpu/pipeline/gpl.py``, reference
src/cellfilter.rs:105-333).

The per-barcode read histogram is host work: the native codec
walks the RAD records and hash-counts the barcodes.  The rescue — for
every barcode that is not a kept permit-list entry, the kept barcodes
within Hamming distance 1 — runs kernel K4 on the chosen device.

Outputs the reference's artifacts: permit_freq.bin, permit_map.bin and
generate_permit_list.json.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..radz import (
    KnownRecordType, bincodeio, read_prelude, record_type_from_prelude,
)
from ..radz import _native
from ..radz.chunkio import _gather_uint, iter_decoded_blocks, iter_raw_blocks
from ..radz.records import RecordSchema

from .. import __version__
from ..ops import barcodes as bcops
from ..utils import (
    STRAND_BOTH, STRAND_FW, read_barcode_file, read_strand_mask,
    record_layout, strand_from_ori_arg, write_json,
)
from .logging_ import get_logger
from .progress import stage_timer

log = get_logger("gpl")

# reads per streamed block of the histogram pass
GPL_BLOCK_RECORDS = 20_000_000


@dataclass
class CellFilterMethod:
    """The cell filter (src/cellfilter.rs:51-71).  The port runs the
    unfiltered external list only."""

    kind: str  # "knee" | "force" | "expect" | "explicit" | "unfiltered"
    count: int = 0
    path: Optional[Path] = None
    min_reads: int = 10

    def describe(self) -> str:
        return {
            "knee": "KneeFinding",
            "force": f"ForceCells({self.count})",
            "expect": f"ExpectCells({self.count})",
            "explicit": f"ExplicitList({self.path})",
            "unfiltered": f"UnfilteredExternalList({self.path}, {self.min_reads})",
        }[self.kind]


@dataclass
class GenPermitListOpts:
    input_dir: Path
    output_dir: Path
    fmeth: CellFilterMethod
    expected_ori: str  # "fw" | "rc" | "both" | "either"
    device: torch.device  # where the rescue (K4) runs
    threads: int = 8
    cmdline: str = ""
    version: str = __version__


def _serialize_opts(opts: GenPermitListOpts) -> dict:
    """The ``gpl_options`` record, field for field as the reference
    writes it (the multi-barcode fields are always unset here)."""
    return {
        "input_dir": str(opts.input_dir),
        "output_dir": str(opts.output_dir),
        "fmeth": opts.fmeth.describe(),
        "expected_ori": opts.expected_ori,
        "velo_mode": False,
        "threads": opts.threads,
        "cmdline": opts.cmdline,
        "version": opts.version,
        "sample_bc_list": None,
        "sample_names": None,
        "sample_correction_mode": "exact",
        "sample_bc_ori": "forward",
    }


def _histogram(bcs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted (barcode, count) histogram; native hash counting when
    available."""
    if len(bcs) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    if _native.available() and len(bcs) > 16384:
        return _native.count_u64(bcs)
    uniq, counts = np.unique(bcs, return_counts=True)
    return uniq, counts.astype(np.uint64)


def _merge_histograms(a_bc, a_ct, b_bc, b_ct):
    """Merge two sorted histograms."""
    if len(a_bc) == 0:
        return b_bc, b_ct
    if len(b_bc) == 0:
        return a_bc, a_ct
    bc = np.concatenate([a_bc, b_bc])
    ct = np.concatenate([a_ct, b_ct])
    order = np.argsort(bc, kind="stable")
    bc, ct = bc[order], ct[order]
    new = np.ones(len(bc), bool)
    new[1:] = bc[1:] != bc[:-1]
    starts = np.flatnonzero(new)
    return bc[starts], np.add.reduceat(ct, starts).astype(np.uint64)


def _iter_block_barcodes(fh, schema, num_chunks, strand):
    """Yield (barcodes u64, strand-compatible mask, alignments per read)
    per streamed block: byte-level through the native codec, else
    through the columnar decoder."""
    ori_mode = {STRAND_BOTH: 0, STRAND_FW: 1}.get(strand, 2)
    ref_width = (
        dict(schema.aln_fields).get(schema.ref_field)
        if schema.ref_field is not None else None
    )
    if _native.available() and (ori_mode == 0 or ref_width == 4):
        bc_off, bc_width, ref_off = record_layout(schema)
        for buf, region_starts, chunk_recs in iter_raw_blocks(
            fh, num_chunks, GPL_BLOCK_RECORDS, prefetch=True,
        ):
            rec_starts, num_aln = _native.walk_records(
                buf, region_starts, chunk_recs, schema.read_bytes, schema.aln_bytes,
            )
            bcs = _gather_uint(buf, rec_starts + 4 + bc_off, bc_width)
            if ori_mode == 0:
                compat = num_aln > 0
            else:
                compat = _native.ori_counts(
                    buf, rec_starts, num_aln, schema.read_bytes,
                    schema.aln_bytes, ref_off, ori_mode,
                ) > 0
            yield bcs, compat, num_aln
        return
    for block in iter_decoded_blocks(
        fh, schema, num_chunks, GPL_BLOCK_RECORDS, prefetch=True,
    ):
        compat = read_strand_mask(block.dirs, block.aln_offsets, strand)
        yield block.barcode(), compat, block.num_aln_per_read


def generate_permit_list(opts: GenPermitListOpts) -> int:
    """Run the stage; returns the number of distinct corrected barcodes
    (src/cellfilter.rs:487)."""
    if opts.fmeth.kind != "unfiltered":
        raise NotImplementedError(
            f"filtered permit lists ({opts.fmeth.describe()}) are not ported "
            "yet; use --unfiltered-pl"
        )
    with open(Path(opts.input_dir) / "map.rad", "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        rec_type, _info = record_type_from_prelude(prelude, ftm)
        if rec_type == KnownRecordType.ATAC:
            raise ValueError(
                'To process atac-seq data, you should use the "atac" sub-command'
            )
        if rec_type == KnownRecordType.RNA_MULTI_BC:
            raise NotImplementedError("multi-barcode (Flex) inputs are not ported yet")
        schema = RecordSchema.from_prelude(prelude)
        if prelude.hdr.num_chunks == 0:
            raise ValueError(
                "The RAD file appears to have no chunks; this most commonly "
                "occurs when no reads are mapped due to an incorrect chemistry"
            )
        log.info(
            "record type %s; ref_count %d; num_chunks %d",
            rec_type.value, prelude.hdr.ref_count, prelude.hdr.num_chunks,
        )
        strand = strand_from_ori_arg(opts.expected_ori)
        num_reads = num_compat = max_ambig = 0
        h_bc = np.zeros(0, np.uint64)
        h_ct = np.zeros(0, np.uint64)
        with stage_timer(log, "generate-permit-list histogram", "reads") as pb:
            for bcs, compat, nal in _iter_block_barcodes(
                fh, schema, prelude.hdr.num_chunks, strand,
            ):
                pb.update(len(bcs))
                num_reads += len(bcs)
                nc = int(compat.sum())
                num_compat += nc
                if nc:
                    max_ambig = max(max_ambig, int(nal[compat].max()))
                b_bc, b_ct = _histogram(bcs[compat] if nc < len(bcs) else bcs)
                h_bc, h_ct = _merge_histograms(h_bc, h_ct, b_bc, b_ct)
    log.info(
        "observed %d reads (%d orientation consistent); max ambiguity %d refs",
        num_reads, num_compat, max_ambig,
    )
    out_dir = Path(opts.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return _process_unfiltered(
        opts, h_bc, h_ct, int(ftm["cblen"]), num_reads, max_ambig, out_dir
    )


def rescue_and_write(
    wl_sorted: np.ndarray,
    uniq: np.ndarray,
    counts: np.ndarray,
    bclen: int,
    min_reads: int,
    num_reads: int,
    device: torch.device,
    out_dir: Path,
) -> int:
    """Keep the whitelisted barcodes (``wl_sorted``, unique) of the
    histogram ``uniq``/``counts`` with >= min_reads reads; rescue every
    other observed barcode that has a unique Hamming-1 kept neighbour
    (src/cellfilter.rs:105-333, shared by the ATAC gpl); write
    permit_freq.bin and permit_map.bin.  Returns the number of distinct
    corrected barcodes."""
    log.info("number of unfiltered bcs read = %d", len(wl_sorted))
    idx = np.minimum(np.searchsorted(wl_sorted, uniq), max(len(wl_sorted) - 1, 0))
    in_wl = wl_sorted[idx] == uniq if len(wl_sorted) else np.zeros(len(uniq), bool)
    matched_bc, matched_ct = uniq[in_wl], counts[in_wl]
    unmatched_bc, unmatched_ct = uniq[~in_wl], counts[~in_wl]
    num_unmatched_reads = int(unmatched_ct.sum())
    if num_reads > 0:
        frac = num_unmatched_reads / num_reads
        if frac >= 0.3:
            log.warning(
                "Percentage of mapped reads not matching a known barcode "
                "exactly (%.3f%%) is > the suggested fraction (30%%)", frac * 100,
            )
        else:
            log.info(
                "%.3f%% of mapped reads did not match a known barcode exactly "
                "(< 30%% warning threshold)", frac * 100,
            )

    # barcodes below min_reads join the unmatched pool for the rescue
    # (src/cellfilter.rs:124-156)
    keep = matched_ct >= int(min_reads)
    kept_bc = matched_bc[keep]
    kept_ct = matched_ct[keep].copy()
    log.info("num_passing = %d", len(kept_bc))

    rescue_bc = np.concatenate([unmatched_bc, matched_bc[~keep]])
    rescue_ct = np.concatenate([unmatched_ct, matched_ct[~keep]])
    order = np.argsort(rescue_bc, kind="stable")
    rescue_bc, rescue_ct = rescue_bc[order], rescue_ct[order]

    ncounts, reps = bcops.find_neighbors(rescue_bc, kept_bc, bclen, device)
    # a unique single-mismatch neighbour that is not the barcode itself
    rescued = (ncounts == 1) & (reps != rescue_bc)
    num_corrected = int(rescued.sum())
    log.info(
        "of %d distinct unmatched barcodes: %d recoverable; reads: %d rescued, "
        "%d ambiguous, %d not found",
        len(rescue_bc), num_corrected, int(rescue_ct[rescued].sum()),
        int(rescue_ct[ncounts > 1].sum()), int(rescue_ct[ncounts == 0].sum()),
    )
    if num_corrected:
        np.add.at(kept_ct, np.searchsorted(kept_bc, reps[rescued]), rescue_ct[rescued])

    bincodeio.write_permit_freq(out_dir / "permit_freq.bin", bclen, kept_bc, kept_ct)
    # correction map: kept -> itself, rescued -> its unique neighbour
    bincodeio.write_u64_map_file(
        out_dir / "permit_map.bin",
        np.concatenate([kept_bc, rescue_bc[rescued]]),
        np.concatenate([kept_bc, reps[rescued]]),
    )
    return num_corrected


def _process_unfiltered(
    opts: GenPermitListOpts,
    uniq: np.ndarray,
    counts: np.ndarray,
    bclen: int,
    num_reads: int,
    max_ambig: int,
    out_dir: Path,
) -> int:
    """Keep permit-list barcodes with >= min_reads reads; rescue every
    other observed barcode that has a unique Hamming-1 kept neighbour
    (src/cellfilter.rs:105-333)."""
    wl, first_bclen = read_barcode_file(opts.fmeth.path)
    if first_bclen != bclen:
        log.warning(
            "provided permit list has barcodes of length %d but mapped reads "
            "have barcodes of length %d", first_bclen, bclen,
        )
    num_corrected = rescue_and_write(
        np.unique(wl), uniq, counts, bclen, opts.fmeth.min_reads, num_reads,
        opts.device, out_dir,
    )
    write_json(out_dir / "generate_permit_list.json", {
        "velo_mode": False,
        "expected_ori": strand_from_ori_arg(opts.expected_ori),
        "version_str": opts.version,
        "max-ambig-record": max_ambig,
        "cmd": opts.cmdline,
        "permit-list-type": "unfiltered",
        "gpl_options": _serialize_opts(opts),
    })
    log.info("total number of distinct corrected barcodes: %d", num_corrected)
    return num_corrected
