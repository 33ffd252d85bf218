"""generate-permit-list (RNA) (port of ``alevin_fry_tpu/pipeline/gpl.py``,
reference src/cellfilter.rs).

The per-barcode read histogram of the orientation-compatible reads is
host work: the native codec walks the RAD records and hash-counts the
barcodes.  Then one of the cell filters chooses the cells:

* the unfiltered external list (cellfilter.rs:105-333) keeps the listed
  barcodes with enough reads and rescues every other barcode that has a
  unique kept barcode within Hamming distance 1, on kernel K4 on the
  chosen device;
* the filtered methods (cellfilter.rs:336-480) — the knee of the
  frequency curve, the top ``-f`` barcodes, the ``-e`` expected-cells
  threshold or an explicit list — keep barcodes by frequency or by name
  and map every 1-edit neighbour (substitution or indel) of a kept
  barcode to it.  This is host NumPy, as in the reference.

Outputs the reference's artifacts: permit_freq.bin, permit_map.bin
(all_freq.bin too for a filtered method) and generate_permit_list.json.
A multi-barcode (Flex) input goes through ``pipeline/gpl_multi.py``,
which filters each sample's cells.

In a multi-process run (``parallel/dist.py``) each rank histograms its
contiguous range of the RAD chunks; the histograms and the read counts
merge over collectives, every rank filters the merged histogram (so
every rank runs the rescue) and rank 0 writes the artifacts.  In a
one-process run with the unfiltered list, ``AFT_GPL_MESH`` counts the
whitelisted barcodes on a device mesh (``parallel/mesh.py``) block by
block; only the unmatched tail is histogrammed on the host, and the two
merge before the rescue (cellfilter.rs:1762-1888).
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
from ..radz.chunkio import iter_decoded_blocks, iter_raw_blocks
from ..radz.records import RecordSchema

from .. import __version__, spans
from ..ops import barcodes as bcops
from ..ops.knee import get_knee
from ..parallel import dist
from ..parallel.mesh import mesh_from_env, sharded_histogram
from ..utils import (
    STRAND_BOTH, STRAND_FW, read_barcode_file, read_strand_mask,
    record_layout, sorted_unique, strand_from_ori_arg, write_json,
)
from .logging_ import get_logger
from .progress import Progress

log = get_logger("gpl")

# reads per streamed block of the histogram pass
GPL_BLOCK_RECORDS = 20_000_000


@dataclass
class CellFilterMethod:
    """The cell filter (src/cellfilter.rs:51-71)."""

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
    # velocity mode: recorded in the JSON, where collate reads it (no
    # CLI flag sets it, as in the reference)
    velo_mode: bool = False
    cmdline: str = ""
    version: str = __version__
    # the multi-barcode (Flex) options (pipeline/gpl_multi.py); a plain
    # RNA input records them and uses none
    sample_bc_list: Optional[Path] = None
    sample_names: Optional[Path] = None
    sample_correction_mode: str = "exact"  # "exact" | "1-edit"
    sample_bc_ori: str = "forward"  # "forward" | "reverse"


def _serialize_opts(opts: GenPermitListOpts) -> dict:
    """The ``gpl_options`` record, field for field as the reference
    writes it."""
    return {
        "input_dir": str(opts.input_dir),
        "output_dir": str(opts.output_dir),
        "fmeth": opts.fmeth.describe(),
        "expected_ori": opts.expected_ori,
        "velo_mode": opts.velo_mode,
        "threads": opts.threads,
        "cmdline": opts.cmdline,
        "version": opts.version,
        "sample_bc_list": str(opts.sample_bc_list) if opts.sample_bc_list else None,
        "sample_names": str(opts.sample_names) if opts.sample_names else None,
        "sample_correction_mode": opts.sample_correction_mode,
        "sample_bc_ori": opts.sample_bc_ori,
    }


def _histogram(bcs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted (barcode, count) histogram, by native hash counting."""
    if len(bcs) == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    return _native.count_u64(bcs)


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


def _iter_block_barcodes(fh, schema, num_chunks, strand, chunk_range=None):
    """Yield (barcodes u64, strand-compatible mask, alignments per read)
    per streamed block of the chunks ``chunk_range`` (all when None):
    byte-level, else (a strand filter on a ref field other than 4 bytes
    wide) through the columnar decoder."""
    ori_mode = {STRAND_BOTH: 0, STRAND_FW: 1}.get(strand, 2)
    ref_width = (
        dict(schema.aln_fields).get(schema.ref_field)
        if schema.ref_field is not None else None
    )
    if ori_mode == 0 or ref_width == 4:
        bc_off, bc_width, ref_off = record_layout(schema)
        for buf, region_starts, chunk_recs in iter_raw_blocks(
            fh, num_chunks, GPL_BLOCK_RECORDS, prefetch=True, chunk_range=chunk_range,
        ):
            with spans.span("decode", "codec"):
                rec_starts, num_aln = _native.walk_records(
                    buf, region_starts, chunk_recs, schema.read_bytes, schema.aln_bytes,
                )
                spans.add("records", len(rec_starts))
                bcs = _native.gather_uint(buf, rec_starts + 4 + bc_off, bc_width)
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
        fh, schema, num_chunks, GPL_BLOCK_RECORDS, prefetch=True, chunk_range=chunk_range,
    ):
        with spans.span("decode", "codec"):
            compat = read_strand_mask(block.dirs, block.aln_offsets, strand)
        yield block.barcode(), compat, block.num_aln_per_read


def generate_permit_list(opts: GenPermitListOpts) -> int:
    """Run the stage; returns the number of distinct corrected barcodes
    (src/cellfilter.rs:487)."""
    rank, world = dist.rank_world()
    with open(Path(opts.input_dir) / "map.rad", "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        rec_type, info = record_type_from_prelude(prelude, ftm)
        if rec_type == KnownRecordType.ATAC:
            raise ValueError(
                'To process atac-seq data, you should use the "atac" sub-command'
            )
        schema = RecordSchema.from_prelude(prelude)
        chunk_range = None
        if world > 1:
            chunk_range = dist.host_chunk_plan(prelude.hdr.num_chunks, world, rank)
        if rec_type == KnownRecordType.RNA_MULTI_BC:
            from .gpl_multi import do_generate_permit_list_multi_bc

            if chunk_range is not None:
                log.info("multi-host multi-BC gpl: process %d/%d owns chunks [%d, %d)",
                         rank, world, *chunk_range)
            blocks = iter_decoded_blocks(
                fh, schema, prelude.hdr.num_chunks, GPL_BLOCK_RECORDS, prefetch=True,
                chunk_range=chunk_range,
            )
            return do_generate_permit_list_multi_bc(opts, blocks, info)
        if prelude.hdr.num_chunks == 0:
            raise ValueError(
                "The RAD file appears to have no chunks; this most commonly "
                "occurs when no reads are mapped due to an incorrect chemistry"
            )
        log.info(
            "record type %s; ref_count %d; num_chunks %d",
            rec_type.value, prelude.hdr.ref_count, prelude.hdr.num_chunks,
        )
        if chunk_range is not None:
            log.info("multi-host gpl: process %d/%d owns chunks [%d, %d)",
                     rank, world, *chunk_range)
        strand = strand_from_ori_arg(opts.expected_ori)
        num_reads = num_compat = max_ambig = 0
        h_bc = np.zeros(0, np.uint64)
        h_ct = np.zeros(0, np.uint64)
        mesh = None
        if opts.fmeth.kind == "unfiltered" and world == 1:
            mesh = mesh_from_env("AFT_GPL_MESH", opts.device)
        if mesh is not None:
            with spans.span("list_parse", "codec"):
                wl_mesh = sorted_unique(read_barcode_file(opts.fmeth.path)[0])
            wl_counts = np.zeros(len(wl_mesh), np.int64)
        with spans.span("histogram", "resolution"), \
                Progress("generate-permit-list histogram", "reads") as pb:
            for bcs, compat, nal in _iter_block_barcodes(
                fh, schema, prelude.hdr.num_chunks, strand, chunk_range,
            ):
                pb.update(len(bcs))
                num_reads += len(bcs)
                nc = int(compat.sum())
                num_compat += nc
                if nc:
                    max_ambig = max(max_ambig, int(nal[compat].max()))
                kept = bcs[compat] if nc < len(bcs) else bcs
                if mesh is not None and len(kept):
                    cnt, _unmatched, hit = sharded_histogram(mesh, kept, wl_mesh)
                    wl_counts += cnt
                    kept = kept[~hit]
                b_bc, b_ct = _histogram(kept)
                h_bc, h_ct = _merge_histograms(h_bc, h_ct, b_bc, b_ct)
        if mesh is not None:
            nz = wl_counts > 0
            h_bc, h_ct = _merge_histograms(h_bc, h_ct, wl_mesh[nz],
                                           wl_counts[nz].astype(np.uint64))
    if world > 1:
        h_bc, h_ct = merge_rank_histograms(h_bc, h_ct)
        num_reads, num_compat, max_ambig = dist.merge_counts([num_reads, num_compat],
                                                             [max_ambig])
    log.info(
        "observed %d reads (%d orientation consistent); max ambiguity %d refs",
        num_reads, num_compat, max_ambig,
    )
    out_dir = Path(opts.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    # every rank filters the merged histogram; only rank 0 writes
    write = rank == 0
    if opts.fmeth.kind == "unfiltered":
        n = _process_unfiltered(
            opts, h_bc, h_ct, int(ftm["cblen"]), num_reads, max_ambig, out_dir, write
        )
    else:
        n = _process_filtered(opts, h_bc, h_ct, int(ftm["cblen"]), max_ambig, out_dir, write)
    dist.barrier()
    return n


def merge_rank_histograms(h_bc: np.ndarray, h_ct: np.ndarray):
    """Every rank's sorted (barcode, count) histogram merged, in rank
    order, on every rank."""
    m_bc, m_ct = np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    for p_bc, p_ct in zip(dist.allgather_ragged(np.asarray(h_bc, np.uint64)),
                          dist.allgather_ragged(np.asarray(h_ct, np.uint64))):
        m_bc, m_ct = _merge_histograms(m_bc, m_ct, p_bc, p_ct)
    return m_bc, m_ct


def rescue_and_write(
    wl_sorted: np.ndarray,
    uniq: np.ndarray,
    counts: np.ndarray,
    bclen: int,
    min_reads: int,
    num_reads: int,
    device: torch.device,
    out_dir: Path,
    write: bool = True,
) -> int:
    """Keep the whitelisted barcodes (``wl_sorted``, unique) of the
    histogram ``uniq``/``counts`` with >= min_reads reads; rescue every
    other observed barcode that has a unique Hamming-1 kept neighbour
    (src/cellfilter.rs:105-333, shared by the ATAC gpl); write
    permit_freq.bin and permit_map.bin (unless ``write`` is false: a
    rank other than 0).  Returns the number of distinct corrected
    barcodes."""
    with spans.span("rescue", "resolution"):
        kept_bc, kept_ct, rescue_bc, reps, rescued = _rescue(
            wl_sorted, uniq, counts, bclen, min_reads, num_reads, device)
    if not write:
        return int(rescued.sum())
    with spans.span("write", "codec"):
        bincodeio.write_permit_freq(out_dir / "permit_freq.bin", bclen, kept_bc, kept_ct)
        # correction map: kept -> itself, rescued -> its unique neighbour
        bincodeio.write_u64_map_file(
            out_dir / "permit_map.bin",
            np.concatenate([kept_bc, rescue_bc[rescued]]),
            np.concatenate([kept_bc, reps[rescued]]),
        )
        spans.wrote(out_dir / "permit_freq.bin", out_dir / "permit_map.bin")
    return int(rescued.sum())


def _rescue(wl_sorted, uniq, counts, bclen, min_reads, num_reads, device):
    """The kept barcodes and their counts after the rescue, the rescue's
    candidates, their neighbours and which of them were rescued."""
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
    return kept_bc, kept_ct, rescue_bc, reps, rescued


def _process_unfiltered(
    opts: GenPermitListOpts,
    uniq: np.ndarray,
    counts: np.ndarray,
    bclen: int,
    num_reads: int,
    max_ambig: int,
    out_dir: Path,
    write: bool = True,
) -> int:
    """Keep permit-list barcodes with >= min_reads reads; rescue every
    other observed barcode that has a unique Hamming-1 kept neighbour
    (src/cellfilter.rs:105-333)."""
    with spans.span("list_parse", "codec"):
        wl, first_bclen = read_barcode_file(opts.fmeth.path)
        wl = sorted_unique(wl)
    if first_bclen != bclen:
        log.warning(
            "provided permit list has barcodes of length %d but mapped reads "
            "have barcodes of length %d", first_bclen, bclen,
        )
    num_corrected = rescue_and_write(
        wl, uniq, counts, bclen, opts.fmeth.min_reads, num_reads,
        opts.device, out_dir, write,
    )
    if write:
        _write_gpl_json(opts, max_ambig, out_dir, "unfiltered")
    log.info("total number of distinct corrected barcodes: %d", num_corrected)
    return num_corrected


def _write_gpl_json(opts: GenPermitListOpts, max_ambig: int, out_dir: Path,
                    list_type: str) -> None:
    write_json(out_dir / "generate_permit_list.json", {
        "velo_mode": opts.velo_mode,
        "expected_ori": strand_from_ori_arg(opts.expected_ori),
        "version_str": opts.version,
        "max-ambig-record": max_ambig,
        "cmd": opts.cmdline,
        "permit-list-type": list_type,
        "gpl_options": _serialize_opts(opts),
    })


def _filtered_cells(meth: CellFilterMethod, uniq: np.ndarray, counts: np.ndarray,
                    bclen: int) -> np.ndarray:
    """The permitted barcodes of a filtered method, in the priority
    order of contested 1-edit neighbours: by descending read count, then
    ascending barcode, for the frequency methods (a barcode passes at
    the count of the ``n``-th most frequent one); in file order for an
    explicit list (docs/parity.md:48-53)."""
    if meth.kind == "explicit":
        with spans.span("list_parse", "codec"):
            return read_barcode_file(meth.path, bclen)[0]
    freq = np.sort(counts)[::-1]
    if meth.kind == "knee":
        min_freq = int(freq[get_knee(freq, 100)])
    elif meth.kind == "force":
        min_freq = int(freq[min(len(freq), meth.count) - 1])
    elif meth.kind == "expect":
        # the 0.99 robust quantile's count over 10, at least 1
        robust_freq = int(freq[min(len(freq) - 1, int(round(meth.count * 0.99)))])
        min_freq = max(1, int(round(robust_freq / 10.0)))
    else:
        raise ValueError(f"unsupported filter method {meth.kind}")
    valid = counts >= min_freq
    valid_bc = uniq[valid]
    if meth.kind == "knee":
        log.info("knee distance method resulted in the selection of %d permitted "
                 "barcodes.", len(valid_bc))
    return valid_bc[np.lexsort((valid_bc, -counts[valid].astype(np.int64)))]


def _process_filtered(
    opts: GenPermitListOpts,
    uniq: np.ndarray,
    counts: np.ndarray,
    bclen: int,
    max_ambig: int,
    out_dir: Path,
    write: bool = True,
) -> int:
    """Keep the filtered method's barcodes, map every 1-edit neighbour
    of a kept barcode to it, and correct the histogram through that map
    (src/cellfilter.rs:336-480)."""
    cells = _filtered_cells(opts.fmeth, uniq, counts, bclen)
    with spans.span("filter", "resolution"):
        map_keys, map_vals = bcops.generate_permitlist_map(cells, bclen)
        # the keys come sorted and unique
        idx = np.minimum(np.searchsorted(map_keys, uniq), max(len(map_keys) - 1, 0))
        hit = map_keys[idx] == uniq if len(map_keys) else np.zeros(len(uniq), bool)
        num_corrected = int(hit.sum())
        perm_bc, inv = np.unique(map_vals[idx[hit]], return_inverse=True)
        perm_ct = np.zeros(len(perm_bc), np.uint64)
        np.add.at(perm_ct, inv, counts[hit])
    if write:
        with spans.span("write", "codec"):
            bincodeio.write_permit_freq(out_dir / "permit_freq.bin", bclen, perm_bc, perm_ct)
            bincodeio.write_permit_freq(out_dir / "all_freq.bin", bclen, uniq, counts)
            bincodeio.write_u64_map_file(out_dir / "permit_map.bin", map_keys, map_vals)
            spans.wrote(*(out_dir / n for n in ("permit_freq.bin", "all_freq.bin",
                                                "permit_map.bin")))
        _write_gpl_json(opts, max_ambig, out_dir, "filtered")
    log.info("total number of distinct corrected barcodes: %d", num_corrected)
    return num_corrected
