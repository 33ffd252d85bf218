"""quant, cr-like resolution (port of the combined cr-like fast path of
``alevin_fry_tpu/pipeline/quant.py``).

With ``-r cr-like`` (and, in USA mode, the winner-take-all spliced
ambiguity model) every cell resolves by the same gene-unique / USA
winner-take-all rule (src/quant.rs:453 for small cells, :822 for
large), so each block of whole cells goes through one pass of the
device WTA resolver (``ops/crlike_device.py``).  The collated file
(``map.collated.rad``, or the snappy stream ``map.collated.rad.sz``
after ``collate -c``) streams in blocks of whole cells, synchronously.

Outputs the reference's artifacts: alevin/quants_mat.mtx with its rows
and cols files, featureDump.txt and quant.json.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..radz import KnownRecordType, record_type_from_prelude
from ..radz.chunkio import ReadBatch, iter_decoded_blocks
from ..radz.mtx import format_f32_list, write_matrix_market
from ..radz.records import RecordSchema
from ..radz.unmapped import UnmappedLookup

from .. import __version__
from ..ops.barcodes import unpack_seqs
from ..ops.crlike import wta_counts_device
from ..utils import parse_tg_map, write_json
from .collate import open_collated
from .logging_ import get_logger
from .progress import stage_timer

log = get_logger("quant")

# reads per streamed block of whole cells
QUANT_BLOCK_RECORDS = 30_000_000


@dataclass
class QuantOpts:
    input_dir: Path
    tg_map: Path
    output_dir: Path
    device: torch.device  # where the WTA resolver runs
    num_threads: int = 8
    num_bootstraps: int = 0
    init_uniform: bool = False
    summary_stat: bool = False
    dump_eq: bool = False
    resolution: str = "cr-like"
    pug_exact_umi: bool = False
    sa_model: str = "winner-take-all"
    small_thresh: int = 10
    large_graph_thresh: int = 1000
    filter_list: Optional[Path] = None
    cmdline: str = ""
    version: str = __version__


@dataclass
class CellResult:
    cells: np.ndarray      # processed cell (chunk) indices, in row order
    cell_bcs: np.ndarray   # uint64 barcode per processed cell
    nrec: np.ndarray       # mapped records per processed cell
    rows: np.ndarray       # MTX COO
    cols: np.ndarray
    vals: np.ndarray
    cell_stats: tuple      # (sum_umi, max_umi, num_expr, over_mean) per row


def _check_supported(opts: QuantOpts, usa_mode: bool) -> None:
    """The port runs the cr-like fast path only."""
    if opts.resolution != "cr-like":
        raise NotImplementedError(
            f"the {opts.resolution} resolution is not ported yet (only cr-like)"
        )
    if opts.dump_eq:
        raise NotImplementedError("--dump-eqclasses is not ported yet")
    if opts.num_bootstraps:
        raise NotImplementedError("bootstraps are not ported yet")
    if opts.filter_list is not None:
        raise NotImplementedError("--quant-subset is not ported yet")
    if usa_mode and opts.sa_model != "winner-take-all":
        raise NotImplementedError(
            f"--sa-model {opts.sa_model} (prefer-ambig) is not ported yet"
        )


def quantify(opts: QuantOpts) -> None:
    parent = Path(opts.input_dir)
    if (parent / "collation_manifest.bin").exists():
        raise NotImplementedError("multi-barcode (Flex) quantification is not ported yet")
    with open_collated(parent) as (br, prelude, ftm):
        _do_quantify(br, prelude, ftm, opts, parent)


def _do_quantify(br, prelude, ftm, opts: QuantOpts, parent: Path) -> None:
    rec_type, _info = record_type_from_prelude(prelude, ftm)
    if rec_type == KnownRecordType.ATAC:
        raise ValueError(
            'To process atac-seq data, you should use the "atac" sub-command'
        )
    schema = RecordSchema.from_prelude(prelude)
    hdr = prelude.hdr
    log.info(
        "quantifying %d cells over %d references (record type %s)",
        hdr.num_chunks, hdr.ref_count, rec_type.value,
    )
    tid_to_gid, gene_names, gene_name_to_id, usa_mode = parse_tg_map(
        Path(opts.tg_map), hdr.ref_names
    )
    _check_supported(opts, usa_mode)
    if usa_mode:
        mid = max(gene_name_to_id.values()) + 2
        num_rows = mid + mid // 2
    else:
        num_rows = len(gene_name_to_id)
    log.info(
        "tg-map contained %d genes mapping to %d transcripts (usa_mode=%s)",
        len(gene_name_to_id), len(tid_to_gid), usa_mode,
    )
    barcode_len = int(ftm.get("cblen") or ftm.get("b1len") or ftm.get("b0len"))
    unmapped = UnmappedLookup.from_file(parent / "unmapped_bc_count_collated.bin")

    # blocks of whole cells: cells are independent, so each block
    # resolves on its own; only each cell's first barcode is read
    parts: List[CellResult] = []
    with stage_timer(log, "quant resolve", "reads") as pb:
        for batch in iter_decoded_blocks(
            br, schema, hdr.num_chunks, QUANT_BLOCK_RECORDS,
            skip_read_fields=set(schema.barcode_fields), want_dirs=False,
            prefetch=True,
        ):
            pb.update(batch.n_reads)
            parts.append(_resolve_cells(batch, tid_to_gid, usa_mode, num_rows, opts.device))
    _write_outputs(
        opts, _merge_results(parts), gene_names, usa_mode, num_rows,
        barcode_len, unmapped,
    )


def _coo_cell_stats(rows: np.ndarray, vals: np.ndarray, n_cells: int) -> tuple:
    """Per-row featureDump stats from COO triplets sorted by row."""
    sum_umi = np.zeros(n_cells, np.float32)
    max_umi = np.zeros(n_cells, np.float32)
    num_expr = np.zeros(n_cells, np.int64)
    over_mean = np.zeros(n_cells, np.int64)
    if len(rows):
        starts = np.flatnonzero(np.concatenate(([True], rows[1:] != rows[:-1])))
        ridx = rows[starts]
        sum_umi[ridx] = np.add.reduceat(vals, starts)
        max_umi[ridx] = np.maximum.reduceat(vals, starts)
        num_expr[ridx] = np.add.reduceat((vals > 0).astype(np.int64), starts)
        with np.errstate(invalid="ignore", divide="ignore"):
            mean_expr = sum_umi / num_expr.astype(np.float32)
        over_mean[ridx] = np.add.reduceat(
            (vals > mean_expr[rows]).astype(np.int64), starts
        )
    return sum_umi, max_umi, num_expr, over_mean


def _resolve_cells(
    batch: ReadBatch, tid_to_gid: np.ndarray, usa_mode: bool, num_rows: int,
    device: torch.device,
) -> CellResult:
    """One block of whole cells through the device WTA resolver.  Rows
    are the block's non-empty cells in file order."""
    first = batch.first_chunk
    cell_of_read = batch.chunk_id - first
    nrec_all = np.diff(batch.chunk_offsets)
    processed = np.flatnonzero(nrec_all > 0)
    cell_row = np.full(len(nrec_all), -1, np.int64)
    cell_row[processed] = np.arange(len(processed))
    cell_bcs = batch.barcode_at(batch.chunk_offsets[:-1][processed])

    cells, cols, vals = wta_counts_device(
        cell_of_read, batch.umi, batch.refs, batch.aln_offsets, tid_to_gid,
        num_rows, device, usa=usa_mode,
    )
    # the resolver emits triplets sorted by (cell, column), and cell_row
    # is monotone, so rows stay sorted
    rows = cell_row[cells]
    return CellResult(
        cells=processed + first, cell_bcs=cell_bcs, nrec=nrec_all[processed],
        rows=rows, cols=cols, vals=vals,
        cell_stats=_coo_cell_stats(rows, vals, len(processed)),
    )


def _merge_results(parts: List[CellResult]) -> CellResult:
    """Concatenate per-block results; block rows shift by the rows of
    the blocks before them."""
    if len(parts) == 1:
        return parts[0]
    z64, zf32 = np.zeros(0, np.int64), np.zeros(0, np.float32)
    parts = [CellResult(z64, np.zeros(0, np.uint64), z64, z64, z64, zf32,
                        (zf32, zf32, z64, z64))] + parts
    offs = np.cumsum([0] + [len(p.cells) for p in parts])

    def cat(field):
        return np.concatenate([getattr(p, field) for p in parts])

    return CellResult(
        cells=cat("cells"), cell_bcs=cat("cell_bcs"), nrec=cat("nrec"),
        rows=np.concatenate([p.rows + o for p, o in zip(parts, offs)]),
        cols=cat("cols"), vals=cat("vals"),
        cell_stats=tuple(
            np.concatenate([p.cell_stats[i] for p in parts]) for i in range(4)
        ),
    )


def _write_outputs(
    opts: QuantOpts,
    result: CellResult,
    gene_names: List[str],
    usa_mode: bool,
    num_rows: int,
    barcode_len: int,
    unmapped: UnmappedLookup,
) -> None:
    out_path = Path(opts.output_dir)
    mat_path = out_path / "alevin"
    mat_path.mkdir(parents=True, exist_ok=True)
    n_rows_out = len(result.cells)

    # quants_mat_cols.txt (src/quant.rs:1745-1768)
    with open(mat_path / "quants_mat_cols.txt", "w") as fh:
        fh.write("".join(f"{g}\n" for g in gene_names))
        if usa_mode:
            fh.write("".join(f"{g}-U\n" for g in gene_names))
            fh.write("".join(f"{g}-A\n" for g in gene_names))

    bc_u = (
        unpack_seqs(result.cell_bcs, barcode_len).view(f"S{barcode_len}").ravel()
        .astype(f"U{barcode_len}")
        if n_rows_out else np.zeros(0, dtype="U1")
    )
    sum_umi, max_umi, num_expr, over_mean = result.cell_stats
    nm_v = result.nrec.astype(np.int64)
    nu_v = unmapped.get(result.cell_bcs).astype(np.int64)
    with np.errstate(invalid="ignore", divide="ignore"):
        mean_expr = (sum_umi / num_expr.astype(np.float32)).astype(np.float32)
        mean_by_max = (mean_expr / max_umi).astype(np.float32)
        mapping_rate = nm_v.astype(np.float32) / (nm_v + nu_v).astype(np.float32)
        dedup_rate = sum_umi / nm_v.astype(np.float32)

    tab = np.full(n_rows_out, "\t", dtype="U1")
    line = np.char.add(bc_u, tab)
    for piece in (
        (nm_v + nu_v).astype("U20"), tab, nm_v.astype("U20"), tab,
        np.asarray(format_f32_list(sum_umi), dtype="U"), tab,
        np.asarray(format_f32_list(mapping_rate), dtype="U"), tab,
        np.asarray(format_f32_list(dedup_rate), dtype="U"), tab,
        np.asarray(format_f32_list(mean_by_max), dtype="U"), tab,
        num_expr.astype("U20"), tab, over_mean.astype("U20"),
        np.full(n_rows_out, "\n", dtype="U1"),
    ):
        line = np.char.add(line, piece)
    with open(mat_path / "quants_mat_rows.txt", "w") as fbc:
        fbc.write("\n".join(bc_u.tolist()) + ("\n" if n_rows_out else ""))
    with open(out_path / "featureDump.txt", "w") as ffd:
        ffd.write(
            "CB\tCorrectedReads\tMappedReads\tDeduplicatedReads\tMappingRate\t"
            "DedupRate\tMeanByMax\tNumGenesExpressed\tNumGenesOverMean\n"
        )
        ffd.write("".join(line.tolist()))

    write_matrix_market(
        mat_path / "quants_mat.mtx", result.rows, result.cols, result.vals,
        (n_rows_out, num_rows),
    )
    write_json(out_path / "quant.json", {
        "cmd": opts.cmdline,
        "version_str": opts.version,
        "resolution_strategy": "CellRangerLike",
        "num_quantified_cells": n_rows_out,
        "num_genes": num_rows,
        "dump_eq": opts.dump_eq,
        "usa_mode": usa_mode,
        "alt_resolved_cell_numbers": [],
        "empty_resolved_cell_numbers": [int(c) for c in result.cells[num_expr == 0]],
        "quant_options": {
            "input_dir": str(opts.input_dir),
            "tg_map": str(opts.tg_map),
            "output_dir": str(opts.output_dir),
            "num_threads": opts.num_threads,
            "num_bootstraps": opts.num_bootstraps,
            "init_uniform": opts.init_uniform,
            "summary_stat": opts.summary_stat,
            "dump_eq": opts.dump_eq,
            "resolution": "CellRangerLike",
            "pug_exact_umi": opts.pug_exact_umi,
            "sa_model": opts.sa_model,
            "small_thresh": opts.small_thresh,
            "large_graph_thresh": opts.large_graph_thresh,
            "filter_list": None,
            "cmdline": opts.cmdline,
            "version": opts.version,
        },
    })
    log.info("finished quantifying %d cells", n_rows_out)
