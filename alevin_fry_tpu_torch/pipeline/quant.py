"""quant: per-cell UMI resolution and gene-level counts (port of
``alevin_fry_tpu/pipeline/quant.py``).

The collated file (``map.collated.rad``, or the snappy stream
``map.collated.rad.sz`` after ``collate -c``) streams in blocks of whole
cells, synchronously; ``--quant-subset`` keeps the cells whose first
record's barcode is listed (src/quant.rs:1732-1743).  In each block:

* cells with fewer than 100 records resolve by the winner-take-all rule
  on the device whatever the resolution (src/quant.rs:433, :760), and
  so do the larger ones under ``-r cr-like``: without ``-d`` and with
  the winner-take-all spliced-ambiguity model the whole block goes
  through one pass of the device resolver (``ops/crlike_device.py``);
* larger cells otherwise take their resolution's path: ``cr-like``
  with ``--sa-model prefer-ambig`` the device resolver's gene-pair
  rule; ``cr-like`` with ``-d`` and ``cr-like-em`` the host tie sets
  grouped into per-cell equivalence classes, counted (only the classes
  the USA or gene-unique rules count) or solved by the EM on the device
  (kernel K6, ``ops/em.py``); ``trivial`` the host's distinct UMIs of
  single-gene reads; the ``parsimony`` family the UMI graphs of
  ``ops/pug.py`` (their connected components on the device, kernel K7),
  whose gene-level classes are counted (USA or gene-unique, for
  ``parsimony`` and ``parsimony-gene``) or solved by the EM (the
  ``-em`` ones; long-read records weight it by their alignment
  probabilities outside USA mode).

With ``-b N`` the EM resolutions also run N bootstrap replicates of
every large cell's EM on the device (``ops/bootstrap.py``: the random
init on kernel K8, the replicate EMs on K6) and write their mean and
variance; as in the reference, USA mode refuses them.

Outputs the reference's artifacts: alevin/quants_mat.mtx with its rows
and cols files, featureDump.txt, quant.json (with the cells that took the
parsimony's large-component fallback), with ``-d``
alevin/geqc_counts.mtx and alevin/gene_eqclass.txt.gz, and with ``-b``
alevin/bootstraps_mean.mtx and alevin/bootstraps_var.mtx.  A
hierarchically collated (Flex) directory's ``collation_manifest.bin``
names the samples: each cell's manifest ordinal, in its first record's
barcodes[0], prefixes its row (``<sample>_<barcode>``) and fills
featureDump.txt's ``sample_name`` column, whatever the resolution.

The count triplets stay in memory up to ``QUANT_SPILL_TRIPLETS``;
past that they go to a binary sidecar and the matrix body streams from
it to disk in rounds of ``QUANT_MERGE_TRIPLETS`` (``radz/mtx.py``'s
``MtxStreamWriter``), the same bytes.  A multi-process run
(``parallel/dist.py``) is the same with N ranks: each resolves a
contiguous range of the cells holding about its share of the records,
and rank 0 writes every artifact, the matrix body streamed from the
ranks in rank order, the rest sent to it in rank order, with the rows of
each rank shifted by the cells of the ranks before it.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..radz import KnownRecordType, _native, record_type_from_prelude
from ..radz.chunkio import ReadBatch, chunk_record_counts, iter_decoded_blocks
from ..radz.collation import CollationManifest
from ..radz.constants import SMALL_CELL_FAST_THRESHOLD
from ..radz.mtx import MtxStreamWriter, format_f32_list, write_matrix_market
from ..radz.records import RecordSchema
from ..radz.unmapped import UnmappedLookup

from .. import __version__, spans
from ..ops import crlike, pug
from ..ops.barcodes import unpack_seqs
from ..ops.bootstrap import run_bootstraps
from ..ops.em import class_weights_from_prob_rows, em_cells
from ..parallel import dist
from ..parallel.mesh import mesh_from_env
from ..utils import parse_tg_map, read_barcode_file, sorted_unique, write_json
from .collate import open_collated
from .logging_ import get_logger
from .progress import Progress

log = get_logger("quant")

# reads per streamed block of whole cells
QUANT_BLOCK_RECORDS = 30_000_000
# count triplets held in memory before the matrix body streams to disk
QUANT_SPILL_TRIPLETS = 50_000_000
# triplets a round of the streamed matrix body moves
QUANT_MERGE_TRIPLETS = 4_000_000

# the reference serializes the enum's Debug name (src/quant.rs:92-96)
RESOLUTION_NAMES = {
    "trivial": "Trivial", "cr-like": "CellRangerLike", "cr-like-em": "CellRangerLikeEm",
    "parsimony": "Parsimony", "parsimony-em": "ParsimonyEm",
    "parsimony-gene": "ParsimonyGene", "parsimony-gene-em": "ParsimonyGeneEm",
}


@dataclass
class QuantOpts:
    input_dir: Path
    tg_map: Path
    output_dir: Path
    device: torch.device  # where the WTA resolver and the EM run
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
    # with -d: the large cells' classes as (row, label count, labels,
    # count) in class order
    eqc: Optional[tuple] = None
    # cells (file numbers) that took the parsimony's large-component fallback
    alt_cells: List[int] = field(default_factory=list)
    # with -b, when the EM ran: the bootstraps' (row, column, value)
    # triplets of the mean and of the variance
    boot_mean: Optional[tuple] = None
    boot_var: Optional[tuple] = None
    # multi-barcode (Flex) input: each processed cell's manifest ordinal
    sample_idx: Optional[np.ndarray] = None


def quantify(opts: QuantOpts) -> None:
    parent = Path(opts.input_dir)
    with open_collated(parent) as (br, prelude, ftm):
        _do_quantify(br, prelude, ftm, opts, parent)


def _read_sample_names(parent: Path) -> Optional[List[str]]:
    """The sample names of a hierarchically collated (Flex) directory,
    in manifest order, or None (src/quant.rs:1314-1330)."""
    path = parent / "collation_manifest.bin"
    if not path.exists():
        return None
    return [g.name if g.name is not None else f"{g.key:x}"
            for g in CollationManifest.read_from_file(path).sample_groups]


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
    with spans.span("manifest_read", "codec"):
        sample_names = _read_sample_names(parent)
    with spans.span("t2g_read", "codec"):
        tid_to_gid, gene_names, gene_name_to_id, usa_mode = parse_tg_map(
            Path(opts.tg_map), hdr.ref_names
        )
    if usa_mode and opts.num_bootstraps:
        # the reference's refusal (its assert), kept under python -O
        raise AssertionError("currently USA-mode analysis cannot be used with bootstrapping.")
    if usa_mode and opts.resolution == "trivial":
        raise ValueError("the trivial resolution strategy is not available in USA mode")
    sa_model = opts.sa_model
    if not usa_mode and sa_model != "winner-take-all":
        log.info("When not operating in USA-mode, the SplicedAmbiguityModel will be ignored.")
        sa_model = "winner-take-all"
    num_genes = len(gene_name_to_id)
    if usa_mode:
        mid = max(gene_name_to_id.values()) + 2
        num_rows = mid + mid // 2
    else:
        num_rows = num_genes
    log.info(
        "tg-map contained %d genes mapping to %d transcripts (usa_mode=%s)",
        num_genes, len(tid_to_gid), usa_mode,
    )
    barcode_len = int(ftm.get("cblen") or ftm.get("b1len") or ftm.get("b0len"))
    with spans.span("unmapped_read", "codec"):
        unmapped = UnmappedLookup.from_file(parent / "unmapped_bc_count_collated.bin")
    listed = None
    if opts.filter_list is not None:
        with spans.span("list_parse", "codec"):
            listed = sorted_unique(read_barcode_file(Path(opts.filter_list), barcode_len)[0])

    rank, world = dist.rank_world()
    chunk_range = None
    if world > 1:
        # the cells are chunks, largest first: split by records
        with open_collated(parent) as (fh, _prelude, _ftm):
            chunk_range = dist.record_chunk_plan(chunk_record_counts(fh, hdr.num_chunks),
                                                 world, rank)
        log.info("multi-host quant: process %d/%d owns cell chunks [%d, %d)",
                 rank, world, *chunk_range)
    mtx_path = Path(opts.output_dir) / "alevin" / "quants_mat.mtx"
    sink = _CooSpill(mtx_path.parent / f".quants_coo_r{rank}", QUANT_SPILL_TRIPLETS)
    # blocks of whole cells: cells are independent, so each block
    # resolves on its own; only each cell's first barcode is read
    parts: List[CellResult] = []
    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32))
    try:
        with spans.span("resolve", "resolution"), \
                Progress("quant resolve", "reads") as pb:
            for batch in iter_decoded_blocks(
                br, schema, hdr.num_chunks, QUANT_BLOCK_RECORDS,
                skip_read_fields=set(schema.barcode_fields), want_dirs=False,
                chunk_range=chunk_range, prefetch=True,
            ):
                pb.update(batch.n_reads)
                keep = np.ones(len(batch.chunk_offsets) - 1, bool)
                if listed is not None:
                    keep = np.isin(batch.barcode_at(batch.chunk_offsets[:-1]), listed)
                res = _resolve_cells(batch, keep, tid_to_gid, opts, sa_model, usa_mode,
                                     num_genes, num_rows, sample_names)
                # the triplets go to the sink, which shifts their rows
                sink.add(res.rows, res.cols, res.vals, len(res.cells))
                res.rows, res.cols, res.vals = empty
                parts.append(res)
            result = _merge_results(parts)
            mtx_written = world > 1 or sink.spilled
            if not mtx_written:
                result.rows, result.cols, result.vals = sink.concatenated()
        if sink.spilled:
            log.info("process %d: %d triplets spilled to the rank-local binary sidecar past "
                     "the %d in-memory bound; quants_mat.mtx streamed to disk", rank,
                     sink.nnz, QUANT_SPILL_TRIPLETS)
        if mtx_written:
            with spans.span("write", "codec"):
                _stream_merge_mtx(sink, len(result.cells), num_rows, mtx_path)
        if world > 1:
            result = _merge_hosts(result, opts,
                                  sample_names is not None and len(schema.barcode_fields) > 1)
    finally:
        sink.cleanup()
    if rank == 0:
        with spans.span("write", "codec"):
            _write_outputs(
                opts, result, gene_names, usa_mode, num_rows, barcode_len, unmapped,
                sample_names, mtx_written,
            )
    dist.barrier()


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


def _aln_index(batch: ReadBatch, idx: np.ndarray) -> tuple:
    """(alignment offsets, batch alignment indices) of the reads ``idx``."""
    nal = batch.num_aln_per_read[idx]
    offs = np.zeros(len(idx) + 1, np.int64)
    np.cumsum(nal, out=offs[1:])
    gather = np.repeat(batch.aln_offsets[:-1][idx], nal) + (
        np.arange(int(offs[-1])) - np.repeat(offs[:-1], nal)
    )
    return offs, gather


def _reads(batch: ReadBatch, cell_of_read: np.ndarray, sel: np.ndarray) -> tuple:
    """(cell, umi, refs, alignment offsets) of the reads ``sel`` marks."""
    if sel.all():
        return cell_of_read, batch.umi, batch.refs, batch.aln_offsets
    idx = np.flatnonzero(sel)
    offs, gather = _aln_index(batch, idx)
    return cell_of_read[idx], batch.umi[idx], batch.refs[gather], offs


def _aln_cols(batch: ReadBatch, sel: np.ndarray) -> dict:
    """The other alignment fields (name -> column) of the reads ``sel``
    marks: the long-read probabilities' inputs."""
    if sel.all():
        return batch.aln_cols
    gather = _aln_index(batch, np.flatnonzero(sel))[1]
    return {k: v[gather] for k, v in batch.aln_cols.items()}


def _is_long_read(schema: RecordSchema) -> bool:
    names = {n for n, _ in schema.aln_fields}
    return {"as", "start", "end"} <= names


def _longread_aln_probs(sub: dict) -> np.ndarray:
    """Per-alignment probabilities for long-read records: the product of
    the alignment-score model exp((AS - max_AS)/5) (eq_class.rs:20-38)
    and the 3'-end distance model (eq_class.rs:40-85), normalized to sum
    1 within each read."""
    offs = sub["offs"]
    n = len(offs) - 1
    nal = np.diff(offs)
    read_of_aln = np.repeat(np.arange(n), nal)
    as_raw = np.ascontiguousarray(
        sub["aln_cols"]["as"].astype(np.uint32)
    ).view(np.int32).astype(np.float64)
    max_as = np.full(n, -np.inf)
    np.maximum.at(max_as, read_of_aln, as_raw)
    score_p = np.exp((as_raw - max_as[read_of_aln]) / 5.0)

    ends = sub["aln_cols"]["end"].astype(np.float64)
    tlens = sub["aln_cols"].get("tlen")
    if tlens is None:
        # without a tlen tag the 3' model degenerates to distance 0
        tlens = ends
    else:
        tlens = tlens.astype(np.float64)
    dist = tlens - ends
    extra = np.maximum(dist - 100.0, 0.0)
    ln_w = -(extra * extra) * (0.5 / (100.0 * 100.0))
    ln_floor = -3.0 * np.log(10.0)
    end_p = np.exp(np.maximum(ln_w, ln_floor))

    final = score_p * end_p
    sums = np.zeros(n)
    np.add.at(sums, read_of_aln, final)
    ok = sums[read_of_aln] > 0
    final[ok] = final[ok] / sums[read_of_aln][ok]
    return final


def _resolve_cells(
    batch: ReadBatch, keep_cells: np.ndarray, tid_to_gid: np.ndarray, opts: QuantOpts,
    sa_model: str, usa_mode: bool, num_genes: int, num_rows: int,
    sample_names: Optional[List[str]],
) -> CellResult:
    """One block of whole cells (module docstring).  Rows are the
    block's kept non-empty cells in file order; with ``sample_names`` (a
    Flex input) each row also carries its sample's manifest ordinal."""
    first = batch.first_chunk
    cell_of_read = batch.chunk_id - first
    nrec_all = np.diff(batch.chunk_offsets)
    processed = np.flatnonzero(keep_cells & (nrec_all > 0))
    cell_row = np.full(len(nrec_all), -1, np.int64)
    cell_row[processed] = np.arange(len(processed))
    cell_bcs = batch.barcode_at(batch.chunk_offsets[:-1][processed])
    sample_idx = None
    if sample_names is not None and len(batch.schema.barcode_fields) > 1:
        # collate wrote the manifest ordinal into barcodes[0]
        # (src/quant.rs:1955-1956)
        sample_idx = batch.barcode_at(batch.chunk_offsets[:-1][processed], 0).astype(np.int64)
    read_keep = keep_cells[cell_of_read]
    large = read_keep & (nrec_all >= SMALL_CELL_FAST_THRESHOLD)[cell_of_read]
    prefer_ambig = usa_mode and sa_model == "prefer-ambig"

    def wta(sel, pa=False):
        return crlike.wta_counts_device(*_reads(batch, cell_of_read, sel), tid_to_gid,
                                        num_rows, opts.device, usa=usa_mode, prefer_ambig=pa)

    # each block of triplets comes sorted by (cell, column)
    blocks, eqc, alt_cells, classes, boot = [], None, [], None, None
    if opts.resolution == "cr-like" and not opts.dump_eq and not prefer_ambig:
        # small and large cells resolve alike (src/quant.rs:453, :822)
        blocks.append(wta(read_keep))
    else:
        if (read_keep & ~large).any():
            blocks.append(wta(read_keep & ~large))
        if large.any():
            reads = _reads(batch, cell_of_read, large)
            if opts.resolution == "trivial":
                blocks.append(crlike.resolve_trivial(*reads, tid_to_gid, len(nrec_all),
                                                     num_genes)[:3])
            elif opts.resolution == "cr-like" and not opts.dump_eq:
                blocks.append(wta(large, pa=True))
            elif opts.resolution.startswith("parsimony"):
                sub = dict(zip(("cell", "umi", "refs", "offs"), reads))
                probs = None
                if _is_long_read(batch.schema):
                    sub["aln_cols"] = _aln_cols(batch, large)
                    probs = _longread_aln_probs(sub)
                classes, alt, eq_probs = pug.resolve_parsimony_cells(
                    sub, tid_to_gid, opts.pug_exact_umi, opts.large_graph_thresh,
                    opts.resolution in ("parsimony-gene", "parsimony-gene-em"), opts.device,
                    probs,
                )
                alt_cells = [c + first for c in alt]
                if opts.resolution.endswith("-em"):
                    weights = None
                    if eq_probs is not None and not usa_mode:
                        # the long-read EM weights each label (em.rs:716-844)
                        weights = class_weights_from_prob_rows(classes.label_offsets, eq_probs)
                    counts, boot = _em_counts(classes, opts, usa_mode, num_genes, num_rows,
                                              first, weights)
                    blocks.append(counts)
                else:
                    blocks.append(_unique_counts(classes, usa_mode, num_rows))
            else:
                groups = crlike.resolve_crlike(*reads, tid_to_gid, prefer_ambig=prefer_ambig)
                classes = crlike.group_eqclasses(groups)
                if opts.resolution == "cr-like":
                    slots = (crlike.usa_slots_for_groups(groups, num_rows) if usa_mode
                             else crlike.nonusa_unique_slots(groups))
                    blocks.append(crlike.counts_from_slots(groups.cell, *slots, len(nrec_all),
                                                           num_rows))
                else:
                    counts, boot = _em_counts(classes, opts, usa_mode, num_genes, num_rows, first)
                    blocks.append(counts)
            if opts.dump_eq and classes is not None:
                eqc = (cell_row[np.repeat(classes.cell_ids, np.diff(classes.cell_eq_offsets))],
                       np.diff(classes.label_offsets), classes.labels, classes.counts)
    rows = np.concatenate([cell_row[b[0]] for b in blocks] or [np.zeros(0, np.int64)])
    cols = np.concatenate([np.asarray(b[1], np.int64) for b in blocks] or [np.zeros(0, np.int64)])
    vals = np.concatenate([np.asarray(b[2], np.float32) for b in blocks]
                          or [np.zeros(0, np.float32)])
    if len(blocks) > 1:
        # two sorted runs of distinct (row, column) keys: one merge
        order = np.argsort(rows * np.int64(num_rows) + cols, kind="stable")
        rows, cols, vals = rows[order], cols[order], vals[order]
    boot_mean = boot_var = None
    if boot is not None:
        boot_mean, boot_var = ((cell_row[r], c, v) for r, c, v in boot)
    return CellResult(
        cells=processed + first, cell_bcs=cell_bcs, nrec=nrec_all[processed],
        rows=rows, cols=cols, vals=vals,
        cell_stats=_coo_cell_stats(rows, vals, len(processed)), eqc=eqc, alt_cells=alt_cells,
        boot_mean=boot_mean, boot_var=boot_var, sample_idx=sample_idx,
    )


def _unique_counts(eqc: crlike.CellEqClasses, usa_mode: bool, num_rows: int) -> tuple:
    """The classes' counts without EM -> (cell, column, value) sorted by
    (cell, column): in USA mode each class counts for the slot of the USA
    rule (utils.rs:656-739), else only single-gene classes count."""
    if usa_mode:
        g = crlike.UmiGroups(
            cell=np.repeat(eqc.cell_ids, np.diff(eqc.cell_eq_offsets)),
            umi=np.zeros(len(eqc.counts), np.uint64),
            label_offsets=eqc.label_offsets,
            labels=eqc.labels,
        )
        slot, valid = crlike.usa_slots_for_groups(g, num_rows)
        c, col = g.cell[valid], slot[valid]
        w = eqc.counts[valid].astype(np.float32)
    else:
        sgl = np.diff(eqc.label_offsets) == 1
        c = np.repeat(eqc.cell_ids, np.diff(eqc.cell_eq_offsets))[sgl]
        col = eqc.labels[eqc.label_offsets[:-1][sgl]].astype(np.int64)
        w = eqc.counts[sgl].astype(np.float32)
    key = c * np.int64(num_rows) + col
    uk, inv = np.unique(key, return_inverse=True)
    agg = np.zeros(len(uk), np.float32)
    np.add.at(agg, inv, w)
    return uk // num_rows, uk % num_rows, agg


def _em_counts(eqc: crlike.CellEqClasses, opts: QuantOpts, usa_mode: bool,
               num_genes: int, num_rows: int, first: int,
               weights: Optional[np.ndarray] = None) -> tuple:
    """A block's large cells through the EM -> ((cell, column, value)
    sorted by (cell, column), and with -b the bootstraps' mean and
    variance triplets, else None) (src/quant.rs:822-1000); ``first`` is
    the block's first cell number in the file; ``weights`` (one per
    label, outside USA mode) for the long-read EM, which the bootstraps
    do not take.  ``AFT_EM_MESH`` splits the EM's cells over a device
    mesh (``parallel/mesh.py``); the bootstraps take none, as in the
    reference."""
    mesh = mesh_from_env("AFT_EM_MESH", opts.device)
    if usa_mode:
        # the USA EM couples each gene's three slots and runs the
        # thresholded last round (em_optimize_subset, em.rs:178-299)
        lab_offs, labels = crlike.usa_transform_labels(eqc.label_offsets, eqc.labels, num_rows)
        res = em_cells(eqc.cell_eq_offsets, lab_offs, labels, eqc.counts, num_rows,
                       (num_rows // 3, 2 * num_rows // 3), opts.init_uniform, True, opts.device,
                       mesh=mesh)
    else:
        res = em_cells(eqc.cell_eq_offsets, eqc.label_offsets, eqc.labels, eqc.counts,
                       num_genes, None, opts.init_uniform, False, opts.device, weights,
                       mesh=mesh)
    n = [len(ids) for ids, _ in res]
    boot = None
    if opts.num_bootstraps > 0:
        boot = run_bootstraps(eqc, eqc.label_offsets, eqc.labels, num_genes,
                              opts.num_bootstraps, opts.device, cell_offset=first)
    return (np.repeat(eqc.cell_ids, n),
            np.concatenate([ids for ids, _ in res] or [np.zeros(0, np.int64)]),
            np.concatenate([v for _, v in res] or [np.zeros(0, np.float32)])), boot


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

    dumped = [(p.eqc, o) for p, o in zip(parts, offs) if p.eqc is not None]
    eqc = None
    if dumped:
        eqc = (np.concatenate([e[0] + o for e, o in dumped]),
               *(np.concatenate([e[i] for e, _ in dumped]) for i in (1, 2, 3)))

    def boot(field):
        got = [(getattr(p, field), o) for p, o in zip(parts, offs)
               if getattr(p, field) is not None]
        if not got:
            return None
        return (np.concatenate([t[0] + o for t, o in got]),
                *(np.concatenate([t[i] for t, _ in got]) for i in (1, 2)))

    sample_idx = [p.sample_idx for p in parts if p.sample_idx is not None]
    return CellResult(
        cells=cat("cells"), cell_bcs=cat("cell_bcs"), nrec=cat("nrec"),
        rows=np.concatenate([p.rows + o for p, o in zip(parts, offs)]),
        cols=cat("cols"), vals=cat("vals"),
        cell_stats=tuple(
            np.concatenate([p.cell_stats[i] for p in parts]) for i in range(4)
        ),
        eqc=eqc, alt_cells=[c for p in parts for c in p.alt_cells],
        boot_mean=boot("boot_mean"), boot_var=boot("boot_var"),
        sample_idx=np.concatenate(sample_idx) if sample_idx else None,
    )


class _CooSpill:
    """One rank's count triplets at bounded memory: in memory until more
    than ``spill`` triplets came, then in three rank-local binary
    sidecars ``<base>.rows``, ``.cols`` and ``.vals``, read back by
    :meth:`iter_chunks` for the streamed matrix body.  Rows come
    block-local and are shifted here to rank-local rows; the body shifts
    them by the ranks before."""

    DTYPES = (np.int64, np.int64, np.float32)

    def __init__(self, base: Path, spill: int):
        self.base, self.spill = Path(base), spill
        self.row_off = self.nnz = 0
        self._blocks: List[tuple] = []
        self._fh = None

    def _paths(self) -> List[Path]:
        return [Path(f"{self.base}.{s}") for s in ("rows", "cols", "vals")]

    def add(self, rows, cols, vals, n_cells: int) -> None:
        blk = tuple(np.asarray(a, dt) for a, dt in zip((rows + self.row_off, cols, vals),
                                                       self.DTYPES))
        self.row_off += n_cells
        self.nnz += len(vals)
        if self._fh is None:
            self._blocks.append(blk)
            if self.nnz <= self.spill:
                return
            self.base.parent.mkdir(parents=True, exist_ok=True)
            self._fh = [open(p, "wb") for p in self._paths()]
            blks, self._blocks = self._blocks, []
        else:
            blks = [blk]
        for b in blks:
            for fh, a in zip(self._fh, b):
                fh.write(a.tobytes())

    @property
    def spilled(self) -> bool:
        return self._fh is not None

    def concatenated(self) -> tuple:
        """The triplets held in memory (none spilled), concatenated."""
        cat = tuple(np.concatenate([np.zeros(0, dt)] + [b[i] for b in self._blocks])
                    for i, dt in enumerate(self.DTYPES))
        self._blocks = []
        return cat

    def iter_chunks(self, chunk: int):
        """The triplets in windows of at most ``chunk``: exactly
        ``ceil(nnz / chunk)`` of them, as the merge counts on."""
        if self._fh is None:
            cat = self.concatenated()
            for off in range(0, self.nnz, chunk):
                yield tuple(c[off:off + chunk] for c in cat)
            return
        for fh in self._fh:
            fh.close()
        for off in range(0, self.nnz, chunk):
            n = min(chunk, self.nnz - off)
            yield tuple(np.fromfile(p, dt, count=n, offset=off * np.dtype(dt).itemsize)
                        for p, dt in zip(self._paths(), self.DTYPES))

    def cleanup(self) -> None:
        """Close and remove the sidecars."""
        for fh in self._fh or ():
            fh.close()
        self._fh, self._blocks = None, []
        for p in self._paths():
            p.unlink(missing_ok=True)


def _stream_merge_mtx(sink: _CooSpill, n_local_cells: int, num_rows: int,
                      out_path: Path) -> None:
    """quants_mat.mtx at rank 0 from every rank's triplets, with no whole
    matrix in memory: the ranks own contiguous cell ranges, so the body
    is their triplets in rank order, each round of at most
    ``QUANT_MERGE_TRIPLETS`` sent to rank 0 once.  Rank 0 counts each
    rank's rounds from gathered numbers.  One process is world 1."""
    rank, world = dist.rank_world()
    chunk = QUANT_MERGE_TRIPLETS
    counts = np.concatenate(dist.allgather_ragged(np.asarray([n_local_cells], np.int64)))
    nnz = np.concatenate(dist.allgather_ragged(np.asarray([sink.nnz], np.int64)))
    if rank != 0:
        try:
            for part in sink.iter_chunks(chunk):
                for a in part:
                    dist.send_to_root(a)
        finally:
            sink.cleanup()
        return
    out_path.parent.mkdir(parents=True, exist_ok=True)
    writer = MtxStreamWriter(out_path)
    base = 0
    try:
        for r in range(world):
            rounds = (sink.iter_chunks(chunk) if r == 0 else
                      (tuple(dist.recv_from(r, dt) for dt in _CooSpill.DTYPES)
                       for _ in range(-(-int(nnz[r]) // chunk))))
            for rr, cc, vv in rounds:
                writer.add(rr + base, cc, vv)
            base += int(counts[r])
        writer.finalize((int(counts.sum()), num_rows))
        writer = None
    finally:
        if writer is not None:
            writer.abort()
        sink.cleanup()


def _merge_hosts(result: CellResult, opts: QuantOpts, want_sample: bool) -> CellResult:
    """Every rank's CellResult (its matrix triplets already merged by
    :func:`_stream_merge_mtx`) gathered at rank 0 in rank order; rows
    shift by the cells of the ranks before.  What is gathered follows the
    options and the input, never the local result, which may be empty on
    a rank, so every rank enters the same collectives.  Other ranks get
    an empty result."""
    rank, _world = dist.rank_world()
    n_rows = np.concatenate(dist.allgather_ragged(np.asarray([len(result.cells)], np.int64)))
    row_off = int(n_rows[:rank].sum())

    def gather(a, dt):
        return np.concatenate(dist.gather_to_root(np.asarray(a, dt)))

    eqc = None
    if opts.dump_eq:
        rows, lens, labels, counts = result.eqc if result.eqc is not None else (
            np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.uint32),
            np.zeros(0, np.uint32))
        eqc = (gather(rows + row_off, np.int64), gather(lens, np.int64),
               gather(labels, np.uint32), gather(counts, np.uint32))
    boot_mean = boot_var = None
    if opts.num_bootstraps > 0:
        # as in one process, the matrices exist once some block ran the EM
        ran = gather([result.boot_mean is not None], np.int64).any()
        z = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.float32))
        boot_mean, boot_var = (dist.merge_partial_coo(*(t if t is not None else z), row_off)
                               for t in (result.boot_mean, result.boot_var))
        if not ran:
            boot_mean = boot_var = None
    sample_idx = None
    if want_sample:
        sample_idx = gather(result.sample_idx if result.sample_idx is not None
                            else np.zeros(0, np.int64), np.int64)
    z64 = np.zeros(0, np.int64)
    return CellResult(
        cells=gather(result.cells, np.int64), cell_bcs=gather(result.cell_bcs, np.uint64),
        nrec=gather(result.nrec, np.int64), rows=z64, cols=z64, vals=np.zeros(0, np.float32),
        cell_stats=tuple(gather(a, dt) for a, dt in zip(
            result.cell_stats, (np.float32, np.float32, np.int64, np.int64))),
        eqc=eqc, alt_cells=[int(c) for c in gather(result.alt_cells, np.int64)],
        boot_mean=boot_mean, boot_var=boot_var, sample_idx=sample_idx,
    )


def _write_outputs(
    opts: QuantOpts,
    result: CellResult,
    gene_names: List[str],
    usa_mode: bool,
    num_rows: int,
    barcode_len: int,
    unmapped: UnmappedLookup,
    sample_names: Optional[List[str]],
    mtx_written: bool = False,
) -> None:
    """Write the stage's artifacts; ``mtx_written``: quants_mat.mtx is
    already there (streamed past the spill bound, or merged from the
    ranks)."""
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
    row_names, line = bc_u, np.char.add(bc_u, tab)
    if sample_names is not None and result.sample_idx is not None:
        # rows "<sample>_<bc>"; an ordinal past the names (which collate
        # never writes) leaves its row bare and names its sample "NA"
        valid = result.sample_idx < len(sample_names)
        names = np.asarray(list(sample_names) + ["NA"], dtype="U")[
            np.where(valid, result.sample_idx, len(sample_names))]
        row_names = np.where(valid, np.char.add(np.char.add(names, "_"), bc_u), bc_u)
        line = np.char.add(np.char.add(line, names), tab)
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
        fbc.write("\n".join(row_names.tolist()) + ("\n" if n_rows_out else ""))
    with open(out_path / "featureDump.txt", "w") as ffd:
        ffd.write(
            "CB\t" + ("sample_name\t" if sample_names is not None else "")
            + "CorrectedReads\tMappedReads\tDeduplicatedReads\tMappingRate\t"
            "DedupRate\tMeanByMax\tNumGenesExpressed\tNumGenesOverMean\n"
        )
        ffd.write("".join(line.tolist()))

    if not mtx_written:
        write_matrix_market(
            mat_path / "quants_mat.mtx", result.rows, result.cols, result.vals,
            (n_rows_out, num_rows),
        )
    if result.boot_mean is not None:
        for name, (r, c, v) in (("bootstraps_mean.mtx", result.boot_mean),
                                ("bootstraps_var.mtx", result.boot_var)):
            write_matrix_market(mat_path / name, r, c, v, (n_rows_out, num_rows))
    if opts.dump_eq:
        # small cells contribute no class (src/quant.rs:1269-1272), but
        # both files are written
        _write_eqc_counts(result.eqc, n_rows_out, num_rows, usa_mode, mat_path)
    spans.wrote(
        out_path / "featureDump.txt",
        *(mat_path / f"quants_mat{x}" for x in (".mtx", "_rows.txt", "_cols.txt")),
        *((mat_path / "bootstraps_mean.mtx", mat_path / "bootstraps_var.mtx")
          if result.boot_mean is not None else ()),
        *((mat_path / "geqc_counts.mtx", mat_path / "gene_eqclass.txt.gz")
          if opts.dump_eq else ()),
    )
    resolution = RESOLUTION_NAMES[opts.resolution]
    write_json(out_path / "quant.json", {
        "cmd": opts.cmdline,
        "version_str": opts.version,
        "resolution_strategy": resolution,
        "num_quantified_cells": n_rows_out,
        "num_genes": num_rows,
        "dump_eq": opts.dump_eq,
        "usa_mode": usa_mode,
        "alt_resolved_cell_numbers": result.alt_cells,
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
            "resolution": resolution,
            "pug_exact_umi": opts.pug_exact_umi,
            "sa_model": opts.sa_model,
            "small_thresh": opts.small_thresh,
            "large_graph_thresh": opts.large_graph_thresh,
            "filter_list": str(opts.filter_list) if opts.filter_list else None,
            "cmdline": opts.cmdline,
            "version": opts.version,
        },
    })
    log.info("finished quantifying %d cells", n_rows_out)


def _write_eqc_counts(eqc: Optional[tuple], n_cells: int, num_rows: int, usa_mode: bool,
                      mat_path: Path) -> None:
    """geqc_counts.mtx and gene_eqclass.txt.gz (src/quant.rs:228-354):
    label sets numbered in order of first appearance over the cells,
    written with the USA relabelling in USA mode."""
    if eqc is None:
        eqc = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.uint32),
               np.zeros(0, np.uint32))
    rows, lens, labels, counts = eqc
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    ids, rep = _native.intern_label_sets(labels.astype(np.uint64), offs)
    write_matrix_market(mat_path / "geqc_counts.mtx", rows, ids, counts.astype(np.float32),
                        (n_cells, len(rep)))

    rep_lens = offs[rep + 1] - offs[rep]
    rep_off = np.zeros(len(rep) + 1, np.int64)
    np.cumsum(rep_lens, out=rep_off[1:])
    tok = labels[np.repeat(offs[rep], rep_lens) + (
        np.arange(int(rep_off[-1])) - np.repeat(rep_off[:-1], rep_lens))]
    new_off = rep_off
    if usa_mode:
        # written with the USA relabelling (src/quant.rs:286-338)
        new_off, tok = crlike.usa_transform_labels(rep_off, tok, num_rows)
    body = _native.format_eqc_rows(tok.astype(np.uint64), new_off)
    # mtime=0: the file's bytes do not depend on when it was written
    with open(mat_path / "gene_eqclass.txt.gz", "wb") as raw:
        with gzip.GzipFile(fileobj=raw, mode="wb", mtime=0) as fh:
            fh.write(f"{num_rows}\n{len(rep)}\n".encode())
            fh.write(body)
