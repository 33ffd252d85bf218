"""Multi-barcode (10x Flex) generate-permit-list (port of
``alevin_fry_tpu/pipeline/gpl_multi.py``, reference
do_generate_permit_list_multi_bc, src/cellfilter.rs:563-1063).

* loads the sample barcode list (1-column, 2-column ``barcode<TAB>name``
  or 3-column ``observed<TAB>canonical<TAB>name`` rotation format),
  reverse-complemented under ``--sample-bc-ori reverse``;
* builds the rotation -> canonical sample permit map (exact, or with
  every 1-edit neighbour of a rotation);
* streams the reads once: the strand filter, the sample correction and
  a histogram of the composite key ``(sample << 2·cell_bc_len) | cell``;
* filters each sample's cells (the unfiltered list with its rescue on
  kernel K4 on the chosen device, once per sample; the knee; ``-f``;
  the multi-barcode ``-e`` heuristic; an explicit list) and writes its
  permit artifacts under ``sample_<name>/``;
* writes ``sample_permit_map.bin``, ``sample_info.json`` and the
  ``generate_permit_list.json`` gate with ``multi_barcode: true``.

Host NumPy apart from the rescue, as in the reference.  In a
multi-process run (``parallel/dist.py``) the caller gives each rank the
blocks of its chunk range; the composite histograms and the read
counters merge over collectives, every rank filters every sample, and
rank 0 writes the artifacts.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from .. import spans
from ..ops import barcodes as bcops
from ..ops.knee import get_knee
from ..parallel import dist
from ..radz import bincodeio
from ..utils import read_barcode_file, read_strand_mask, strand_from_ori_arg, write_json
from .gpl import _histogram, _merge_histograms, merge_rank_histograms
from .logging_ import get_logger

log = get_logger("gpl.multi")

_COMPLEMENT = str.maketrans("ACGTacgt", "TGCAtgca")


def load_sample_barcode_list(path: Path, reverse: bool):
    """Returns (canonical barcodes in file order, rotation -> canonical,
    canonical -> name, sample barcode length)."""
    rot_to_canon: Dict[int, int] = {}
    canon_to_name: Dict[int, str] = {}
    canon_order: List[int] = []
    bc_len = None
    with open(path) as fh:
        for line in fh:
            t = line.strip()
            if not t or t.startswith("#"):
                continue
            parts = t.split("\t")
            if len(parts) >= 3:
                obs, canon, name = parts[0], parts[1], parts[2]
            elif len(parts) == 2:
                obs, canon, name = parts[0], parts[0], parts[1]
            else:
                obs, canon, name = parts[0], parts[0], parts[0]
            if reverse:
                obs, canon = obs.translate(_COMPLEMENT)[::-1], canon.translate(_COMPLEMENT)[::-1]
            if bc_len is None:
                bc_len = len(obs)
            cb = bcops.pack_seq(canon)
            rot_to_canon[bcops.pack_seq(obs)] = cb
            if cb not in canon_to_name:
                canon_order.append(cb)
            canon_to_name[cb] = name
    log.info(
        "Loaded %d rotation barcodes mapping to %d canonical samples from %s",
        len(rot_to_canon), len(canon_order), path,
    )
    return canon_order, rot_to_canon, canon_to_name, bc_len or 0


def build_sample_permit_map(rot_to_canon: Dict[int, int], correction_mode: str,
                            bc_len: int) -> Dict[int, int]:
    """Rotation -> canonical, and under ``1-edit`` every 1-edit neighbour
    of a rotation -> its canonical; a neighbour of several rotations goes
    to the first of them in file order (docs/parity.md:48-53)."""
    permit = dict(rot_to_canon)
    if correction_mode == "1-edit":
        observed = np.asarray(list(rot_to_canon.keys()), np.uint64)
        keys, vals = bcops.generate_permitlist_map(observed, bc_len)
        for k, v in zip(keys.tolist(), vals.tolist()):
            if k not in permit and v in rot_to_canon:
                permit[k] = rot_to_canon[v]
    return permit


def do_generate_permit_list_multi_bc(opts, block_iter, info: dict) -> int:
    """The stage on the decoded blocks of ``block_iter``; the composite
    histogram accumulates across blocks, so memory is bounded by the
    distinct (sample, cell) pairs.  Returns the number of cells kept
    over all samples."""
    num_barcodes = info["num_barcodes"]
    cell_bc_len = info["cell_bc_len"]
    out_dir = Path(opts.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if opts.sample_bc_list is None:
        raise ValueError(
            f"Multi-barcode RAD file detected ({num_barcodes} barcode levels), "
            "but --sample-bc-list was not provided."
        )
    reverse = opts.sample_bc_ori == "reverse"
    canon_order, rot_to_canon, canon_to_name, sbc_len = load_sample_barcode_list(
        Path(opts.sample_bc_list), reverse
    )
    if opts.sample_names is not None:
        with open(opts.sample_names) as fh:
            for line in fh:
                parts = line.strip().split("\t")
                if len(parts) >= 2:
                    b = bcops.pack_seq(parts[0])
                    canon_to_name[rot_to_canon.get(b, b)] = parts[1]
    sample_names = [canon_to_name.get(cb, f"{cb:x}") for cb in canon_order]
    permit = build_sample_permit_map(rot_to_canon, opts.sample_correction_mode, sbc_len)
    num_samples = len(canon_order)

    # the first pass: strand filter, sample correction, composite histogram
    strand = strand_from_ori_arg(opts.expected_ori)
    pk = np.asarray(sorted(permit), np.uint64)
    pv = np.asarray([permit[int(k)] for k in pk], np.uint64)
    canon_arr = np.asarray(canon_order, np.uint64)
    canon_perm = np.argsort(canon_arr, kind="stable")
    canon_sorted = canon_arr[canon_perm]
    cbits = np.uint64(2 * cell_bc_len)
    h_key = np.zeros(0, np.uint64)
    h_ct = np.zeros(0, np.uint64)
    total_reads = matched_reads = unmatched_reads = 0
    for batch in block_iter:
        compat = read_strand_mask(batch.dirs, batch.aln_offsets, strand)
        total_reads += batch.n_reads
        sbc = batch.barcode(0)[compat]
        cbc = batch.barcode(-1)[compat]
        known = np.zeros(len(sbc), bool)
        ci = np.zeros(len(sbc), np.int64)
        if len(pk) and num_samples:
            idx = np.minimum(np.searchsorted(pk, sbc), len(pk) - 1)
            corrected = pv[idx]
            ci = np.minimum(np.searchsorted(canon_sorted, corrected), num_samples - 1)
            known = (pk[idx] == sbc) & (canon_sorted[ci] == corrected)
        matched_reads += int(known.sum())
        unmatched_reads += int((~known).sum())
        comp = (canon_perm[ci[known]].astype(np.uint64) << cbits) | cbc[known]
        h_key, h_ct = _merge_histograms(h_key, h_ct, *_histogram(comp))
    rank, world = dist.rank_world()
    if world > 1:
        h_key, h_ct = merge_rank_histograms(h_key, h_ct)
        total_reads, matched_reads, unmatched_reads = dist.merge_counts(
            [total_reads, matched_reads, unmatched_reads])
        log.info("multi-host multi-BC gpl: merged %d per-host histograms (%d composite keys)",
                 world, len(h_key))
    write = rank == 0
    log.info(
        "First pass complete: %d total reads, %d matched to samples, %d unmatched",
        total_reads, matched_reads, unmatched_reads,
    )

    wl_sorted = None
    min_reads = 0
    if opts.fmeth.kind == "unfiltered":
        with spans.span("list_parse", "codec"):
            wl_sorted = np.unique(read_barcode_file(opts.fmeth.path)[0])
        min_reads = int(opts.fmeth.min_reads)
        log.info("Loaded %d cell barcodes from whitelist", len(wl_sorted))

    if write:
        bincodeio.write_u64_map_file(
            out_dir / "sample_permit_map.bin",
            np.asarray(list(permit.keys()), np.uint64),
            np.asarray(list(permit.values()), np.uint64),
        )
        spans.wrote(out_dir / "sample_permit_map.bin")

    total_cells = 0
    sample_entries = []
    h_sample = (h_key >> cbits).astype(np.int64)
    cell_mask = (np.uint64(1) << cbits) - np.uint64(1)
    for si, name in enumerate(sample_names):
        entry = {"name": name, "barcode": f"0x{canon_order[si]:x}",
                 "num_reads": 0, "num_cells": 0}
        sample_entries.append(entry)
        sel = h_sample == si
        # the composite keys come sorted, so each sample's cells do too
        uniq = h_key[sel] & cell_mask
        if len(uniq) == 0:
            log.warning("Sample '%s' has no reads — skipping", name)
            continue
        kept_bc, kept_ct, map_keys, map_vals = _filter_sample_cells(
            opts, uniq, h_ct[sel].astype(np.uint64), wl_sorted, min_reads, cell_bc_len, name
        )
        if write:
            sample_dir = out_dir / f"sample_{name}"
            sample_dir.mkdir(parents=True, exist_ok=True)
            bincodeio.write_u64_map_file(sample_dir / "permit_map.bin", map_keys, map_vals)
            bincodeio.write_permit_freq(sample_dir / "permit_freq.bin", cell_bc_len, kept_bc,
                                        kept_ct)
            spans.wrote(sample_dir / "permit_map.bin", sample_dir / "permit_freq.bin")
        total_cells += len(kept_bc)
        entry.update(num_reads=int(kept_ct.sum()), num_cells=int(len(kept_bc)))

    if write:
        write_json(out_dir / "sample_info.json", {
            "num_samples": num_samples,
            "num_barcodes": num_barcodes,
            "total_cells": total_cells,
            "total_reads": total_reads,
            "matched_reads": matched_reads,
            "unmatched_reads": unmatched_reads,
            "sample_correction_mode": (
                "OneEdit" if opts.sample_correction_mode == "1-edit" else "Exact"
            ),
            "sample_bc_ori": "Reverse" if reverse else "Forward",
            "samples": sample_entries,
        })
        # the reference writes no gpl_options record on this path
        write_json(out_dir / "generate_permit_list.json", {
            "velo_mode": opts.velo_mode,
            "expected_ori": strand,
            "version_str": opts.version,
            "cmd": opts.cmdline,
            "permit-list-type": opts.fmeth.describe(),
            "multi_barcode": True,
            "num_barcodes": num_barcodes,
        })
    dist.barrier()
    log.info(
        "Multi-barcode permit list generation complete: %d samples, %d total cells",
        num_samples, total_cells,
    )
    return total_cells


def _filter_sample_cells(
    opts, uniq: np.ndarray, counts: np.ndarray, wl_sorted, min_reads: int,
    cell_bc_len: int, name: str,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One sample's cell filter (cellfilter.rs:843-1000) over its sorted
    histogram -> (kept barcodes, their counts, correction map keys,
    values)."""
    meth = opts.fmeth
    if meth.kind == "unfiltered":
        in_wl = np.zeros(len(uniq), bool)
        if len(wl_sorted):
            idx = np.minimum(np.searchsorted(wl_sorted, uniq), len(wl_sorted) - 1)
            in_wl = wl_sorted[idx] == uniq
        passing = in_wl & (counts >= np.uint64(min_reads))
        kept_bc = uniq[passing]
        kept_ct = counts[passing].copy()
        rescue_bc = uniq[~passing]
        rescue_ct = counts[~passing]
        ncnt, reps = bcops.find_neighbors(rescue_bc, kept_bc, cell_bc_len, opts.device)
        rescued = (ncnt == 1) & (reps != rescue_bc)
        if rescued.any():
            np.add.at(kept_ct, np.searchsorted(kept_bc, reps[rescued]), rescue_ct[rescued])
        log.info(
            "  sample '%s': %d whitelist BCs pass min_reads=%d, %d rescued",
            name, len(kept_bc), min_reads, int(rescued.sum()),
        )
        return (kept_bc, kept_ct, np.concatenate([kept_bc, rescue_bc[rescued]]),
                np.concatenate([kept_bc, reps[rescued]]))

    if meth.kind == "explicit":
        vset = np.unique(read_barcode_file(meth.path, cell_bc_len)[0])
        sel = np.zeros(len(uniq), bool)
        if len(vset):
            idx = np.minimum(np.searchsorted(vset, uniq), len(vset) - 1)
            sel = vset[idx] == uniq
    else:
        freq = np.sort(counts)[::-1]
        if meth.kind == "knee":
            num_cells = get_knee(freq, 100)
        elif meth.kind == "force":
            num_cells = min(meth.count, len(freq))
        elif meth.kind == "expect":
            # the multi-barcode heuristic (cellfilter.rs:963-969): ten
            # times the cells above a tenth of the top count
            below = np.flatnonzero(freq < int(freq[0]) // meth.count)
            num_cells = min((int(below[0]) if len(below) else len(freq)) * 10, len(freq))
        else:
            raise ValueError(f"unsupported filter method {meth.kind}")
        threshold = int(freq[max(num_cells - 1, 0)]) if num_cells > 0 else 0
        sel = counts >= np.uint64(threshold)
    kept_bc = uniq[sel]
    kept_ct = counts[sel]
    log.info("  %d cells retained for sample '%s'", len(kept_bc), name)
    order = np.lexsort((kept_bc, -kept_ct.astype(np.int64)))
    mk, mv = bcops.generate_permitlist_map(kept_bc[order], cell_bc_len)
    return kept_bc, kept_ct, mk, mv
