"""infer: gene-level counts from a dumped equivalence-class count matrix
(port of ``alevin_fry_tpu/pipeline/infer.py``, src/infer.rs:31-400).

Reads the cell x class MTX (``quant -d``'s ``geqc_counts.mtx``) and the
gzipped class labels (``gene_eqclass.txt.gz``), runs every cell's EM on
the device (kernel K6, ``ops/em.py``; USA offsets with ``--usa``, always
with the thresholded last round) and writes the cell x gene matrix with
its rows file and the input's cols file.  As the reference's, it runs as
one process, a multi-process coordinator set or not; ``AFT_EM_MESH``
splits the EM's cells over a device mesh (``parallel/mesh.py``).
"""

from __future__ import annotations

import gzip
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..ops.barcodes import pack_seqs
from ..ops.em import em_cells
from ..parallel.mesh import mesh_from_env
from ..radz.mtx import read_matrix_market, write_matrix_market
from ..utils import read_barcode_file
from .logging_ import get_logger

log = get_logger("infer")


def read_eqc_label_file(path: Path):
    """gene_eqclass.txt.gz: the gene count, the class count, then per
    line ``g1 ... gk id`` (eq_class.rs:249-298) -> (gene count, label
    offsets by class id, labels uint32)."""
    with gzip.open(path, "rt") as fh:
        num_genes = int(fh.readline())
        num_eqc = int(fh.readline())
        by_id = [np.zeros(0, np.uint32)] * num_eqc
        for line in fh:
            toks = line.split()
            if toks:
                by_id[int(toks[-1])] = np.asarray(toks[:-1], np.int64).astype(np.uint32)
    offsets = np.zeros(num_eqc + 1, np.int64)
    np.cumsum([len(x) for x in by_id], out=offsets[1:])
    flat = np.concatenate(by_id) if num_eqc else np.zeros(0, np.uint32)
    return num_genes, offsets, flat


def infer(
    count_mat: Path,
    eq_label_file: Path,
    usa_mode: bool,
    num_threads: int,
    filter_list: Optional[Path],
    output_dir: Path,
    device: torch.device,
) -> None:
    del num_threads  # the EM runs on the device
    count_mat = Path(count_mat)
    parent = count_mat.parent
    rows, cols, vals, (n_cells, n_eqc_mat) = read_matrix_market(count_mat)
    log.info("read %d x %d equivalence class count matrix.", n_cells, n_eqc_mat)
    num_genes, eq_offsets, eq_labels = read_eqc_label_file(Path(eq_label_file))
    log.info("read %d equivalence classes from file.", len(eq_offsets) - 1)

    with open(parent / "quants_mat_rows.txt") as fh:
        bc_lines = [line.strip() for line in fh if line.strip()]
    keep = np.ones(n_cells, bool)
    if filter_list is not None:
        bc_len = len(bc_lines[0])
        listed = read_barcode_file(Path(filter_list), bc_len)[0]
        keep = np.isin(pack_seqs(bc_lines, bc_len), listed)

    # each kept cell's classes, in class id order, labels gathered from
    # the label file
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    m = keep[rows]
    rows, cols, vals = rows[m], cols[m], vals[m]
    kept = np.flatnonzero(keep)
    rank = np.full(n_cells, -1, np.int64)
    rank[kept] = np.arange(len(kept))
    cell_eq_offsets = np.zeros(len(kept) + 1, np.int64)
    np.cumsum(np.bincount(rank[rows], minlength=len(kept)), out=cell_eq_offsets[1:])
    lens = eq_offsets[cols + 1] - eq_offsets[cols]
    lab_offsets = np.zeros(len(cols) + 1, np.int64)
    np.cumsum(lens, out=lab_offsets[1:])
    labels = eq_labels[np.repeat(eq_offsets[cols], lens)
                       + np.arange(int(lab_offsets[-1])) - np.repeat(lab_offsets[:-1], lens)]
    results = em_cells(
        cell_eq_offsets, lab_offsets, labels, vals.astype(np.uint32), num_genes,
        (num_genes // 3, 2 * num_genes // 3) if usa_mode else None, False, True, device,
        mesh=mesh_from_env("AFT_EM_MESH", device),
    )

    out_path = Path(output_dir)
    out_path.mkdir(parents=True, exist_ok=True)
    shutil.copy(parent / "quants_mat_cols.txt", out_path / "quants_mat_cols.txt")
    with open(out_path / "quants_mat_rows.txt", "w") as fh:
        fh.write("".join(bc_lines[ci] + "\n" for ci in kept))
    n = [len(ids) for ids, _ in results]
    write_matrix_market(
        out_path / "quants_mat.mtx", np.repeat(np.arange(len(kept)), n),
        np.concatenate([ids for ids, _ in results] or [np.zeros(0, np.int64)]),
        np.concatenate([v for _, v in results] or [np.zeros(0, np.float32)]),
        (len(kept), num_genes),
    )
    log.info("finished quantifying %d cells.", len(kept))
