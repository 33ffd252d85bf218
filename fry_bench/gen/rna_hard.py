"""10x Chromium 3' v3 scRNA reads, molecule by molecule.

A frozen copy of ``tests/synth_hard.py::make_hard_dataset`` (commit
37c8559), with three changes: the records go through the benchmark's
own RAD writer (``gen/rad.py``); the unfiltered permit list has the size
the configuration gives (10x v3's 6,794,880 entries), the cells and the
ambient barcodes drawn from it; and the mapper's unmapped-read counts
(``unmapped_bc_count.bin``) are written beside the RAD file, as a
mapper writes them.  It models per-cycle barcode errors (one or two
substitutions), log-normal cells over a geometric ambient population,
gene-family ambiguity (one transcript, two of one gene, a cross-gene
pair, a three-gene family, twelve genes that the USA rules drop), PCR
copies with one-substitution UMI satellites, and about 2% of reads in
the wrong orientation.  Reads are shuffled, as a RAD file holds them.

:func:`make` writes ``rad/map.rad``, ``rad/unmapped_bc_count.bin``,
``permit.txt`` and the 3-column ``t2g_3col.tsv`` and returns the records
as arrays for the reference.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import rad


def phred_ramp(bc_len: int) -> np.ndarray:
    """Per-cycle substitution probability: ~0.001 at cycle 1 rising
    geometrically to ~0.01 at the last cycle."""
    return 0.001 * (10.0 ** (np.linspace(0.0, 1.0, bc_len)))


def sub_errors(rng, codes: np.ndarray, which: np.ndarray, pos_prob: np.ndarray,
               length: int) -> None:
    """One random substitution in place in ``codes[which]``, its position
    drawn from ``pos_prob``, the new base never the old one."""
    n = which.sum() if which.dtype == bool else len(which)
    if n == 0:
        return
    pos = rng.choice(length, size=n, p=pos_prob)
    shift = (2 * pos).astype(np.uint64)
    old = (codes[which] >> shift) & np.uint64(3)
    delta = rng.randint(1, 4, n).astype(np.uint64)
    new = (old + delta) & np.uint64(3)
    codes[which] ^= (old ^ new) << shift


def random_codes(rng, n: int, length: int) -> np.ndarray:
    """``n`` distinct random barcodes of ``length`` bases, sorted."""
    mask = np.uint64((1 << (2 * length)) - 1)
    got = np.zeros(0, np.uint64)
    while len(got) < n:
        draw = rng.randint(0, 1 << 62, size=int(1.05 * (n - len(got))) + 16).astype(np.uint64)
        got = np.unique(np.concatenate([got, draw & mask]))
    return np.sort(got[rng.permutation(len(got))[:n]])


def rng_for(seed: int) -> np.random.RandomState:
    """A RandomState from a seed of any size."""
    return np.random.RandomState(int(np.random.SeedSequence(int(seed)).generate_state(1)[0]))


def make(d: Path, seed: int, n_cells: int, n_reads: int, n_genes: int, txps_per_gene: int,
         bc_len: int, umi_len: int, ambient_factor: int, mean_reads_per_mol: float,
         umi_error_rate: float, wrong_ori_rate: float, spliced_frac: float,
         permit_list_size: int, unmapped_frac: float, reads_per_chunk: int, **_) -> dict:
    rng = rng_for(seed)
    n_txps = n_genes * txps_per_gene
    fam = 4  # paralog family size: genes [4k, 4k+3] overlap

    # barcodes: the unfiltered list, and the cells and ambient drops in it
    n_ambient = ambient_factor * n_cells
    permit = random_codes(rng, permit_list_size, bc_len)
    perm = rng.permutation(len(permit))
    real_bcs = permit[perm[:n_cells]]
    ambient_bcs = permit[perm[n_cells:n_cells + n_ambient]]

    # cell sizes: log-normal cells, exponential ambient at 8% of the mass
    real_w = np.exp(rng.normal(0.0, 0.8, n_cells))
    real_w /= real_w.sum()
    amb_w = rng.exponential(1.0, n_ambient)
    amb_w /= amb_w.sum()
    amb_mass = 0.08
    cell_w = np.concatenate([(1 - amb_mass) * real_w, amb_mass * amb_w])
    all_bcs = np.concatenate([real_bcs, ambient_bcs])

    # molecules
    n_mols = int(n_reads / mean_reads_per_mol)
    mol_cell = rng.choice(len(all_bcs), size=n_mols, p=cell_w)
    gw = 1.0 / np.arange(1, n_genes + 1) ** 0.9
    gw /= gw.sum()
    mol_gene = rng.choice(n_genes, size=n_mols, p=gw)
    mol_umi = rng.randint(0, 1 << (2 * umi_len), size=n_mols).astype(np.uint64)
    mol_spliced = rng.rand(n_mols) < spliced_frac
    # 0 unique, 1 intra-gene, 2 cross-gene pair, 3 family, 4 wide (dropped)
    amb_class = rng.choice(5, size=n_mols, p=[0.57, 0.25, 0.12, 0.05, 0.01])
    mol_rpm = rng.geometric(1.0 / mean_reads_per_mol, size=n_mols)
    n_mols = min(int(np.searchsorted(np.cumsum(mol_rpm), n_reads) + 1), len(mol_rpm))
    mol_cell, mol_gene, mol_umi = mol_cell[:n_mols], mol_gene[:n_mols], mol_umi[:n_mols]
    mol_spliced, amb_class, mol_rpm = mol_spliced[:n_mols], amb_class[:n_mols], mol_rpm[:n_mols]
    total_reads = int(mol_rpm.sum())

    # label sets: spliced transcripts have even local ids, unspliced odd
    def txp_of(gene, spliced, k):
        return gene * txps_per_gene + (2 * k + np.where(spliced, 0, 1)) % txps_per_gene

    halves = txps_per_gene // 2
    k0 = rng.randint(0, halves, n_mols)
    lab_counts = np.ones(n_mols, np.int32)
    base_txp = txp_of(mol_gene, mol_spliced, k0)
    c1, c2, c3, c4 = (amb_class == 1), (amb_class == 2), (amb_class == 3), (amb_class == 4)
    partner_gene = (mol_gene ^ 1) % n_genes
    fam_base = (mol_gene // fam) * fam
    lab_counts[c1] = 2
    lab_counts[c2] = 2
    lab_counts[c3] = 3
    lab_counts[c4] = 12
    offs = np.zeros(n_mols + 1, np.int64)
    np.cumsum(lab_counts, out=offs[1:])
    labels = np.empty(offs[-1], np.uint32)
    labels[offs[:-1]] = base_txp.astype(np.uint32)
    sec = np.where(c1, txp_of(mol_gene, mol_spliced, (k0 + 1) % halves),
                   txp_of(partner_gene, mol_spliced, k0))
    has2 = lab_counts >= 2
    labels[offs[:-1][has2] + 1] = sec[has2].astype(np.uint32)
    g3 = fam_base + (mol_gene - fam_base + 2) % fam
    has3 = lab_counts >= 3
    labels[offs[:-1][has3] + 2] = txp_of(g3, mol_spliced, k0)[has3].astype(np.uint32)
    if c4.any():
        wi = np.flatnonzero(c4)
        for j in range(1, 12):
            gj = (mol_gene[wi] + j) % n_genes
            labels[offs[wi] + j] = txp_of(gj, mol_spliced[wi], k0[wi]).astype(np.uint32)

    # reads: UMI satellites (never on a molecule's first read), barcode
    # errors on the per-cycle ramp, wrong orientation
    read_mol = np.repeat(np.arange(n_mols), mol_rpm)
    read_umi = mol_umi[read_mol].copy()
    first_of_mol = np.zeros(total_reads, bool)
    first_of_mol[np.cumsum(mol_rpm) - mol_rpm] = True
    umi_err = (rng.rand(total_reads) < umi_error_rate) & ~first_of_mol
    sub_errors(rng, read_umi, umi_err, np.full(umi_len, 1.0 / umi_len), umi_len)
    read_bc = all_bcs[mol_cell[read_mol]]
    q = phred_ramp(bc_len)
    nerr = np.minimum(rng.poisson(q.sum(), total_reads), 2)
    pos_prob = q / q.sum()
    sub_errors(rng, read_bc, nerr >= 1, pos_prob, bc_len)
    sub_errors(rng, read_bc, nerr >= 2, pos_prob, bc_len)
    read_fw = rng.rand(total_reads) >= wrong_ori_rate

    order = rng.permutation(total_reads)
    read_mol, read_bc, read_umi, read_fw = (read_mol[order], read_bc[order], read_umi[order],
                                            read_fw[order])
    nal = lab_counts[read_mol].astype(np.int64)
    aln_offsets = np.zeros(total_reads + 1, np.int64)
    np.cumsum(nal, out=aln_offsets[1:])
    n_aln = int(aln_offsets[-1])
    src = np.repeat(offs[read_mol], nal) + (np.arange(n_aln) - np.repeat(aln_offsets[:-1], nal))
    refs = labels[src]
    dirs = np.repeat(read_fw, nal)

    # the mapper's unmapped reads, by barcode as sequenced
    n_unmapped = int(unmapped_frac * total_reads)
    un_bc = all_bcs[rng.choice(len(all_bcs), size=n_unmapped, p=cell_w)]
    un_err = np.minimum(rng.poisson(q.sum(), n_unmapped), 2)
    sub_errors(rng, un_bc, un_err >= 1, pos_prob, bc_len)
    sub_errors(rng, un_bc, un_err >= 2, pos_prob, bc_len)
    un_bc, un_ct = np.unique(un_bc, return_counts=True)
    shuffle = rng.permutation(len(un_bc))

    ref_names = [f"tx_{i}" for i in range(n_txps)]
    schema = rad.rna_schema(ref_names, bc_len, umi_len)
    (d / "rad").mkdir(parents=True, exist_ok=True)
    rad.write_rad(d / "rad" / "map.rad", schema, [read_bc, read_umi], aln_offsets,
                  [refs | np.where(dirs, rad.ORI_BIT, np.uint32(0))],
                  rad.fixed_chunks(total_reads, reads_per_chunk))
    rad.write_raw_unmapped(d / "rad" / "unmapped_bc_count.bin", un_bc[shuffle],
                           un_ct[shuffle])
    rad.write_barcode_list(d / "permit.txt", permit, bc_len)
    tx = np.arange(n_txps)
    status = np.where((tx % txps_per_gene) % 2 == 0, "S", "U")
    (d / "t2g_3col.tsv").write_text("".join(
        f"tx_{i}\tg_{i // txps_per_gene}\t{s}\n" for i, s in zip(tx.tolist(), status.tolist())))
    return {
        "n_records": total_reads, "bc_len": bc_len, "umi_len": umi_len,
        "n_genes": n_genes, "txps_per_gene": txps_per_gene, "ref_names": ref_names,
        "schema": schema, "bc": read_bc, "umi": read_umi, "aln_offsets": aln_offsets,
        "refs": refs, "dirs": dirs, "permit": permit,
        "unmapped_bc": un_bc, "unmapped_ct": un_ct,
        "num_chunks": len(rad.fixed_chunks(total_reads, reads_per_chunk)) - 1,
    }
