"""10x Flex (Fixed RNA Profiling) 16-plex reads, molecule by molecule.

Each read carries two barcode levels, as alevin-fry's multi-barcode RAD
files hold them (read tags ``b0`` the 8-base probe (sample) barcode,
``b1`` the 16-base cell barcode, ``u`` the UMI; the file tags
``num_barcodes``, ``b0len``, ``b1len``, ``ulen`` and ``known_rad_type``
of alevin-fry's ``tests/multi_barcode_integration.rs``).  It models:

* probe barcodes named ``BC001``, ``BC002``, ... drawn from the seed,
  each with ``rotations`` observed forms (the canonical first) written as
  the 3-column list ``observed<TAB>canonical<TAB>name``; a read carries a
  random rotation of its sample with per-cycle substitutions, at most
  two, so a read with two should drop;
* one GEM pool of listed cell barcodes shared by the samples: each
  sample's cells are drawn from it, so a GEM barcode lies in about
  ``n_samples * cells_per_sample / gem_pool`` samples (the composite
  key's identity, ``collate.rs:1194-1198``), with log-normal cell sizes
  over an exponential ambient population of listed barcodes outside the
  pool; per-cycle substitutions on the cell barcode, at most one;
* genes of ``probes_per_gene`` probes (the references; a 2-column
  probe-to-gene map): most reads on one probe, some on two probes of
  one gene, some on two probes of different genes;
* PCR copies with one-substitution UMI satellites (never on a
  molecule's first read) and reads in the wrong orientation.

Reads are shuffled, as a RAD file holds them.  :func:`make` writes
``rad/map.rad``, ``samples.tsv``, ``permit.txt`` and ``t2g.tsv`` and
returns the records as arrays for the reference.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import rad
from .rna_hard import phred_ramp, random_codes, rng_for, sub_errors


def flex_schema(ref_names, sample_bc_len: int, cell_bc_len: int, umi_len: int) -> rad.Schema:
    """Multi-barcode records: read tags ``b0``, ``b1``, ``u`` (32-bit
    each), alignment tag ``compressed_ori_refid``."""
    return rad.Schema(
        ref_names, 0,
        [("num_barcodes", (rad.U16,)), ("b0len", (rad.U16,)), ("b1len", (rad.U16,)),
         ("ulen", (rad.U16,)), ("known_rad_type", (rad.STRING,))],
        {"num_barcodes": 2, "b0len": sample_bc_len, "b1len": cell_bc_len, "ulen": umi_len,
         "known_rad_type": "sc_rna_multi_bc"},
        [("b0", (rad.U32,)), ("b1", (rad.U32,)), ("u", (rad.U32,))],
        [("compressed_ori_refid", (rad.U32,))])


def _errors(rng, codes: np.ndarray, most: int, length: int) -> None:
    """Per-cycle substitutions in place, at most ``most`` a code."""
    q = phred_ramp(length)
    n = np.minimum(rng.poisson(q.sum(), len(codes)), most)
    for k in range(1, most + 1):
        sub_errors(rng, codes, n >= k, q / q.sum(), length)


def make(d: Path, seed: int, n_samples: int, sample_bc_len: int, rotations: int,
         cells_per_sample: int, gem_pool: int, cell_bc_len: int, umi_len: int,
         permit_list_size: int, n_genes: int, probes_per_gene: int, n_reads: int,
         reads_per_chunk: int, ambient_factor: int, ambient_mass: float,
         mean_reads_per_mol: float, umi_error_rate: float, wrong_ori_rate: float,
         two_probe_frac: float, cross_gene_frac: float, **_) -> dict:
    if not cells_per_sample <= gem_pool <= permit_list_size:
        raise ValueError("each sample's cells come from the GEM pool, which comes from the list")
    rng = rng_for(seed)

    # probe barcodes: each sample's rotations, its canonical form first
    rot = random_codes(rng, n_samples * rotations, sample_bc_len)
    rot = rot[rng.permutation(len(rot))].reshape(n_samples, rotations)
    names = [f"BC{i + 1:03d}" for i in range(n_samples)]

    # cell barcodes: the list, the GEM pool in it, each sample's cells
    # from the pool and its ambient barcodes from the rest of the list
    permit = random_codes(rng, permit_list_size, cell_bc_len)
    perm = rng.permutation(permit_list_size)
    pool, rest = permit[perm[:gem_pool]], permit[perm[gem_pool:]]
    n_amb = ambient_factor * cells_per_sample
    cell_bc = np.concatenate([pool[rng.permutation(gem_pool)[:cells_per_sample]]
                              for _ in range(n_samples)])
    amb_bc = np.concatenate([rest[rng.choice(len(rest), n_amb, replace=False)]
                             for _ in range(n_samples)])
    all_bc = np.concatenate([cell_bc, amb_bc])
    all_sample = np.concatenate([np.repeat(np.arange(n_samples), cells_per_sample),
                                 np.repeat(np.arange(n_samples), n_amb)])
    cell_w = np.exp(rng.normal(0.0, 0.8, len(cell_bc)))
    amb_w = rng.exponential(1.0, len(amb_bc))
    weight = np.concatenate([(1 - ambient_mass) * cell_w / cell_w.sum(),
                             ambient_mass * amb_w / amb_w.sum()])

    # molecules: a composite barcode, a gene, its probes, a UMI
    n_mols = int(n_reads / mean_reads_per_mol)
    mol_bc = rng.choice(len(all_bc), size=n_mols, p=weight)
    gw = 1.0 / np.arange(1, n_genes + 1) ** 0.9
    mol_gene = rng.choice(n_genes, size=n_mols, p=gw / gw.sum())
    mol_umi = rng.randint(0, 1 << (2 * umi_len), size=n_mols).astype(np.uint64)
    # 0 one probe, 1 two probes of the gene, 2 a probe of another gene too
    kind = rng.choice(3, size=n_mols, p=[1 - two_probe_frac - cross_gene_frac,
                                         two_probe_frac, cross_gene_frac])
    mol_rpm = rng.geometric(1.0 / mean_reads_per_mol, size=n_mols)
    n_mols = min(int(np.searchsorted(np.cumsum(mol_rpm), n_reads) + 1), len(mol_rpm))
    mol_bc, mol_gene, mol_umi = mol_bc[:n_mols], mol_gene[:n_mols], mol_umi[:n_mols]
    kind, mol_rpm = kind[:n_mols], mol_rpm[:n_mols]
    total_reads = int(mol_rpm.sum())
    ppg = probes_per_gene
    k0 = rng.randint(0, ppg, n_mols)
    probe0 = mol_gene * ppg + k0
    other_gene = (mol_gene + 1 + rng.randint(0, n_genes - 1, n_mols)) % n_genes
    probe1 = np.where(kind == 1, mol_gene * ppg + (k0 + 1 + rng.randint(0, ppg - 1, n_mols)) % ppg,
                      other_gene * ppg + rng.randint(0, ppg, n_mols))
    n_lab = np.where(kind == 0, 1, 2).astype(np.int64)
    offs = np.zeros(n_mols + 1, np.int64)
    np.cumsum(n_lab, out=offs[1:])
    labels = np.empty(offs[-1], np.uint32)
    labels[offs[:-1]] = probe0
    labels[offs[:-1][kind > 0] + 1] = probe1[kind > 0]

    # reads: a rotation of the sample's barcode, errors on both levels,
    # UMI satellites, the wrong orientation
    read_mol = np.repeat(np.arange(n_mols), mol_rpm)
    read_bcid = mol_bc[read_mol]
    sbc = rot[all_sample[read_bcid], rng.randint(0, rotations, total_reads)]
    _errors(rng, sbc, 2, sample_bc_len)
    cbc = all_bc[read_bcid]
    _errors(rng, cbc, 1, cell_bc_len)
    umi = mol_umi[read_mol].copy()
    first = np.zeros(total_reads, bool)
    first[np.cumsum(mol_rpm) - mol_rpm] = True
    sub_errors(rng, umi, (rng.rand(total_reads) < umi_error_rate) & ~first,
               np.full(umi_len, 1.0 / umi_len), umi_len)
    fw = rng.rand(total_reads) >= wrong_ori_rate

    order = rng.permutation(total_reads)
    read_mol, sbc, cbc, umi, fw = read_mol[order], sbc[order], cbc[order], umi[order], fw[order]
    nal = n_lab[read_mol]
    aln_offsets = np.zeros(total_reads + 1, np.int64)
    np.cumsum(nal, out=aln_offsets[1:])
    src = np.repeat(offs[read_mol], nal) + (np.arange(int(aln_offsets[-1]))
                                            - np.repeat(aln_offsets[:-1], nal))
    refs = labels[src]
    dirs = np.repeat(fw, nal)
    del read_mol, src

    ref_names = [f"probe_{i}" for i in range(n_genes * ppg)]
    schema = flex_schema(ref_names, sample_bc_len, cell_bc_len, umi_len)
    chunks = rad.fixed_chunks(total_reads, reads_per_chunk)
    (d / "rad").mkdir(parents=True, exist_ok=True)
    rad.write_rad(d / "rad" / "map.rad", schema, [sbc, cbc, umi], aln_offsets,
                  [refs | np.where(dirs, rad.ORI_BIT, np.uint32(0))], chunks)
    rad.write_barcode_list(d / "permit.txt", permit, cell_bc_len)
    text = rad.unpack_ascii(rot.ravel(), sample_bc_len).view(f"S{sample_bc_len}").ravel()
    text = [t.decode() for t in text]
    (d / "samples.tsv").write_text("".join(
        f"{text[s * rotations + r]}\t{text[s * rotations]}\t{names[s]}\n"
        for s in range(n_samples) for r in range(rotations)))
    (d / "t2g.tsv").write_text("".join(
        f"probe_{i}\tg_{i // ppg}\n" for i in range(n_genes * ppg)))
    return {
        "n_records": total_reads, "sample_bc_len": sample_bc_len, "bc_len": cell_bc_len,
        "umi_len": umi_len, "n_genes": n_genes, "probes_per_gene": ppg, "schema": schema,
        "sample_list": [(int(rot[s, r]), int(rot[s, 0]), names[s])
                        for s in range(n_samples) for r in range(rotations)],
        "sbc": sbc, "bc": cbc, "umi": umi,
        "aln_offsets": aln_offsets, "refs": refs, "dirs": dirs, "permit": permit,
        "num_chunks": len(chunks) - 1,
    }
