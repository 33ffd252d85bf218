"""10x scATAC fragments.

A frozen copy of ``tests/synth_hard.py::make_hard_atac_dataset``
(commit 37c8559), with two changes: the records go through the
benchmark's own RAD writer (``gen/rad.py``), and the whitelist has the
size the configuration gives (10x's 737K-cratac-v1 list), the cells and
ambient barcodes drawn from it.  It models nucleosome-banded fragment
lengths with a tail past the 2 kb cap, peak-clustered positions, PCR
duplicates (the same cell, chromosome, start and length), non-proper
pairs and multi-mapped fragments, and log-normal cells over an ambient
population with per-cycle barcode errors.

:func:`make` writes ``rad/map.rad`` and the reverse-complement whitelist
``wl.txt`` (the 10x convention) and returns the records as arrays.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from . import rad
from .rna_hard import phred_ramp, random_codes, rng_for, sub_errors


def make(d: Path, seed: int, n_cells: int, n_frags: int, n_chrs: int, chr_len: int,
         bc_len: int, ambient_factor: int, dup_rate: float, whitelist_size: int,
         reads_per_chunk: int, **_) -> dict:
    rng = rng_for(seed)
    n_ambient = ambient_factor * n_cells
    permit = random_codes(rng, whitelist_size, bc_len)
    perm = rng.permutation(len(permit))
    real_bcs = permit[perm[:n_cells]]
    ambient_bcs = permit[perm[n_cells:n_cells + n_ambient]]
    real_w = np.exp(rng.normal(0.0, 0.8, n_cells))
    real_w /= real_w.sum()
    amb_w = rng.exponential(1.0, n_ambient)
    amb_w /= amb_w.sum()
    cell_w = np.concatenate([0.92 * real_w, 0.08 * amb_w])
    all_bcs = np.concatenate([real_bcs, ambient_bcs])

    # unique molecules, then PCR duplication
    n_mols = int(n_frags / (1.0 + dup_rate))
    mol_cell = rng.choice(len(all_bcs), size=n_mols, p=cell_w)
    mol_chr = rng.randint(0, n_chrs, n_mols)
    n_peaks = 3000
    peak_pos = rng.randint(0, chr_len - 3000, (n_chrs, n_peaks))
    in_peak = rng.rand(n_mols) < 0.6
    pk = rng.randint(0, n_peaks, n_mols)
    mol_pos = np.where(in_peak, peak_pos[mol_chr, pk] + rng.randint(0, 500, n_mols),
                       rng.randint(0, chr_len - 3000, n_mols))
    band = rng.choice(4, size=n_mols, p=[0.45, 0.33, 0.17, 0.05])
    flen = np.where(
        band == 0, rng.randint(60, 141, n_mols),
        np.where(band == 1, rng.randint(160, 251, n_mols),
                 np.where(band == 2, rng.randint(300, 501, n_mols),
                          (600 + rng.exponential(700, n_mols)).astype(np.int64))),
    ).astype(np.int64)
    dups = 1 + rng.poisson(dup_rate, n_mols)
    frag_mol = np.repeat(np.arange(n_mols), dups)[:n_frags]
    total = len(frag_mol)
    f_cell = mol_cell[frag_mol]
    f_chr = mol_chr[frag_mol].astype(np.int64)
    f_pos = mol_pos[frag_mol].astype(np.int64)
    f_len = flen[frag_mol]

    f_bc = all_bcs[f_cell]
    q = phred_ramp(bc_len)
    nerr = np.minimum(rng.poisson(q.sum(), total), 2)
    pos_prob = q / q.sum()
    sub_errors(rng, f_bc, nerr >= 1, pos_prob, bc_len)
    sub_errors(rng, f_bc, nerr >= 2, pos_prob, bc_len)

    # map type 4: a unique proper pair; ~3% non-proper, ~2% multi-mapped
    mt = np.full(total, 4, np.int64)
    mt[rng.rand(total) < 0.03] = 2
    multi = rng.rand(total) < 0.02

    order = rng.permutation(total)
    f_bc, f_chr, f_pos, f_len, mt, multi = (f_bc[order], f_chr[order], f_pos[order],
                                            f_len[order], mt[order], multi[order])
    nal = 1 + multi.astype(np.int64)
    aln_offsets = np.zeros(total + 1, np.int64)
    np.cumsum(nal, out=aln_offsets[1:])
    first = aln_offsets[:-1]
    second = first[multi] + 1
    n_aln = int(aln_offsets[-1])
    a_chr = np.empty(n_aln, np.uint32)
    a_type = np.empty(n_aln, np.uint8)
    a_pos = np.empty(n_aln, np.uint32)
    a_len = np.empty(n_aln, np.uint16)
    a_chr[first], a_type[first] = f_chr, mt
    a_pos[first], a_len[first] = f_pos, np.minimum(f_len, 65535)
    a_chr[second], a_type[second] = (f_chr[multi] + 1) % n_chrs, mt[multi]
    a_pos[second], a_len[second] = f_pos[multi], np.minimum(f_len[multi], 65535)

    ref_names = [f"chr{i + 1}" for i in range(n_chrs)]
    schema = rad.atac_schema(ref_names, [chr_len] * n_chrs, bc_len)
    (d / "rad").mkdir(parents=True, exist_ok=True)
    chunks = rad.fixed_chunks(total, reads_per_chunk)
    rad.write_rad(d / "rad" / "map.rad", schema, [f_bc], aln_offsets,
                  [a_chr, a_type, a_pos, a_len], chunks)
    rad.write_barcode_list(d / "wl.txt", rad.revcomp(permit, bc_len), bc_len)
    return {
        "n_records": total, "bc_len": bc_len, "ref_names": ref_names,
        "ref_lens": np.full(n_chrs, chr_len, np.uint64), "schema": schema,
        "bc": f_bc, "aln_offsets": aln_offsets, "chr": a_chr, "type": a_type,
        "start": a_pos, "frag_len": a_len, "permit": permit, "num_chunks": len(chunks) - 1,
    }
