"""2-bit packed barcodes and the 1-edit rescue entry point.

Barcodes pack as 2-bit codes in a uint64 (A=0, C=1, G=2, T=3, N->A;
``cb_string_to_u64``, src/convert.rs:75-89), the first base in the
highest bits.  Packing and unpacking are host NumPy, as in
``alevin_fry_tpu/ops/barcodes.py``, and so is the 1-edit correction
map of the filtered permit lists (:func:`generate_permitlist_map`).

:func:`find_neighbors` is the unfiltered-permit-list rescue search
(src/cellfilter.rs:190-233): it runs kernel K4 or K5
(``ops/hamming.py``) on the device it is given, chosen as the
reference's dispatcher chooses (``alevin_fry_tpu/ops/barcodes.py``).
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np
import torch

from . import hamming

_ASCII_TO_2BIT = np.full(256, 255, np.uint8)
for _b, _v in zip(b"ACGT", range(4)):
    _ASCII_TO_2BIT[_b] = _v
for _b, _v in zip(b"acgt", range(4)):
    _ASCII_TO_2BIT[_b] = _v
_ASCII_TO_2BIT[ord("N")] = 0
_ASCII_TO_2BIT[ord("n")] = 0

_BASES = np.frombuffer(b"ACGT", np.uint8)


def pack_seq(seq: str) -> int:
    """Pack one nucleotide string into a 2-bit integer."""
    v = 0
    for ch in seq:
        v = (v << 2) | int(_ASCII_TO_2BIT[ord(ch)])
    return v


def pack_seqs(lines: Iterable[bytes | str], length: int | None = None) -> np.ndarray:
    """Pack equal-length sequences into a uint64 array."""
    rows = [l.encode() if isinstance(l, str) else l for l in lines]
    if not rows:
        return np.zeros(0, np.uint64)
    if length is None:
        length = len(rows[0])
    mat = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, length)
    codes = _ASCII_TO_2BIT[mat].astype(np.uint64)
    shifts = np.uint64(2) * np.arange(length - 1, -1, -1, dtype=np.uint64)
    return (codes << shifts[None, :]).sum(axis=1, dtype=np.uint64)


def unpack_seq(bc: int, length: int) -> str:
    return "".join("ACGT"[(int(bc) >> (2 * i)) & 3] for i in range(length - 1, -1, -1))


def unpack_seqs(bcs: np.ndarray, length: int) -> np.ndarray:
    """uint64 barcodes -> (n, length) uint8 ASCII matrix."""
    bcs = np.asarray(bcs, np.uint64)
    shifts = np.uint64(2) * np.arange(length - 1, -1, -1, dtype=np.uint64)
    codes = ((bcs[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.uint8)
    return _BASES[codes]


def unpack_seqs_to_strings(bcs: np.ndarray, length: int) -> list:
    return [bytes(row).decode() for row in unpack_seqs(bcs, length)]


def revcomp_packed(bcs: np.ndarray, length: int) -> np.ndarray:
    """Reverse-complement 2-bit packed barcodes."""
    bcs = np.asarray(bcs, np.uint64)
    out = np.zeros_like(bcs)
    for i in range(length):
        comp = ((bcs >> np.uint64(2 * i)) & np.uint64(3)) ^ np.uint64(3)
        out |= comp << np.uint64(2 * (length - 1 - i))
    return out


def snp_neighbors(bcs: np.ndarray, length: int) -> np.ndarray:
    """Every substitution variant of each barcode, the barcode itself
    among them (where the new base is the old one): (n, 4 * length)
    uint64, positions counted from the low bits (get_all_snps,
    src/utils.rs:917-943)."""
    bcs = np.asarray(bcs, np.uint64)
    shifts = np.uint64(2) * np.arange(length, dtype=np.uint64)
    cleared = bcs[:, None] & ~(np.uint64(3) << shifts)[None, :]
    bases = np.arange(4, dtype=np.uint64)
    out = cleared[:, :, None] | (bases[None, None, :] << shifts[None, :, None])
    return out.reshape(len(bcs), 4 * length)


def indel_neighbors(bcs: np.ndarray, length: int) -> np.ndarray:
    """Every 1-indel variant of each barcode at the interior positions
    1..length-1: an insertion of each base, the low part shifted right,
    and a deletion, the low part shifted left with each base filling
    the end (get_all_indels, src/utils.rs:945-981).  (n, 8 * (length -
    1)) uint64, insertion and deletion interleaved; may hold the
    barcode itself."""
    bcs = np.asarray(bcs, np.uint64)
    out = np.empty((len(bcs), length - 1, 4, 2), np.uint64)
    for pos in range(1, length):
        low_mask = np.uint64((1 << (2 * pos)) - 1)
        upper, lower = bcs & ~low_mask, bcs & low_mask
        del_mask = ~(np.uint64(3) << np.uint64(2 * pos))
        for base in range(4):
            b = np.uint64(base)
            out[:, pos - 1, base, 0] = (upper | (b << np.uint64(2 * (pos - 1)))
                                        | (lower >> np.uint64(2)))
            out[:, pos - 1, base, 1] = upper | b | ((lower & del_mask) << np.uint64(2))
    return out.reshape(len(bcs), 8 * (length - 1))


def generate_permitlist_map(permit_bcs: np.ndarray, length: int) -> Tuple[np.ndarray, np.ndarray]:
    """The correction map (src/utils.rs:1026-1051): every permitted
    barcode to itself, and every 1-edit neighbour (substitution or
    indel) to a permitted barcode.  ``permit_bcs`` comes in priority
    order: a neighbour of several permitted barcodes maps to the first
    of them (the reference takes the first in hash order; the JAX
    package fixes the order, docs/parity.md:48-53), and an exact entry
    wins over any neighbour.  Returns (keys sorted ascending, values)."""
    permit_bcs = np.asarray(permit_bcs, np.uint64)
    k = len(permit_bcs)
    if k == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.uint64)
    neigh = np.concatenate(
        [snp_neighbors(permit_bcs, length), indel_neighbors(permit_bcs, length)], axis=1
    )
    owner = np.repeat(np.arange(k, dtype=np.int64), neigh.shape[1])
    flat = neigh.reshape(-1)
    other = flat != permit_bcs[owner]
    flat, owner = flat[other], owner[other]
    keys = np.concatenate([permit_bcs, flat])
    prio = np.concatenate([np.full(k, -1, np.int64), owner])
    vals = np.concatenate([permit_bcs, permit_bcs[owner]])
    order = np.lexsort((prio, keys))
    keys, vals = keys[order], vals[order]
    first = np.ones(len(keys), bool)
    first[1:] = keys[1:] != keys[:-1]
    return keys[first], vals[first]


def find_neighbors(
    queries: np.ndarray, kept_sorted: np.ndarray, length: int,
    device: torch.device,
) -> Tuple[np.ndarray, np.ndarray]:
    """For each query barcode: the number of kept barcodes within
    Hamming distance 1 (substitutions, exact match included) and the
    smallest of them (unique where the count is 1, the only case the
    rescue consumes).

    ``AFT_RESCUE_BACKEND`` picks the kernel as it does in the reference:
    unset, ``auto`` or ``mxu`` runs K4; ``pallas`` runs K5, and so does
    any barcode length outside K4's 2..32.  The reference's host
    engines (``host``, ``jax``) are not kernels of the port and raise:
    its host path is ``--device cpu``."""
    mode = os.environ.get("AFT_RESCUE_BACKEND") or "auto"
    if mode not in ("auto", "mxu", "pallas"):
        raise ValueError(
            f"AFT_RESCUE_BACKEND={mode!r}: the port's rescue runs kernel K4 "
            "('auto', 'mxu') or K5 ('pallas'); its host path is --device cpu"
        )
    if mode == "pallas" or not 2 <= length <= 32:
        return hamming.find_neighbors_brute(queries, kept_sorted, device)
    return hamming.find_neighbors(queries, kept_sorted, length, device)
