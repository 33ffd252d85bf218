"""2-bit packed barcodes and the 1-edit rescue entry point.

Barcodes pack as 2-bit codes in a uint64 (A=0, C=1, G=2, T=3, N->A;
``cb_string_to_u64``, src/convert.rs:75-89), the first base in the
highest bits.  Packing and unpacking are host NumPy, as in
``alevin_fry_tpu/ops/barcodes.py``.

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
