"""bincode-compatible serialization for the stage sidecar files.

The reference serializes Rust ``HashMap<u64, u64>`` / ``Vec<u64>`` values
with bincode's default (legacy) configuration: little-endian, fixed-width
integers, collection length prefixed as u64.  That is what
``permit_map.bin`` / ``permit_freq.bin`` / ``bin_recs.bin`` etc. contain
(written at src/utils.rs:414-459, src/cellfilter.rs:301-305, read back at
src/collate.rs:143-177).

We write map entries sorted by key so our outputs are deterministic;
readers (including the reference) deserialize into hash maps, so entry
order is immaterial.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import BinaryIO, Tuple

import numpy as np

from .constants import PERMIT_FILE_VER


def write_u64_map(fh: BinaryIO, keys: np.ndarray, vals: np.ndarray) -> None:
    keys = np.asarray(keys, np.uint64)
    vals = np.asarray(vals, np.uint64)
    order = np.argsort(keys, kind="stable")
    keys, vals = keys[order], vals[order]
    fh.write(struct.pack("<Q", len(keys)))
    inter = np.empty(2 * len(keys), np.uint64)
    inter[0::2] = keys
    inter[1::2] = vals
    fh.write(inter.tobytes())


def read_u64_map(fh: BinaryIO) -> Tuple[np.ndarray, np.ndarray]:
    (n,) = struct.unpack("<Q", fh.read(8))
    raw = np.frombuffer(fh.read(16 * n), dtype=np.uint64)
    return raw[0::2].copy(), raw[1::2].copy()


def write_u64_vec(fh: BinaryIO, vals: np.ndarray) -> None:
    vals = np.asarray(vals, np.uint64)
    fh.write(struct.pack("<Q", len(vals)))
    fh.write(vals.tobytes())


def read_u64_vec(fh: BinaryIO) -> np.ndarray:
    (n,) = struct.unpack("<Q", fh.read(8))
    return np.frombuffer(fh.read(8 * n), dtype=np.uint64).copy()


# --- permit_freq.bin / all_freq.bin (src/utils.rs:414-435) ------------------

def write_permit_freq(path: Path, bclen: int, keys: np.ndarray, vals: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", PERMIT_FILE_VER))
        fh.write(struct.pack("<Q", bclen))
        write_u64_map(fh, keys, vals)


def read_permit_freq(path: Path) -> Tuple[int, np.ndarray, np.ndarray]:
    with open(path, "rb") as fh:
        (ver,) = struct.unpack("<Q", fh.read(8))
        if ver > PERMIT_FILE_VER:
            raise ValueError(
                f"permit_freq.bin has version {ver}, supported <= {PERMIT_FILE_VER}"
            )
        (bclen,) = struct.unpack("<Q", fh.read(8))
        keys, vals = read_u64_map(fh)
    return int(bclen), keys, vals


def write_u64_map_file(path: Path, keys: np.ndarray, vals: np.ndarray) -> None:
    with open(path, "wb") as fh:
        write_u64_map(fh, keys, vals)


def read_u64_map_file(path: Path) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as fh:
        return read_u64_map(fh)


def write_u64_vec_file(path: Path, vals: np.ndarray) -> None:
    with open(path, "wb") as fh:
        write_u64_vec(fh, vals)


def read_u64_vec_file(path: Path) -> np.ndarray:
    with open(path, "rb") as fh:
        return read_u64_vec(fh)
