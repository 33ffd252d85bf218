"""The comparison that decides ``correct``: each artifact the program
wrote, read back by the benchmark's own readers, against what the
reference worked out, as a count of the units that differ (map entries,
vector elements, bytes, JSON fields).  Every limit is 0: the outputs
are exact."""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np


def _map(raw: bytes, offset: int, val: str):
    """A bincode map of ``u64`` keys: ``n:u64`` then the entries."""
    (n,) = struct.unpack_from("<Q", raw, offset)
    rec = np.frombuffer(raw, np.dtype([("k", "<u8"), ("v", val)]), count=n, offset=offset + 8)
    order = np.argsort(rec["k"], kind="stable")
    return rec["k"][order], rec["v"][order].astype(np.uint64)


def load(kind: str, path: Path, want=None):
    """The artifact at ``path`` in the form the reference gives ``kind``."""
    raw = path.read_bytes()
    if kind == "permit_freq":
        _ver, bclen = struct.unpack_from("<QQ", raw)
        return (int(bclen), *_map(raw, 16, "<u8"))
    if kind == "u64_map":
        return _map(raw, 0, "<u8")
    if kind == "u64_u32_map":
        return _map(raw, 0, "<u4")
    if kind == "u64_vec":
        (n,) = struct.unpack_from("<Q", raw)
        return np.frombuffer(raw, "<u8", count=n, offset=8)
    if kind == "bytes":
        return np.frombuffer(raw, np.uint8)
    if kind == "json":
        doc = json.loads(raw)
        return {k: doc.get(k) for k in want}
    raise ValueError(f"unknown artifact kind {kind}")


def _pairs(keys, vals) -> np.ndarray:
    return np.ascontiguousarray(
        np.stack([np.asarray(keys, np.uint64), np.asarray(vals, np.uint64)], axis=1)).view("V16")


def _elements(got: np.ndarray, want: np.ndarray) -> int:
    n = min(len(got), len(want))
    return int((got[:n] != want[:n]).sum()) + abs(len(got) - len(want))


def size(kind: str, want) -> int:
    """The units of an artifact: what a missing file counts."""
    if kind == "permit_freq":
        return 1 + len(want[1])
    if kind in ("u64_map", "u64_u32_map"):
        return len(want[0])
    return len(want)


def diff(kind: str, got, want) -> int:
    """Units of ``got`` that differ from ``want``."""
    if kind == "permit_freq":
        return int(got[0] != want[0]) + diff("u64_map", got[1:], want[1:])
    if kind in ("u64_map", "u64_u32_map"):
        a, b = _pairs(*got), _pairs(*want)
        if len(a) == len(b) and (a == b).all():
            return 0
        return int(len(np.setxor1d(a.ravel(), b.ravel())))
    if kind in ("u64_vec", "bytes"):
        return _elements(np.asarray(got), np.asarray(want))
    if kind == "json":
        return sum(got.get(k) != v for k, v in want.items())
    raise ValueError(f"unknown artifact kind {kind}")


def compare(out_dir: Path, expected: dict) -> dict:
    """``{artifact: differing units}`` of the files under ``out_dir``
    against ``{artifact: (kind, value)}``; a missing file differs in
    every unit."""
    found = {}
    for name, (kind, want) in expected.items():
        path = out_dir / name
        try:
            found[name] = diff(kind, load(kind, path, want), want)
        except (OSError, ValueError, struct.error):
            # missing, truncated or not the format at all
            found[name] = max(1, size(kind, want))
    return found
