"""Collation manifest sidecar of a hierarchically collated (multi-sample,
10x Flex) RAD file (port of ``alevin_fry_tpu/radz/collation.py``).

Mirrors libradicl's ``collation::{CollationManifest, SampleGroup}`` as the
reference uses it (written at collate.rs:1896-1931, read at
quant.rs:1314-1330): ordered sample groups with (key, optional name,
chunk_start, num_chunks, num_records) and a list of level names.

Binary layout: bincode 1.x default config (little-endian, fixint, u64
collection lengths) of the struct in field order, the codec of every
other sidecar (``permit_map.bin`` etc.):

    levels:        u64 count, then per level  u64 len + utf8 bytes
    sample_groups: u64 count, then per group:
        key:         u64
        name:        u8 Option tag (0|1), if 1: u64 len + utf8 bytes
        chunk_start: u64
        num_chunks:  u64
        num_records: u64
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional


def _pack_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<Q", len(b)) + b


def _read_str(fh) -> str:
    (n,) = struct.unpack("<Q", fh.read(8))
    return fh.read(n).decode()


@dataclass
class SampleGroup:
    key: int
    name: Optional[str]
    chunk_start: int
    num_chunks: int
    num_records: int


@dataclass
class CollationManifest:
    levels: List[str]
    sample_groups: List[SampleGroup] = field(default_factory=list)

    def add_sample_group(self, g: SampleGroup) -> None:
        self.sample_groups.append(g)

    def total_chunks(self) -> int:
        return sum(g.num_chunks for g in self.sample_groups)

    def total_records(self) -> int:
        return sum(g.num_records for g in self.sample_groups)

    def write_to_file(self, path: Path) -> None:
        with open(path, "wb") as fh:
            fh.write(struct.pack("<Q", len(self.levels)))
            for lv in self.levels:
                fh.write(_pack_str(lv))
            fh.write(struct.pack("<Q", len(self.sample_groups)))
            for g in self.sample_groups:
                fh.write(struct.pack("<Q", g.key))
                if g.name is None:
                    fh.write(b"\x00")
                else:
                    fh.write(b"\x01" + _pack_str(g.name))
                fh.write(struct.pack("<QQQ", g.chunk_start, g.num_chunks, g.num_records))

    @classmethod
    def read_from_file(cls, path: Path) -> "CollationManifest":
        with open(path, "rb") as fh:
            (nlv,) = struct.unpack("<Q", fh.read(8))
            if nlv > 64:
                raise ValueError(f"{path}: implausible level count {nlv}")
            m = cls([_read_str(fh) for _ in range(nlv)])
            (ng,) = struct.unpack("<Q", fh.read(8))
            for _ in range(ng):
                (key,) = struct.unpack("<Q", fh.read(8))
                (has_name,) = struct.unpack("<B", fh.read(1))
                name = _read_str(fh) if has_name else None
                cs, nc, nr = struct.unpack("<QQQ", fh.read(24))
                m.add_sample_group(SampleGroup(key, name, cs, nc, nr))
        return m
