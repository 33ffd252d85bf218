"""RAD header and prelude.

Layout (reference: RadHeader::write as used by src/convert.rs:238-257;
read back at src/cellfilter.rs:507-509 via RadPrelude::from_bytes):

    is_paired  : u8
    ref_count  : u64
    ref names  : ref_count x (name_len:u16 | utf8 bytes)
    num_chunks : u64            (backpatched after writing chunks)

followed by the three tag sections (file, read, alignment) and then the
file-level tag *values* in file-tag declaration order.
"""

from __future__ import annotations

import struct
from collections.abc import Sequence
from dataclasses import dataclass, field
from typing import BinaryIO, Dict, List

import numpy as np

from .. import spans
from . import _native
from .types import (
    SECTION_ALN,
    SECTION_FILE,
    SECTION_READ,
    TagSection,
    TagValue,
    read_tag_value,
    write_tag_value,
)


class RefNames(Sequence):
    """Lazy view over the header's raw ``[len:u16|utf8]*`` name blob.

    Parsing a header with hundreds of thousands of reference names is a
    per-stage cost in the reference too (it eagerly builds a
    ``Vec<String>``, libradicl RadHeader::from_bytes); here the blob is
    boundary-scanned natively and names decode to Python strings only
    when a stage actually reads them (quant's tg-map join, view, ATAC
    BED emit).  collate round-trips the blob untouched.
    """

    __slots__ = ("_blob", "_starts", "_list")

    def __init__(self, blob: bytes, starts: np.ndarray):
        self._blob = blob
        self._starts = starts  # int64[count+1]; payload i = blob[s[i]:s[i+1]-2]
        self._list = None

    @property
    def blob(self) -> bytes:
        return self._blob

    def _materialize(self) -> List[str]:
        if self._list is None:
            b, st = self._blob, self._starts
            self._list = [
                b[st[i] : st[i + 1] - 2].decode("utf-8")
                for i in range(len(st) - 1)
            ]
        return self._list

    def __len__(self) -> int:
        return len(self._starts) - 1

    def __getitem__(self, i):
        if self._list is not None:
            return self._list[i]
        if isinstance(i, slice):
            return self._materialize()[i]
        n = len(self._starts) - 1
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        st = self._starts
        return self._blob[st[i] : st[i + 1] - 2].decode("utf-8")

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        if isinstance(other, RefNames):
            other = other._materialize()
        if isinstance(other, (list, tuple)):
            return self._materialize() == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return f"RefNames(<{len(self)} names>)"


@dataclass
class RadHeader:
    is_paired: int = 0
    ref_names: List[str] = field(default_factory=list)
    num_chunks: int = 0
    # raw [len:u16|utf8] name blob, cached on parse so a read->write
    # round trip (collate) skips re-encoding tens of thousands of names
    _names_blob: bytes = field(default=None, repr=False, compare=False)

    @property
    def ref_count(self) -> int:
        return len(self.ref_names)

    @classmethod
    def from_bytes(cls, fh: BinaryIO) -> "RadHeader":
        (is_paired,) = struct.unpack("<B", fh.read(1))
        (ref_count,) = struct.unpack("<Q", fh.read(8))
        if ref_count:
            # native boundary scan over bulk reads; names stay an
            # undecoded lazy blob until a stage actually needs them
            buf = b""
            read_sz = 1 << 20
            while True:
                n, starts = _native.scan_names(
                    np.frombuffer(buf, np.uint8), ref_count
                )
                if n >= 0:
                    break
                chunk = fh.read(read_sz)
                if not chunk:
                    raise EOFError("truncated RAD header")
                buf += chunk
                read_sz *= 2
            if len(buf) != n:
                fh.seek(n - len(buf), 1)
            names = RefNames(buf[:n], starts)
            hdr = cls(is_paired, names, 0)
            hdr._names_blob = buf[:n]
        else:
            hdr = cls(is_paired, [], 0)
        (num_chunks,) = struct.unpack("<Q", fh.read(8))
        hdr.num_chunks = num_chunks
        return hdr

    def names_nbytes(self) -> int:
        """Byte length of the encoded [len:u16|utf8]* name region."""
        if self._names_blob is not None:
            return len(self._names_blob)
        if isinstance(self.ref_names, RefNames):
            return len(self.ref_names.blob)
        return sum(2 + len(n.encode("utf-8")) for n in self.ref_names)

    def write(self, fh: BinaryIO) -> int:
        """Write the header; returns the byte offset of the num_chunks
        field (for backpatching, cf. src/convert.rs:254)."""
        fh.write(struct.pack("<B", self.is_paired))
        fh.write(struct.pack("<Q", self.ref_count))
        blob = self._names_blob
        if blob is None:
            if isinstance(self.ref_names, RefNames):
                blob = self.ref_names.blob
            else:
                parts = []
                for n in self.ref_names:
                    nb = n.encode("utf-8")
                    parts.append(struct.pack("<H", len(nb)))
                    parts.append(nb)
                blob = b"".join(parts)
            self._names_blob = blob
        fh.write(blob)
        pos = fh.tell()
        fh.write(struct.pack("<Q", self.num_chunks))
        return pos


@dataclass
class RadPrelude:
    hdr: RadHeader
    file_tags: TagSection
    read_tags: TagSection
    aln_tags: TagSection

    @classmethod
    def from_bytes(cls, fh: BinaryIO) -> "RadPrelude":
        hdr = RadHeader.from_bytes(fh)
        ft = TagSection.from_bytes(fh, SECTION_FILE)
        rt = TagSection.from_bytes(fh, SECTION_READ)
        at = TagSection.from_bytes(fh, SECTION_ALN)
        return cls(hdr, ft, rt, at)

    def write(self, fh: BinaryIO) -> int:
        """Write header + tag sections; returns num_chunks offset."""
        nc_pos = self.hdr.write(fh)
        self.file_tags.write(fh)
        self.read_tags.write(fh)
        self.aln_tags.write(fh)
        return nc_pos

    def parse_file_tag_values(self, fh: BinaryIO) -> Dict[str, TagValue]:
        vals: Dict[str, TagValue] = {}
        for t in self.file_tags.tags:
            vals[t.name] = read_tag_value(fh, t.typeid)
        return vals

    def write_file_tag_values(self, fh: BinaryIO, vals: Dict[str, TagValue]) -> None:
        for t in self.file_tags.tags:
            write_tag_value(fh, t.typeid, vals[t.name])


def read_prelude(fh: BinaryIO):
    """Read the prelude and file tag values, a ``header_read`` span;
    returns (prelude, file_tag_map, data_start_offset)."""
    with spans.span("header_read", "codec"):
        prelude = RadPrelude.from_bytes(fh)
        ftm = prelude.parse_file_tag_values(fh)
        return prelude, ftm, fh.tell()
