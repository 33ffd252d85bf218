"""RAD typed-tag system.

Binary encoding reconstructed from the reference's use of libradicl's
``rad_types`` module (TagSection/TagDesc written at src/convert.rs:282-370,
parsed at src/collate.rs:988-1001) and the RAD format specification:

* type ids: Bool=0, U8=1, U16=2, U32=3, U64=4, F32=5, F64=6, Array=7,
  String=8 (``encode_type_tag`` / ``decode_int_type_tag``).
* a TagDesc is serialized as ``name_len:u16 | name bytes | type_id:u8``;
  for an Array tag the type id byte is followed by the length-int type id
  and the element type id.
* a TagSection is ``num_tags:u16`` followed by the TagDescs (the section
  label — file / read / alignment — is positional, not serialized).
* tag *values* are serialized per their type: ints little-endian at their
  width, String as ``len:u16 | utf8``, Array as ``len:<len-int-type>``
  followed by the packed elements, Bool as one byte.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import BinaryIO, List, Union

import numpy as np

# --- type ids ---------------------------------------------------------------
BOOL = 0
U8 = 1
U16 = 2
U32 = 3
U64 = 4
F32 = 5
F64 = 6
ARRAY = 7
STRING = 8

_INT_SIZES = {U8: 1, U16: 2, U32: 4, U64: 8}
_INT_STRUCT = {U8: "<B", U16: "<H", U32: "<I", U64: "<Q"}
_INT_NP = {U8: np.uint8, U16: np.uint16, U32: np.uint32, U64: np.uint64}
_FLOAT_SIZES = {F32: 4, F64: 8}
_FLOAT_STRUCT = {F32: "<f", F64: "<d"}
_FLOAT_NP = {F32: np.float32, F64: np.float64}

SECTION_FILE = "FileTags"
SECTION_READ = "ReadTags"
SECTION_ALN = "AlignmentTags"


def int_type_for_seq_len(length: int) -> int:
    """Smallest unsigned int type that can hold a 2-bit packed sequence of
    ``length`` bases (reference: src/convert.rs:323-343)."""
    if 1 <= length <= 4:
        return U8
    if length <= 8:
        return U16
    if length <= 16:
        return U32
    if length <= 32:
        return U64
    raise ValueError(f"cannot encode sequence of length {length} > 32")


def int_size(type_id: int) -> int:
    return _INT_SIZES[type_id]


def is_int_type(type_id: int) -> bool:
    return type_id in _INT_SIZES


@dataclass(frozen=True)
class RadType:
    """A RAD tag type.  ``type_id`` is one of the ids above; for ARRAY,
    ``len_type`` and ``elem_type`` give the length-int and element ids."""

    type_id: int
    len_type: int | None = None
    elem_type: int | None = None

    @property
    def is_int(self) -> bool:
        return is_int_type(self.type_id)

    def fixed_size(self) -> int | None:
        """Byte width for fixed-size types, None for String/Array."""
        if self.type_id in _INT_SIZES:
            return _INT_SIZES[self.type_id]
        if self.type_id in _FLOAT_SIZES:
            return _FLOAT_SIZES[self.type_id]
        if self.type_id == BOOL:
            return 1
        return None


@dataclass(frozen=True)
class TagDesc:
    name: str
    typeid: RadType


@dataclass
class TagSection:
    label: str
    tags: List[TagDesc] = field(default_factory=list)

    def add(self, name: str, typeid: RadType) -> None:
        self.tags.append(TagDesc(name, typeid))

    def has_tag(self, name: str) -> bool:
        return any(t.name == name for t in self.tags)

    def get(self, name: str) -> TagDesc | None:
        for t in self.tags:
            if t.name == name:
                return t
        return None

    # -- binary io -----------------------------------------------------------
    @classmethod
    def from_bytes(cls, fh: BinaryIO, label: str = "") -> "TagSection":
        (num_tags,) = struct.unpack("<H", fh.read(2))
        sec = cls(label)
        for _ in range(num_tags):
            (nlen,) = struct.unpack("<H", fh.read(2))
            name = fh.read(nlen).decode("utf-8")
            (tid,) = struct.unpack("<B", fh.read(1))
            if tid == ARRAY:
                lt, et = struct.unpack("<BB", fh.read(2))
                sec.add(name, RadType(ARRAY, lt, et))
            else:
                sec.add(name, RadType(tid))
        return sec

    def write(self, fh: BinaryIO) -> None:
        fh.write(struct.pack("<H", len(self.tags)))
        for t in self.tags:
            nb = t.name.encode("utf-8")
            fh.write(struct.pack("<H", len(nb)))
            fh.write(nb)
            fh.write(struct.pack("<B", t.typeid.type_id))
            if t.typeid.type_id == ARRAY:
                fh.write(struct.pack("<BB", t.typeid.len_type, t.typeid.elem_type))


TagValue = Union[bool, int, float, str, np.ndarray]


def read_tag_value(fh: BinaryIO, typeid: RadType) -> TagValue:
    tid = typeid.type_id
    if tid == BOOL:
        return bool(fh.read(1)[0])
    if tid in _INT_STRUCT:
        (v,) = struct.unpack(_INT_STRUCT[tid], fh.read(_INT_SIZES[tid]))
        return int(v)
    if tid in _FLOAT_STRUCT:
        (v,) = struct.unpack(_FLOAT_STRUCT[tid], fh.read(_FLOAT_SIZES[tid]))
        return float(v)
    if tid == STRING:
        (n,) = struct.unpack("<H", fh.read(2))
        return fh.read(n).decode("utf-8")
    if tid == ARRAY:
        (n,) = struct.unpack(
            _INT_STRUCT[typeid.len_type], fh.read(_INT_SIZES[typeid.len_type])
        )
        if typeid.elem_type in _INT_NP:
            dt = _INT_NP[typeid.elem_type]
        else:
            dt = _FLOAT_NP[typeid.elem_type]
        raw = fh.read(int(n) * np.dtype(dt).itemsize)
        return np.frombuffer(raw, dtype=dt).copy()
    raise ValueError(f"unsupported tag type id {tid}")


def write_tag_value(fh: BinaryIO, typeid: RadType, value: TagValue) -> None:
    tid = typeid.type_id
    if tid == BOOL:
        fh.write(struct.pack("<B", 1 if value else 0))
    elif tid in _INT_STRUCT:
        fh.write(struct.pack(_INT_STRUCT[tid], int(value)))
    elif tid in _FLOAT_STRUCT:
        fh.write(struct.pack(_FLOAT_STRUCT[tid], float(value)))
    elif tid == STRING:
        vb = str(value).encode("utf-8")
        fh.write(struct.pack("<H", len(vb)))
        fh.write(vb)
    elif tid == ARRAY:
        arr = np.asarray(value)
        fh.write(struct.pack(_INT_STRUCT[typeid.len_type], arr.size))
        if typeid.elem_type in _INT_NP:
            dt = _INT_NP[typeid.elem_type]
        else:
            dt = _FLOAT_NP[typeid.elem_type]
        fh.write(arr.astype(dt).tobytes())
    else:
        raise ValueError(f"unsupported tag type id {tid}")
