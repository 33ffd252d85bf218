"""Snappy framing format for the compressed collated RAD file
(``map.collated.rad.sz``; the reference writes it with
``snap::write::FrameEncoder``, src/collate.rs:564-575, and reads it back
with ``FrameDecoder``, src/quant.rs:372-382).  The port's copy of
``alevin_fry_tpu/radz/snappyz.py``, written to give the same bytes.

* Writing splits the whole uncompressed stream into chunks of 64 KiB,
  however it arrives in ``write`` calls, and stores each chunk
  block-compressed by the native codec (``csrc/libradc.so``) when that
  shrinks it, else as it is.
* Reading decodes compressed chunks with the native codec and takes
  stored chunks as they are (the JAX package's pure path writes only
  those).  The CRC-32C of each chunk is written, not checked.

Framing spec: https://github.com/google/snappy/blob/main/framing_format.txt
"""

from __future__ import annotations

import struct
from typing import BinaryIO

from . import _native

_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_MAX_CHUNK = 65536
_CHUNK_COMPRESSED, _CHUNK_STORED, _CHUNK_PADDING, _CHUNK_STREAM_ID = 0x00, 0x01, 0xFE, 0xFF


def _masked_crc(data: bytes) -> int:
    c = _native.crc32c(data)
    return ((((c >> 15) | (c << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF


def _read_varint(buf: bytes, pos: int):
    shift = val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def block_decompress(buf: bytes) -> bytes:
    """Decode one snappy block (its length leads as a varint)."""
    ulen = _read_varint(buf, 0)[0]
    out = _native.snappy_uncompress(buf, ulen)
    if len(out) != ulen:
        raise ValueError("snappy block decodes to the wrong length")
    return out


class SnappyFrameWriter:
    """Incremental framing writer: buffers across ``write`` calls and
    emits a chunk per 64 KiB of the stream, so the chunks do not depend
    on how the stream was cut into writes.  ``flush`` emits the last
    partial chunk."""

    def __init__(self, fh: BinaryIO):
        self.fh = fh
        fh.write(_STREAM_ID)
        self._pend = bytearray()

    def write(self, data) -> None:
        """Take any bytes-like ``data``; only a partial chunk is copied
        into the buffer."""
        mv = memoryview(data).cast("B")
        if self._pend:
            take = min(len(mv), _MAX_CHUNK - len(self._pend))
            self._pend += mv[:take]
            mv = mv[take:]
            if len(self._pend) < _MAX_CHUNK:
                return
            self._emit(self._pend)
            self._pend.clear()
        done = len(mv) - len(mv) % _MAX_CHUNK
        for s in range(0, done, _MAX_CHUNK):
            self._emit(mv[s:s + _MAX_CHUNK])
        self._pend += mv[done:]

    def _emit(self, chunk) -> None:
        chunk = bytes(chunk)
        crc = struct.pack("<I", _masked_crc(chunk))
        body, ctype = chunk, _CHUNK_STORED
        comp = _native.snappy_compress(chunk)
        if len(comp) < len(chunk):
            body, ctype = comp, _CHUNK_COMPRESSED
        self.fh.write(struct.pack("<I", ((len(body) + 4) << 8) | ctype) + crc + body)

    def flush(self) -> None:
        if self._pend:
            self._emit(self._pend)
            self._pend.clear()


def frame_compress_stream(data, fh: BinaryIO) -> None:
    """Write ``data`` as one framing stream."""
    w = SnappyFrameWriter(fh)
    w.write(data)
    w.flush()


class SnappyFrameReader:
    """Streaming framing reader with a file-like ``read`` / ``seek`` /
    ``tell``, so a stage reads the collated file without holding it
    decompressed.  ``read(n)`` returns ``n`` bytes unless the stream
    ends.  The reader keeps every decoded byte until
    :meth:`drop_history`, because the RAD header parser reads ahead and
    seeks back; after it, consumed bytes are dropped and only forward
    seeks are served (by decoding further chunks)."""

    def __init__(self, fh: BinaryIO):
        self._fh = fh
        self._buf = bytearray()
        self._pos = 0       # cursor into _buf
        self._base = 0      # stream offset of _buf[0]
        self._keep_history = True
        self._eof = False
        self._first = True

    def drop_history(self) -> None:
        self._keep_history = False
        self._trim()

    def _trim(self) -> None:
        if self._keep_history or self._pos < (1 << 22):
            return
        del self._buf[:self._pos]
        self._base += self._pos
        self._pos = 0

    def _pull_chunk(self) -> bool:
        hdr = self._fh.read(4)
        if len(hdr) < 4:
            self._eof = True
            return False
        word = struct.unpack("<I", hdr)[0]
        ctype, ln = word & 0xFF, word >> 8
        body = self._fh.read(ln)
        if len(body) != ln:
            raise EOFError("truncated snappy frame")
        if ctype == _CHUNK_STREAM_ID:
            if self._first and body != b"sNaPpY":
                raise ValueError("bad snappy stream identifier")
        elif ctype == _CHUNK_COMPRESSED:
            self._buf += block_decompress(body[4:])
        elif ctype == _CHUNK_STORED:
            self._buf += body[4:]
        elif not (ctype == _CHUNK_PADDING or 0x80 <= ctype <= 0xFD):
            raise ValueError(f"unskippable snappy chunk type 0x{ctype:02x}")
        self._first = False
        return True

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            while self._pull_chunk():
                pass
            n = len(self._buf) - self._pos
        while len(self._buf) - self._pos < n and not self._eof:
            self._pull_chunk()
        out = bytes(self._buf[self._pos:self._pos + n])
        self._pos += len(out)
        self._trim()
        return out

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 1:
            target = self._pos + offset
        elif whence == 0:
            target = offset - self._base
        else:
            raise OSError("snappy frame reader cannot seek from the end")
        if target < 0:
            raise OSError("seek before the retained snappy history")
        while target > len(self._buf) and not self._eof:
            self._pull_chunk()
        self._pos = min(target, len(self._buf))
        return self._base + self._pos

    def tell(self) -> int:
        return self._base + self._pos

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
