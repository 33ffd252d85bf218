"""RAD file writer for a stream of chunks whose count is known only at
the end (convert): the header's ``num_chunks`` is written as 0 and
patched with one seek when the writer is finalized, as convert.rs does
(src/convert.rs:584-590) and as ``alevin_fry_tpu/radz/writers.py``
does.  The output must therefore be a seekable file.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict

import numpy as np

from .chunkio import ChunkWriter, encode_records
from .header import RadPrelude
from .records import RecordSchema
from .types import TagValue


class RadWriter:
    def __init__(self, fh: BinaryIO, prelude: RadPrelude, file_tag_vals: Dict[str, TagValue]):
        self.fh = fh
        self.schema = RecordSchema.from_prelude(prelude)
        self.num_chunks_pos = prelude.write(fh)
        prelude.write_file_tag_values(fh, file_tag_vals)
        self.chunks = ChunkWriter(fh)

    def write_chunk(self, read_cols: Dict[str, np.ndarray], aln_offsets: np.ndarray,
                    refs: np.ndarray, dirs: np.ndarray) -> None:
        """Encode one chunk of records (read columns, CSR alignment
        offsets, reference ids and orientations) and write it."""
        body = encode_records(self.schema, read_cols, aln_offsets, refs, dirs, {})
        self.chunks.write_chunk_bytes(body, len(aln_offsets) - 1)

    def finalize(self) -> int:
        """Patch num_chunks into the header; returns the chunk count."""
        n = self.chunks.num_chunks
        self.fh.flush()
        pos = self.fh.tell()
        self.fh.seek(self.num_chunks_pos)
        self.fh.write(struct.pack("<Q", n))
        self.fh.seek(pos)
        self.fh.flush()
        return n
