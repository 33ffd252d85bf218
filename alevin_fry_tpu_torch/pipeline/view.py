"""view: a RAD file as text (port of ``alevin_fry_tpu/pipeline/view.py``;
the format of src/convert.rs:596-709).

With ``-H`` the header lines ``{ref_id}:{ref_name}`` come first, then
one line per alignment:
``ID:{read}\\tHI:{i + 1}\\tNH:{n}\\tCB:{barcode}\\tUMI:{umi}\\tDIR:{true|false}\\t{ref_name}``.
Host code: the text of a decoded block is built from its columns at
once (the barcodes and UMIs unpacked by NumPy, one format call a line),
where the reference formats each alignment in a Python loop; the text
is the same.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

from ..ops.barcodes import unpack_seqs_to_strings
from ..radz import read_prelude
from ..radz.chunkio import iter_decoded_blocks
from ..radz.records import RecordSchema

_VIEW_BLOCK_RECORDS = 2_000_000
_WRITE_LINES = 1 << 18  # lines joined into one write
_LINE = "ID:{}\tHI:{}\tNH:{}\tCB:{}\tUMI:{}\tDIR:{}\t{}\n".format


def view(rad_file: Path, print_header: bool = False, out=None) -> int:
    """Write ``rad_file`` as text to ``out`` (standard output by
    default); returns the number of alignment lines."""
    out = out or sys.stdout
    num = 0
    with open(rad_file, "rb") as fh:
        prelude, ftm, _ = read_prelude(fh)
        bclen, umilen = int(ftm["cblen"]), int(ftm["ulen"])
        schema = RecordSchema.from_prelude(prelude)
        names = np.asarray(list(prelude.hdr.ref_names), object)
        if print_header:
            out.write("".join(f"{i}:{n}\n" for i, n in enumerate(names)))
        rid_base = 0
        for batch in iter_decoded_blocks(fh, schema, prelude.hdr.num_chunks,
                                         _VIEW_BLOCK_RECORDS, prefetch=True):
            nh = np.diff(batch.aln_offsets)
            read = np.repeat(np.arange(batch.n_reads), nh)
            hi = np.arange(batch.n_aln) - batch.aln_offsets[read] + 1
            cb = np.asarray(unpack_seqs_to_strings(batch.barcode(), bclen), object)[read]
            umi = np.asarray(unpack_seqs_to_strings(batch.umi, umilen), object)[read]
            cols = ((read + rid_base).tolist(), hi.tolist(), nh[read].tolist(), cb, umi,
                    np.where(batch.dirs, "true", "false").tolist(),
                    names[batch.refs.astype(np.int64)])
            for s in range(0, batch.n_aln, _WRITE_LINES):
                out.write("".join(map(_LINE, *(c[s:s + _WRITE_LINES] for c in cols))))
            num += batch.n_aln
            rid_base += batch.n_reads
    return num
