"""MatrixMarket I/O matching the reference's sprs-based writer.

The reference writes cell x gene counts via ``sprs::io::write_matrix_market``
(src/quant.rs:1805-1806) with f32 values; Rust's float Display prints the
shortest round-trip decimal (so integral values print without a decimal
point).  We mirror that formatting so diffs against the reference are
byte-clean on integer-valued matrices.
"""

from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from . import _native


def format_f32_list(vals: np.ndarray) -> list:
    """Format f32 values as Rust's ``Display`` does (shortest decimal
    that round-trips, positional notation), one str each."""
    return _native.format_f32(np.asarray(vals, np.float32))


MTX_HEADER = (
    b"%%MatrixMarket matrix coordinate real general\n"
    b"% written by alevin-fry-tpu\n"
)


def format_mtx_body(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> bytes:
    """Format coordinate triplets (0-based in, 1-based out) as MTX body
    bytes.  A value formats identically whether or not the batch around
    it is all-integral, so bodies can be produced block-by-block and
    concatenated byte-identically to a single call."""
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    vals = np.asarray(vals, np.float32)
    ivals = vals.astype(np.int64)
    if ((vals == ivals) & np.isfinite(vals)).all():
        # a count matrix: the integer formatter
        return _native.format_triplets(rows + 1, cols + 1, ivals)
    # fractions (EM outputs): integral values still print as integers
    return _native.format_triplets_f32(rows + 1, cols + 1, vals)


def write_matrix_market(
    path: Path, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
    shape: Tuple[int, int],
) -> None:
    """Write a coordinate-format MatrixMarket file (1-based indices)."""
    # binary sink: the body is pure ASCII and the native formatter
    # already produces bytes — avoid a decode + re-encode round trip
    with open(path, "wb") as fh:
        fh.write(MTX_HEADER)
        fh.write(f"{shape[0]} {shape[1]} {len(np.asarray(vals))}\n".encode())
        fh.write(format_mtx_body(rows, cols, vals))


class MtxStreamWriter:
    """A MatrixMarket file written block by block at bounded memory: the
    body streams to a sidecar as the blocks come, and :meth:`finalize`
    writes the header, whose entry count is known only then, and one
    sequential copy of the body; nothing seeks back.  The bytes equal
    one ``write_matrix_market`` call over the concatenated triplets."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self._tmp = self.path.with_suffix(self.path.suffix + ".body.tmp")
        self._fh = open(self._tmp, "wb")
        self.nnz = 0

    def add(self, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray) -> None:
        self._fh.write(format_mtx_body(rows, cols, vals))
        self.nnz += len(vals)

    def finalize(self, shape: Tuple[int, int]) -> None:
        import shutil

        self._fh.close()
        with open(self.path, "wb") as out, open(self._tmp, "rb") as body:
            out.write(MTX_HEADER)
            out.write(f"{shape[0]} {shape[1]} {self.nnz}\n".encode())
            shutil.copyfileobj(body, out, 1 << 22)
        self._tmp.unlink()

    def abort(self) -> None:
        self._fh.close()
        self._tmp.unlink(missing_ok=True)


def read_matrix_market(path: Path):
    """Read a coordinate MatrixMarket file -> (rows, cols, vals f64,
    (nrows, ncols)), indices 0-based."""
    with open(path) as fh:
        header = fh.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError(f"{path} is not a MatrixMarket file")
        line = fh.readline()
        while line.startswith("%"):
            line = fh.readline()
        nrows, ncols, nnz = (int(t) for t in line.split())
        data = np.loadtxt(fh, dtype=np.float64, ndmin=2) if nnz else np.zeros((0, 3))
    data = data.reshape(-1, 3)
    return (
        data[:, 0].astype(np.int64) - 1, data[:, 1].astype(np.int64) - 1, data[:, 2],
        (nrows, ncols),
    )
