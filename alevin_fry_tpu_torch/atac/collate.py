"""atac collate (port of ``alevin_fry_tpu/atac/collate.py``, reference
src/atac/collate.rs), single process.

The RNA collation keyed by barcode alone (``expected_ori='.'``: ATAC
records carry no orientation): correct barcodes through the permit map
and write one chunk per cell, in memory or, beyond ``max_records``
records, out of core (``pipeline/collate.py``); with ``-c`` into
``map.collated.rad.sz``.  The RAD header's chunk count may be 0
(atac/collate.rs:212); the readers then stream to EOF.
"""

from __future__ import annotations

from pathlib import Path

import torch

from .. import __version__
from ..device import refuse_multi_process
from ..pipeline.collate import collate_cells
from ..utils import check_version_compat


def collate(
    input_dir: Path,
    rad_dir: Path,
    device: torch.device,
    max_records: int = 30_000_000,
    compress_out: bool = False,
    cmdline: str = "",
    version: str = __version__,
) -> None:
    input_dir = Path(input_dir)
    check_version_compat(version, input_dir / "generate_permit_list.json")
    refuse_multi_process()
    collate_cells(input_dir, Path(rad_dir), ".", device, max_records, compress_out,
                  cmdline, version, expect_atac=True)
