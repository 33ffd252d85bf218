"""The benchmark's own tests (``python -m pytest fry_bench/tests -q``).
They import neither JAX nor the JAX package.  Tests marked ``cuda`` run
the benchmark on a card and skip where torch sees none."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each cell cut to a size a CPU test holds: every code path of the full
# size (the rescue, out-of-core sort buckets, wide label sets) still runs
TINY = {
    "rna_10xv3_usa.crlike": dict(n_cells=200, n_reads=60_000, n_genes=400,
                                 permit_list_size=20_000, reads_per_chunk=5_000),
    "atac_10x.sort": dict(n_cells=200, n_frags=60_000, chr_len=2_000_000,
                          whitelist_size=20_000, reads_per_chunk=5_000,
                          sort_max_records=15_000),
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skipped where torch sees none)")


def tiny_cell(name):
    from fry_bench import harness

    cell = harness.load_cell(name)
    cell.config["sizes"].update(TINY[name])
    return cell


@pytest.fixture
def tiny():
    return tiny_cell
