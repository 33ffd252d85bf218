"""The plain reference agrees with the port (``cli.main(...
--device cpu)``, the kernels' plain twins) at a size a test holds: every
number compared is 0 in each traffic, on two seeds."""

import pytest

from fry_bench import harness
from fry_bench.tests.conftest import tiny_cell


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
@pytest.mark.parametrize("name", ["rna_10xv3_usa.crlike", "atac_10x.sort"])
def test_reference_agrees_with_the_port_on_the_cpu(name, seed, capsys):
    res = harness.run_cell(tiny_cell(name), seed, 0.5, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())
    # every artifact the issue names is compared
    names = set(res["checks"])
    if name.startswith("rna"):
        assert {"gpl:permit_freq.bin", "gpl:permit_map.bin", "collate:map.collated.rad",
                "collate:unmapped_bc_count_collated.bin", "quant:alevin/quants_mat.mtx",
                "quant:alevin/quants_mat_rows.txt", "quant:alevin/quants_mat_cols.txt",
                "gpl:generate_permit_list.json", "quant:quant.json"} <= names
    else:
        assert {"atac_gpl:permit_freq.bin", "atac_gpl:permit_map.bin",
                "atac_gpl:bin_recs.bin", "atac_gpl:bin_lens.bin",
                "atac_gpl:generate_permit_list.json", "atac_sort:map.bed"} <= names


def test_the_reference_imports_nothing_of_the_program():
    import ast
    from pathlib import Path

    for path in (Path(harness.HERE) / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in ("alevin_fry_tpu_torch", "alevin_fry_tpu", "jax",
                                               "torch"), (path, m)
