"""``correct`` comes out false where it should.  The control (the
reference with the configuration's guarantee broken, ``no_rescue``)
fails a number of each cell; and a run with the timed path broken
underneath fails, once for each fault a cell can have: half of the
input left out, an answer altered where it is produced, a stage that
leaves its state unchanged.  (One chip a cell: no exchange between
chips to leave out.)"""

import numpy as np
import pytest

from fry_bench import control, harness
from fry_bench.tests.conftest import tiny_cell


@pytest.mark.parametrize("name", ["rna_10xv3_usa.crlike", "atac_10x.sort"])
def test_the_control_fails(name, tmp_path):
    found = control.readings(tiny_cell(name), 21, tmp_path)
    assert max(found.values()) > 0, found
    # the rescue's own numbers move: the permit list and the map
    stage = "gpl" if name.startswith("rna") else "atac_gpl"
    assert found[f"{stage}:permit_map.bin"] > 0 and found[f"{stage}:permit_freq.bin"] > 0


def _half_histogram(mp):
    from alevin_fry_tpu_torch.pipeline import gpl

    orig = gpl._histogram
    mp.setattr(gpl, "_histogram", lambda bcs: orig(bcs[: len(bcs) // 2]))


def _altered_count(mp):
    from alevin_fry_tpu_torch.ops import crlike

    orig = crlike.wta_counts_device

    def one_more(*a, **k):
        rows, cols, vals = orig(*a, **k)
        vals = vals.copy()
        vals[:1] += 1
        return rows, cols, vals

    mp.setattr(crlike, "wta_counts_device", one_more)


def _quant_unchanged(mp):
    from alevin_fry_tpu_torch.pipeline import quant

    mp.setattr(quant, "quantify", lambda opts: None)


def _half_rows(mp):
    from alevin_fry_tpu_torch.atac import sort

    orig = sort._extract_cols
    mp.setattr(sort, "_extract_cols", lambda *a: orig(*a)[::2])


def _altered_bed(mp):
    from alevin_fry_tpu_torch.atac import sort

    orig = sort.format_bed_rows

    def one_more(ref_names, chrs, starts, frag_lens, bcs, counts, *a, **k):
        counts = np.array(counts, copy=True)
        counts[:1] += 1
        return orig(ref_names, chrs, starts, frag_lens, bcs, counts, *a, **k)

    mp.setattr(sort, "format_bed_rows", one_more)


def _sort_unchanged(mp):
    from alevin_fry_tpu_torch.atac import sort

    mp.setattr(sort, "sort", lambda *a, **k: None)


@pytest.mark.parametrize("name,fault", [
    ("rna_10xv3_usa.crlike", _half_histogram), ("rna_10xv3_usa.crlike", _altered_count),
    ("rna_10xv3_usa.crlike", _quant_unchanged), ("atac_10x.sort", _half_rows),
    ("atac_10x.sort", _altered_bed), ("atac_10x.sort", _sort_unchanged),
], ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch, capsys):
    fault(monkeypatch)
    res = harness.run_cell(tiny_cell(name), 4, 0.2, False, "cpu")
    assert not res["correct"]
    # every job compared fails: the first, the sample and the last
    assert res["failed"] == min(res["attempted"], 3) >= 1
    assert max(c["value"] for c in res["checks"].values()) > 0
