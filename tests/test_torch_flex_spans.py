"""The port's spans on its Flex (multi-barcode) path: generate-permit-list
with the sample list and 1-edit sample correction, the fast collate and
quant through the CLI with ``--device cpu`` on the benchmark generator's
data (``fry_bench/gen/flex_hard.py``), each stage run once to warm up
and once measured, as the benchmark does.

Each stage's new spans and counts must appear under its root on the
main thread: gpl's ``sample_map`` (the map's build and each block's
sample correction), ``histogram``, one ``filter`` a sample holding its
K4 ``rescue``, and the counts ``sample_exact``, ``sample_corrected``,
``sample_dropped``, ``composite_cells``; collate's ``tier`` inside each
block's ``map_lookup``, the composite ``order``, ``emit``, and the
``manifest`` inside a ``write``, with the counts ``tier_exact``,
``tier_queries``, ``tier_rescued``, ``tier_dropped``; quant's
``manifest_read``.  The counts must equal what the plain reference
counts on the same reads, and each root must be at least 99% covered by
its main thread's spans."""


import numpy as np
import pytest

from alevin_fry_tpu_torch import spans
from alevin_fry_tpu_torch.cli import main as port_main
from fry_bench import harness
from fry_bench.gen import flex_hard
from fry_bench.reference import flex_gpl
from fry_bench.reference.rescue import _lookup, unique_neighbour

CPU = ["-t", "2", "--device", "cpu"]
# large enough that the roots' own time (argument handling, log lines)
# stays under 1% of each stage on the CPU
SIZES = dict(n_samples=4, cells_per_sample=300, gem_pool=600, n_reads=1_000_000, n_genes=400,
             permit_list_size=20_000, reads_per_chunk=20_000)
STAGES = {
    "generate-permit-list": ("generate-permit-list -i {d}/rad -d fw -o {o}/gpl -u {d}/permit.txt "
                             "-m 10 --sample-bc-list {d}/samples.tsv "
                             "--sample-correction-mode 1-edit"),
    "collate": "collate -i {o}/gpl -r {d}/rad",
    "quant": "quant -i {o}/gpl -m {d}/t2g.tsv -o {o}/quant -r cr-like",
}
# each stage's new spans and their parents' names on the main thread
NEW_SPANS = {
    "generate-permit-list": {"sample_map": {"generate-permit-list", "histogram"},
                             "histogram": {"generate-permit-list"},
                             "filter": {"generate-permit-list"}, "rescue": {"filter"}},
    "collate": {"map_read": {"collate"}, "order": {"collate"}, "map_lookup": {"collate"},
                "tier": {"map_lookup"}, "emit": {"collate"}, "manifest": {"write"}},
    "quant": {"manifest_read": {"quant"}},
}
NEW_COUNTS = {
    "generate-permit-list": ("sample_exact", "sample_corrected", "sample_dropped",
                             "composite_cells"),
    "collate": ("tier_exact", "tier_queries", "tier_rescued", "tier_dropped"),
    "quant": (),
}


def _tree(root, new) -> list:
    def top(sp):
        while sp.parent is not None:
            sp = sp.parent
        return sp
    return [sp for sp in new if sp is not root and top(sp) is root]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Each stage's root and its tree of the measured pass, and the
    reference's counts on the same reads."""
    base = tmp_path_factory.mktemp("flex_spans")
    sizes = dict(harness.load_cell("flex_16plex.main").config["sizes"], **SIZES)
    data = flex_hard.make(base / "data", 19, **sizes)
    state = {"counts": {}, "bc": data["bc"], "bc_len": data["bc_len"]}
    flex_gpl.expect(data, {"expected_ori": "fw", "min_reads": 10,
                           "sample_correction_mode": "1-edit"}, state)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for var in ("AFT_RESCUE_BACKEND", "AFT_COORDINATOR", "AFT_NUM_PROCESSES",
                    "AFT_PROCESS_ID", "AFT_PREFETCH", "AFT_GPL_MESH"):
            mp.delenv(var, raising=False)
        for run in ("warm", "measured"):
            for name, argv in STAGES.items():
                n0 = len(spans.SPANS)
                assert port_main(argv.format(d=base / "data", o=base / run).split() + CPU) == 0
                new = spans.SPANS[n0:]
                root = new[-1]
                assert root.parent is None and root.name == name
                out[name] = (root, _tree(root, new))
    return out, state


@pytest.mark.parametrize("stage", list(STAGES))
def test_flex_stage_has_its_spans_and_counts(traced, stage):
    (root, tree), _state = traced[0][stage], traced[1]
    main = [sp for sp in tree if sp.thread == root.thread]
    for sp in tree:
        assert root.start_ns <= sp.start_ns <= sp.end_ns <= root.end_ns, sp
    for name, parents in NEW_SPANS[stage].items():
        found = [sp for sp in main if sp.name == name]
        assert found, (name, spans.summary(root))
        assert {sp.parent.name for sp in found} <= parents, (name, found)
    for key in NEW_COUNTS[stage]:
        assert key in root.attrs, (key, root.attrs)
    if stage == "generate-permit-list":
        # the map's build, then one correction a block of the first pass
        maps = [sp.parent.name for sp in main if sp.name == "sample_map"]
        assert maps[0] == "generate-permit-list" and maps[1:] and set(maps[1:]) == {"histogram"}
        decodes = [sp for sp in main if sp.name == "decode"]
        assert len(maps) - 1 == len(decodes)
        assert len([sp for sp in main if sp.name == "filter"]) == SIZES["n_samples"]
        assert len([sp for sp in main if sp.name == "rescue"]) == SIZES["n_samples"]


@pytest.mark.parametrize("stage", list(STAGES))
def test_flex_root_is_covered_by_its_spans(traced, stage):
    root, _tree_ = traced[0][stage]
    assert root.self_ns <= 0.01 * (root.end_ns - root.start_ns), spans.summary(root)


def test_gpl_counts_equal_the_reference(traced):
    (root, _tree_), state = traced[0]["generate-permit-list"], traced[1]
    want = state["counts"]
    for key in ("sample_exact", "sample_corrected", "sample_dropped", "composite_cells"):
        assert root.attrs[key] == want[key] > 0, key


def test_tier_counts_add_up_to_the_corrected_reads(traced):
    """Every compatible read whose sample was corrected goes through the
    tiers once: kept as it is, rescued or dropped; the queries sent to
    K4 are the rescued and the dropped; the tier spans hold the counts."""
    (root, tree), state = traced[0]["collate"], traced[1]
    a = root.attrs
    corrected = int(((state["sample"] >= 0) & state["compat"]).sum())
    assert a["tier_exact"] + a["tier_rescued"] + a["tier_dropped"] == corrected
    assert a["tier_queries"] == a["tier_rescued"] + a["tier_dropped"]
    assert a["tier_rescued"] > 0 and a["tier_dropped"] > 0
    tiers = [sp for sp in tree if sp.name == "tier"]
    for key in ("tier_exact", "tier_queries", "tier_rescued", "tier_dropped"):
        assert sum(sp.attrs.get(key, 0) for sp in tiers) == a[key]


def test_each_correction_lies_in_its_span(traced):
    """collate corrects each block inside one ``map_lookup`` holding one
    ``tier``, which holds every tier count; gpl corrects each block
    inside a ``sample_map`` of the ``histogram``, which holds every
    sample count."""
    (groot, gtree), (croot, ctree) = traced[0]["generate-permit-list"], traced[0]["collate"]
    lookups = [sp for sp in ctree if sp.name == "map_lookup"]
    tiers = [sp for sp in ctree if sp.name == "tier"]
    assert lookups and len(tiers) == len(lookups)
    assert {id(sp.parent) for sp in tiers} == {id(sp) for sp in lookups}
    for key in ("tier_exact", "tier_queries", "tier_rescued", "tier_dropped"):
        assert sum(sp.attrs.get(key, 0) for sp in tiers) == croot.attrs[key]
        # a span's counts roll up into its parent's
        assert [sp.attrs.get(key, 0) for sp in lookups] == [sp.attrs.get(key, 0) for sp in tiers]
    histogram = [sp for sp in gtree if sp.name == "histogram"]
    blocks = [sp for sp in gtree if sp.name == "sample_map" and sp.parent.name == "histogram"]
    assert len(histogram) == 1 and blocks
    for key in ("sample_exact", "sample_corrected", "sample_dropped"):
        assert sum(sp.attrs.get(key, 0) for sp in blocks) == groot.attrs[key]
        assert histogram[0].attrs[key] == groot.attrs[key]


def test_the_seven_flex_counts_equal_the_reference(traced):
    """The sample counts of gpl and the tier counts of collate, read for
    read, as the plain reference works them out: a compatible read of a
    corrected sample is exact where (sample, cell) is a kept cell, else
    a query, rescued where exactly one of its sample's cells lies one
    substitution away."""
    (groot, _g), (croot, _c) = traced[0]["generate-permit-list"], traced[0]["collate"]
    state = traced[1]
    cbits = np.uint64(2 * state["bc_len"])
    cell_mask = np.uint64((1 << (2 * state["bc_len"])) - 1)
    comp = np.sort(np.concatenate([(np.uint64(si) << cbits) | cells
                                   for si, (cells, _ct) in enumerate(state["cells_of"])]))
    reads = np.flatnonzero((state["sample"] >= 0) & state["compat"])
    key = (state["sample"][reads].astype(np.uint64) << cbits) | state["bc"][reads]
    exact, _ = _lookup(comp, key)
    miss, n_reads = np.unique(key[~exact], return_counts=True)
    rescued = 0
    for si, (cells, _ct) in enumerate(state["cells_of"]):
        sel = (miss >> cbits) == np.uint64(si)
        one, _rep = unique_neighbour(miss[sel] & cell_mask, cells, state["bc_len"])
        rescued += int(n_reads[sel][one].sum())
    want = dict(state["counts"], tier_exact=int(exact.sum()), tier_queries=int((~exact).sum()),
                tier_rescued=rescued, tier_dropped=int((~exact).sum()) - rescued)
    for key_ in ("sample_exact", "sample_corrected", "sample_dropped"):
        assert groot.attrs[key_] == want[key_] > 0, key_
    for key_ in ("tier_exact", "tier_queries", "tier_rescued", "tier_dropped"):
        assert croot.attrs[key_] == want[key_] > 0, key_
