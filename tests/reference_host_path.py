"""The reference package's host path, as an oracle for the port.

Runs ``alevin_fry_tpu``'s generate-permit-list (unfiltered, or a
filtered method) -> collate (plain or compressed) -> quant (any ported
resolution and quant option), quant alone on a collated directory, infer,
its ATAC stages (generate-permit-list -> sort, collate -> deduplicate,
plain or compressed), or convert and view, through its Python API with every device
policy set to the host, so no JAX is needed: ``run`` and ``run-atac``
block the ``jax`` import outright (so do ``quant`` and ``infer``; their
EM asks ``parallel/mesh.py``, which imports JAX, for a mesh, and gets
None, its answer under ``AFT_EM_MESH=0``).  The policies are set in the
environment only while the stages run.  The stage command lines are
given, so the stage JSONs can be compared with the port's field for
field.

As a script (this imports nothing of the port):

    python tests/reference_host_path.py make DIR --n-cells C --n-reads R --n-genes G [--seed S]
        writes tests/synth_hard.make_hard_dataset(DIR, RandomState(S), ...)
    python tests/reference_host_path.py make-longread DIR --n-cells C --n-reads R --n-genes G
            [--seed S]
        writes make_longread_dataset(DIR, RandomState(S), ...): long-read
        records (as / start / end / tlen) in DIR/rad, DIR/permit.txt and
        DIR/t2g.tsv
    python tests/reference_host_path.py run DIR OUT CMDLINES.json [--usa] [--min-reads M]
            [--threads T] [--filter knee|force:N|expect:N|explicit:PATH] [--compress]
            [--max-records R] [--rad RAD_DIR] [QUANT OPTIONS]
        runs the three stages on DIR/rad (or RAD_DIR) into OUT (gpl with DIR/permit.txt
        unless --filter names a filtered method; collate -c with
        --compress) and prints their seconds as one JSON line.  QUANT
        OPTIONS: --resolution R, --sa-model M, --dump-eq, --quant-subset
        FILE, --init-uniform, --umi-edit-dist D, --large-graph-thresh N
        (both as the CLI defaults them when left out), --num-bootstraps N,
        --summary-stat, --t2g FILE (default DIR/t2g_3col.tsv with --usa,
        else DIR/t2g.tsv)
    python tests/reference_host_path.py quant GPL OUT CMDLINE --t2g FILE [--threads T]
            [QUANT OPTIONS]
        runs quant alone on the collated directory GPL into OUT and prints
        its seconds as one JSON line
    python tests/reference_host_path.py infer COUNT_MAT EQ_LABELS OUT [--usa]
            [--quant-subset FILE]
        runs infer into OUT and prints its seconds as one JSON line
    python tests/reference_host_path.py make-atac DIR --n-cells C --n-frags F --n-chrs N
            --chr-len L --ambient-factor A [--seed S]
        writes tests/synth_hard.make_hard_atac_dataset(DIR, RandomState(S), ...)
        (16-base barcodes, a reverse-complement whitelist DIR/wl.txt)
    python tests/reference_host_path.py run-atac DIR OUT CMDLINES.json [--min-reads M]
            [--max-records R] [--threads T] [--compress] [--skip-gpl]
        runs the four ATAC stages on DIR/rad into OUT (sort and collate
        -c with --compress; with --skip-gpl, OUT/gpl already holds the
        generate-permit-list output) and prints their seconds and the
        deduplicate counters as one JSON line

    python tests/reference_host_path.py make-flex DIR --n-samples S --n-cells-per-sample C
            --n-reads R --n-genes G [--seed S] [--permit-size N]
        writes tests/synth_hard.make_hard_flex_dataset(DIR, RandomState(S), ...)
        (DIR/rad, the 3-column DIR/samples.tsv, DIR/t2g.tsv) and the
        unfiltered list DIR/permit.txt: the generator's shared pool of C
        cell barcodes (each code with no Hamming-1 neighbour of more
        reads), most reads first, then random codes from the seed, N
        entries in all
    python tests/reference_host_path.py run-flex DIR OUT CMDLINES.json [--expected-ori O]
            [--filter SPEC] [--min-reads M] [--sample-correction-mode exact|1-edit]
            [--sample-bc-ori forward|reverse] [--sample-names FILE]
            [--collation-mode fast|two-round] [--max-records R] [--compress]
            [--gpl-from GPL] [--threads T] [QUANT OPTIONS]
        runs the three Flex stages on DIR/rad with the sample list
        DIR/samples.tsv into OUT (gpl as in run; with --gpl-from, a copy
        of the directory GPL stands in for it) and prints their seconds
        as one JSON line

    python tests/reference_host_path.py make-bam DIR --n-alignments N [--seed S] [--threads T]
        writes tests/bam_cases.make_bam_dataset(DIR, S, N): DIR/aln.bam (BGZF;
        10,000 cells, 20,000 genes), the unfiltered list DIR/permit.txt,
        DIR/t2g.tsv and DIR/t2g_3col.tsv
    python tests/reference_host_path.py convert BAM RAD [--filter-best] [--threads T]
        runs the reference's convert (bam2rad) and prints its seconds as
        one JSON line
    python tests/reference_host_path.py view RAD OUT [--header]
        runs the reference's view into the file OUT and prints its seconds
        and line count as one JSON line

A ``.gz`` artifact (the compressed ATAC sort's ``map.bed.gz``) is held
to its decompressed bytes and its header without the MTIME field, which
gzip sets to the time of the write.
"""

from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import os
import shutil
import sys
import time
import types
from pathlib import Path

HOST_ENV = {
    "AFT_CRLIKE_BACKEND": "host",
    "AFT_RESCUE_BACKEND": "host",
    "AFT_COLLATE_BACKEND": "host",
    "AFT_ATAC_SORT_BACKEND": "host",
    "AFT_GPL_MESH": "0",
    "AFT_EM_MESH": "0",
    "AFT_EM_BACKEND": "host",
    # parsimony: the monolithic native resolver, no accelerator probe
    "AFT_PUG_CC_BACKEND": "host",
    # bootstraps: the NumPy EMs and the RandomState init
    "AFT_BOOT_BACKEND": "host",
}

# the artifacts both packages must write byte for byte, and the stage
# JSONs that must agree once their path-valued fields are dropped
DATA_ARTIFACTS = (
    "gpl/permit_freq.bin", "gpl/permit_map.bin", "gpl/map.collated.rad",
    "gpl/unmapped_bc_count_collated.bin", "quant/alevin/quants_mat.mtx",
    "quant/alevin/quants_mat_rows.txt", "quant/alevin/quants_mat_cols.txt",
    "quant/featureDump.txt",
)
STAGE_JSONS = (
    "gpl/generate_permit_list.json", "gpl/collate.json", "quant/quant.json",
)
# quant -d's dump, quant -b's matrices, and infer's outputs (into an
# infer/ directory)
DUMP_ARTIFACTS = ("quant/alevin/geqc_counts.mtx", "quant/alevin/gene_eqclass.txt.gz")
BOOT_ARTIFACTS = ("quant/alevin/bootstraps_mean.mtx", "quant/alevin/bootstraps_var.mtx")
# the Flex run's data artifacts (each sample's permit files are listed
# by flex_artifacts) and stage JSONs
FLEX_DATA_ARTIFACTS = (
    "gpl/sample_permit_map.bin", "gpl/map.collated.rad", "gpl/collation_manifest.bin",
    "gpl/unmapped_bc_count_collated.bin", "quant/alevin/quants_mat.mtx",
    "quant/alevin/quants_mat_rows.txt", "quant/alevin/quants_mat_cols.txt",
    "quant/featureDump.txt",
)
FLEX_STAGE_JSONS = STAGE_JSONS + ("gpl/sample_info.json",)
INFER_ARTIFACTS = ("infer/quants_mat.mtx", "infer/quants_mat_rows.txt",
                   "infer/quants_mat_cols.txt")
QUANT_ARTIFACTS = tuple(n for n in DATA_ARTIFACTS if n.startswith("quant/"))
PATH_FIELDS = ("input_dir", "output_dir", "tg_map")

# the ATAC run's artifacts: the sort's BED is moved to sort/map.bed
# before deduplicate writes gpl/map.bed
ATAC_DATA_ARTIFACTS = (
    "gpl/permit_freq.bin", "gpl/permit_map.bin", "gpl/bin_recs.bin",
    "gpl/bin_lens.bin", "sort/map.bed", "gpl/map.collated.rad",
    "gpl/unmapped_bc_count_collated.bin", "gpl/map.bed",
)


def _compressed(names, compressed: bool) -> tuple:
    """``names`` with the collated file and the sort's BED as ``-c``
    writes them."""
    if not compressed:
        return tuple(names)
    renamed = {"gpl/map.collated.rad": "gpl/map.collated.rad.sz",
               "sort/map.bed": "sort/map.bed.gz"}
    return tuple(renamed.get(n, n) for n in names)


def rna_artifacts(filtered: bool = False, compressed: bool = False) -> tuple:
    """The RNA run's data artifacts; a filtered gpl adds all_freq.bin."""
    extra = ("gpl/all_freq.bin",) if filtered else ()
    return _compressed(DATA_ARTIFACTS + extra, compressed)


def flex_artifacts(run: Path, compressed: bool = False) -> tuple:
    """The Flex run's data artifacts, with the permit files of each
    sample directory ``run/gpl`` holds."""
    samples = sorted(p.name for p in (Path(run) / "gpl").glob("sample_*") if p.is_dir())
    per_sample = tuple(f"gpl/{s}/{f}" for s in samples
                       for f in ("permit_map.bin", "permit_freq.bin"))
    return _compressed(FLEX_DATA_ARTIFACTS + per_sample, compressed)


def atac_artifacts(compressed: bool = False) -> tuple:
    return _compressed(ATAC_DATA_ARTIFACTS, compressed)


def gzip_differs(a: bytes, b: bytes) -> bool:
    """Whether two gzip files differ in their decompressed bytes or in
    their headers apart from the MTIME field (bytes 4-7)."""
    def header(x: bytes) -> bytes:
        end = x.index(b"\0", 10) + 1 if x[3] & 0x08 else 10  # FNAME
        return x[:4] + x[8:end]

    return header(a) != header(b) or gzip.decompress(a) != gzip.decompress(b)
ATAC_STAGE_JSONS = (
    "gpl/generate_permit_list.json", "gpl/sort.json", "gpl/collate.json",
)


@contextlib.contextmanager
def host_policies():
    """Point every device policy of the reference at the host while the
    block runs, and restore the environment after it."""
    saved = {k: os.environ.get(k) for k in HOST_ENV}
    os.environ.update(HOST_ENV)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def move_sorted_bed(out: Path) -> None:
    """Keep the sort stage's BED (map.bed, or map.bed.gz after sort -c):
    deduplicate writes map.bed."""
    (out / "sort").mkdir(parents=True, exist_ok=True)
    name = "map.bed.gz" if (out / "gpl" / "map.bed.gz").exists() else "map.bed"
    shutil.move(str(out / "gpl" / name), str(out / "sort" / name))


def comparable_json(path: Path) -> dict:
    """A stage JSON without the fields that name a run's directories."""
    d = json.loads(Path(path).read_text())
    for key in ("gpl_options", "quant_options"):
        if key in d:
            d[key] = {k: v for k, v in d[key].items() if k not in PATH_FIELDS}
    return d


def artifact_mismatches(a: Path, b: Path, artifacts=DATA_ARTIFACTS,
                        jsons=STAGE_JSONS) -> list:
    """Names of the artifacts that differ between two run directories."""
    def differs(p: str) -> bool:
        x, y = (a / p).read_bytes(), (b / p).read_bytes()
        return gzip_differs(x, y) if p.endswith(".gz") else x != y

    bad = [p for p in artifacts if differs(p)]
    bad += [p for p in jsons if comparable_json(a / p) != comparable_json(b / p)]
    return bad


def cell_filter(spec, d: Path, min_reads: int):
    """The reference's CellFilterMethod for ``spec``: None is the
    unfiltered list ``d/permit.txt``; else ``knee``, ``force:N``,
    ``expect:N`` or ``explicit:PATH``."""
    from alevin_fry_tpu.pipeline.gpl import CellFilterMethod

    if spec is None:
        return CellFilterMethod("unfiltered", path=d / "permit.txt", min_reads=min_reads)
    kind, _, arg = spec.partition(":")
    if kind == "explicit":
        return CellFilterMethod("explicit", path=Path(arg))
    return CellFilterMethod(kind, count=int(arg or 0))


def run_reference(d: Path, out: Path, cmdlines: dict, usa: bool,
                  min_reads: int = 10, threads: int = 4, cell_filter_spec=None,
                  compress: bool = False, max_records: int = 30_000_000,
                  gpl_opts=None, quant_opts=None, t2g=None, rad=None) -> dict:
    """Run the reference's three stages on ``d/rad`` (or ``rad``) into ``out/gpl`` and
    ``out/quant``; returns each stage's seconds.  ``cmdlines`` maps
    gpl / collate / quant to the command line each JSON records;
    ``cell_filter_spec`` is :func:`cell_filter`'s; ``compress`` and
    ``max_records`` are collate's ``-c`` and ``-m``; ``gpl_opts`` adds
    fields of the gpl options (the Flex sample flags), ``quant_opts``
    fields of the quant options (:func:`run_reference_quant`); ``t2g``
    replaces ``d/t2g_3col.tsv`` (``usa``) or ``d/t2g.tsv``."""
    with host_policies():
        secs = _run_reference(d, out, cmdlines, usa, min_reads, threads,
                              cell_filter_spec, compress, max_records, gpl_opts or {},
                              rad or d / "rad")
    t2g = t2g or d / ("t2g_3col.tsv" if usa else "t2g.tsv")
    secs["quant"] = run_reference_quant(out / "gpl", out / "quant", t2g, cmdlines["quant"],
                                        threads, **(quant_opts or {}))
    return secs


def run_reference_quant(gpl: Path, out: Path, t2g: Path, cmdline: str, threads: int = 4,
                        resolution: str = "cr-like", sa_model: str = "winner-take-all",
                        dump_eq: bool = False, quant_subset=None,
                        init_uniform: bool = False, umi_edit_dist=None,
                        large_graph_thresh=None, num_bootstraps: int = 0,
                        summary_stat: bool = False) -> float:
    """The reference's quant on the collated directory ``gpl`` into
    ``out``, with the quant options of its CLI (``umi_edit_dist`` and
    ``large_graph_thresh`` defaulted as the CLI does); returns its
    seconds."""
    parsimony = resolution.startswith("parsimony")
    if umi_edit_dist is None:
        umi_edit_dist = 1 if parsimony else 0
    if large_graph_thresh is None:
        large_graph_thresh = 1000 if parsimony else 0
    with host_policies():
        from alevin_fry_tpu.pipeline.quant import QuantOpts, quantify
        from alevin_fry_tpu.radz import _native

        _native.set_threads(threads)
        t0 = time.perf_counter()
        quantify(QuantOpts(
            input_dir=gpl, tg_map=t2g, output_dir=out, num_threads=threads,
            resolution=resolution, sa_model=sa_model, dump_eq=dump_eq,
            filter_list=quant_subset, init_uniform=init_uniform,
            pug_exact_umi=parsimony and umi_edit_dist == 0,
            large_graph_thresh=large_graph_thresh, num_bootstraps=num_bootstraps,
            summary_stat=summary_stat, cmdline=cmdline,
        ))
        return time.perf_counter() - t0


def run_reference_infer(count_mat: Path, eq_labels: Path, out: Path, usa: bool,
                        quant_subset=None, threads: int = 4) -> float:
    """The reference's infer into ``out``; returns its seconds."""
    with host_policies():
        from alevin_fry_tpu.pipeline.infer import infer

        t0 = time.perf_counter()
        infer(count_mat, eq_labels, usa, threads, quant_subset, out)
        return time.perf_counter() - t0


def _run_reference(d, out, cmdlines, usa, min_reads, threads, cell_filter_spec,
                   compress, max_records, gpl_opts, rad) -> dict:
    return {
        "gpl": run_reference_gpl(d, out / "gpl", cmdlines["gpl"], cell_filter_spec,
                                 min_reads, threads, gpl_opts=gpl_opts, rad=rad),
        "collate": run_reference_collate(out / "gpl", rad, cmdlines["collate"], compress,
                                         max_records, threads),
    }


def run_reference_gpl(d: Path, gpl: Path, cmdline: str, cell_filter_spec=None,
                      min_reads: int = 10, threads: int = 4, expected_ori: str = "fw",
                      velo_mode: bool = False, gpl_opts=None, rad=None) -> float:
    """The reference's generate-permit-list alone on ``d/rad`` (or
    ``rad``) into ``gpl``, with ``velo_mode`` (its library option: the
    CLI has no flag) and ``gpl_opts`` added to its options; returns its
    seconds."""
    with host_policies():
        from alevin_fry_tpu.pipeline.gpl import GenPermitListOpts, generate_permit_list
        from alevin_fry_tpu.radz import _native

        _native.set_threads(threads)
        t0 = time.perf_counter()
        generate_permit_list(GenPermitListOpts(
            input_dir=rad or d / "rad", output_dir=gpl,
            fmeth=cell_filter(cell_filter_spec, d, min_reads), expected_ori=expected_ori,
            threads=threads, velo_mode=velo_mode, cmdline=cmdline, **(gpl_opts or {}),
        ))
        return time.perf_counter() - t0


def run_reference_collate(gpl: Path, rad: Path, cmdline: str, compress: bool = False,
                          max_records: int = 30_000_000, threads: int = 4) -> float:
    """The reference's collate alone of ``rad`` into the permit-list
    directory ``gpl``; returns its seconds."""
    with host_policies():
        from alevin_fry_tpu.pipeline.collate import collate
        from alevin_fry_tpu.radz import _native

        _native.set_threads(threads)
        t0 = time.perf_counter()
        collate(gpl, rad, threads, max_records, compress, cmdline=cmdline)
        return time.perf_counter() - t0


def run_reference_atac(d: Path, out: Path, cmdlines: dict, min_reads: int = 10,
                       max_records: int = 30_000_000, threads: int = 4,
                       compress: bool = False, skip_gpl: bool = False) -> tuple:
    """Run the reference's ATAC stages on ``d/rad`` with the whitelist
    ``d/wl.txt`` (reverse complement) into ``out``: generate-permit-list
    (unless ``skip_gpl``: ``out/gpl`` holds its output), sort (its BED
    moved to ``out/sort``), collate, deduplicate; sort and collate with
    ``-c`` when ``compress``.  ``cmdlines`` maps gpl / sort / collate /
    deduplicate to the command line each records.  Returns (seconds per
    stage, deduplicate's counters)."""
    with host_policies():
        from alevin_fry_tpu.atac.collate import collate
        from alevin_fry_tpu.atac.dedup import deduplicate
        from alevin_fry_tpu.atac.gpl import AtacGplOpts, generate_permit_list
        from alevin_fry_tpu.atac.sort import sort
        from alevin_fry_tpu.radz import _native

        _native.set_threads(threads)
        gpl = out / "gpl"
        secs = {}
        if not skip_gpl:
            t0 = time.perf_counter()
            generate_permit_list(AtacGplOpts(
                input_dir=d / "rad", output_dir=gpl, unfiltered_pl=d / "wl.txt",
                min_reads=min_reads, rc=True, threads=threads, cmdline=cmdlines["gpl"],
            ))
            secs["gpl"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sort(gpl, d / "rad", threads, max_records, compress, cmdline=cmdlines["sort"])
        secs["sort"] = time.perf_counter() - t0
        move_sorted_bed(out)
        t0 = time.perf_counter()
        collate(gpl, d / "rad", threads, max_records, compress, cmdline=cmdlines["collate"])
        secs["collate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = deduplicate(gpl, threads, rev=True, cmdline=cmdlines["deduplicate"])
        secs["deduplicate"] = time.perf_counter() - t0
    return secs, stats


def run_reference_flex(d: Path, out: Path, cmdlines: dict, expected_ori: str = "fw",
                       cell_filter_spec=None, min_reads: int = 10, gpl_opts=None,
                       collation_mode: str = "fast", max_records: int = 30_000_000,
                       compress: bool = False, gpl_from=None, threads: int = 4,
                       quant_opts=None, t2g=None) -> dict:
    """Run the reference's Flex stages on ``d/rad`` with the sample list
    ``d/samples.tsv`` into ``out/gpl`` and ``out/quant``; returns each
    stage's seconds.  ``gpl_opts`` adds or replaces fields of the gpl
    options (sample list, names, correction mode, orientation); with ``gpl_from`` a
    copy of that directory stands in for generate-permit-list;
    ``collation_mode``, ``max_records`` and ``compress`` are collate's;
    the rest as :func:`run_reference`."""
    secs = {}
    with host_policies():
        from alevin_fry_tpu.pipeline.collate import collate
        from alevin_fry_tpu.pipeline.gpl import GenPermitListOpts, generate_permit_list
        from alevin_fry_tpu.radz import _native

        _native.set_threads(threads)
        if gpl_from is not None:
            shutil.copytree(gpl_from, out / "gpl",
                            ignore=shutil.ignore_patterns("map.collated.rad*"))
        else:
            t0 = time.perf_counter()
            generate_permit_list(GenPermitListOpts(
                input_dir=d / "rad", output_dir=out / "gpl",
                fmeth=cell_filter(cell_filter_spec, d, min_reads), expected_ori=expected_ori,
                threads=threads, cmdline=cmdlines["gpl"],
                **{"sample_bc_list": d / "samples.tsv", **(gpl_opts or {})},
            ))
            secs["gpl"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        collate(out / "gpl", d / "rad", threads, max_records, compress,
                cmdline=cmdlines["collate"], collation_mode=collation_mode)
        secs["collate"] = time.perf_counter() - t0
    secs["quant"] = run_reference_quant(out / "gpl", out / "quant", t2g or d / "t2g.tsv",
                                        cmdlines["quant"], threads, **(quant_opts or {}))
    return secs


def make_flex_permit_list(d: Path, n_listed: int, size: int, seed: int,
                          bc_len: int = 16) -> dict:
    """``d/permit.txt`` for the Flex dataset in ``d/rad``: the generator's
    shared pool of ``n_listed`` cell barcodes (which it does not return),
    most reads over all samples first, then random codes from ``seed`` up
    to ``size`` entries.  The generator gives a read at most one
    substitution in its cell barcode, so every observed code is a pool
    code or one substitution from one, which holds far more reads: the
    pool is the codes with no Hamming-1 neighbour of more reads, and
    there must be ``n_listed`` of them.  (The largest cells' commonest
    error codes hold about as many reads as the smallest cells, so the
    reads alone do not set the pool apart.)"""
    import numpy as np

    from alevin_fry_tpu.ops.barcodes import snp_neighbors, unpack_seqs_to_strings
    from alevin_fry_tpu.radz import read_prelude
    from alevin_fry_tpu.radz.chunkio import iter_decoded_blocks
    from alevin_fry_tpu.radz.records import RecordSchema

    with open(d / "rad" / "map.rad", "rb") as fh:
        prelude, _ftm, _ = read_prelude(fh)
        schema = RecordSchema.from_prelude(prelude)
        cells = [batch.barcode(-1).astype(np.uint64) for batch in
                 iter_decoded_blocks(fh, schema, prelude.hdr.num_chunks, 5_000_000)]
    bcs, counts = np.unique(np.concatenate(cells), return_counts=True)
    neigh = snp_neighbors(bcs, bc_len)
    pos = np.minimum(np.searchsorted(bcs, neigh), len(bcs) - 1)
    most_neighbour = np.where((bcs[pos] == neigh) & (neigh != bcs[:, None]),
                              counts[pos], 0).max(axis=1)
    pool = np.flatnonzero(counts > most_neighbour)
    if len(pool) != n_listed:
        raise AssertionError(f"{len(pool)} codes have no Hamming-1 neighbour of more reads, "
                             f"not the pool's {n_listed}")
    pool = pool[np.argsort(-counts[pool], kind="stable")]
    others = np.setdiff1d(np.arange(len(bcs)), pool)
    codes = bcs[pool]
    rng = np.random.RandomState(seed)
    mask = np.uint64((1 << (2 * bc_len)) - 1)
    while len(codes) < size:
        draw = rng.randint(0, 1 << 62, size, dtype=np.int64).astype(np.uint64) & mask
        draw = np.setdiff1d(draw, codes)
        codes = np.concatenate([codes, draw[rng.permutation(len(draw))][:size - len(codes)]])
    (d / "permit.txt").write_text(
        "".join(f"{b}\n" for b in unpack_seqs_to_strings(codes, bc_len)))
    return {"permit_entries": len(codes), "least_listed_reads": int(counts[pool].min()),
            "most_other_reads": int(counts[others].max()) if len(others) else 0}


def _quant_flags(p) -> None:
    p.add_argument("--resolution", default="cr-like")
    p.add_argument("--sa-model", default="winner-take-all")
    p.add_argument("--dump-eq", action="store_true")
    p.add_argument("--quant-subset", type=Path, default=None)
    p.add_argument("--init-uniform", action="store_true")
    p.add_argument("--umi-edit-dist", type=int, default=None)
    p.add_argument("--large-graph-thresh", type=int, default=None)
    p.add_argument("--num-bootstraps", type=int, default=0)
    p.add_argument("--summary-stat", action="store_true")
    p.add_argument("--t2g", type=Path, default=None)


def _quant_opts(args) -> dict:
    return {"resolution": args.resolution, "sa_model": args.sa_model,
            "dump_eq": args.dump_eq, "quant_subset": args.quant_subset,
            "init_uniform": args.init_uniform, "umi_edit_dist": args.umi_edit_dist,
            "large_graph_thresh": args.large_graph_thresh,
            "num_bootstraps": args.num_bootstraps, "summary_stat": args.summary_stat}


def make_longread_dataset(d: Path, rng, n_cells: int, n_reads: int, n_genes: int,
                          txps_per_gene: int = 4, bc_len: int = 16, umi_len: int = 12,
                          umi_error_rate: float = 0.05, chunk: int = 100_000) -> dict:
    """A long-read dataset in ``d``: ``rad/map.rad`` (the record layout of
    tests/synth.py::write_longread_rad: alignment fields as / start /
    end / tlen), ``permit.txt`` and a plain ``t2g.tsv``.  Molecules of
    Zipf-drawn genes amplify to 1 + Poisson(2) reads, a fraction with a
    one-base UMI error; a molecule aligns to one transcript of its gene
    (half of them), to several of them (a third) or to transcripts of
    its gene and of its paralog (the rest); each alignment carries a
    score and a 3' distance drawn per read.  Reads are shuffled and
    written in chunks of ``chunk``.  Returns the counts written."""
    import sys as _sys

    import numpy as np

    _sys.path.insert(0, str(Path(__file__).resolve().parent))
    from synth import make_longread_prelude

    from alevin_fry_tpu.ops.barcodes import unpack_seqs_to_strings
    from alevin_fry_tpu.radz import RadWriter

    n_txps = n_genes * txps_per_gene
    bcs = np.unique(rng.randint(0, 1 << 62, 2 * n_cells, dtype=np.int64).astype(np.uint64)
                    & np.uint64((1 << (2 * bc_len)) - 1))[:n_cells]
    bcs = bcs[rng.permutation(len(bcs))]
    n_mols = max(1, n_reads // 3)
    mol_cell = rng.randint(0, len(bcs), n_mols)
    mol_umi = rng.randint(0, 1 << (2 * umi_len), n_mols, dtype=np.int64).astype(np.uint64)
    mol_gene = np.minimum(rng.zipf(1.3, n_mols) - 1, n_genes - 1)
    mol_gene = rng.permutation(n_genes)[mol_gene]
    reads_per = 1 + rng.poisson(2.0, n_mols)
    read_mol = np.repeat(np.arange(n_mols), reads_per)[:n_reads]
    read_mol = read_mol[rng.permutation(len(read_mol))]
    n = len(read_mol)
    umi = mol_umi[read_mol].copy()
    err = rng.rand(n) < umi_error_rate
    pos = rng.randint(0, umi_len, int(err.sum())).astype(np.uint64)
    umi[err] ^= np.uint64(1) << (np.uint64(2) * pos)
    # each molecule's label set: (kind, count) drawn per molecule
    kind = rng.choice(3, n_mols, p=[0.5, 0.33, 0.17])
    n_own = np.where(kind == 0, 1, rng.randint(2, txps_per_gene + 1, n_mols))
    n_para = np.where(kind == 2, rng.randint(1, txps_per_gene + 1, n_mols), 0)
    nal = (n_own + n_para)[read_mol]
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(nal, out=offs[1:])
    aln_read = np.repeat(np.arange(n), nal)
    slot = np.arange(int(offs[-1])) - offs[:-1][aln_read]
    m = read_mol[aln_read]
    own = slot < n_own[m]
    gene = np.where(own, mol_gene[m], (mol_gene[m] ^ 1) % n_genes)
    k = np.where(own, slot, slot - n_own[m])
    refs = (gene * txps_per_gene + (k + mol_gene[m]) % txps_per_gene).astype(np.uint32)
    tlen = rng.randint(800, 3000, len(refs)).astype(np.uint64)
    end = tlen - np.minimum(rng.geometric(0.01, len(refs)), tlen - 1).astype(np.uint64)
    score = rng.randint(-40, 200, len(refs)).astype(np.int64)
    prelude, ftv = make_longread_prelude([f"tx_{i}" for i in range(n_txps)], bc_len, umi_len)
    (d / "rad").mkdir(parents=True, exist_ok=True)
    with open(d / "rad" / "map.rad", "wb") as fh:
        w = RadWriter(fh, prelude, ftv)
        for s0 in range(0, n, chunk):
            s1 = min(s0 + chunk, n)
            a0, a1 = offs[s0], offs[s1]
            w.write_chunk(
                read_cols={"b": bcs[mol_cell[read_mol[s0:s1]]], "u": umi[s0:s1]},
                aln_offsets=offs[s0:s1 + 1] - a0, refs=refs[a0:a1],
                dirs=np.ones(a1 - a0, bool),
                aln_cols={"as": (score[a0:a1] & 0xFFFFFFFF).astype(np.uint64),
                          "start": np.zeros(a1 - a0, np.uint64), "end": end[a0:a1],
                          "tlen": tlen[a0:a1]},
            )
        w.finalize()
    (d / "permit.txt").write_text("".join(f"{b}\n" for b in unpack_seqs_to_strings(bcs, bc_len)))
    (d / "t2g.tsv").write_text("".join(f"tx_{i}\tg_{i // txps_per_gene}\n"
                                       for i in range(n_txps)))
    return {"n_reads": n, "n_alignments": int(offs[-1]), "n_cells": len(bcs)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make")
    mk.add_argument("dir", type=Path)
    mk.add_argument("--n-cells", type=int, required=True)
    mk.add_argument("--n-reads", type=int, required=True)
    mk.add_argument("--n-genes", type=int, required=True)
    mk.add_argument("--seed", type=int, default=7)
    rn = sub.add_parser("run")
    rn.add_argument("dir", type=Path)
    rn.add_argument("out", type=Path)
    rn.add_argument("cmdlines", type=Path)
    rn.add_argument("--usa", action="store_true")
    rn.add_argument("--min-reads", type=int, default=10)
    rn.add_argument("--threads", type=int, default=4)
    rn.add_argument("--filter", default=None)
    rn.add_argument("--compress", action="store_true")
    rn.add_argument("--max-records", type=int, default=30_000_000)
    rn.add_argument("--rad", type=Path, default=None)
    _quant_flags(rn)
    qu = sub.add_parser("quant")
    qu.add_argument("gpl", type=Path)
    qu.add_argument("out", type=Path)
    qu.add_argument("cmdline")
    qu.add_argument("--threads", type=int, default=4)
    _quant_flags(qu)
    inf = sub.add_parser("infer")
    inf.add_argument("count_mat", type=Path)
    inf.add_argument("eq_labels", type=Path)
    inf.add_argument("out", type=Path)
    inf.add_argument("--usa", action="store_true")
    inf.add_argument("--quant-subset", type=Path, default=None)
    ml = sub.add_parser("make-longread")
    ml.add_argument("dir", type=Path)
    ml.add_argument("--n-cells", type=int, required=True)
    ml.add_argument("--n-reads", type=int, required=True)
    ml.add_argument("--n-genes", type=int, required=True)
    ml.add_argument("--seed", type=int, default=5)
    ma = sub.add_parser("make-atac")
    ma.add_argument("dir", type=Path)
    ma.add_argument("--n-cells", type=int, required=True)
    ma.add_argument("--n-frags", type=int, required=True)
    ma.add_argument("--n-chrs", type=int, required=True)
    ma.add_argument("--chr-len", type=int, required=True)
    ma.add_argument("--ambient-factor", type=int, required=True)
    ma.add_argument("--seed", type=int, default=11)
    mf = sub.add_parser("make-flex")
    mf.add_argument("dir", type=Path)
    mf.add_argument("--n-samples", type=int, required=True)
    mf.add_argument("--n-cells-per-sample", type=int, required=True)
    mf.add_argument("--n-reads", type=int, required=True)
    mf.add_argument("--n-genes", type=int, required=True)
    mf.add_argument("--seed", type=int, default=13)
    mf.add_argument("--permit-size", type=int, default=737_280)
    rf = sub.add_parser("run-flex")
    rf.add_argument("dir", type=Path)
    rf.add_argument("out", type=Path)
    rf.add_argument("cmdlines", type=Path)
    rf.add_argument("--expected-ori", default="fw")
    rf.add_argument("--filter", default=None)
    rf.add_argument("--min-reads", type=int, default=10)
    rf.add_argument("--sample-correction-mode", default="exact")
    rf.add_argument("--sample-bc-ori", default="forward")
    rf.add_argument("--sample-names", type=Path, default=None)
    rf.add_argument("--collation-mode", default="fast")
    rf.add_argument("--max-records", type=int, default=30_000_000)
    rf.add_argument("--compress", action="store_true")
    rf.add_argument("--gpl-from", type=Path, default=None)
    rf.add_argument("--threads", type=int, default=4)
    _quant_flags(rf)
    ra = sub.add_parser("run-atac")
    ra.add_argument("dir", type=Path)
    ra.add_argument("out", type=Path)
    ra.add_argument("cmdlines", type=Path)
    ra.add_argument("--min-reads", type=int, default=10)
    ra.add_argument("--max-records", type=int, default=30_000_000)
    ra.add_argument("--threads", type=int, default=4)
    ra.add_argument("--compress", action="store_true")
    ra.add_argument("--skip-gpl", action="store_true")
    mb = sub.add_parser("make-bam")
    mb.add_argument("dir", type=Path)
    mb.add_argument("--n-alignments", type=int, required=True)
    mb.add_argument("--seed", type=int, default=17)
    mb.add_argument("--threads", type=int, default=8)
    cv = sub.add_parser("convert")
    cv.add_argument("bam", type=Path)
    cv.add_argument("rad", type=Path)
    cv.add_argument("--filter-best", action="store_true")
    cv.add_argument("--threads", type=int, default=4)
    vw = sub.add_parser("view")
    vw.add_argument("rad", type=Path)
    vw.add_argument("out", type=Path)
    vw.add_argument("--header", action="store_true")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    if args.cmd == "make":
        import numpy as np
        from synth_hard import make_hard_dataset

        args.dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        stats = make_hard_dataset(
            args.dir, np.random.RandomState(args.seed), n_cells=args.n_cells,
            n_reads=args.n_reads, n_genes=args.n_genes,
        )
        print(json.dumps({"seconds": time.perf_counter() - t0, "n_reads": stats["n_reads"]}))
        return 0
    if args.cmd == "make-longread":
        import numpy as np

        args.dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        stats = make_longread_dataset(args.dir, np.random.RandomState(args.seed),
                                      args.n_cells, args.n_reads, args.n_genes)
        print(json.dumps({"seconds": time.perf_counter() - t0, **stats}))
        return 0
    if args.cmd == "make-atac":
        import numpy as np
        from synth_hard import make_hard_atac_dataset

        args.dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        stats = make_hard_atac_dataset(
            args.dir, np.random.RandomState(args.seed), n_cells=args.n_cells,
            n_frags=args.n_frags, n_chrs=args.n_chrs, chr_len=args.chr_len,
            bc_len=16, ambient_factor=args.ambient_factor,
        )
        print(json.dumps({"seconds": time.perf_counter() - t0, **stats}))
        return 0
    if args.cmd == "make-flex":
        import numpy as np
        from synth_hard import make_hard_flex_dataset

        args.dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        stats = make_hard_flex_dataset(
            args.dir, np.random.RandomState(args.seed), n_samples=args.n_samples,
            n_cells_per_sample=args.n_cells_per_sample, n_reads=args.n_reads,
            n_genes=args.n_genes,
        )
        stats.update(make_flex_permit_list(args.dir, args.n_cells_per_sample,
                                           args.permit_size, args.seed))
        print(json.dumps({"seconds": time.perf_counter() - t0, **stats}))
        return 0
    if args.cmd == "make-bam":
        from bam_cases import make_bam_dataset

        stats = make_bam_dataset(args.dir, args.seed, args.n_alignments, threads=args.threads)
        print(json.dumps(stats))
        return 0
    # the host path must not need JAX: make any import of it fail
    sys.modules["jax"] = None
    if args.cmd == "convert":
        from alevin_fry_tpu.pipeline.convert import bam2rad
        from alevin_fry_tpu.radz import _native

        _native.set_threads(args.threads)
        t0 = time.perf_counter()
        bam2rad(args.bam, args.rad, args.threads, args.filter_best)
        print(json.dumps({"convert": time.perf_counter() - t0}))
        return 0
    if args.cmd == "view":
        from alevin_fry_tpu.pipeline.view import view

        t0 = time.perf_counter()
        with open(args.out, "w") as fh:
            n = view(args.rad, args.header, fh)
        print(json.dumps({"view": time.perf_counter() - t0, "lines": n}))
        return 0
    # quant's and infer's EM ask parallel/mesh.py for a device mesh, which
    # is None under HOST_ENV's AFT_EM_MESH=0; that module imports JAX at
    # its top, so it is stood in for by its answer
    mesh = types.ModuleType("alevin_fry_tpu.parallel.mesh")
    mesh.mesh_from_env = lambda: None
    sys.modules[mesh.__name__] = mesh
    if args.cmd == "run-atac":
        secs, stats = run_reference_atac(
            args.dir, args.out, json.loads(args.cmdlines.read_text()),
            args.min_reads, args.max_records, args.threads, args.compress, args.skip_gpl,
        )
        print(json.dumps({"seconds": secs, "dedup": stats}))
        return 0
    if args.cmd == "run-flex":
        secs = run_reference_flex(
            args.dir, args.out, json.loads(args.cmdlines.read_text()), args.expected_ori,
            args.filter, args.min_reads,
            {"sample_correction_mode": args.sample_correction_mode,
             "sample_bc_ori": args.sample_bc_ori, "sample_names": args.sample_names},
            args.collation_mode, args.max_records, args.compress, args.gpl_from,
            args.threads, _quant_opts(args), args.t2g,
        )
        print(json.dumps(secs))
        return 0
    if args.cmd == "quant":
        secs = run_reference_quant(args.gpl, args.out, args.t2g, args.cmdline, args.threads,
                                   **_quant_opts(args))
        print(json.dumps({"quant": secs}))
        return 0
    if args.cmd == "infer":
        secs = run_reference_infer(args.count_mat, args.eq_labels, args.out, args.usa,
                                   args.quant_subset)
        print(json.dumps({"infer": secs}))
        return 0
    secs = run_reference(
        args.dir, args.out, json.loads(args.cmdlines.read_text()), args.usa,
        args.min_reads, args.threads, args.filter, args.compress, args.max_records,
        quant_opts=_quant_opts(args), t2g=args.t2g, rad=args.rad,
    )
    print(json.dumps(secs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
