"""The reference package's host path, as an oracle for the port.

Runs ``alevin_fry_tpu``'s generate-permit-list (unfiltered, or a
filtered method) -> collate (plain or compressed) -> quant (cr-like), or
its ATAC stages (generate-permit-list -> sort, collate -> deduplicate,
plain or compressed), through its Python API with every device
policy set to the host, so no JAX is needed: ``run`` and ``run-atac``
block the ``jax`` import outright.  The policies are set in the
environment only while the stages run.  The stage command lines are
given, so the stage JSONs can be compared with the port's field for
field.

As a script (this imports nothing of the port):

    python tests/reference_host_path.py make DIR --n-cells C --n-reads R --n-genes G [--seed S]
        writes tests/synth_hard.make_hard_dataset(DIR, RandomState(S), ...)
    python tests/reference_host_path.py run DIR OUT CMDLINES.json [--usa] [--min-reads M]
            [--threads T] [--filter knee|force:N|expect:N|explicit:PATH] [--compress]
            [--max-records R]
        runs the three stages on DIR/rad into OUT (gpl with DIR/permit.txt
        unless --filter names a filtered method; collate -c with
        --compress) and prints their seconds as one JSON line
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
from pathlib import Path

HOST_ENV = {
    "AFT_CRLIKE_BACKEND": "host",
    "AFT_RESCUE_BACKEND": "host",
    "AFT_COLLATE_BACKEND": "host",
    "AFT_ATAC_SORT_BACKEND": "host",
    "AFT_GPL_MESH": "0",
    "AFT_EM_MESH": "0",
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
                  gpl_opts=None) -> dict:
    """Run the reference's three stages on ``d/rad`` into ``out/gpl`` and
    ``out/quant``; returns each stage's seconds.  ``cmdlines`` maps
    gpl / collate / quant to the command line each JSON records;
    ``cell_filter_spec`` is :func:`cell_filter`'s; ``compress`` and
    ``max_records`` are collate's ``-c`` and ``-m``; ``gpl_opts`` adds
    fields of the gpl options (the Flex sample flags)."""
    with host_policies():
        return _run_reference(d, out, cmdlines, usa, min_reads, threads,
                              cell_filter_spec, compress, max_records, gpl_opts or {})


def _run_reference(d, out, cmdlines, usa, min_reads, threads, cell_filter_spec,
                   compress, max_records, gpl_opts) -> dict:
    from alevin_fry_tpu.pipeline.collate import collate
    from alevin_fry_tpu.pipeline.gpl import GenPermitListOpts, generate_permit_list
    from alevin_fry_tpu.pipeline.quant import QuantOpts, quantify
    from alevin_fry_tpu.radz import _native

    _native.set_threads(threads)
    secs = {}
    t0 = time.perf_counter()
    generate_permit_list(GenPermitListOpts(
        input_dir=d / "rad", output_dir=out / "gpl",
        fmeth=cell_filter(cell_filter_spec, d, min_reads),
        expected_ori="fw", threads=threads, cmdline=cmdlines["gpl"], **gpl_opts,
    ))
    secs["gpl"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    collate(out / "gpl", d / "rad", threads, max_records, compress,
            cmdline=cmdlines["collate"])
    secs["collate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    quantify(QuantOpts(
        input_dir=out / "gpl", tg_map=d / ("t2g_3col.tsv" if usa else "t2g.tsv"),
        output_dir=out / "quant", num_threads=threads, resolution="cr-like",
        large_graph_thresh=0, cmdline=cmdlines["quant"],
    ))
    secs["quant"] = time.perf_counter() - t0
    return secs


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
    ma = sub.add_parser("make-atac")
    ma.add_argument("dir", type=Path)
    ma.add_argument("--n-cells", type=int, required=True)
    ma.add_argument("--n-frags", type=int, required=True)
    ma.add_argument("--n-chrs", type=int, required=True)
    ma.add_argument("--chr-len", type=int, required=True)
    ma.add_argument("--ambient-factor", type=int, required=True)
    ma.add_argument("--seed", type=int, default=11)
    ra = sub.add_parser("run-atac")
    ra.add_argument("dir", type=Path)
    ra.add_argument("out", type=Path)
    ra.add_argument("cmdlines", type=Path)
    ra.add_argument("--min-reads", type=int, default=10)
    ra.add_argument("--max-records", type=int, default=30_000_000)
    ra.add_argument("--threads", type=int, default=4)
    ra.add_argument("--compress", action="store_true")
    ra.add_argument("--skip-gpl", action="store_true")
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
    # the host path must not need JAX: make any import of it fail
    sys.modules["jax"] = None
    if args.cmd == "run-atac":
        secs, stats = run_reference_atac(
            args.dir, args.out, json.loads(args.cmdlines.read_text()),
            args.min_reads, args.max_records, args.threads, args.compress, args.skip_gpl,
        )
        print(json.dumps({"seconds": secs, "dedup": stats}))
        return 0
    secs = run_reference(
        args.dir, args.out, json.loads(args.cmdlines.read_text()), args.usa,
        args.min_reads, args.threads, args.filter, args.compress, args.max_records,
    )
    print(json.dumps(secs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
