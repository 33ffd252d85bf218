"""Command line of the port: ``generate-permit-list``, ``collate``,
``quant``, ``infer``, ``view``, ``convert`` and the ``atac`` subcommands,
with the reference's flags (alevin_fry_tpu/cli.py, reference
src/main.rs) plus ``--device {cuda,cpu}`` on the stages that use a
device (view and convert are host and native code).

    python -m alevin_fry_tpu_torch generate-permit-list -i RAD -d fw -o OUT -u PERMIT.txt
    python -m alevin_fry_tpu_torch collate -i OUT -r RAD
    python -m alevin_fry_tpu_torch quant -i OUT -m T2G.tsv -o QUANT -r cr-like-em -d
    python -m alevin_fry_tpu_torch infer -c QUANT/alevin/geqc_counts.mtx \
        -e QUANT/alevin/gene_eqclass.txt.gz -o INFER --usa
    python -m alevin_fry_tpu_torch atac generate-permit-list -i RAD -o OUT -u WL.txt
    python -m alevin_fry_tpu_torch atac sort -i OUT -r RAD
    python -m alevin_fry_tpu_torch atac collate -i OUT -r RAD
    python -m alevin_fry_tpu_torch atac deduplicate -i OUT
    python -m alevin_fry_tpu_torch convert -b ALN.bam -o RAD/map.rad [-f]
    python -m alevin_fry_tpu_torch view -r RAD/map.rad [-H]

The stage JSONs record the command line as ``alevin-fry-tpu <args>``,
the reference's own form, so either package's artifacts are accepted by
the other.

With ``AFT_COORDINATOR=host:port``, ``AFT_NUM_PROCESSES=N`` and
``AFT_PROCESS_ID=r`` set, N processes run one stage together
(``parallel/dist.py``): each takes its share of the chunks, rank 0
writes the artifacts, and the stage ends with a barrier and the process
group's end, on its error path too.  ``infer``, ``view`` and
``convert`` always run as one process.

    AFT_COORDINATOR=127.0.0.1:29500 AFT_NUM_PROCESSES=2 AFT_PROCESS_ID=0 \
        python -m alevin_fry_tpu_torch quant -i OUT -m T2G.tsv -o QUANT -r cr-like &
    AFT_COORDINATOR=127.0.0.1:29500 AFT_NUM_PROCESSES=2 AFT_PROCESS_ID=1 \
        python -m alevin_fry_tpu_torch quant -i OUT -m T2G.tsv -o QUANT -r cr-like
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from . import __version__, spans


def _existing_dir(v: str) -> Path:
    p = Path(v)
    if not p.is_dir():
        raise argparse.ArgumentTypeError("No valid directory was found at this path.")
    return p


def _existing_file(v: str) -> Path:
    p = Path(v)
    if not p.exists():
        raise argparse.ArgumentTypeError("No valid file was found at this path.")
    return p


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="alevin-fry-tpu-torch",
        description="Process RAD files (PyTorch / CUDA port of alevin-fry-tpu)",
    )
    ap.add_argument("--version", action="version", version=__version__)
    sub = ap.add_subparsers(dest="command", required=True)

    ncpu = os.cpu_count() or 1
    gpl_threads = max(2, min(8, ncpu))
    collate_threads = max(2, min(16, ncpu))

    def device_flag(p):
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                       help="where the stage's kernels run (default: cuda)")

    g = sub.add_parser("generate-permit-list", help="Generate a permit list of barcodes from a RAD file")
    g.add_argument("-i", "--input", required=True, type=_existing_dir)
    g.add_argument("-d", "--expected-ori", required=True,
                   choices=["fw", "rc", "both", "either", "FW", "RC", "BOTH", "EITHER"])
    g.add_argument("-o", "--output-dir", required=True, type=Path)
    g.add_argument("-k", "--knee-distance", action="store_true")
    g.add_argument("-t", "--threads", type=int, default=gpl_threads)
    g.add_argument("-e", "--expect-cells", type=int)
    g.add_argument("-f", "--force-cells", type=int)
    g.add_argument("-b", "--valid-bc", type=_existing_file)
    g.add_argument("-u", "--unfiltered-pl", type=_existing_file)
    g.add_argument("-m", "--min-reads", type=int, default=10)
    g.add_argument("--sample-bc-list", type=_existing_file)
    g.add_argument("--sample-names", type=_existing_file)
    g.add_argument("--sample-correction-mode", choices=["exact", "1-edit"], default="exact")
    g.add_argument("--sample-bc-ori", choices=["forward", "reverse"], default="forward")
    device_flag(g)

    c = sub.add_parser("collate", help="Collate a RAD file by corrected cell barcode")
    c.add_argument("-i", "--input-dir", required=True, type=_existing_dir)
    c.add_argument("-r", "--rad-dir", required=True, type=_existing_dir)
    c.add_argument("-t", "--threads", type=int, default=collate_threads)
    c.add_argument("-c", "--compress", action="store_true")
    c.add_argument("-m", "--max-records", type=int, default=30_000_000)
    c.add_argument("--collation-mode", choices=["two-round", "fast"], default="fast")
    device_flag(c)

    q = sub.add_parser("quant", help="Quantify expression from a collated RAD file")
    q.add_argument("-i", "--input-dir", required=True, type=_existing_dir)
    q.add_argument("-m", "--tg-map", required=True, type=_existing_file)
    q.add_argument("-o", "--output-dir", required=True, type=Path)
    q.add_argument("-t", "--threads", type=int, default=ncpu)
    q.add_argument("-d", "--dump-eqclasses", action="store_true")
    q.add_argument("-b", "--num-bootstraps", type=int, default=0)
    q.add_argument("--init-uniform", action="store_true")
    q.add_argument("--summary-stat", action="store_true")
    q.add_argument("--use-mtx", action="store_true",
                   help="write matrix in MTX format (default; kept for compatibility)")
    q.add_argument("--use-eds", action="store_true", help=argparse.SUPPRESS)
    q.add_argument("--quant-subset", type=_existing_file)
    q.add_argument("-r", "--resolution", required=True,
                   choices=["trivial", "cr-like", "cr-like-em", "parsimony",
                            "parsimony-em", "parsimony-gene", "parsimony-gene-em"])
    q.add_argument("--sa-model", choices=["winner-take-all", "prefer-ambig"],
                   default="winner-take-all")
    q.add_argument("--umi-edit-dist", type=int, default=None)
    q.add_argument("--large-graph-thresh", type=int, default=None)
    q.add_argument("--small-thresh", type=int, default=10)
    q.add_argument("--multi-sample-output", choices=["separate", "combined", "both"],
                   default="separate")
    device_flag(q)

    i = sub.add_parser("infer", help="Perform inference on equivalence class count data")
    i.add_argument("-c", "--count-mat", required=True, type=_existing_file)
    i.add_argument("-e", "--eq-labels", required=True, type=_existing_file)
    i.add_argument("-o", "--output-dir", required=True, type=Path)
    i.add_argument("-t", "--threads", type=int, default=ncpu)
    i.add_argument("--usa", action="store_true")
    i.add_argument("--quant-subset", type=_existing_file)
    i.add_argument("--use-mtx", action="store_true")
    i.add_argument("--use-eds", action="store_true", help=argparse.SUPPRESS)
    device_flag(i)

    v = sub.add_parser("view", help="View a RAD file")
    v.add_argument("-r", "--rad", required=True, type=_existing_file)
    v.add_argument("-H", "--header", action="store_true")

    cv = sub.add_parser("convert", help="Convert a BAM file to a RAD file")
    cv.add_argument("-b", "--bam", required=True, type=_existing_file)
    cv.add_argument("-t", "--threads", type=int, default=ncpu)
    cv.add_argument("-f", "--filter_best", action="store_true")
    cv.add_argument("-o", "--output", required=True, type=Path)

    at = sub.add_parser("atac", help="subcommand for processing scATAC-seq RAD files")
    atsub = at.add_subparsers(dest="atac_command", required=True)
    ag = atsub.add_parser("generate-permit-list")
    ag.add_argument("-i", "--input", required=True, type=_existing_dir)
    ag.add_argument("-o", "--output-dir", required=True, type=Path)
    ag.add_argument("-t", "--threads", type=int, default=gpl_threads)
    ag.add_argument("-u", "--unfiltered-pl", required=True, type=_existing_file)
    ag.add_argument("-m", "--min-reads", type=int, default=10)
    ag.add_argument("-d", "--permit-bc-ori", choices=["fw", "rc", "FW", "RC"], default="rc")
    device_flag(ag)
    for name in ("collate", "sort"):
        p = atsub.add_parser(name)
        p.add_argument("-i", "--input-dir", required=True, type=_existing_dir)
        p.add_argument("-r", "--rad-dir", required=True, type=_existing_dir)
        p.add_argument("-t", "--threads", type=int, default=collate_threads)
        p.add_argument("-c", "--compress", action="store_true")
        p.add_argument("-m", "--max-records", type=int, default=30_000_000)
        device_flag(p)
    ad = atsub.add_parser("deduplicate")
    ad.add_argument("-i", "--input-dir", required=True, type=_existing_dir)
    ad.add_argument("-t", "--threads", type=int, default=ncpu)
    ad.add_argument("-d", "--permit-bc-ori", choices=["fw", "rc", "FW", "RC"], default="rc")
    device_flag(ad)
    return ap


def _gpl(ap, args, cmdline, device) -> int:
    from .pipeline.gpl import CellFilterMethod, GenPermitListOpts, generate_permit_list

    nmeth = sum(1 for x in (args.knee_distance, args.expect_cells, args.force_cells,
                            args.valid_bc, args.unfiltered_pl) if x)
    if nmeth != 1:
        ap.error(
            "exactly one of --knee-distance / --expect-cells / --force-cells / "
            "--valid-bc / --unfiltered-pl is required"
        )
    if args.unfiltered_pl:
        if args.min_reads < 1:
            ap.error(f"min-reads < 1 is not supported, the value {args.min_reads} was provided")
        fmeth = CellFilterMethod("unfiltered", path=args.unfiltered_pl, min_reads=args.min_reads)
    elif args.valid_bc:
        fmeth = CellFilterMethod("explicit", path=args.valid_bc)
    elif args.force_cells:
        fmeth = CellFilterMethod("force", count=args.force_cells)
    elif args.expect_cells:
        fmeth = CellFilterMethod("expect", count=args.expect_cells)
    else:
        fmeth = CellFilterMethod("knee")
    n = generate_permit_list(GenPermitListOpts(
        input_dir=args.input, output_dir=args.output_dir, fmeth=fmeth,
        expected_ori=args.expected_ori, device=device, threads=args.threads,
        cmdline=cmdline, sample_bc_list=args.sample_bc_list,
        sample_names=args.sample_names,
        sample_correction_mode=args.sample_correction_mode,
        sample_bc_ori=args.sample_bc_ori,
    ))
    if n == 0:
        print("warning: found 0 corrected barcodes; please check the input.", file=sys.stderr)
    return 0


def _quant(args, cmdline, device) -> int:
    from .pipeline.quant import QuantOpts, quantify
    from .utils import is_velo_mode

    if args.use_eds:
        print("--use-eds is no longer supported. EDS output has been removed.", file=sys.stderr)
        return 1
    # umi-edit-dist / resolution compatibility (src/main.rs:483-531)
    parsimony = args.resolution.startswith("parsimony")
    edist = args.umi_edit_dist
    if edist is None:
        edist = 1 if parsimony else 0
    if edist not in (0, 1) or (edist == 1 and not parsimony):
        print(
            f"Resolution strategy {args.resolution} doesn't currently support "
            f"{edist}-edit UMI resolution", file=sys.stderr,
        )
        return 1
    if args.dump_eqclasses and args.resolution == "trivial":
        print("Gene equivalence classes are not meaningful in case of Trivial "
              "resolution.", file=sys.stderr)
        return 1
    if args.num_bootstraps > 0 and args.resolution not in (
            "cr-like-em", "parsimony-em", "parsimony-gene-em"):
        print("bootstrapping can only be used with the cr-like-em, parsimony-em, "
              "or parsimony-gene-em resolution strategies", file=sys.stderr)
        return 1
    lgt = args.large_graph_thresh
    if lgt is None:
        lgt = 1000 if parsimony else 0
    if not (args.input_dir / "generate_permit_list.json").exists():
        print(
            "The provided input directory lacks a generate_permit_list.json "
            "file; this should not happen.", file=sys.stderr,
        )
        return 1
    if is_velo_mode(args.input_dir):
        raise NotImplementedError("velocity mode is not implemented on this branch")
    quantify(QuantOpts(
        input_dir=args.input_dir, tg_map=args.tg_map, output_dir=args.output_dir,
        device=device, num_threads=args.threads,
        num_bootstraps=args.num_bootstraps, init_uniform=args.init_uniform,
        summary_stat=args.summary_stat, dump_eq=args.dump_eqclasses,
        resolution=args.resolution, pug_exact_umi=parsimony and edist == 0,
        sa_model=args.sa_model, small_thresh=args.small_thresh,
        large_graph_thresh=lgt, filter_list=args.quant_subset, cmdline=cmdline,
    ))
    return 0


def main(argv=None) -> int:
    """Run one subcommand inside its root span (``spans.py``), named by
    the subcommand; a stage that succeeds logs the span tree's summary."""
    from .pipeline.logging_ import get_logger

    argv = argv if argv is not None else sys.argv[1:]
    cmdline = "alevin-fry-tpu " + " ".join(argv)
    ap = build_parser()
    args = ap.parse_args(argv)
    name = f"atac {args.atac_command}" if args.command == "atac" else args.command
    with spans.span(name, "stage") as root:
        rc = _dispatch(ap, args, cmdline)
    if rc == 0:
        get_logger("stage").info("%s", spans.summary(root))
    return rc


def _dispatch(ap, args, cmdline) -> int:
    from .device import resolve_device
    from .parallel import dist
    from .radz import _native

    # -t/--threads also governs the native codec's thread pool
    if getattr(args, "threads", None) is not None:
        _native.set_threads(args.threads)
    if args.command == "view":
        from .pipeline.view import view

        view(args.rad, args.header)
        return 0
    if args.command == "convert":
        from .pipeline.convert import bam2rad

        bam2rad(args.bam, args.output, args.threads, args.filter_best)
        return 0
    if args.command == "infer":
        return _infer(args, resolve_device(args.device))
    dist.initialize()
    ok = False
    try:
        rc = _stage(ap, args, cmdline, resolve_device(args.device))
        ok = True
    finally:
        dist.finalize(ok)
    return rc


def _infer(args, device) -> int:
    if args.use_eds:
        print("--use-eds is no longer supported.", file=sys.stderr)
        return 1
    from .pipeline.infer import infer

    infer(args.count_mat, args.eq_labels, args.usa, args.threads, args.quant_subset,
          args.output_dir, device)
    return 0


def _stage(ap, args, cmdline, device) -> int:
    """One stage of a (possibly multi-process) run."""
    if args.command == "generate-permit-list":
        return _gpl(ap, args, cmdline, device)
    if args.command == "collate":
        from .pipeline.collate import collate

        collate(
            args.input_dir, args.rad_dir, device, args.max_records, args.compress,
            cmdline, collation_mode=args.collation_mode,
        )
        return 0
    if args.command == "atac":
        from .atac import run as atac_run

        return atac_run.run(args, cmdline, device)
    return _quant(args, cmdline, device)


if __name__ == "__main__":
    sys.exit(main())
