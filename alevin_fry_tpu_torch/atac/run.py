"""``atac`` subcommand dispatch (port of ``alevin_fry_tpu/atac/run.py``,
reference src/atac/run.rs)."""

from __future__ import annotations

import sys
from pathlib import Path


def run(args, cmdline: str, device) -> int:
    cmd = args.atac_command
    if cmd == "generate-permit-list":
        from .gpl import AtacGplOpts, generate_permit_list

        if args.min_reads < 1:
            print(f"min-reads < 1 is not supported, the value {args.min_reads} "
                  "was provided", file=sys.stderr)
            return 1
        n = generate_permit_list(AtacGplOpts(
            input_dir=args.input, output_dir=args.output_dir,
            unfiltered_pl=args.unfiltered_pl, device=device, min_reads=args.min_reads,
            rc=args.permit_bc_ori.upper() == "RC", threads=args.threads,
            cmdline=cmdline,
        ))
        if n == 0:
            print("warning: found 0 corrected barcodes; please check the input.",
                  file=sys.stderr)
        return 0
    if cmd == "collate":
        from .collate import collate

        collate(args.input_dir, args.rad_dir, device, args.max_records, args.compress,
                cmdline)
        return 0
    if cmd == "sort":
        from .sort import sort

        sort(args.input_dir, args.rad_dir, device, args.threads, args.max_records,
             args.compress, cmdline)
        return 0
    parent = Path(args.input_dir)
    if not ((parent / "generate_permit_list.json").exists()
            and (parent / "collate.json").exists()):
        print("The provided input directory lacks a generate_permit_list.json or "
              "collate.json file; this should not happen.", file=sys.stderr)
        return 1
    from . import dedup

    dedup.deduplicate(args.input_dir, device, args.threads,
                      rev=args.permit_bc_ori.upper() == "RC", cmdline=cmdline)
    return 0
