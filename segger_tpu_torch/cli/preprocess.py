"""`segger-tpu-torch preprocess`: standardize a raw platform directory
(the port's copy of ``segger_tpu.cli.preprocess``)."""
from __future__ import annotations


def add_preprocess_parser(sub):
    p = sub.add_parser(
        "preprocess",
        help="Standardize a raw Xenium/CosMX/MERSCOPE directory",
    )
    p.add_argument("-i", "--input-directory", required=True)
    p.add_argument("-o", "--output-directory", required=True)
    p.add_argument(
        "--platform",
        default=None,
        help="Platform name (auto-inferred when omitted)",
    )
    p.add_argument("--overwrite", action="store_true")
    p.set_defaults(func=run_preprocess)
    return p


def run_preprocess(args) -> int:
    from ..io import get_preprocessor

    pp = get_preprocessor(args.input_directory, platform=args.platform)
    out = pp.save(args.output_directory, overwrite=args.overwrite)
    print(f"Standardized dataset written to {out}")
    return 0
