"""segger-tpu-torch command-line interface.

Commands (reference CLI surface: src/segger/cli/main.py:9-13,
segment.py, export.py, debug.py), the port's copy of
``segger_tpu.cli.main``:

  segger-tpu-torch preprocess  — standardize a raw platform directory
  segger-tpu-torch segment     — train + predict + write segmentation
  segger-tpu-torch export      — boundaries / anndata / transcripts exports
  segger-tpu-torch debug       — re-run pipeline stages from saved artifacts

``segment`` and ``debug predict-only`` train and predict on CUDA unless
``--device cpu`` is given.  The commands import their modules inside
their functions, and the options come from the config classes' sources
(cli/registry.py), not from importing them.
"""
from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="segger-tpu-torch",
        description=(
            "GPU cell segmentation for imaging spatial "
            "transcriptomics (Xenium / CosMX / MERSCOPE)"
        ),
    )
    parser.add_argument(
        "--log-level",
        default=None,
        help="Logging level (also via SEGGER_LOG_LEVEL / LOG_LEVEL env)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    from .segment import add_segment_parser
    from .export import add_export_parser
    from .debug import add_debug_parser
    from .preprocess import add_preprocess_parser

    add_preprocess_parser(sub)
    add_segment_parser(sub)
    add_export_parser(sub)
    add_debug_parser(sub)
    return parser


def setup_logging(level=None):
    """Env-var driven logging (reference: utils.py:6-41); records carry
    host RSS and, once CUDA is up, free device memory (utils.MemFilter)."""
    import os

    level = (
        level
        or os.environ.get("SEGGER_LOG_LEVEL")
        or os.environ.get("LOG_LEVEL")
        or "INFO"
    )
    from ..utils import setup_logging as _setup

    _setup(level)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    setup_logging(args.log_level)
    return args.func(args) or 0


if __name__ == "__main__":
    sys.exit(main())
