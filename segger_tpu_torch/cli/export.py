"""`segger-tpu-torch export`: post-segmentation exports
(reference: src/segger/cli/export.py:47-137).

Joins the segmentation parquet back onto the source transcripts by
row_index, filters by similarity threshold (per-gene / fixed / none) and
minimum transcripts per cell, then writes any of: boundaries (Delaunay
concave hulls as flat-vertex parquet), anndata (SpatialData-convention
h5ad), transcripts (parquet).  The port's copy of ``segger_tpu.cli.export``;
it runs on the host only.
"""
from __future__ import annotations

from pathlib import Path


def add_export_parser(sub):
    p = sub.add_parser(
        "export", help="Export boundaries / anndata / transcripts"
    )
    p.add_argument("-i", "--input-directory", required=True,
                   help="Original dataset directory")
    p.add_argument("-s", "--segmentation-directory", required=True,
                   help="Directory containing segger_segmentation.parquet")
    p.add_argument("-o", "--output-directory", required=True)
    p.add_argument(
        "elements", nargs="+",
        choices=["anndata", "transcripts", "boundaries"],
    )
    p.add_argument("--platform", default=None)
    p.add_argument(
        "--threshold-mode", default="per-gene",
        choices=["per-gene", "fixed", "none"],
    )
    p.add_argument("--fixed-threshold", type=float, default=0.5)
    p.add_argument("--min-transcripts", type=int, default=10,
                   help="Minimum assigned transcripts per cell")
    p.add_argument("--boundary-method", default="delaunay",
                   choices=["delaunay", "convex_hull"])
    p.add_argument("--smoothing", type=int, default=0,
                   help="Chaikin smoothing iterations")
    p.add_argument("--connectivity", type=float, default=2.0)
    p.set_defaults(func=run_export)
    return p


def load_assigned(
    input_directory,
    segmentation_directory,
    platform=None,
    threshold_mode: str = "per-gene",
    fixed_threshold: float = 0.5,
    min_transcripts: int = 10,
):
    """Segmentation table joined with source transcripts + filters
    (reference: export.py:47-94)."""
    import pandas as pd

    from ..io import get_preprocessor, StandardTranscriptFields

    tx_f = StandardTranscriptFields()
    seg = pd.read_parquet(
        Path(segmentation_directory) / "segger_segmentation.parquet"
    )
    pp = get_preprocessor(input_directory, platform=platform)
    tx = pp.transcripts

    df = seg.merge(
        tx[[tx_f.row_index, tx_f.x, tx_f.y, tx_f.feature]],
        on=tx_f.row_index,
        how="left",
    )
    df = df[df["segger_cell_id"].notna()]
    if threshold_mode == "per-gene":
        df = df[df["segger_similarity"] >= df["similarity_threshold"]]
    elif threshold_mode == "fixed":
        df = df[df["segger_similarity"] >= fixed_threshold]
    # min transcripts per cell (export.py:88-94)
    counts = df.groupby("segger_cell_id")[tx_f.row_index].transform(
        "count"
    )
    return df[counts >= min_transcripts].reset_index(drop=True)


def run_export(args) -> int:
    import pandas as pd

    from ..io import StandardTranscriptFields

    tx_f = StandardTranscriptFields()
    out_dir = Path(args.output_directory)
    out_dir.mkdir(parents=True, exist_ok=True)

    df = load_assigned(
        args.input_directory,
        args.segmentation_directory,
        platform=args.platform,
        threshold_mode=args.threshold_mode,
        fixed_threshold=args.fixed_threshold,
        min_transcripts=args.min_transcripts,
    )

    boundaries = None
    if "boundaries" in args.elements:
        from ..export.boundary import generate_boundaries

        boundaries = generate_boundaries(
            df,
            cell_id="segger_cell_id",
            x=tx_f.x,
            y=tx_f.y,
            method=args.boundary_method,
            smoothing=args.smoothing,
            connectivity=args.connectivity,
            progress=True,
        )
        rows = []
        for cid, rec in boundaries.iterrows():
            for v in rec["polygon"]:
                rows.append((cid, rec["n_transcripts"], v[0], v[1]))
        pd.DataFrame(
            rows,
            columns=["cell_id", "n_transcripts", "vertex_x", "vertex_y"],
        ).to_parquet(out_dir / "segger_boundaries.parquet", index=False)

    if "anndata" in args.elements:
        from ..export.anndata_writer import build_anndata

        ad = build_anndata(
            df,
            cell_id_column="segger_cell_id",
            feature_column=tx_f.feature,
            x=tx_f.x,
            y=tx_f.y,
            boundaries=boundaries,
        )
        ad.write_h5ad(out_dir / "segger_anndata.h5ad")

    if "transcripts" in args.elements:
        df.to_parquet(out_dir / "segger_transcripts.parquet", index=False)

    print(f"Export complete: {out_dir}")
    return 0
