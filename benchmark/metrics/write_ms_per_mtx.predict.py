"""Host milliseconds of the writer (``SegmentationWriter.write``: dedupe,
per-gene thresholds, parquet) per million transcripts written, by the
benchmark's clock around its own call."""


def read(view):
    if view.kind != "predict" or not view.rows_written:
        return None
    return 1e3 * view.write_s / (view.rows_written / 1e6)
