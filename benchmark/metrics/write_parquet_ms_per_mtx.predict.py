"""Host milliseconds of the writer's parquet file: the output table's
columns and the file written (the program's span ``write.parquet``), per
million transcripts written in the traced passes."""


def read(view):
    if (view.kind != "predict" or not view.rows_written
            or "write.parquet" not in view.stages):
        return None
    seconds = view.stages["write.parquet"][0]
    return 1e3 * seconds / (view.rows_written / 1e6)
