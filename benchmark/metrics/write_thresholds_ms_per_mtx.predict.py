"""Host milliseconds of the writer's per-gene Yen and Li thresholds (the
program's span ``write.thresholds``), per million transcripts written in
the traced passes."""


def read(view):
    if (view.kind != "predict" or not view.rows_written
            or "write.thresholds" not in view.stages):
        return None
    seconds = view.stages["write.thresholds"][0]
    return 1e3 * seconds / (view.rows_written / 1e6)
