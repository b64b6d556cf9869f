"""Host milliseconds of the writer's table less its per-gene thresholds:
the dedupe of transcripts predicted in several tiles, the cell ids, each
row's threshold (the self time of the program's span ``write.assign``,
less its child ``write.thresholds``), per million transcripts written in
the traced passes."""


def read(view):
    if (view.kind != "predict" or not view.rows_written
            or "write.assign" not in view.stages):
        return None
    seconds = view.stages["write.assign"][0]
    seconds -= view.stages.get("write.thresholds", (0.0, 0))[0]
    return 1e3 * seconds / (view.rows_written / 1e6)
