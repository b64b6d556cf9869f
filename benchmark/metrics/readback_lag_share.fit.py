"""The share of the traced epochs' steps whose loss row the step loop read
one step late, after a later step was enqueued, in percent: the program's
counter ``loss_row.lagged`` over the calls of ``stage``, one a step."""


def read(view):
    if view.kind != "fit" or "loss_row.lagged" not in view.stages:
        return None
    lagged = view.stages["loss_row.lagged"][1]
    steps = view.stages.get("stage", (0.0, 0))[1]
    return 100.0 * lagged / steps if steps else None
