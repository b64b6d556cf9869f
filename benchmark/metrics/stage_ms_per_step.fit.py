"""Host milliseconds of a step's staging once its pinned slot is free:
the batch's copies into the slot, the random draws, the upload's
enqueue (the program's span ``stage``, one call a step), a step of
the traced epochs."""


def read(view):
    if view.kind != "fit" or "stage" not in view.stages:
        return None
    seconds, steps = view.stages["stage"]
    return 1e3 * seconds / steps if steps else None
