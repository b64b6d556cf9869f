"""Host milliseconds a step of the random draws of a loss step: its
launches' seed words and its loss uniforms, tile by tile (the program's
span ``stage.draws``, inside ``stage``), over the steps of the traced
epochs: the calls of ``stage``, one a step."""


def read(view):
    if view.kind != "fit" or "stage.draws" not in view.stages:
        return None
    seconds = view.stages["stage.draws"][0]
    steps = view.stages.get("stage", (0.0, 0))[1]
    return 1e3 * seconds / steps if steps else None
