"""Host milliseconds a step of the main thread's wait on the prefetch
thread's queue for its next batch (the program's span
``prefetch.wait``), over the steps of the traced epochs: the calls of
``stage``, one a step."""


def read(view):
    if view.kind != "fit" or "prefetch.wait" not in view.stages:
        return None
    seconds = view.stages["prefetch.wait"][0]
    steps = view.stages.get("stage", (0.0, 0))[1]
    return 1e3 * seconds / steps if steps else None
