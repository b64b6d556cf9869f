"""Host milliseconds a step of the step loop blocked on the device: a
pinned slot's last upload, a predict step's output copied back, the loss
rows read back (the program's span ``device.wait``), over the steps of
the traced epochs: the calls of ``stage``, one a step."""


def read(view):
    if view.kind != "fit" or "device.wait" not in view.stages:
        return None
    seconds = view.stages["device.wait"][0]
    steps = view.stages.get("stage", (0.0, 0))[1]
    return 1e3 * seconds / steps if steps else None
