"""Device milliseconds a step of the copies between cards in the traced
epochs (the profiler's ``Memcpy PtoP`` records: the shards' loss
statistics and gradients into the model's card, the parameters pulled
back to the replicas), over the calls of ``stage``, one a step; nothing
on one card."""


def read(view):
    if view.kind != "fit" or view.cards < 2:
        return None
    seconds = view.peer_copy_seconds()
    steps = view.stages.get("stage", (0.0, 0))[1]
    return 1e3 * seconds / steps if seconds and steps else None
