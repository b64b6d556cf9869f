"""Host milliseconds of tile planning (the program's
``substage("plan.tile_bucket")``) per traced epoch."""


def read(view):
    if view.kind != "fit" or view.units < 1:
        return None
    seconds, calls = view.stages.get("plan.tile_bucket", (0.0, 0))
    return 1e3 * seconds / view.units if calls else None
