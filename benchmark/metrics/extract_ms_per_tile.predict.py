"""Host milliseconds a tile extraction takes (the program's
``substage("extract.tile")``, on the prefetch thread) over the tiles
extracted in the traced passes."""


def read(view):
    if view.kind != "predict":
        return None
    seconds, calls = view.stages.get("extract.tile", (0.0, 0))
    return 1e3 * seconds / calls if calls else None
