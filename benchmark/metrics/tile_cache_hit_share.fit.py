"""The share of the traced epochs' tile extractions that the epoch-spanning
tile cache served, in percent: the program's counters ``tile_cache.hit``
over ``tile_cache.hit`` and ``tile_cache.miss``."""


def read(view):
    if view.kind != "fit":
        return None
    hits = view.stages.get("tile_cache.hit", (0.0, 0))[1]
    misses = view.stages.get("tile_cache.miss", (0.0, 0))[1]
    return 100.0 * hits / (hits + misses) if hits + misses else None
