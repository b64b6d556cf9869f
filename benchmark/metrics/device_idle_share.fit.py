"""The share of the traced window in which no kernel or copy ran on a
card (each card's union of the trace's device records, spins left out,
averaged over the cell's cards), in percent."""


def read(view):
    if view.kind != "fit" or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
