"""K5, the candidate scoring: its launches' least time at the card's HBM rate (or float32
rate), from the benchmark's byte counts of each launch's table, over the
kernel's summed device time in the trace, in percent."""


def read(view):
    if view.kind != "predict":
        return None
    return view.roofline("K5")
