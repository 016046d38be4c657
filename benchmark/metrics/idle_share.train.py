"""idle_share.train: 1 minus the union of the device's operation intervals
over the traced training window."""


def read(w):
    return w.trace.idle_share() if w.kind == "train" else None
