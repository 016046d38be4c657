"""idle_share.test: 1 minus the union of the device's operation intervals
over the traced window of test requests."""


def read(w):
    return w.trace.idle_share() if w.kind == "test" else None
