"""lp_idle_share.test: the device's idle share inside the rooms' label
propagation: 1 minus the union of the device's operation intervals inside
the program's ``lp.room`` spans over their summed length, over the rooms
served in the traced window."""

from harness import spans


def read(w):
    if w.kind != "test":
        return None
    lps = spans.in_rooms(w, "lp.room")
    if not lps:
        return None
    return 1.0 - spans.busy_share(w.trace, lps)
